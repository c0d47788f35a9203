"""lm_head_ms.train (ms): device ms per traced training step put down to the
program's ``llama.lm_head`` region, forward plus backward (``regions.py``):
the f32 ``lm_head`` product, its gradients and its input's cast."""

from benchmark import regions


def read(reading):
    return regions.region_ms(reading, "llama.lm_head")
