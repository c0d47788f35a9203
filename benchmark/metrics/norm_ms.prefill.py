"""norm_ms.prefill (ms): device ms per traced prefill pass put down to the
program's ``llama.norm`` region (``regions.py``): every RMSNorm, the final
one too, in f32."""

from benchmark import regions


def read(reading):
    return regions.region_ms(reading, "llama.norm")
