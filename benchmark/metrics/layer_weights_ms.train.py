"""layer_weights_ms.train (ms): device ms per traced training step put down
to the program's ``llama.layer_weights`` region, forward plus backward
(``regions.py``): each layer's slab of the stacked parameters and its cast;
in the backward, the ``select``'s full-size zero and gradient accumulation
and the cast's."""

from benchmark import regions


def read(reading):
    return regions.region_ms(reading, "llama.layer_weights")
