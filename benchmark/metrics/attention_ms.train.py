"""attention_ms.train (ms): device ms per traced training step put down to
the program's ``llama.attention`` region, forward plus backward
(``regions.py``): the layout copies, the GQA repetition and K2-K4."""

from benchmark import regions


def read(reading):
    return regions.region_ms(reading, "llama.attention")
