"""attention_ms.prefill (ms): device ms per traced prefill pass put down to
the program's ``llama.attention`` region (``regions.py``): the layout
copies, the GQA repetition and K2."""

from benchmark import regions


def read(reading):
    return regions.region_ms(reading, "llama.attention")
