"""rope_ms.prefill (ms): device ms per traced prefill pass put down to the
program's ``llama.rope`` region (``regions.py``): the rotary embedding of
the queries and keys."""

from benchmark import regions


def read(reading):
    return regions.region_ms(reading, "llama.rope")
