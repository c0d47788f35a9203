"""k2_roofline.prefill (%): K2's share of its roofline in a prefill pass."""

from benchmark import rooflines
from benchmark.costs import flash_fwd


def read(reading):
    return rooflines.kernel_roofline(reading, flash_fwd)
