"""k2_roofline.train (%): K2's share of its roofline in the training step."""

from benchmark import rooflines
from benchmark.costs import flash_fwd


def read(reading):
    return rooflines.kernel_roofline(reading, flash_fwd)
