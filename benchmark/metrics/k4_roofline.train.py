"""k4_roofline.train (%): K4's share of its roofline in the training step."""

from benchmark import rooflines
from benchmark.costs import flash_bwd_dkv


def read(reading):
    return rooflines.kernel_roofline(reading, flash_bwd_dkv)
