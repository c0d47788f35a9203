"""k3_roofline.train (%): K3's share of its roofline in the training step."""

from benchmark import rooflines
from benchmark.costs import flash_bwd_dq


def read(reading):
    return rooflines.kernel_roofline(reading, flash_bwd_dq)
