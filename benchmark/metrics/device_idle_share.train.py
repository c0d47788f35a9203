"""device_idle_share.train (%): share of the traced training steps with no
operation on the device."""

from benchmark import rooflines


def read(reading):
    return rooflines.idle_share(reading)
