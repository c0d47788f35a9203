"""device_idle_share.prefill (%): share of the traced prefill passes with no
operation on the device."""

from benchmark import rooflines


def read(reading):
    return rooflines.idle_share(reading)
