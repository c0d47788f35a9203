"""Shared arithmetic of the per-layer readers in ``metrics/``."""

from __future__ import annotations


def kernel_roofline(reading, cost) -> float | None:
    """A kernel's share of its roofline, in %: the least time of its traced
    launches (the larger of operations over the bf16 peak and bytes over
    the HBM peak) over their device time. ``cost`` is a ``costs/`` module.
    None when the stretch has no launch of it or the card has no peaks."""
    ops = [op for op in reading.trace.ops if cost.KERNEL in op.name]
    if not ops or reading.peaks is None:
        return None
    flops, nbytes = cost.cost(*reading.facts["attention_shape"])
    least_us = 1e6 * max(flops / reading.peaks["bf16"], nbytes / reading.peaks["hbm"])
    return 100.0 * least_us * len(ops) / sum(op.dur_us for op in ops)


def mfu(reading) -> float | None:
    """Model operations of the traced steps over the stretch's seconds, as a
    share of the card's bf16 peak, in %."""
    if reading.peaks is None or reading.trace.window_s <= 0:
        return None
    done = reading.facts["step_flops"] * reading.facts["steps"]
    return 100.0 * done / reading.trace.window_s / reading.peaks["bf16"]


def idle_share(reading) -> float | None:
    """Share of the traced stretch in which no operation ran on the device, in %."""
    if reading.trace.window_s <= 0 or not reading.trace.ops:
        return None
    return 100.0 * (1.0 - reading.trace.busy_s / reading.trace.window_s)
