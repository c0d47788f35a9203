"""Deadline-bounded polling (the port's own copy of
``tpu_cc_manager/utils/retry.py::poll_until``)."""

from __future__ import annotations

import time
from typing import Callable


def poll_until(
    predicate: Callable[[], bool],
    timeout_s: float,
    interval_s: float,
    *,
    sleep: Callable[[float], None] = time.sleep,
    clock: Callable[[], float] = time.monotonic,
) -> bool:
    """Call ``predicate`` immediately, then every ``interval_s`` until it
    returns truthy (-> True) or the deadline passes (-> False). Never
    sleeps past the deadline."""
    deadline = clock() + timeout_s
    while True:
        if predicate():
            return True
        remaining = deadline - clock()
        if remaining <= 0:
            return False
        sleep(min(interval_s, remaining))
