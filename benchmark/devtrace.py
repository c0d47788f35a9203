"""A ``torch.profiler`` trace of a short steady stretch, and the arithmetic
the per-layer readers take from it.

The device's operations (kernels, copies and fills) come from the trace's
``kernel``, ``gpu_memcpy`` and ``gpu_memset`` events. Each is tied by its
correlation id to the host call that launched it, and so to the
benchmark's own ``bench.*`` span that was open on the host then. Busy time
is the union of the device's intervals; the idle share is one less busy
over the stretch's length on the host clock (the method of
``chip_smoke.py``'s profiled train step, with the union taken over the
timeline instead of a sum by kernel, and over several steps instead of
one).
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import json
import pathlib
import time
from collections.abc import Callable

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
OUTSIDE = "outside bench spans"


@dataclasses.dataclass(frozen=True)
class DeviceOp:
    name: str
    start_us: float
    dur_us: float
    span: str  # the innermost bench.* span open on the host at its launch


@dataclasses.dataclass
class Trace:
    ops: list[DeviceOp]
    window_s: float  # the stretch on the host clock
    start_us: float  # the stretch's start on the trace's clock

    def intervals(self) -> list[tuple[float, float, DeviceOp]]:
        """The union of the device's busy intervals, each with the op that
        ends the idle gap before it."""
        merged: list[list] = []
        for op in sorted(self.ops, key=lambda o: o.start_us):
            end = op.start_us + op.dur_us
            if merged and op.start_us <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], end)
            else:
                merged.append([op.start_us, end, op])
        return [tuple(m) for m in merged]

    @property
    def busy_s(self) -> float:
        return sum(end - start for start, end, _ in self.intervals()) / 1e6

    def idle_gaps(self) -> list[tuple[str, float]]:
        """(what the host was doing, seconds) of every idle gap: the span in
        which the op that ends the gap was launched."""
        gaps, last = [], self.start_us
        for start, end, op in self.intervals():
            if start > last:
                gaps.append((op.span, (start - last) / 1e6))
            last = max(last, end)
        return sorted(gaps, key=lambda g: -g[1])

    def device_ops(self) -> list[tuple[str, float]]:
        """(op name, seconds) summed by name, longest first."""
        total: dict[str, float] = {}
        for op in self.ops:
            total[op.name] = total.get(op.name, 0.0) + op.dur_us / 1e6
        return sorted(total.items(), key=lambda kv: -kv[1])

    def breakdown(self, top: int = 10) -> dict:
        return {"device_ops": [[name[:160], s] for name, s in self.device_ops()[:top]],
                "idle_gaps": [[span, s] for span, s in self.idle_gaps()[:top]]}


def sync(device) -> None:
    """Wait for the card's queue (nothing to wait for on the CPU)."""
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def span(name: str, on: bool):
    """The benchmark's span ``name`` on the profiler's host timeline while
    ``on``; nothing otherwise."""
    import torch

    return torch.profiler.record_function(name) if on else contextlib.nullcontext()


def parse(events: list[dict], window_s: float) -> Trace:
    """A :class:`Trace` from a Chrome trace's ``traceEvents``."""
    launches = {}
    spans = []
    starts = []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, args = e.get("cat", ""), e.get("args") or {}
        if cat in ("cuda_runtime", "cuda_driver") and "correlation" in args:
            launches[args["correlation"]] = float(e["ts"])
        elif cat == "user_annotation" and e["name"].startswith("bench."):
            spans.append((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]))
        elif cat == "user_annotation" and e["name"].startswith("ProfilerStep#"):
            starts.append(float(e["ts"]))
    spans.sort()
    span_starts = [s[0] for s in spans]

    def span_at(ts: float | None) -> str:
        if ts is None:
            return OUTSIDE
        inner = None
        for begin, end, name in spans[: bisect.bisect_right(span_starts, ts)]:
            if begin <= ts <= end and (inner is None or end - begin < inner[1] - inner[0]):
                inner = (begin, end, name)
        return OUTSIDE if inner is None else inner[2]

    ops = [DeviceOp(e["name"], float(e["ts"]), float(e["dur"]),
                    span_at(launches.get((e.get("args") or {}).get("correlation"))))
           for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES]
    start = min(starts) if starts else min((op.start_us for op in ops), default=0.0)
    return Trace(ops, window_s, start)


def capture(step: Callable[[int], None], steps: int, path: pathlib.Path,
            sync: Callable[[], None], warmed: Callable[[], None]) -> Trace:
    """Run ``step(0)`` untraced as the profiler's warm-up and call
    ``warmed()`` once it has ended, then ``step(1)`` .. ``step(steps)``
    traced; the stretch ends at ``sync()``. The Chrome trace is written to
    ``path``."""
    from torch.profiler import ProfilerActivity, profile, schedule

    import torch

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    path.parent.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities,
                 schedule=schedule(wait=0, warmup=1, active=steps, repeat=1),
                 on_trace_ready=lambda prof: prof.export_chrome_trace(str(path))) as prof:
        step(0)
        sync()
        warmed()
        prof.step()
        t0 = time.perf_counter()
        for i in range(1, steps + 1):
            step(i)
            if i == steps:
                sync()
                window_s = time.perf_counter() - t0
            prof.step()
    return parse(json.loads(path.read_text())["traceEvents"], window_s)
