"""The program's own profiler regions in a traced stretch: every device
operation put down to the region that caused it.

The program opens ``torch.profiler.record_function`` regions while a
profiler records (``obs.trace.region``): ``llama.*`` in the model,
``train.*`` in the train step; FSDP2 opens its own ``FSDP::*``. This
module re-reads the Chrome trace that ``devtrace.capture`` wrote for the
run, since ``devtrace`` keeps only the benchmark's ``bench.*`` spans, and
assigns each device operation (``kernel``, ``gpu_memcpy``, ``gpu_memset``)
to a region:

1. its correlation id gives the runtime call that launched it;
2. if that launch lies inside an ``autograd::engine::evaluate_function: ...``
   operator (a backward node), and a region opened inside that node is
   open at the launch (an FSDP2 post-backward hook, a recomputed layer),
   that region owns it;
3. else, for a backward node, the forward operator it differentiates owns
   it through the innermost region open at that operator. The profiler
   joins a node to its forward operator by ``(Fwd thread id, Sequence
   number)`` and writes the join as a ``fwdbwd`` flow from the one to the
   other; this module follows that flow;
4. else the innermost region open at the launch owns it: on the launching
   thread, or failing that, on any thread;
5. an operation that finds none is ``unattributed``.

A region's self time is the summed duration of the operations it owns,
split into the backward's (launched in a backward node, or on any thread
while the train step's ``train.backward`` is open: FSDP2's post-backward
callback runs outside any node) and the rest, the forward's. An idle gap of
the device is put down, as ``devtrace`` does, to the operation that ends
it, and so to that operation's region.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import pathlib
import sys
from collections import defaultdict

from benchmark import devtrace

PREFIXES = ("llama.", "train.", "FSDP::")
NODE = "autograd::engine::evaluate_function: "
BACKWARD = "train.backward"
UNATTRIBUTED = "unattributed"
TRACES = pathlib.Path(__file__).resolve().parent / "traces"


class Timeline:
    """Intervals ``(tid, start, end, value)``, properly nested on each
    thread, asked for the innermost one open at a time."""

    def __init__(self, intervals):
        by_tid = defaultdict(list)
        for tid, start, end, value in intervals:
            by_tid[tid].append((start, -end, value))
        self.threads = {}
        for tid, items in by_tid.items():
            items.sort(key=lambda i: (i[0], i[1]))
            parents, stack = [], []
            for k, (start, neg_end, _) in enumerate(items):
                while stack and -items[stack[-1]][1] < start:
                    stack.pop()
                parents.append(stack[-1] if stack else -1)
                stack.append(k)
            self.threads[tid] = ([i[0] for i in items], [-i[1] for i in items],
                                 [i[2] for i in items], parents)

    def at(self, tid, ts: float):
        """(start, value) of the innermost interval of ``tid`` open at
        ``ts``, or None."""
        if tid not in self.threads:
            return None
        starts, ends, values, parents = self.threads[tid]
        k = bisect.bisect_right(starts, ts) - 1
        while k >= 0 and ends[k] < ts:
            k = parents[k]
        return None if k < 0 else (starts[k], values[k])

    def anywhere(self, tid, ts: float):
        """:meth:`at` on ``tid``, or else the innermost (latest opened) on
        any other thread."""
        found = self.at(tid, ts)
        if found is not None:
            return found
        others = [f for t in self.threads if t != tid for f in [self.at(t, ts)] if f]
        return max(others, key=lambda f: f[0], default=None)


@dataclasses.dataclass(frozen=True)
class Op:
    name: str
    start_us: float
    dur_us: float
    region: str
    backward: bool  # launched in a backward node or while train.backward is open
    node: str | None  # that node's name (``SelectBackward0``, ...)


@dataclasses.dataclass
class Regions:
    ops: list[Op]
    steps: int
    gaps: list[tuple[str, float]]  # (region, seconds) of every idle gap, longest first

    def _per_step_ms(self, us: float) -> float:
        return us / 1e3 / self.steps

    def self_ms(self, region: str) -> float | None:
        """Device ms per step the region owns, forward plus backward; None
        when it owns no operation."""
        durs = [op.dur_us for op in self.ops if op.region == region]
        return self._per_step_ms(sum(durs)) if durs else None

    def table(self) -> list[dict]:
        """One row per region, longest first: ms a step forward and
        backward, launches a step, idle ms a step before its operations."""
        rows = defaultdict(lambda: {"forward_ms": 0.0, "backward_ms": 0.0, "launches": 0,
                                    "idle_ms": 0.0})
        for op in self.ops:
            row = rows[op.region]
            row["backward_ms" if op.backward else "forward_ms"] += self._per_step_ms(op.dur_us)
            row["launches"] += 1
        for region, seconds in self.gaps:
            rows[region]["idle_ms"] += seconds * 1e3 / self.steps
        out = [{"region": name, "ms": r["forward_ms"] + r["backward_ms"], **r,
                "launches": r["launches"] / self.steps} for name, r in rows.items()]
        return sorted(out, key=lambda r: -r["ms"])

    def total_ms(self) -> float:
        return self._per_step_ms(sum(op.dur_us for op in self.ops))

    def text(self) -> str:
        """The table, a region a line, and the unattributed share and the
        longest idle gaps."""
        total = self.total_ms()
        lines = [f"regions: device ms a step by program region ({self.steps} steps, "
                 f"{total:.3f} ms a step of device operations)",
                 f"  {'region':<44} {'ms':>9} {'forward':>9} {'backward':>9} {'launches':>9} "
                 f"{'idle ms':>8}"]
        for r in self.table():
            lines.append(f"  {r['region'][:44]:<44} {r['ms']:9.3f} {r['forward_ms']:9.3f} "
                         f"{r['backward_ms']:9.3f} {r['launches']:9.1f} {r['idle_ms']:8.3f}")
        left = self.self_ms(UNATTRIBUTED) or 0.0
        lines.append(f"  unattributed share {100.0 * left / total if total else 0.0:.3f}%; "
                     "longest idle gaps: "
                     + ", ".join(f"{region} {1e3 * s:.3f} ms" for region, s in self.gaps[:5]))
        return "\n".join(lines)


def _is_region(e: dict) -> bool:
    return e.get("cat") == "user_annotation" and e["name"].startswith(PREFIXES)


def assign(events: list[dict], steps: int, start_us: float) -> Regions:
    """Every device operation of the Chrome trace ``events`` put down to a
    program region, by the rule of the module's docstring."""
    launches, flows = {}, defaultdict(dict)
    regions, nodes = [], []
    for e in events:
        ph, cat, args = e.get("ph"), e.get("cat", ""), e.get("args") or {}
        if cat == "fwdbwd" and ph in ("s", "f"):
            flows[e["id"]][ph] = (e["tid"], float(e["ts"]))
        if ph != "X":
            continue
        start, end = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))
        if cat in ("cuda_runtime", "cuda_driver") and "correlation" in args:
            launches[args["correlation"]] = (e["tid"], start)
        elif _is_region(e):
            regions.append((e["tid"], start, end, e["name"]))
        elif e["name"].startswith(NODE):
            nodes.append((e["tid"], start, end, e["name"][len(NODE):]))
    region_at, node_at = Timeline(regions), Timeline(nodes)
    backward_at = Timeline([r for r in regions if r[3] == BACKWARD])
    # A node's flow ends on the node's own operator, inside the node.
    forward_of = {}
    for link in flows.values():
        if "s" in link and "f" in link:
            node = node_at.at(*link["f"])
            if node is not None:
                forward_of[(link["f"][0], node[0])] = link["s"]

    def owner(launch) -> tuple[str, bool, str | None]:
        if launch is None:
            return UNATTRIBUTED, False, None
        tid, ts = launch
        own = region_at.anywhere(tid, ts)
        node = node_at.at(tid, ts)
        if node is None:
            in_backward = backward_at.anywhere(tid, ts) is not None
            return (own[1] if own else UNATTRIBUTED), in_backward, None
        inner = region_at.at(tid, ts)
        if inner is not None and inner[0] >= node[0]:
            return inner[1], True, node[1]
        forward = forward_of.get((tid, node[0]))
        found = region_at.anywhere(*forward) if forward is not None else None
        found = found or own
        return (found[1] if found else UNATTRIBUTED), True, node[1]

    ops = []
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in devtrace.DEVICE_CATEGORIES:
            region, backward, node = owner(launches.get((e.get("args") or {}).get("correlation")))
            ops.append(Op(e["name"], float(e["ts"]), float(e["dur"]), region, backward, node))
    gaps = devtrace.Trace([devtrace.DeviceOp(op.name, op.start_us, op.dur_us, op.region)
                           for op in ops], 0.0, start_us).idle_gaps()
    return Regions(ops, steps, gaps)


def confirm(events: list[dict], trace, path) -> None:
    """Raise unless the device operations of ``events`` are those of the
    run's :class:`devtrace.Trace` ``trace``: their count, first and last
    start."""
    starts = sorted(float(e["ts"]) for e in events
                    if e.get("ph") == "X" and e.get("cat") in devtrace.DEVICE_CATEGORIES)
    want = sorted(op.start_us for op in trace.ops)
    got_key = (len(starts), starts[:1], starts[-1:])
    want_key = (len(want), want[:1], want[-1:])
    if got_key != want_key:
        raise RuntimeError(f"{path} is not this run's trace: (count, first, last start) "
                           f"{got_key} against the run's {want_key}")


_parsed: tuple[object, Regions] | None = None  # the run's devtrace.Trace and its regions


def of(reading, path: pathlib.Path | None = None) -> Regions:
    """The regions of the run's traced stretch, from ``path`` (by default
    the newest trace under ``traces/``, which the harness has just
    written). Parsed once a run and printed on standard error then."""
    global _parsed
    if _parsed is not None and _parsed[0] is reading.trace:
        return _parsed[1]
    if path is None:
        written = sorted(TRACES.glob("*.json"), key=lambda p: p.stat().st_mtime)
        if not written:
            raise RuntimeError(f"no trace under {TRACES}")
        path = written[-1]
    events = json.loads(pathlib.Path(path).read_text())["traceEvents"]
    confirm(events, reading.trace, path)
    found = assign(events, reading.facts["steps"], reading.trace.start_us)
    print(found.text(), file=sys.stderr, flush=True)
    _parsed = (reading.trace, found)
    return found


def region_ms(reading, region: str) -> float | None:
    """Device ms per traced step or pass that ``region`` owns, forward plus
    backward; None when it owns none (a program without the region)."""
    return of(reading).self_ms(region)
