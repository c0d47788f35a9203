"""Open-loop rate sweep: find the knee, prove shedding holds goodput.

A closed-loop driver can never see queueing collapse (it backs off when
the pool slows — coordinated omission by construction). This module
drives the serving stack the way millions of users do: a seeded Poisson
arrival process at a FIXED offered rate, per-request deadlines,
admission control shedding at intake — and measures, per rate:

- **offered vs goodput**: goodput = completed WITHIN deadline. Below
  the knee goodput tracks offered load; past it, shedding holds goodput
  near the knee instead of letting queueing collapse take it to zero.
- **shed rate** and **deadline misses** (the deliberate refusal vs the
  broken promise — conserved against issued, never "lost").
- **queue-delay percentiles**: time from scheduled arrival to first
  executor dispatch — the number that explodes past the knee.

:func:`run_rate_point` is deliberately lightweight (a bare FakeKube,
NodeServers and an open-loop TrafficDriver — no agents, no rollout) so
a sweep of N rates costs N × traffic_s. The full rolling-flip-at-the-
knee measurement composes it with :class:`ServeHarness`
(hack/serve_bench.py --sweep → SERVE_r02.json).

:func:`find_knee` is a pure function of the sweep rows, property-tested
in tests/test_serve.py: the knee is the LAST rate where goodput tracks
offered load and queue-delay p99 stays bounded.
"""

from __future__ import annotations

import logging

from tpu_cc_manager_torch.kubeclient.fake import FakeKube
from tpu_cc_manager_torch.serve.driver import PoissonSchedule, TrafficDriver
from tpu_cc_manager_torch.serve.server import NodeServer, SimulatedExecutor
from tpu_cc_manager_torch.utils import retry as retry_mod

log = logging.getLogger(__name__)

#: Default knee criteria: goodput must stay within this fraction of the
#: offered load ("tracks"), and queue-delay p99 must stay under the
#: request deadline ("bounded" — a p99 past the deadline means the
#: typical tail request was already dead on dispatch). 0.95 sits above
#: Poisson measurement noise at sweep sample sizes but below the first
#: real divergence: a rate completing only 90% of its offered load is
#: already past the knee, not at it.
DEFAULT_TRACK_FRAC = 0.95

#: SERVE_r02's headline bar: past the knee, shedding must hold goodput
#: within this fraction OF THE KNEE'S goodput (collapse would take it
#: toward zero).
DEFAULT_HOLD_FRAC = 0.80


def run_rate_point(
    rate_rps: float,
    n_nodes: int = 3,
    traffic_s: float = 2.5,
    deadline_s: float = 0.5,
    request_tokens: int = 8,
    batch: int = 8,
    seed: int = 0,
    executor_factory=None,
    drain_grace_s: float = 10.0,
) -> dict:
    """One open-loop measurement at a fixed offered rate: a bare pool
    (no agents, no flip), seeded Poisson arrivals, admission control on.
    The batch ladder is pinned (min=max=``batch``) so every rate is
    measured against the same per-node capacity — a sweep compares
    rates, not ladder trajectories. Returns one JSON-able row."""
    factory = executor_factory if executor_factory is not None else SimulatedExecutor
    kube = FakeKube()
    servers: dict[str, NodeServer] = {}
    for i in range(n_nodes):
        name = f"sweep-node-{i}"
        kube.add_node(name)
        servers[name] = NodeServer(
            kube, name,
            on_complete=lambda n, r, u: driver.on_complete(n, r, u),
            on_requeue=lambda n, rs: driver.on_requeue(n, rs),
            on_shed=lambda n, rs: driver.on_shed(n, rs),
            executor=factory(),
            poll_interval_s=5.0,  # no drain in a rate point; quiet poller
        )
    driver = TrafficDriver(
        servers,
        request_tokens=request_tokens,
        initial_batch=batch, min_batch=batch, max_batch=batch,
        schedule=PoissonSchedule(rate_rps, seed=seed),
        deadline_s=deadline_s,
        submit_interval_s=0.002,
    )
    for server in servers.values():
        server.start()
    driver.start()
    try:
        retry_mod.wait(traffic_s, None)
    finally:
        driver.stop()
    driver.drain_outstanding(grace_s=drain_grace_s)
    report = driver.report()
    for server in servers.values():
        server.stop()
    qd = report["queue_delay"]
    return {
        "rate_rps": rate_rps,
        "traffic_s": traffic_s,
        "deadline_ms": round(1e3 * deadline_s, 1),
        "nodes": n_nodes,
        "batch": batch,
        "seed": seed,
        "offered_rps": report["offered_rps"],
        "goodput_rps": report["goodput_rps"],
        "issued": report["requests_issued"],
        "completed": report["requests_completed"],
        "completed_within_deadline": report["completed_within_deadline"],
        "shed": report["requests_shed"],
        "shed_rate": report["shed_rate"],
        "deadline_misses": report["deadline_misses"],
        "lost": report["requests_lost"],
        "conserved": report["conserved"],
        "queue_delay_p50_ms": qd["p50_ms"],
        "queue_delay_p99_ms": qd["p99_ms"],
        "latency_p99_ms": report["latency"]["p99_ms"],
        # A rate point is healthy when nothing leaked: every issued
        # request either completed or was explicitly shed.
        "ok": bool(report["conserved"] and report["requests_lost"] == 0),
    }


def find_knee(
    rows: list[dict],
    track_frac: float = DEFAULT_TRACK_FRAC,
    queue_p99_bound_ms: float | None = None,
) -> dict | None:
    """The knee of a sweep: the LAST (highest-rate) row where goodput
    still tracks the offered load (``goodput >= track_frac * offered``)
    and queue-delay p99 stays bounded (default bound: the row's own
    deadline — a tail request queued past its deadline was dead on
    dispatch). Pure function of the rows; None when no row qualifies
    (every measured rate was already past the knee)."""
    knee = None
    for row in sorted(rows, key=lambda r: r["rate_rps"]):
        offered = row.get("offered_rps") or 0.0
        goodput = row.get("goodput_rps") or 0.0
        if offered <= 0:
            continue
        bound = queue_p99_bound_ms
        if bound is None:
            bound = row.get("deadline_ms")
        p99 = row.get("queue_delay_p99_ms")
        bounded = bound is None or p99 is None or p99 <= bound
        if goodput >= track_frac * offered and bounded:
            knee = row
    return knee


def knee_slack_nodes(
    knee_rps: float, offered_rps: float, n_nodes: int
) -> int:
    """How many whole nodes of capacity the offered load leaves free
    under the knee. The knee is the fleet's proven serving capacity, so
    one node is worth ``knee_rps / n_nodes`` of it; the slack is the
    unused capacity expressed in those units, floored (a fractional
    node cannot absorb a whole node's traffic during its prestage).
    Pure and fail-closed: nonsensical inputs (no nodes, no knee,
    offered at/above knee) yield 0."""
    if n_nodes <= 0 or knee_rps <= 0:
        return 0
    per_node = knee_rps / n_nodes
    slack = (knee_rps - max(0.0, offered_rps)) / per_node
    return max(0, int(slack))


def prestage_allowance(
    knee_rps: float,
    offered_rps: float,
    n_nodes: int,
    reserve_nodes: int = 1,
) -> int:
    """The capacity ledger's concurrency budget: how many nodes may be
    in prestage transition at once. The ledger's rule is "prestage only
    while offered load leaves >= 1 node of slack" — so the allowance is
    the knee slack MINUS a reserved node kept free for the wave itself
    (the draining window's traffic has to land somewhere). At 80 % of
    knee on 10 nodes: slack 2, allowance 1."""
    slack = knee_slack_nodes(knee_rps, offered_rps, n_nodes)
    return max(0, slack - max(0, int(reserve_nodes)))


def goodput_holds_past_knee(
    rows: list[dict], knee: dict, hold_frac: float = DEFAULT_HOLD_FRAC
) -> bool:
    """SERVE_r02's overload claim: at every measured rate PAST the knee,
    shedding held goodput within ``1 - hold_frac`` of the knee's goodput
    instead of collapsing. Vacuously true when the sweep never went past
    the knee (the caller should sweep further)."""
    knee_goodput = knee.get("goodput_rps") or 0.0
    if knee_goodput <= 0:
        return False
    past = [r for r in rows if r["rate_rps"] > knee["rate_rps"]]
    return all(
        (r.get("goodput_rps") or 0.0) >= hold_frac * knee_goodput
        for r in past
    )
