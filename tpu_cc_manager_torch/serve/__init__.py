"""Continuous synthetic serving: measure what a *user* sees while a pool
flips CC mode under load (ROADMAP item 3).

Every bench before this package measured node-seconds; nothing measured
user-visible disruption. The pieces here close that gap:

- :class:`~tpu_cc_manager_torch.serve.server.NodeServer` — a per-node batched
  inference server that subscribes to the drain handshake
  (``drain/handshake.py``): when its node's manager requests a drain the
  server checkpoints in-flight requests (sized to the
  ``drain.deadline-s`` hint when one is published) and hands them back
  to the driver instead of dying with them.
- :class:`~tpu_cc_manager_torch.serve.driver.TrafficDriver` — sustains batched
  requests across the pool, routes around draining nodes, and adapts
  its per-node batch ladder from the reported ``hbm_bw_util`` headroom
  (a conservative, lower-bound read — see ``smoke/llama_infer.py``).
- :class:`~tpu_cc_manager_torch.serve.harness.ServeHarness` — wires a fake
  pool of REAL node agents (CCManager watch loops), the servers and the
  driver together, runs a real rolling CC flip mid-traffic, and reports
  p50/p99 latency + error rate during the rollout vs steady state, plus
  requests lost per node bounced (target: zero).

The driver has two traffic modes: the closed-loop ladder above
(SERVE_r01) and an **open-loop** rate-driven mode
(:class:`~tpu_cc_manager_torch.serve.driver.PoissonSchedule` /
:class:`~tpu_cc_manager_torch.serve.driver.RampSchedule`, SERVE_r02) that
submits on schedule regardless of pipe depth, attaches per-request
deadlines, and lets the server's admission control shed at intake —
the overload-honest half: goodput = completed-within-deadline, and
``serve/sweep.py`` finds the knee of a rate sweep.

The layer is live-observable, not just report-observable: servers and
driver export the ``tpu_cc_serve_*`` metric families through one shared
``utils/metrics.py`` registry (latency histogram, queue depth,
in-flight, outcome/shed/loss counters, offered rate, goodput) and feed
an ``obs/slo.py`` :class:`~tpu_cc_manager_torch.obs.slo.SloEvaluator` whose
windowed p99 / error-budget burn readout is both exported as gauges and
pollable in-process — the contract the latency-gated rollout
(``ccmanager/rolling.py`` ``slo_gate``) polls at wave boundaries.
"""

from tpu_cc_manager_torch.serve.driver import (
    PoissonSchedule,
    RampSchedule,
    TrafficDriver,
)
from tpu_cc_manager_torch.serve.harness import ServeHarness
from tpu_cc_manager_torch.serve.server import NodeServer, Request, SimulatedExecutor

__all__ = [
    "NodeServer",
    "PoissonSchedule",
    "RampSchedule",
    "Request",
    "ServeHarness",
    "SimulatedExecutor",
    "TrafficDriver",
]
