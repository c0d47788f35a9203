"""Serving bench: one JSON line, ok-gated (SERVE_r01 / SERVE_r02).

A copy of the repository's ``hack/serve_bench.py`` over the port's
``serve/``, ``faults/``, ``ccmanager/`` and ``obs/``; each line of code
that differs is a seam and says so in a comment. One seam changes
behaviour: ``--calibrate-smoke`` runs the port's Llama smoke on the card
(``smoke/runner.py::run_workload_subprocess``), and a calibration smoke
that fails (no passing result, or no ``ms_per_token``) makes the bench
fail, one line with ``"ok": false`` and exit code 1, where the reference
goes on with an uncalibrated executor. There is no CPU fallback. The
other seam is the repository root, three directories above this file.

Converts the "millions of users" north star into measurable artifacts:

**Default (SERVE_r01)**: a closed-loop TrafficDriver sustains batched
synthetic inference across a pool of REAL node agents while a REAL
rolling CC flip runs mid-traffic (tpu_cc_manager_torch/serve/). The line
reports p50/p99 latency and error rate DURING the rollout vs steady
state, and the headline claim: ``requests_lost_per_node_bounced`` == 0.

**--prestage (BENCH_r09)**: the whole-fleet zero-bounce artifact.
Finds the knee with the SERVE_r02 sweep machinery, then runs a 10-node
rolling flip under open-loop traffic at ``--knee-frac`` (80 %) of it
with CONTINUOUS prestage on: the orchestrator's capacity ledger
CAS-reserves knee-slack headroom (``headroom_gate_from_source`` reading
the harness's live ``tpu_cc_serve_offered_rps``) and prestages wave
N+1 while wave N flips. Gates: every node's effective flip wall (its
window-close seconds) ≤ that node's drain+readmit bar, zero
prestage-attributable SLO pauses, zero lost requests — plus a control
leg (same pool, no prestage) whose walls must exceed the bar, and a
crash leg where a seeded SIGKILL lands mid-prestage of wave N+1
(FaultPlan ``seed_prestage_kill``) and the successor resumes BOTH
waves with the ledger balancing to zero and no node double-charged.

**--brownout (GRAY_r01)**: the fail-slow containment artifact. One
seeded node (FaultPlan ``seed_brownout``) degrades to a fraction of its
token rate MID-FLIP while its watchdog stays green — the gray failure.
Two traffic legs at ``--knee-frac`` of the knee: detector-on (the
peer-relative vetter de-weights the suspect within one vetting window
and the remediation ladder escalates runtime-restart -> quarantine
``reason=fail-slow``) and a detector-off control. Gates: detector-on
during-brownout p99 within ``--gray-ratio-bar`` (1.3x) of healthy
steady while the control exceeds 2x, zero lost requests, quarantine
within <=2 vetting windows of onset, probation lift restores the node
after recovery — plus a crash leg where a seeded SIGKILL lands at the
``failslow-vetted`` crash point mid-vetting and the successor resumes
the journaled verdict to the SAME single quarantine, ledger balanced.

**--sweep (SERVE_r02)**: the open-loop overload artifact. A resumable
rate sweep (seeded Poisson arrivals, per-request deadlines, admission
control) finds the KNEE — the last rate where goodput tracks offered
load and queue-delay p99 stays bounded — and proves shedding holds
goodput near the knee past it instead of collapsing. Then a full
rolling CC flip runs AT the knee under open-loop traffic, with the
orchestrator's wave-boundary SLO gate armed from the harness's live
evaluator: ``ok`` requires the knee found, goodput held past it, the
flip converged, and ZERO accepted requests lost (sheds are counted,
never lost).

Usage:
  python -m tpu_cc_manager_torch.bench.serve_bench [--nodes 3] [--traffic-s 8] [--out FILE]
      [--calibrate-smoke]  # calibrate the executor model from a real
                           # llama smoke run (ms_per_token, hbm_bw_util)
      [--sweep 150,300,600,1200,2400] [--rate-s 2.5] [--deadline-ms 500]
      [--partial artifacts/serve_sweep_partial.jsonl]  # resumable rows

``ok`` gates the evidence ladder's skip-when-ok:true stage
(hack/evidence_r5.sh) for both artifact shapes.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile


def _load_partial(path: str | None, config: dict) -> dict[float, dict]:
    """Completed sweep rows from a previous interrupted run, keyed by
    rate. Only ok:true rows measured under the SAME configuration
    (deadline/nodes/seed/point duration — every field in ``config``) are
    reused: mixing rows from different deadlines or pool sizes would
    report a knee that corresponds to no single configuration. Failed or
    mismatched rows are re-bought on resume (same discipline as
    scale_bench --partial)."""
    rows: dict[float, dict] = {}
    if not path or not os.path.exists(path):
        return rows
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                row = json.loads(line)
            except ValueError:
                continue
            if (
                row.get("ok") is True
                and "rate_rps" in row
                and all(row.get(k) == v for k, v in config.items())
            ):
                rows[float(row["rate_rps"])] = row
    return rows


def _fleet_rollup(metrics) -> dict:
    """One in-process fleet-gateway sweep over the harness's registry
    (obs/fleet.py): SERVE artifacts carry the same federated view —
    merged families, capacity-ledger headroom, pooled p99 — an operator
    would read off the real gateway's /metrics during the flip."""
    from tpu_cc_manager_torch.lint import expo as expo_lint
    from tpu_cc_manager_torch.obs import fleet as fleet_mod

    gateway = fleet_mod.FleetGateway(
        targets={"serve-harness": fleet_mod.local_target(metrics)},
    )
    fleetz = gateway.scrape_once()
    merged = gateway.metrics_text()
    p99 = None
    for line in merged.splitlines():
        if line.startswith("tpu_cc_fleet_serve_p99_seconds "):
            p99 = float(line.split()[1])
    return {
        "merged_lines": len(merged.splitlines()),
        "merged_lint_ok": not expo_lint.lint(merged),
        "headroom_nodes": fleetz["fleet"]["headroom_nodes"],
        "max_slo_burn": fleetz["fleet"]["max_slo_burn"],
        "fleet_serve_p99_s": p99,
    }


def _flip_at_knee(args, executor_factory, knee, deadline_s, handoff) -> dict:
    """One full rolling flip AT the knee under open-loop traffic — the
    SERVE_r02 flip leg, parameterized by ``handoff`` so SERVE_r03 can
    measure the zero-bounce path against the same baseline."""
    from tpu_cc_manager_torch.serve import ServeHarness
    from tpu_cc_manager_torch.serve.driver import PoissonSchedule

    harness = ServeHarness(
        n_nodes=args.nodes,
        tmp_dir=tempfile.mkdtemp(prefix="tpu-cc-serve-flip-"),
        executor_factory=executor_factory,
        handoff=handoff,
        driver_kwargs={
            "schedule": PoissonSchedule(
                knee["rate_rps"], seed=args.seed + 1
            ),
            "deadline_s": deadline_s,
            "initial_batch": knee["batch"],
            "min_batch": knee["batch"],
            "max_batch": knee["batch"],
        },
        slo_windows_s=(2.0, 30.0),
        slo_error_budget=0.05,
    )
    harness.build()
    try:
        report = harness.run(
            traffic_s=args.traffic_s,
            rollout_mode=args.mode,
            max_unavailable=args.max_unavailable,
            slo_max_burn_rate=2.0,
            slo_window_s=2.0,
            slo_max_pause_s=30.0,
        )
        report["fleet_rollup"] = _fleet_rollup(harness.metrics)
        return report
    finally:
        harness.shutdown()


def _p99_ratio(flip: dict) -> float | None:
    """during-rollout p99 / steady-state p99 — the number a user FEELS
    during a flip (1.0 = the rollout is invisible)."""
    during = (flip.get("latency_during_rollout") or {}).get("p99_ms")
    steady = (flip.get("latency_steady_state") or {}).get("p99_ms")
    if not during or not steady:
        return None
    return round(during / steady, 3)


def run_handoff(args, executor_factory, calibration) -> dict:
    """SERVE_r03: the zero-bounce flip artifact. Re-finds the knee with
    the SAME sweep machinery as SERVE_r02 (resumable partial rows), then
    runs the flip-at-the-knee twice — control (checkpoint-and-requeue,
    today's path) and handoff (parked requests migrate to an accepting
    peer inside the ack window) — and gates on the handoff flip's
    during-rollout/steady p99 ratio."""
    sweep = run_sweep(args, executor_factory, calibration, flip=False)
    knee = sweep.get("knee")
    control = handoff_flip = None
    if knee is not None:
        control = _flip_at_knee(
            args, executor_factory, knee, args.deadline_ms / 1e3,
            handoff=False,
        )
        handoff_flip = _flip_at_knee(
            args, executor_factory, knee, args.deadline_ms / 1e3,
            handoff=True,
        )
    ratio = _p99_ratio(handoff_flip) if handoff_flip else None
    control_ratio = _p99_ratio(control) if control else None
    accepted = (
        (handoff_flip.get("handoffs") or {}).get("accepted", 0)
        if handoff_flip else 0
    )
    return {
        "metric": "zero_bounce_flip_p99_ratio",
        "nodes": args.nodes,
        "deadline_ms": args.deadline_ms,
        "seed": args.seed,
        "knee": knee,
        "ratio_bar": args.ratio_bar,
        # Control: the SERVE_r02-shaped flip (local checkpoint+requeue).
        "control_flip": control,
        "control_p99_ratio": control_ratio,
        # The zero-bounce flip: in-flight handoff to accepting peers.
        "handoff_flip": handoff_flip,
        "handoff_p99_ratio": ratio,
        "handoffs": (handoff_flip or {}).get("handoffs"),
        "calibration": calibration,
        "ok": bool(
            knee is not None
            and sweep["ok"]
            and handoff_flip is not None
            and handoff_flip["rollout_ok"]
            and handoff_flip["requests_lost"] == 0
            and handoff_flip["conserved"]
            and handoff_flip["nodes_bounced"] == args.nodes
            and accepted > 0
            and ratio is not None
            and ratio <= args.ratio_bar
        ),
    }


def _flight_node_walls(flight_path: str) -> dict[str, float]:
    """Per-node EFFECTIVE flip wall from the rollout flight timeline:
    each node is assigned the wave-0 window its desired-patch landed in,
    and charged that window's close seconds. With continuous prestage a
    held node's window closes as fast as the convergence poll — the
    reset/boot cost was paid off-wave — which is exactly the number the
    BENCH_r09 bar compares against drain+readmit."""
    window_s: dict[int, float] = {}
    node_window: dict[str, int] = {}
    if not os.path.exists(flight_path):
        return {}
    with open(flight_path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                e = json.loads(line)
            except ValueError:
                continue
            if e.get("wave") != 0:
                continue
            if e.get("event") == "node-desired-patch":
                node_window[e["node"]] = e.get("window")
            elif e.get("event") == "window-close":
                window_s[e.get("window")] = float(e.get("seconds") or 0.0)
    return {
        node: window_s[w]
        for node, w in node_window.items() if w in window_s
    }


def _drain_readmit_bar(metrics_text: str) -> float | None:
    """One node's drain+readmit bar from its agent registry: the mean
    drain phase latency plus the mean readmit phase latency (parsed
    from the ``tpu_cc_phase_seconds`` histogram's _sum/_count series).
    None until the agent has run both phases."""
    import re

    bar = 0.0
    for phase in ("drain", "readmit"):
        total = count = 0.0
        for kind in ("sum", "count"):
            pat = (
                r"tpu_cc_phase_seconds_%s\{(?=[^}]*phase=\"%s\")[^}]*\}"
                r"\s+([0-9.eE+-]+)" % (kind, phase)
            )
            acc = sum(float(m) for m in re.findall(pat, metrics_text))
            if kind == "sum":
                total = acc
            else:
                count = acc
        if count <= 0:
            return None
        bar += total / count
    return bar


def _prestage_flip(
    args, executor_factory, knee, deadline_s, prestage: bool
) -> dict:
    """One BENCH_r09 traffic leg: args.nodes real agents with nonzero
    reset/boot latencies (so a full flip visibly costs more than
    drain+readmit), open-loop Poisson at ``--knee-frac`` of the knee,
    rolling flip mid-traffic — with continuous prestage on (the
    measured leg) or off (the control leg that proves the bar bites)."""
    from tpu_cc_manager_torch.ccmanager import rolling as rolling_mod
    from tpu_cc_manager_torch.serve import ServeHarness
    from tpu_cc_manager_torch.serve.driver import PoissonSchedule

    rate = knee["rate_rps"] * args.knee_frac
    tmp = tempfile.mkdtemp(prefix="tpu-cc-serve-prestage-")
    harness = ServeHarness(
        n_nodes=args.nodes,
        tmp_dir=tmp,
        executor_factory=executor_factory,
        reset_latency_s=args.reset_s,
        boot_latency_s=args.boot_s,
        driver_kwargs={
            "schedule": PoissonSchedule(rate, seed=args.seed + 2),
            "deadline_s": deadline_s,
            "initial_batch": knee["batch"],
            "min_batch": knee["batch"],
            "max_batch": knee["batch"],
        },
        slo_windows_s=(2.0, 30.0),
        slo_error_budget=0.05,
    )
    harness.build()
    try:
        roller_kwargs = None
        if prestage:
            # The REAL remote-gate path, fed in-process: the gate
            # scrapes tpu_cc_serve_offered_rps off the harness registry
            # and converts the slack under the knee into whole nodes.
            gate = rolling_mod.headroom_gate_from_source(
                "inproc://serve-harness", knee["rate_rps"], args.nodes,
                fetch=lambda _url: harness.metrics.render_prometheus(),
            )
            roller_kwargs = {
                "continuous_prestage": True,
                "headroom_gate": gate,
                "prestage_timeout_s": 30.0,
            }
        report = harness.run(
            traffic_s=args.traffic_s,
            rollout_mode=args.mode,
            max_unavailable=args.max_unavailable,
            slo_max_burn_rate=2.0,
            slo_window_s=2.0,
            slo_max_pause_s=30.0,
            roller_kwargs=roller_kwargs,
        )
        walls = _flight_node_walls(os.path.join(tmp, "flight.jsonl"))
        bars = {
            mgr.node_name: _drain_readmit_bar(
                mgr.metrics.render_prometheus()
            )
            for mgr in harness.agents
        }
        report["offered_rps"] = round(rate, 1)
        report["node_walls_s"] = {n: round(w, 3) for n, w in walls.items()}
        report["node_bars_s"] = {
            n: (round(b, 3) if b is not None else None)
            for n, b in bars.items()
        }
        report["prestage_totals"] = harness.metrics.prestage_totals()
        report["fleet_rollup"] = _fleet_rollup(harness.metrics)
        return report
    finally:
        harness.shutdown()


def _prestage_crash_leg(args, executor_factory) -> dict:
    """The BENCH_r09 crash leg: a seeded orchestrator SIGKILL lands at
    a prestage crash point — mid-prestage of wave N+1 while wave N
    drains — under a REAL short-TTL lease, and however many successors
    it takes resume BOTH waves from the checkpointed record. No
    traffic (the ledger/resume claims are record semantics, measured
    here without paying another open-loop leg); reserve/arm points
    only, since prestage-invalidate never fires in clean weather."""
    import time as time_mod

    from tpu_cc_manager_torch.ccmanager import rollout_state
    from tpu_cc_manager_torch.ccmanager.rolling import RollingReconfigurator
    from tpu_cc_manager_torch.faults.plan import FaultPlan, OrchestratorKilled
    from tpu_cc_manager_torch.serve import ServeHarness
    from tpu_cc_manager_torch.serve.harness import NS, POOL_SELECTOR
    from tpu_cc_manager_torch.utils.metrics import MetricsRegistry

    harness = ServeHarness(
        n_nodes=args.crash_nodes,
        tmp_dir=tempfile.mkdtemp(prefix="tpu-cc-serve-crash-"),
        executor_factory=executor_factory,
        reset_latency_s=0.05,
        boot_latency_s=0.05,
    )
    harness.build()
    plan = FaultPlan(seed=args.seed, rate=0.0, kill_rate=0.0)
    target = plan.seed_prestage_kill(
        points=("prestage-reserved", "prestage-armed"),
    )
    metrics = MetricsRegistry()
    result = None
    ledger = None
    try:
        for attempt in range(8):
            lease = rollout_state.RolloutLease(
                harness.kube, holder=f"bench-orch-{attempt}", namespace=NS,
                duration_s=2.0, metrics=metrics,
            )
            record = lease.acquire()
            roller = RollingReconfigurator(
                harness.kube, POOL_SELECTOR,
                max_unavailable=2,
                node_timeout_s=30.0,
                poll_interval_s=0.02,
                lease=lease,
                resume_record=(
                    record
                    if record is not None
                    and record.status == rollout_state.RECORD_IN_PROGRESS
                    else None
                ),
                crash_hook=plan.decide_orchestrator_kill,
                metrics=metrics,
                continuous_prestage=True,
                prestage_timeout_s=10.0,
                headroom_gate=lambda: args.crash_nodes,
            )
            try:
                result = roller.rollout(args.mode)
                ledger = roller._ledger
                lease.release(clear_record=result.ok)
                break
            except OrchestratorKilled:
                # SIGKILL semantics: no cleanup, lease NOT released —
                # the successor waits out the real-clock TTL.
                time_mod.sleep(2.2)
    finally:
        harness.shutdown()
    kills = [f for f in plan.injected if f.kind == "orch-kill"]
    return {
        "nodes": args.crash_nodes,
        "kill_point_armed": target,
        "kills": len(kills),
        "kill_landed_at": kills[0].op if kills else None,
        "resumes": metrics.rollout_totals()["resumes"],
        "rollout_ok": bool(result is not None and result.ok),
        "ledger_charges": ledger.charges_total() if ledger else None,
        "ledger_releases": ledger.releases_total() if ledger else None,
        "ledger_balanced": bool(ledger is not None and ledger.balanced()),
        "ledger_open_entries": len(ledger.entries) if ledger else None,
        "double_charged": ledger.double_charged() if ledger else None,
        "ok": bool(
            result is not None and result.ok
            and kills
            and kills[0].op == target
            and metrics.rollout_totals()["resumes"] == len(kills)
            and ledger is not None
            and ledger.balanced()
            and not ledger.entries
            and ledger.double_charged() == []
        ),
    }


def run_prestage(args, executor_factory, calibration) -> dict:
    """BENCH_r09: whole-fleet zero-bounce under the capacity ledger.
    Knee sweep → prestage leg at 80 % of knee (every node's effective
    flip wall ≤ its drain+readmit bar, zero prestage SLO pauses, zero
    lost requests) → control leg (no prestage: walls MUST exceed the
    bar, proving the bar bites) → seeded mid-prestage crash leg."""
    sweep = run_sweep(args, executor_factory, calibration, flip=False)
    knee = sweep.get("knee")
    deadline_s = args.deadline_ms / 1e3
    flip = control = None
    walls_ok = False
    control_exceeds = None
    if knee is not None:
        flip = _prestage_flip(
            args, executor_factory, knee, deadline_s, prestage=True,
        )
        control = _prestage_flip(
            args, executor_factory, knee, deadline_s, prestage=False,
        )
        # Every node's effective wall ≤ its own drain+readmit bar
        # (+0.25 s of convergence-poll/scheduler noise).
        walls_ok = bool(flip["node_walls_s"]) and all(
            flip["node_bars_s"].get(n) is not None
            and w <= flip["node_bars_s"][n] + 0.25
            for n, w in flip["node_walls_s"].items()
        )
        # The control leg pays reset+boot inside the window: its walls
        # exceeding the SAME bar is what makes walls_ok non-trivial.
        control_exceeds = sum(
            1 for n, w in control["node_walls_s"].items()
            if control["node_bars_s"].get(n) is not None
            and w > control["node_bars_s"][n] + 0.25
        )
    crash = _prestage_crash_leg(args, executor_factory)
    pt = (flip or {}).get("prestage_totals") or {}
    return {
        "metric": "zero_bounce_fleet_prestage",
        "nodes": args.nodes,
        "knee_frac": args.knee_frac,
        "deadline_ms": args.deadline_ms,
        "seed": args.seed,
        "knee": knee,
        "prestage_flip": flip,
        "control_flip": control,
        "walls_ok": walls_ok,
        "control_walls_exceeding_bar": control_exceeds,
        "crash_leg": crash,
        "calibration": calibration,
        "ok": bool(
            knee is not None
            and sweep["ok"]
            and flip is not None
            and flip["rollout_ok"]
            and flip["requests_lost"] == 0
            and flip["conserved"]
            and flip["nodes_bounced"] == args.nodes
            # Every node rode the prestage path (held == pool size) and
            # SLO burn never paused a top-up at 80 % of knee.
            and pt.get("held", 0) == args.nodes
            and pt.get("paused", 0) == 0
            and flip["rollout_slo_pauses"] == 0
            and walls_ok
            and control is not None
            and (control_exceeds or 0) > 0
            and crash["ok"]
        ),
    }


def _brownout_flip(
    args, executor_factory, knee, detector: bool
) -> dict:
    """One GRAY_r01 traffic leg: open-loop Poisson at ``--knee-frac``
    of the knee, a rolling flip mid-traffic, and ONE seeded node
    browning out (token rate cut by the plan's factor) right as the
    flip begins — with the peer-relative fail-slow vetter armed
    (``detector=True``) or off (the control leg that proves the bar
    bites). The request deadline is stretched by the brownout factor
    on BOTH legs: a tight deadline would shed the gray node's requests
    at admission, turning fail-slow into fail-stop — the easy case
    this artifact exists to NOT measure."""
    import threading
    import time as time_mod

    from tpu_cc_manager_torch.ccmanager import remediation as remediation_mod
    from tpu_cc_manager_torch.faults.plan import FaultPlan
    from tpu_cc_manager_torch.kubeclient.api import node_labels
    from tpu_cc_manager_torch.serve import ServeHarness
    from tpu_cc_manager_torch.serve.driver import PoissonSchedule
    from tpu_cc_manager_torch.utils import retry as retry_mod

    plan = FaultPlan(seed=args.seed, rate=0.0)
    victim = f"serve-node-{plan.seed_brownout(args.nodes)}"
    factor = plan.brownout_token_rate_factor
    window_s = args.vet_window_s
    rate = knee["rate_rps"] * args.knee_frac
    warmup_frac = 0.25
    harness = ServeHarness(
        n_nodes=args.nodes,
        tmp_dir=tempfile.mkdtemp(prefix="tpu-cc-serve-gray-"),
        executor_factory=executor_factory,
        failslow=detector,
        failslow_kwargs={
            "window_s": window_s,
            "threshold": 2.0,
            # min_windows=1 + re-concluding verdicts: verdict #1 lands
            # at the first window close after onset (runtime restart),
            # verdict #2 one window later (quarantine) — the <=2-window
            # containment bound by construction.
            "min_windows": 1,
            "min_peers": 3,
            "min_samples": 3,
            "clear_windows": 2,
        },
        failslow_probation_s=2 * window_s,
        driver_kwargs={
            "schedule": PoissonSchedule(rate, seed=args.seed + 3),
            "deadline_s": (args.deadline_ms / 1e3) * factor,
            "initial_batch": knee["batch"],
            # min_batch=1 is what the suspect trickle de-weights down
            # to (driver._dispatch_round) — pinning it at the knee
            # batch would turn de-weighting off.
            "min_batch": 1,
            "max_batch": knee["batch"],
        },
        slo_windows_s=(2.0, 30.0),
        slo_error_budget=0.05,
    )
    harness.build()
    events: dict[str, float] = {}

    def drive() -> None:
        # Onset rides the same warmup fraction run() sleeps before the
        # flip, so the brownout begins as the rollout does.
        retry_mod.wait(args.traffic_s * warmup_frac, None)
        harness.set_brownout(victim, factor)
        events["onset"] = time_mod.monotonic()
        deadline = events["onset"] + args.brownout_s
        while time_mod.monotonic() < deadline:
            labels = node_labels(harness.kube.get_node(victim))
            if (
                labels.get(remediation_mod.QUARANTINED_LABEL)
                and "quarantined" not in events
            ):
                events["quarantined"] = time_mod.monotonic()
            time_mod.sleep(0.02)
        harness.set_brownout(victim, 1.0)
        plan.clear_brownout()
        events["cleared"] = time_mod.monotonic()

    t = threading.Thread(target=drive, daemon=True, name="gray-drive")
    t.start()
    try:
        report = harness.run(
            traffic_s=args.traffic_s,
            rollout_mode=args.mode,
            warmup_frac=warmup_frac,
            max_unavailable=args.max_unavailable,
            roller_kwargs={
                # Straggler-proof waves: a browned-out node mid-flip is
                # cut at the peer-relative wall, not the absolute node
                # timeout.
                "straggler_factor": 4.0,
                "straggler_floor_s": 2.0,
            },
        )
        t.join(timeout=args.brownout_s + args.traffic_s)
        restored = None
        if detector:
            ladder = harness.ladders[victim]
            # Probation lift: the vet loop keeps running after the
            # traffic stops — recovered peer stats clear the verdict,
            # healthy probes accrue, the quarantine lifts.
            restored = retry_mod.poll_until(
                lambda: (
                    not ladder.quarantined
                    and not node_labels(
                        harness.kube.get_node(victim)
                    ).get(remediation_mod.QUARANTINED_LABEL)
                ),
                20.0, 0.1,
            )
        # Custom buckets off the SAME completion log: "healthy steady"
        # is everything before onset; "during brownout" starts two
        # vetting windows in (the containment bound this artifact
        # separately asserts) and runs to the seeded clear.
        healthy = harness.driver.report(
            rollout_window=(0.0, events["onset"])
        )["latency_during_rollout"]
        brown = harness.driver.report(
            rollout_window=(
                events["onset"] + 2 * window_s, events["cleared"],
            )
        )["latency_during_rollout"]
        detection_windows = (
            round((events["quarantined"] - events["onset"]) / window_s, 2)
            if "quarantined" in events else None
        )
        ratio = (
            round(brown["p99_ms"] / healthy["p99_ms"], 3)
            if brown.get("p99_ms") and healthy.get("p99_ms") else None
        )
        report["victim"] = victim
        report["brownout_factor"] = factor
        report["vet_window_s"] = window_s
        report["healthy_steady"] = healthy
        report["during_brownout"] = brown
        report["brownout_p99_ratio"] = ratio
        report["detection_windows"] = detection_windows
        report["quarantined"] = "quarantined" in events
        report["restored"] = restored
        if detector:
            report["verdicts"] = harness.failslow_vetter.concluded()[:8]
            totals = harness.metrics.failslow_totals()
            report["failslow_verdict_totals"] = {
                f"{node}/{verdict}": count
                for (node, verdict), count in totals["verdicts"].items()
            }
        return report
    finally:
        harness.shutdown()


def _gray_crash_leg(args, executor_factory) -> dict:
    """The GRAY_r01 crash leg: a scripted vetter concludes two
    confirmed fail-slow verdicts for one node, a seeded SIGKILL lands
    at the ``failslow-vetted`` crash point — AFTER the verdicts are
    journaled in the record, BEFORE containment acts — and the
    successor resumes the journal to the SAME single quarantine
    (restart once, quarantine once, no double-escalation), with the
    continuous-prestage capacity ledger balancing to zero around it.
    No traffic: the journal/resume claims are record semantics."""
    import time as time_mod

    from tpu_cc_manager_torch.ccmanager import rollout_state
    from tpu_cc_manager_torch.ccmanager.remediation import (
        STEP_QUARANTINE,
        STEP_RUNTIME_RESTART,
        RemediationLadder,
    )
    from tpu_cc_manager_torch.ccmanager.rolling import RollingReconfigurator
    from tpu_cc_manager_torch.faults.plan import FaultPlan, OrchestratorKilled
    from tpu_cc_manager_torch.serve import ServeHarness
    from tpu_cc_manager_torch.serve.harness import NS, POOL_SELECTOR
    from tpu_cc_manager_torch.utils.metrics import MetricsRegistry

    harness = ServeHarness(
        n_nodes=args.crash_nodes,
        tmp_dir=tempfile.mkdtemp(prefix="tpu-cc-serve-grayk-"),
        executor_factory=executor_factory,
    )
    harness.build()
    plan = FaultPlan(seed=args.seed, rate=0.0, kill_rate=0.0)
    victim = f"serve-node-{plan.seed_brownout(args.crash_nodes)}"
    target = plan.seed_prestage_kill(points=("failslow-vetted",))

    class ScriptedVetter:
        """Concludes two confirmed verdicts for the victim — the
        escalation pair — on a fixed script; non-draining like the
        real one, so every successor re-reads the same list."""

        def concluded(self):
            return [
                {"id": 1, "node": victim, "verdict": "confirmed",
                 "deviation": 4.0},
                {"id": 2, "node": victim, "verdict": "confirmed",
                 "deviation": 4.0},
            ]

        def suspects(self):
            return {victim}

    metrics = MetricsRegistry()
    acts: list[str] = []

    def failslow_act(node: str, entry: dict) -> None:
        # A fresh ladder per act = a fresh successor process: the
        # exactly-once proof must come from the RECORD journal plus the
        # annotation-persisted ladder state, not in-memory dedup.
        ladder = RemediationLadder(harness.kube, node, metrics=metrics)
        acts.append(ladder.note_failslow(entry.get("deviation")))

    result = None
    ledger = None
    try:
        for attempt in range(8):
            lease = rollout_state.RolloutLease(
                harness.kube, holder=f"gray-orch-{attempt}", namespace=NS,
                duration_s=2.0, metrics=metrics,
            )
            record = lease.acquire()
            roller = RollingReconfigurator(
                harness.kube, POOL_SELECTOR,
                max_unavailable=2,
                node_timeout_s=30.0,
                poll_interval_s=0.02,
                lease=lease,
                resume_record=(
                    record
                    if record is not None
                    and record.status == rollout_state.RECORD_IN_PROGRESS
                    else None
                ),
                crash_hook=plan.decide_orchestrator_kill,
                metrics=metrics,
                continuous_prestage=True,
                prestage_timeout_s=10.0,
                headroom_gate=lambda: args.crash_nodes,
                failslow_vetter=ScriptedVetter(),
                failslow_act=failslow_act,
            )
            try:
                result = roller.rollout(args.mode)
                ledger = roller._ledger
                lease.release(clear_record=result.ok)
                break
            except OrchestratorKilled:
                time_mod.sleep(2.2)
    finally:
        harness.shutdown()
    kills = [f for f in plan.injected if f.kind == "orch-kill"]
    final = RemediationLadder(harness.kube, victim, metrics=metrics)
    return {
        "nodes": args.crash_nodes,
        "victim": victim,
        "kill_point_armed": target,
        "kills": len(kills),
        "kill_landed_at": kills[0].op if kills else None,
        "acts": acts,
        "quarantined": final.quarantined,
        "quarantine_reason": final.last_reason,
        "ledger_balanced": bool(ledger is not None and ledger.balanced()),
        "ledger_open_entries": len(ledger.entries) if ledger else None,
        "ok": bool(
            result is not None and result.ok
            and kills
            and kills[0].op == target
            # Exactly-once containment across the SIGKILL: one restart,
            # one quarantine, nothing doubled.
            and acts == [STEP_RUNTIME_RESTART, STEP_QUARANTINE]
            and final.quarantined
            and final.last_reason == "fail-slow"
            and ledger is not None
            and ledger.balanced()
            and not ledger.entries
        ),
    }


def run_brownout(args, executor_factory, calibration) -> dict:
    """GRAY_r01: fail-slow detection & containment. Knee sweep →
    detector-on brownout flip (containment holds the tail) →
    detector-off control (the tail blows out, proving the bar bites) →
    seeded ``failslow-vetted`` SIGKILL crash leg."""
    sweep = run_sweep(args, executor_factory, calibration, flip=False)
    knee = sweep.get("knee")
    detect = control = None
    if knee is not None:
        detect = _brownout_flip(args, executor_factory, knee, detector=True)
        control = _brownout_flip(
            args, executor_factory, knee, detector=False,
        )
    crash = _gray_crash_leg(args, executor_factory)
    d_ratio = (detect or {}).get("brownout_p99_ratio")
    c_ratio = (control or {}).get("brownout_p99_ratio")
    dw = (detect or {}).get("detection_windows")
    return {
        "metric": "failslow_containment_brownout",
        "nodes": args.nodes,
        "knee_frac": args.knee_frac,
        "vet_window_s": args.vet_window_s,
        "brownout_s": args.brownout_s,
        "seed": args.seed,
        "knee": knee,
        "detector_flip": detect,
        "control_flip": control,
        "detector_p99_ratio": d_ratio,
        "control_p99_ratio": c_ratio,
        "gray_ratio_bar": args.gray_ratio_bar,
        "detection_windows": dw,
        "crash_leg": crash,
        "calibration": calibration,
        "ok": bool(
            knee is not None
            and sweep["ok"]
            and detect is not None
            and detect["rollout_ok"]
            and detect["requests_lost"] == 0
            and detect["conserved"]
            and detect["quarantined"]
            and detect["restored"]
            # Containment bound: quarantine within <=2 vetting windows
            # of onset (+ half a window of vet-loop phase alignment).
            and dw is not None
            and dw <= 2.5
            and d_ratio is not None
            and d_ratio <= args.gray_ratio_bar
            # The control leg must HURT, or the detector leg's clean
            # tail proves nothing.
            and control is not None
            and control["requests_lost"] == 0
            and c_ratio is not None
            and c_ratio >= 2.0
            and crash["ok"]
        ),
    }


def run_sweep(args, executor_factory, calibration, flip: bool = True) -> dict:
    from tpu_cc_manager_torch.serve import sweep as sweep_mod

    rates = sorted(float(r) for r in args.sweep.split(",") if r.strip())
    deadline_s = args.deadline_ms / 1e3
    done = _load_partial(args.partial, {
        "deadline_ms": round(1e3 * deadline_s, 1),
        "nodes": args.nodes,
        "seed": args.seed,
        "traffic_s": args.rate_s,
        # A calibrated executor has a different capacity, hence a
        # different knee: rows from the other executor model must not
        # be mixed in on resume.
        "calibrated": calibration is not None,
    })
    rows: list[dict] = []
    for rate in rates:
        if rate in done:
            print(f">>> rate {rate} already captured; skipping",
                  file=sys.stderr)
            rows.append(done[rate])
            continue
        row = sweep_mod.run_rate_point(
            rate,
            n_nodes=args.nodes,
            traffic_s=args.rate_s,
            deadline_s=deadline_s,
            seed=args.seed,
            executor_factory=executor_factory,
        )
        row["calibrated"] = calibration is not None
        rows.append(row)
        if args.partial:
            os.makedirs(os.path.dirname(args.partial) or ".", exist_ok=True)
            with open(args.partial, "a", encoding="utf-8") as f:
                f.write(json.dumps(row) + "\n")
    knee = sweep_mod.find_knee(rows)
    holds = (
        sweep_mod.goodput_holds_past_knee(rows, knee)
        if knee is not None else False
    )
    swept_past = knee is not None and any(
        r["rate_rps"] > knee["rate_rps"] for r in rows
    )

    flip_report = None
    slo_pauses = None
    if knee is not None and flip:
        # The other half of the claim: a rolling CC flip AT the knee,
        # open-loop traffic still arriving on schedule, SLO gate armed
        # (lenient burn threshold: the gate must pace, not veto — the
        # artifact's bar is zero ACCEPTED losses, sheds counted).
        flip_report = _flip_at_knee(
            args, executor_factory, knee, deadline_s, handoff=False,
        )
        slo_pauses = flip_report.get("rollout_slo_pauses")

    sweep_ok = bool(
        knee is not None
        and swept_past
        and holds
        and all(r["ok"] for r in rows)
    )
    return {
        "metric": "open_loop_overload_sweep",
        "nodes": args.nodes,
        "rate_s": args.rate_s,
        "deadline_ms": args.deadline_ms,
        "seed": args.seed,
        "rates": rows,
        "knee": knee,
        "goodput_holds_past_knee": holds,
        "flip_at_knee": flip_report,
        "rollout_slo_pauses": slo_pauses,
        "calibration": calibration,
        "ok": bool(
            sweep_ok
            and (
                not flip
                or (
                    flip_report is not None
                    and flip_report["rollout_ok"]
                    and flip_report["requests_lost"] == 0
                    and flip_report["nodes_bounced"] == args.nodes
                    and flip_report["conserved"]
                )
            )
        ),
    }


def main(argv: list[str] | None = None) -> int:
    # Seam: the repository root, three directories above this file.
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    sys.path.insert(0, repo_root)
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--nodes", type=int, default=3)
    parser.add_argument("--traffic-s", type=float, default=8.0)
    parser.add_argument("--mode", default="on")
    parser.add_argument("--max-unavailable", type=int, default=1)
    parser.add_argument("--calibrate-smoke", action="store_true",
                        help="run one real llama smoke and calibrate the "
                        "executor's latency/bandwidth model from it")
    parser.add_argument("--sweep", default=None,
                        help="comma-separated offered rates (rps): run the "
                        "open-loop overload sweep + flip-at-the-knee "
                        "(SERVE_r02) instead of the closed-loop flip")
    parser.add_argument("--handoff", action="store_true",
                        help="zero-bounce flip artifact (SERVE_r03): find "
                        "the knee (same sweep machinery as SERVE_r02), "
                        "then flip at it twice — control vs in-flight "
                        "handoff to peers — and gate on the handoff "
                        "flip's during/steady p99 ratio")
    parser.add_argument("--prestage", action="store_true",
                        help="whole-fleet zero-bounce artifact (BENCH_r09): "
                        "find the knee, flip the pool under open-loop "
                        "traffic at --knee-frac of it with continuous "
                        "prestage under the capacity ledger, run a "
                        "no-prestage control leg, and a seeded "
                        "mid-prestage orchestrator-SIGKILL crash leg")
    parser.add_argument("--brownout", action="store_true",
                        help="fail-slow containment artifact (GRAY_r01): "
                        "find the knee, brown out ONE seeded node during "
                        "a rolling flip at load with the peer-relative "
                        "vetter on, run a detector-off control leg that "
                        "must blow the tail, and a seeded SIGKILL at the "
                        "failslow-vetted crash point")
    parser.add_argument("--vet-window-s", type=float, default=0.75,
                        help="--brownout fail-slow vetting window (the "
                        "<=2-window containment bar is in these units)")
    parser.add_argument("--brownout-s", type=float, default=4.0,
                        help="--brownout seconds the victim stays browned "
                        "out before the seeded recovery")
    parser.add_argument("--gray-ratio-bar", type=float, default=1.3,
                        help="--brownout ok-gate: detector-on "
                        "during-brownout p99 must stay within this "
                        "multiple of healthy-steady p99 (control must "
                        "exceed 2x)")
    parser.add_argument("--knee-frac", type=float, default=0.8,
                        help="--prestage offered load as a fraction of "
                        # Seam: the bar named without its issue.
                        "the knee (the acceptance bar: 80%%)")
    parser.add_argument("--reset-s", type=float, default=0.3,
                        help="--prestage simulated device reset latency: "
                        "the cost prestage moves off the flip window")
    parser.add_argument("--boot-s", type=float, default=0.2,
                        help="--prestage simulated runtime boot latency")
    parser.add_argument("--crash-nodes", type=int, default=6,
                        help="--prestage crash-leg pool size")
    parser.add_argument("--ratio-bar", type=float, default=1.3,
                        help="--handoff ok-gate: during-rollout p99 must "
                        "stay within this multiple of steady-state p99")
    parser.add_argument("--rate-s", type=float, default=2.5,
                        help="traffic seconds per sweep rate point")
    parser.add_argument("--deadline-ms", type=float, default=500.0,
                        help="per-request completion deadline (admission "
                        "control sheds when the budget is provably spent)")
    parser.add_argument("--seed", type=int, default=20260804)
    parser.add_argument("--partial", default=None,
                        help="resumable sweep rows (JSONL): ok:true rates "
                        "are skipped on re-run")
    parser.add_argument("--out", default=None,
                        help="also write the JSON line to this file")
    args = parser.parse_args(argv)

    import logging

    logging.basicConfig(level=logging.WARNING)  # stdout carries ONE line

    from tpu_cc_manager_torch.serve import ServeHarness, SimulatedExecutor

    executor_factory = SimulatedExecutor
    calibration = None
    if args.calibrate_smoke:
        # Seam: the runner raises SmokeError for a smoke that did not pass.
        from tpu_cc_manager_torch.smoke.runner import SmokeError, run_workload_subprocess

        try:
            smoke = run_workload_subprocess(
                "llama", timeout_s=600.0, cwd=repo_root,
            )
        except SmokeError as e:
            smoke = {"ok": False, "error": str(e)}
        calibration = {
            "ms_per_token": smoke.get("ms_per_token"),
            "hbm_bw_util": smoke.get("hbm_bw_util"),
            "hbm_bw_util_lower_bound": smoke.get("hbm_bw_util_lower_bound"),
            "backend": smoke.get("backend"),
            "batch": smoke.get("batch"),
        }
        # Seam: an uncalibrated executor is no calibration; the bench fails.
        if not smoke.get("ok") or not smoke.get("ms_per_token"):
            result = {
                "metric": "serve_bench_calibration",
                "ok": False,
                "error": "calibration smoke failed: "
                + str(smoke.get("error") or "no ms_per_token in its result"),
                "calibration": calibration,
            }
            line = json.dumps(result)
            print(line)
            if args.out:
                with open(args.out, "w", encoding="utf-8") as f:
                    f.write(line + "\n")
            return 1
        executor_factory = (
            lambda: SimulatedExecutor.from_smoke_result(smoke)
        )

    if args.brownout:
        if not args.sweep:
            args.sweep = "200,400,800,1600,3200,6400"
        result = run_brownout(args, executor_factory, calibration)
        line = json.dumps(result)
        print(line)
        if args.out:
            with open(args.out, "w", encoding="utf-8") as f:
                f.write(line + "\n")
        return 0 if result["ok"] else 1

    if args.prestage:
        if not args.sweep:
            args.sweep = "200,400,800,1600,3200,6400"
        result = run_prestage(args, executor_factory, calibration)
        line = json.dumps(result)
        print(line)
        if args.out:
            with open(args.out, "w", encoding="utf-8") as f:
                f.write(line + "\n")
        return 0 if result["ok"] else 1

    if args.handoff:
        if not args.sweep:
            args.sweep = "200,400,800,1600,3200,6400"
        result = run_handoff(args, executor_factory, calibration)
        line = json.dumps(result)
        print(line)
        if args.out:
            with open(args.out, "w", encoding="utf-8") as f:
                f.write(line + "\n")
        return 0 if result["ok"] else 1

    if args.sweep:
        result = run_sweep(args, executor_factory, calibration)
        line = json.dumps(result)
        print(line)
        if args.out:
            with open(args.out, "w", encoding="utf-8") as f:
                f.write(line + "\n")
        return 0 if result["ok"] else 1

    harness = ServeHarness(
        n_nodes=args.nodes,
        tmp_dir=tempfile.mkdtemp(prefix="tpu-cc-serve-bench-"),
        executor_factory=executor_factory,
    )
    harness.build()
    try:
        report = harness.run(
            traffic_s=args.traffic_s,
            rollout_mode=args.mode,
            max_unavailable=args.max_unavailable,
        )
        report["fleet_rollup"] = _fleet_rollup(harness.metrics)
    finally:
        harness.shutdown()

    result = {
        "metric": "serving_disruption_per_rollout",
        "nodes": args.nodes,
        "traffic_s": args.traffic_s,
        "mode": args.mode,
        **report,
        "calibration": calibration,
        "ok": bool(
            report["rollout_ok"]
            and report["requests_lost"] == 0
            and report["nodes_bounced"] == args.nodes
            and (report["latency_during_rollout"]["count"] or 0) > 0
            and (report["latency_steady_state"]["count"] or 0) > 0
        ),
    }
    line = json.dumps(result)
    print(line)
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            f.write(line + "\n")
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
