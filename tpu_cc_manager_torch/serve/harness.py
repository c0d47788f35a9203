"""Serving-under-the-flip harness: REAL agents, real rollout, live traffic.

Wires together, against one in-memory apiserver fake:

- a pool of REAL node agents (:class:`CCManager` ``watch_and_apply``
  loops, fake TPU backends, component pods + the emulated operator
  controller reacting to pause labels) — the same full reconcile
  pipeline every other bench drives;
- one :class:`~tpu_cc_manager_torch.serve.server.NodeServer` per node,
  registered on the drain handshake;
- a :class:`~tpu_cc_manager_torch.serve.driver.TrafficDriver` sustaining
  batched traffic across the pool;
- a REAL rolling CC flip (``ccmanager/rolling.py`` — the orchestrator
  ``ctl rollout`` drives) running mid-traffic.

The report is the ROADMAP item 3 artifact: p50/p99 and error rate
*during* the rollout vs steady state, and requests lost per node
bounced (the zero-loss claim).
"""

from __future__ import annotations

import logging
import os
import threading
import time

from tpu_cc_manager_torch.ccmanager.manager import CCManager
from tpu_cc_manager_torch.ccmanager.metrics_server import start_metrics_server
from tpu_cc_manager_torch.ccmanager.node import NodeBackend
from tpu_cc_manager_torch.ccmanager.remediation import RemediationLadder
from tpu_cc_manager_torch.ccmanager.rolling import RollingReconfigurator
from tpu_cc_manager_torch.drain.sim import add_drainable_node
from tpu_cc_manager_torch.kubeclient.api import node_labels
from tpu_cc_manager_torch.kubeclient.fake import FakeKube
from tpu_cc_manager_torch.labels import (
    CC_MODE_STATE_LABEL,
    MODE_OFF,
    SLICE_ID_LABEL,
)
from tpu_cc_manager_torch.obs import failslow as failslow_mod
from tpu_cc_manager_torch.obs.flight import FlightRecorder
from tpu_cc_manager_torch.obs.journal import Journal
from tpu_cc_manager_torch.obs.slo import SloEvaluator
from tpu_cc_manager_torch.serve.driver import TrafficDriver
from tpu_cc_manager_torch.serve.server import NodeServer, SimulatedExecutor
from tpu_cc_manager_torch.gpudev.fake import FakeGpuBackend
from tpu_cc_manager_torch.utils import retry as retry_mod
from tpu_cc_manager_torch.utils.metrics import MetricsRegistry

log = logging.getLogger(__name__)

NS = "tpu-operator"
POOL_LABEL = "pool"
POOL_VALUE = "tpu-serve"
POOL_SELECTOR = f"{POOL_LABEL}={POOL_VALUE}"


def add_serving_node(
    kube: FakeKube, name: str, pod_delete_delay_s: float = 0.0
) -> None:
    """One drainable node with the serving pool label — the SAME
    emulated operator controller the main bench drives
    (drain/sim.py), so SERVE and BENCH artifacts can never measure
    diverging drain emulations."""
    add_drainable_node(
        kube, name, NS, pod_delete_delay_s=pod_delete_delay_s,
        extra_labels={POOL_LABEL: POOL_VALUE},
    )


class ServeHarness:
    """Build the pool, run traffic, flip it, report what users saw."""

    def __init__(
        self,
        n_nodes: int = 3,
        tmp_dir: str = "/tmp/tpu-cc-serve",
        executor_factory=None,
        drain_ack_timeout_s: float = 10.0,
        pod_delete_delay_s: float = 0.0,
        checkpoint_full_s: float = 0.1,
        reset_latency_s: float = 0.0,
        boot_latency_s: float = 0.0,
        driver_kwargs: dict | None = None,
        metrics_port: int | None = None,
        slo_windows_s: tuple[float, ...] = (5.0, 30.0),
        slo_error_budget: float = 1e-3,
        handoff: bool = False,
        failslow: bool = False,
        failslow_kwargs: dict | None = None,
        failslow_probation_s: float = 2.0,
    ) -> None:
        self.n_nodes = n_nodes
        self.nodes = [f"serve-node-{i}" for i in range(n_nodes)]
        self.tmp_dir = tmp_dir
        # ONE shared registry + SLO evaluator for the serving layer
        # (the per-agent registries below stay per-agent on purpose —
        # each models a separate node process): every server's gauges
        # and the driver's histogram/SLO land here, and metrics_port
        # (0 = ephemeral) serves it live at /metrics + /rolloutz —
        # scrapeable DURING the flip, which is the whole point.
        self.metrics = MetricsRegistry()
        self.slo = SloEvaluator(
            windows_s=slo_windows_s, error_budget=slo_error_budget,
        )
        self.metrics_port = metrics_port
        self.metrics_server = None
        self.flight = FlightRecorder(os.path.join(tmp_dir, "flight.jsonl"))
        self.executor_factory = (
            executor_factory if executor_factory is not None
            else SimulatedExecutor
        )
        self.drain_ack_timeout_s = drain_ack_timeout_s
        self.pod_delete_delay_s = pod_delete_delay_s
        self.checkpoint_full_s = checkpoint_full_s
        self.reset_latency_s = reset_latency_s
        self.boot_latency_s = boot_latency_s
        self.driver_kwargs = driver_kwargs or {}
        # Serving-state handoff (SERVE_r03): a draining server's parked
        # requests migrate straight to an accepting peer inside the ack
        # window instead of requeueing into the driver queue. Off by
        # default so SERVE_r01/r02 measurements keep their shape.
        self.handoff = handoff
        self.kube = FakeKube()
        self.backends: dict[str, NodeBackend] = {}
        self.agents: list[CCManager] = []
        self.servers: dict[str, NodeServer] = {}
        self.driver: TrafficDriver | None = None
        self._agent_threads: list[threading.Thread] = []
        self._agent_stop = threading.Event()
        # Fail-slow plane (GRAY_r01): the peer-relative vetter judging
        # every completion, one remediation ladder per node for
        # containment (runtime-restart -> quarantine reason=fail-slow),
        # and a vet-loop thread pacing the windows and acting verdicts
        # at window cadence. A concurrent rollout journals the same
        # verdicts into its record (crash-resume) and replays them
        # through the same callable — both paths funnel through
        # _failslow_act, whose per-id dedup keeps one verdict from ever
        # escalating twice.
        self.failslow = failslow
        self.failslow_kwargs = failslow_kwargs or {}
        self.failslow_probation_s = failslow_probation_s
        self.failslow_vetter: failslow_mod.FailslowVetter | None = None
        self.ladders: dict[str, RemediationLadder] = {}
        self._failslow_acted: set[str] = set()
        self._suspects_published: set[str] = set()
        self._vet_stop = threading.Event()
        self._vet_thread: threading.Thread | None = None

    # -- pool construction -------------------------------------------------

    def build(self) -> None:
        os.makedirs(self.tmp_dir, exist_ok=True)
        for i, name in enumerate(self.nodes):
            add_serving_node(self.kube, name, self.pod_delete_delay_s)
            backend = NodeBackend(FakeGpuBackend(
                node_id=f"serve-slice-{i}",
                reset_latency_s=self.reset_latency_s,
                boot_latency_s=self.boot_latency_s,
            ))
            self.backends[name] = backend
            mgr = CCManager(
                api=self.kube,
                backend=backend,
                node_name=name,
                default_mode=MODE_OFF,
                operator_namespace=NS,
                evict_components=True,
                smoke_workload="none",
                metrics=MetricsRegistry(),
                journal=Journal(trace_file=""),
                eviction_timeout_s=30,
                eviction_poll_interval_s=0.02,
                drain_ack_timeout_s=self.drain_ack_timeout_s,
                watch_timeout_s=1,
                reconnect_delay_s=0.0,
                readiness_file=f"{self.tmp_dir}/ready-{name}",
            )
            self.agents.append(mgr)
            t = threading.Thread(
                target=mgr.watch_and_apply, args=(self._agent_stop,),
                daemon=True, name=f"agent-{name}",
            )
            self._agent_threads.append(t)
        for t in self._agent_threads:
            t.start()
        if not self._await_settled():
            raise RuntimeError("serving pool agents never settled")
        # Forwarding closures break the server↔driver construction cycle
        # (nothing fires before run() starts the servers, by which time
        # the driver exists).
        if self.failslow:
            kwargs = dict(self.failslow_kwargs)
            kwargs.setdefault("metrics", self.metrics)
            self.failslow_vetter = failslow_mod.FailslowVetter.from_env(
                **kwargs
            )
            self.ladders = {
                name: RemediationLadder(
                    self.kube, name, backend=self.backends[name],
                    probation_s=self.failslow_probation_s,
                    metrics=self.metrics,
                )
                for name in self.nodes
            }
        self.servers = {
            name: NodeServer(
                self.kube, name,
                on_complete=lambda n, r, u: self._on_complete(n, r, u),
                on_requeue=lambda n, rs: self.driver.on_requeue(n, rs),
                on_shed=lambda n, rs: self.driver.on_shed(n, rs),
                on_handoff=(
                    (lambda n, rs: self.driver.on_handoff(n, rs))
                    if self.handoff else None
                ),
                executor=self.executor_factory(),
                checkpoint_full_s=self.checkpoint_full_s,
                metrics=self.metrics,
            )
            for name in self.nodes
        }
        self.driver = TrafficDriver(
            self.servers, metrics=self.metrics, slo=self.slo,
            **self.driver_kwargs,
        )
        if self.metrics_port is not None:
            self.metrics_server = start_metrics_server(
                self.metrics_port, self.metrics,
                bind="127.0.0.1", flight=self.flight,
            )

    def _await_settled(self, timeout_s: float = 30.0) -> bool:
        def settled() -> bool:
            for name in self.nodes:
                labels = node_labels(self.kube.get_node(name))
                if labels.get(CC_MODE_STATE_LABEL) != MODE_OFF:
                    return False
                if not labels.get(SLICE_ID_LABEL):
                    return False
            return True

        return retry_mod.poll_until(settled, timeout_s, 0.05)

    # -- fail-slow plane ---------------------------------------------------

    def _on_complete(self, node, req, util) -> None:
        """Driver completion callback, teed into the fail-slow vetter:
        every finished request's SERVICE time (dispatch to completion)
        is one peer-relative sample for the node that served it. NOT
        end-to-end latency: the driver's pending queue is shared, so
        under overload its wait inflates every node's arrival-to-done
        latency together and the peer ratio compresses toward 1 —
        exactly when a browned-out node is eating the fleet's headroom.
        Service time stays a property of the node alone."""
        self.driver.on_complete(node, req, util)
        if (
            self.failslow_vetter is not None
            and req.completed_at is not None
        ):
            t0 = (
                req.started_at
                if req.started_at is not None else req.submitted_at
            )
            self.failslow_vetter.observe(
                node, max(0.0, req.completed_at - t0)
            )

    def _failslow_act(self, node: str, entry: dict) -> None:
        """Containment for ONE fail-slow verdict — the callable the
        rolling orchestrator invokes behind its ``failslow-vetted``
        crash point, and the vet loop invokes between rollouts.
        Idempotent per verdict id (the rolling journal may replay an
        act after a mid-act SIGKILL): a replayed id is a no-op, so a
        node can never be double-escalated for one verdict."""
        key = str(entry.get("id", ""))
        if key and key in self._failslow_acted:
            return
        ladder = self.ladders.get(node)
        if ladder is None:
            return
        if entry.get("verdict") == failslow_mod.VERDICT_CONFIRMED:
            step = ladder.note_failslow(entry.get("deviation"))
            log.warning(
                "fail-slow containment: node %s verdict %s "
                "(deviation %.2fx) -> %s",
                node, key or "?", float(entry.get("deviation") or 0.0),
                step,
            )
        else:
            ladder.note_failslow_recovered()
            log.info(
                "fail-slow cleared: node %s verdict %s (peer-relative "
                "stats recovered)", node, key or "?",
            )
        if key:
            self._failslow_acted.add(key)

    def _vet_once(self) -> None:
        """One vetting window: judge, publish the suspect set to the
        driver (de-weighting) and the node labels (ctl status SUSPECT
        column), then — only while no rollout owns the journal — act
        any verdicts the orchestrator has not already acted."""
        vetter = self.failslow_vetter
        vetter.vet()
        suspects = vetter.suspects()
        if self.driver is not None:
            self.driver.set_suspects(suspects)
        added = suspects - self._suspects_published
        removed = self._suspects_published - suspects
        if added or removed:
            failslow_mod.publish_suspect_labels(
                self.kube, sorted(added), sorted(removed)
            )
            self._suspects_published = set(suspects)
        # Containment latency is the vet loop's job: verdicts are acted
        # HERE, at window cadence, not deferred to the next rollout
        # window boundary. The rolling orchestrator journals the same
        # verdicts into its record (crash-resume) and replays them
        # through this same callable — the per-id dedup makes whichever
        # path runs second a no-op, so the two consumers can never
        # double-escalate one verdict.
        for entry in vetter.concluded():
            self._failslow_act(str(entry.get("node")), entry)
        # Probation feed: a quarantined node that is no longer suspect
        # accrues healthy probes, so the lift (reason=fail-slow release)
        # happens on recovery without a separate watchdog in the
        # harness.
        for name, ladder in self.ladders.items():
            if ladder.quarantined and name not in suspects:
                ladder.note_probe(True)

    def _vet_loop(self) -> None:
        while not self._vet_stop.wait(self.failslow_vetter.window_s):
            try:
                self._vet_once()
            except Exception:  # noqa: BLE001 - vetting never kills traffic
                log.warning(
                    "fail-slow vet pass failed; continuing", exc_info=True
                )

    def _start_vetting(self) -> None:
        if self.failslow_vetter is None or self._vet_thread is not None:
            return
        self._vet_stop.clear()
        self._vet_thread = threading.Thread(
            target=self._vet_loop, daemon=True, name="failslow-vet",
        )
        self._vet_thread.start()

    def _stop_vetting(self) -> None:
        if self._vet_thread is None:
            return
        self._vet_stop.set()
        self._vet_thread.join(timeout=10)
        self._vet_thread = None

    def set_brownout(self, node: str, token_rate_factor: float) -> None:
        """Degrade (or restore, factor 1.0) one node's executor token
        rate AND its fake TPU latency walls — the seeded gray-failure
        injection: the node keeps completing requests and passing
        probes, just slower."""
        server = self.servers.get(node)
        if server is not None and hasattr(server.executor, "set_brownout"):
            server.executor.set_brownout(token_rate_factor)
        backend = self.backends.get(node)
        if backend is not None:
            backend.set_brownout(token_rate_factor)

    # -- run ---------------------------------------------------------------

    def run(
        self,
        traffic_s: float = 6.0,
        rollout_mode: str | None = "on",
        warmup_frac: float = 0.25,
        max_unavailable: int = 1,
        rollout_timeout_s: float = 60.0,
        rollout_hook=None,
        slo_max_burn_rate: float | None = None,
        slo_p99_target_ms: float | None = None,
        slo_window_s: float | None = None,
        slo_max_pause_s: float = 60.0,
        roller_kwargs: dict | None = None,
    ) -> dict:
        """Sustain traffic for ``traffic_s`` (plus however long the flip
        needs), run the rolling CC flip after ``warmup_frac`` of it, and
        report. The steady-state buckets are the pre-flip warmup and the
        post-flip tail. ``rollout_hook`` is passed to the orchestrator's
        named crash points ("window-start"/"mid-window"/...) — the
        mid-flip scrape tests hang their assertions there, so "scraped
        during the flip" is true by construction, not by sleep-timing.

        ``rollout_mode=None`` runs traffic with NO flip (the rate
        sweep's steady measurement). ``slo_max_burn_rate`` /
        ``slo_p99_target_ms`` arm the orchestrator's wave-boundary SLO
        gate with THIS harness's live evaluator — the in-process form of
        the latency-gated rollout (``ctl rollout --slo-source`` is the
        remote one)."""
        assert self.driver is not None, "call build() first"
        for server in self.servers.values():
            server.start()
        self.driver.start()
        self._start_vetting()
        result = None
        t_roll_0 = t_roll_1 = None
        try:
            if rollout_mode is None:
                retry_mod.wait(traffic_s, None)
            else:
                retry_mod.wait(traffic_s * warmup_frac, None)
                slo_gate = None
                slo_config = None
                if slo_max_burn_rate is not None or slo_p99_target_ms is not None:
                    from tpu_cc_manager_torch.ccmanager.rolling import SloGateConfig

                    burn = (
                        slo_max_burn_rate
                        if slo_max_burn_rate is not None else 1.0
                    )
                    target_s = (
                        slo_p99_target_ms / 1e3
                        if slo_p99_target_ms is not None else None
                    )
                    slo_config = SloGateConfig(
                        max_burn_rate=burn,
                        p99_target_ms=slo_p99_target_ms,
                        window_s=slo_window_s,
                        max_pause_s=slo_max_pause_s,
                    )

                    def slo_gate() -> bool:
                        return self.slo.breached(
                            max_burn_rate=burn,
                            window_s=slo_window_s,
                            p99_target_s=target_s,
                        )

                extra = dict(roller_kwargs or {})
                if self.failslow_vetter is not None:
                    # The orchestrator owns verdict acting during the
                    # flip: journaled in the record, acted behind the
                    # failslow-vetted crash point — _failslow_act's
                    # per-id dedup keeps a replay harmless.
                    extra.setdefault("failslow_vetter", self.failslow_vetter)
                    extra.setdefault("failslow_act", self._failslow_act)
                roller = RollingReconfigurator(
                    self.kube, POOL_SELECTOR,
                    max_unavailable=max_unavailable,
                    node_timeout_s=rollout_timeout_s,
                    poll_interval_s=0.02,
                    crash_hook=rollout_hook,
                    flight=self.flight,
                    metrics=self.metrics,
                    slo_gate=slo_gate,
                    slo_config=slo_config,
                    # Extra orchestrator knobs (BENCH_r09 passes
                    # continuous_prestage + headroom_gate here).
                    **extra,
                )
                t_roll_0 = time.monotonic()
                result = roller.rollout(rollout_mode)
                t_roll_1 = time.monotonic()
                # Post-flip steady tail: the rest of the traffic budget,
                # at least a second so the tail bucket has data.
                tail = max(1.0, traffic_s * (1.0 - warmup_frac))
                retry_mod.wait(tail, None)
        finally:
            self.driver.stop()
        # Everything still in the system must complete: the zero-loss
        # claim is checked AFTER the grace drain, not before.
        self.driver.drain_outstanding(grace_s=15.0)
        if rollout_mode is None:
            return self.driver.report()
        bounced = sum(
            1 for name in self.nodes
            if node_labels(self.kube.get_node(name)).get(
                CC_MODE_STATE_LABEL
            ) == rollout_mode
        )
        report = self.driver.report(
            rollout_window=(t_roll_0, t_roll_1), nodes_bounced=bounced,
        )
        report["rollout_ok"] = bool(result.ok)
        report["rollout_wall_s"] = round(t_roll_1 - t_roll_0, 3)
        report["rollout_summary"] = result.summary()
        report["rollout_slo_pauses"] = self.metrics.rollout_totals()[
            "slo_pauses"
        ]
        report["drains"] = {
            name: {
                "drains": s.drains,
                "resumes": s.resumes,
                "last_checkpoint_s": (
                    round(s.last_checkpoint_s, 4)
                    if s.last_checkpoint_s is not None else None
                ),
                "last_checkpoint_deadline_s": s.last_checkpoint_deadline_s,
                # Both per-LAST-drain, so the pair stays comparable;
                # the cumulative migration count rides separately.
                "requeued": s.last_checkpoint_requeued,
                "handed_off": s.last_handoff_accepted,
                "handed_off_total": s.handoffs_accepted,
            }
            for name, s in self.servers.items()
        }
        return report

    def metrics_address(self) -> str | None:
        """host:port of the live serve /metrics endpoint (None when
        metrics_port was not given)."""
        if self.metrics_server is None:
            return None
        host, port = self.metrics_server.server_address[:2]
        return f"{host}:{port}"

    def shutdown(self) -> None:
        self._stop_vetting()
        for server in self.servers.values():
            server.stop()
        self._agent_stop.set()
        for t in self._agent_threads:
            t.join(timeout=10)
        if self.metrics_server is not None:
            self.metrics_server.shutdown()
