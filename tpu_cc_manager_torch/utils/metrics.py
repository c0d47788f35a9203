"""Phase-latency metrics.

The reference has no instrumentation beyond log lines (SURVEY.md §5), but the
north-star metric for this build is a latency — per-node drain→CC-on→ready
< 90 s (BASELINE.md) — so every reconcile phase is timed here and the timings
are exported both as structured log lines and programmatically (bench.py and
the Prometheus text endpoint read them).

Each phase is also traced: :meth:`ReconcileMetrics.phase` opens a span
(obs/trace.py) named after the phase, so the phase record, the log line,
and the journal entry all carry the reconcile's ``trace_id``. Latencies
accumulate into fixed-bucket histograms (``tpu_cc_phase_seconds_bucket``)
rather than only sum/count pairs, because the <90 s SLO is a tail question
— a mean cannot say whether one in ten drains blows the budget.
"""

from __future__ import annotations

import contextlib
import logging
import time
from dataclasses import dataclass, field

from tpu_cc_manager_torch.obs import trace as obs_trace
from tpu_cc_manager_torch.utils import locks as locks_mod

log = logging.getLogger(__name__)

# Canonical phase names, in pipeline order.
PHASE_DRAIN = "drain"
PHASE_STAGE = "stage"
PHASE_BARRIER = "barrier"
PHASE_RESET = "reset"
PHASE_WAIT_READY = "wait_ready"
PHASE_ATTEST = "attest"
PHASE_SMOKE = "smoke"
PHASE_READMIT = "readmit"

# Fixed histogram buckets (seconds), chosen around the <90 s SLO: fine
# resolution under a second for the control-plane-only phases, then the
# decision points an operator actually asks about (30 s reset, 60 s, the
# 90 s budget itself, and the 300 s timeouts). +Inf is implicit.
HISTOGRAM_BUCKETS = (
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 20.0, 30.0, 45.0,
    60.0, 90.0, 120.0, 300.0,
)

# Serving request-latency buckets (seconds): inference latencies live
# orders of magnitude below the reconcile phases — ms-scale resolution
# at the bottom, the checkpoint-bounce tail (~100-500 ms in SERVE_r01)
# in the middle, and multi-second outliers at the top. Fixed like
# HISTOGRAM_BUCKETS so fleet-wide aggregation never mixes bucket sets.
SERVE_HISTOGRAM_BUCKETS = (
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


def _escape_label_value(value: str) -> str:
    """Prometheus text-exposition label-value escaping: backslash, double
    quote, and newline must be escaped or a hostile/odd mode or phase
    string corrupts the whole scrape."""
    return (
        str(value)
        .replace("\\", r"\\")
        .replace('"', r"\"")
        .replace("\n", r"\n")
    )


def _labels(**kv: str) -> str:
    """Render a label set with escaped values, keys in given order."""
    return (
        "{"
        + ",".join(f'{k}="{_escape_label_value(v)}"' for k, v in kv.items())
        + "}"
    )


def _bucket_le(bound: float) -> str:
    return "%g" % bound


@dataclass
class PhaseRecord:
    name: str
    start: float
    end: float = 0.0
    ok: bool = True
    # Correlation with the reconcile's span tree (obs/trace.py); set by
    # ReconcileMetrics.phase from the span it opens.
    trace_id: str | None = None
    span_id: str | None = None

    @property
    def seconds(self) -> float:
        return max(0.0, self.end - self.start)


@dataclass
class ReconcileMetrics:
    """Timings for one reconcile (one desired-mode application)."""

    mode: str
    start: float = field(default_factory=time.monotonic)
    end: float = 0.0
    phases: list[PhaseRecord] = field(default_factory=list)
    result: str = "pending"  # pending | ok | failed | noop
    trace_id: str | None = None
    # Set by MetricsRegistry.start(); finish() folds this reconcile into the
    # registry's cumulative counters (which survive the bounded history).
    registry: "MetricsRegistry | None" = field(
        default=None, repr=False, compare=False
    )

    @contextlib.contextmanager
    def phase(self, name: str):
        rec = PhaseRecord(name=name, start=time.monotonic())
        with obs_trace.span(name, phase=name, mode=self.mode) as sp:
            rec.trace_id, rec.span_id = sp.trace_id, sp.span_id
            if self.trace_id is None:
                self.trace_id = sp.trace_id
            try:
                yield rec
            except BaseException:
                rec.ok = False
                raise
            finally:
                rec.end = time.monotonic()
                sp.set_attribute("ok", rec.ok)
                self.phases.append(rec)
                log.info(
                    "phase %s finished in %.2fs (ok=%s)",
                    name,
                    rec.seconds,
                    rec.ok,
                    extra={"fields": {"phase": name, "seconds": round(rec.seconds, 3), "ok": rec.ok}},
                )

    def finish(self, result: str) -> None:
        self.end = time.monotonic()
        self.result = result
        if self.registry is not None:
            self.registry._accumulate(self)
        log.info(
            "reconcile mode=%s result=%s total=%.2fs phases=%s",
            self.mode,
            result,
            self.total_seconds,
            {p.name: round(p.seconds, 2) for p in self.phases},
            extra={
                "fields": {
                    "mode": self.mode,
                    "result": result,
                    "total_seconds": round(self.total_seconds, 3),
                }
            },
        )

    @property
    def total_seconds(self) -> float:
        end = self.end if self.end else time.monotonic()
        return max(0.0, end - self.start)

    def phase_seconds(self, name: str) -> float:
        return sum(p.seconds for p in self.phases if p.name == name)


class MetricsRegistry:
    """Process-wide registry of reconcile metrics (thread-safe).

    Backs the Prometheus text endpoint and bench.py. The reference exposes no
    metrics endpoint (SURVEY.md §5) — this is a deliberate addition.
    """

    def __init__(self) -> None:
        self._lock = locks_mod.make_lock("metrics.registry")
        self._history: list[ReconcileMetrics] = []  # cclint: guarded-by(_lock)
        # Cumulative counters (unbounded lifetime, unlike the history): a
        # scraper that misses a reconcile still sees its latency in the
        # totals — last-reconcile gauges alone lose data between scrapes.
        self._result_totals: dict[str, int] = {}  # cclint: guarded-by(_lock)
        self._phase_totals: dict[tuple[str, str], list[float]] = {}  # cclint: guarded-by(_lock)
        # (mode, phase) -> per-bucket cumulative-style counts; index i is
        # observations <= HISTOGRAM_BUCKETS[i], the final slot is +Inf.
        self._phase_hist: dict[tuple[str, str], list[int]] = {}  # cclint: guarded-by(_lock)
        # Machine-readable failure reasons (CCManager._failure_reason and
        # the pre-apply failure paths), keyed exactly as the failed.reason
        # node label is.
        self._failure_totals: dict[str, int] = {}  # cclint: guarded-by(_lock)
        # (op, reason) -> retries through the shared policy (utils/retry.py).
        self._retry_totals: dict[tuple[str, str], int] = {}  # cclint: guarded-by(_lock)
        # Circuit breaker states by path name ("apiserver", "device-cmd").
        self._breaker_states: dict[str, str] = {}  # cclint: guarded-by(_lock)
        # Runtime-health watchdog: active probe tier + last probe verdict.
        self._health_tier: tuple[str, int] | None = None  # cclint: guarded-by(_lock)
        self._runtime_healthy: bool | None = None  # cclint: guarded-by(_lock)
        # Failure containment (ccmanager/remediation.py): whether this node
        # is quarantined, ladder actions by (step, outcome), and how many
        # slice barriers were aborted with a fencing generation.
        self._quarantined: bool | None = None  # cclint: guarded-by(_lock)
        self._remediation_totals: dict[tuple[str, str], int] = {}  # cclint: guarded-by(_lock)
        self._barrier_fenced_total = 0  # cclint: guarded-by(_lock)
        # Crash-safe rollout orchestration (ccmanager/rollout_state.py):
        # resumes from a persisted record, lease acquisitions/takeovers,
        # and writes refused because the lease was lost (fencing).
        self._rollout_resumes_total = 0  # cclint: guarded-by(_lock)
        self._rollout_lease_transitions_total = 0  # cclint: guarded-by(_lock)
        self._rollout_fenced_writes_total = 0  # cclint: guarded-by(_lock)
        # Federated rollouts (ccmanager/federation.py): parent-record
        # syncs by outcome (ok / fenced), hierarchical fences by reason
        # (parent-generation / parent-aborted), and the global budget
        # spend size this shard last observed on the parent.
        self._federation_sync_totals: dict[str, int] = {}  # cclint: guarded-by(_lock)
        self._federation_fence_totals: dict[str, int] = {}  # cclint: guarded-by(_lock)
        self._federation_budget_spent: int | None = None  # cclint: guarded-by(_lock)
        # Parent-plane partition tolerance: how long the current parent
        # blackout has lasted (0 when connected), this shard's escrowed
        # budget slice, and how much dark spend is pending reconciliation.
        self._federation_offline_seconds: float | None = None  # cclint: guarded-by(_lock)
        self._federation_escrow_reserved: int | None = None  # cclint: guarded-by(_lock)
        self._federation_escrow_spent: int | None = None  # cclint: guarded-by(_lock)
        # Apiserver-outage autonomy (ccmanager/intent_journal.py): live
        # connectivity, how long the current outage has lasted, intent-
        # journal replays by outcome, and deferred label patches.
        self._apiserver_connected: bool | None = None  # cclint: guarded-by(_lock)
        self._offline_seconds: float | None = None  # cclint: guarded-by(_lock)
        self._journal_replay_totals: dict[str, int] = {}  # cclint: guarded-by(_lock)
        self._deferred_patch_total = 0  # cclint: guarded-by(_lock)
        # Fleet churn (preemption fast-drain + autoscaler interplay):
        # preemption notices handled by outcome (handoff / clean /
        # resumed / handoff-failed), mid-rollout node adoptions, and how
        # long the last fast drain took against its hard deadline.
        self._preemption_totals: dict[str, int] = {}  # cclint: guarded-by(_lock)
        self._node_adoptions_total = 0  # cclint: guarded-by(_lock)
        self._fast_drain_seconds: float | None = None  # cclint: guarded-by(_lock)
        # Pipelined transitions (ccmanager/manager.py): how many seconds
        # the most recent reconcile saved by overlapping phases (sum of
        # phase latencies minus reconcile wall time, floored at 0), and
        # smoke fast-path decisions by outcome (hit = smoke skipped on an
        # unchanged verified digest, miss = digest changed so the full
        # smoke ran, cold = no verified digest on record yet).
        self._phase_overlap_seconds: float | None = None  # cclint: guarded-by(_lock)
        self._smoke_fastpath_totals: dict[str, int] = {}  # cclint: guarded-by(_lock)
        # Client-side apiserver request accounting by verb (get / list /
        # watch / patch / create / update / delete): every HTTP round
        # trip RestKube performs, retries included. The fleet-scale
        # question this answers: is this process O(changes) against the
        # apiserver (watch-driven informer cache) or O(pool) (re-listing
        # per decision)?
        self._apiserver_request_totals: dict[str, int] = {}  # cclint: guarded-by(_lock)
        # Live serving telemetry (tpu_cc_serve_* families; serve/ +
        # obs/slo.py): per-node request-latency histogram (+_sum), queue
        # depth and in-flight gauges, request outcomes
        # (completed/bounced/requeued), requests lost (the zero-loss
        # headline), goodput, and the windowed SLO readout the
        # latency-gated rollout will poll.
        self._serve_hist: dict[str, list[int]] = {}  # cclint: guarded-by(_lock)
        self._serve_hist_sum: dict[str, float] = {}  # cclint: guarded-by(_lock)
        self._serve_queue_depth: dict[str, int] = {}  # cclint: guarded-by(_lock)
        self._serve_inflight: dict[str, int] = {}  # cclint: guarded-by(_lock)
        # Capacity-ledger inputs (obs/fleet.py headroom): per-node HBM
        # bandwidth utilization (the serve driver's ladder signal) and
        # whether a spare pre-stage is in flight on this agent — both
        # read by the fleet gateway to judge per-node serving headroom.
        self._serve_hbm_bw_util: dict[str, float] = {}  # cclint: guarded-by(_lock)
        self._prestage_in_progress: bool | None = None  # cclint: guarded-by(_lock)
        self._serve_outcome_totals: dict[tuple[str, str], int] = {}  # cclint: guarded-by(_lock)
        self._serve_lost_total = 0  # cclint: guarded-by(_lock)
        self._serve_deadline_miss_totals: dict[str, int] = {}  # cclint: guarded-by(_lock)
        self._serve_offered_rps: float | None = None  # cclint: guarded-by(_lock)
        self._rollout_slo_pauses_total = 0  # cclint: guarded-by(_lock)
        self._serve_goodput: float | None = None  # cclint: guarded-by(_lock)
        # window_s -> (p99_s or None, burn_rate)
        self._serve_slo: dict[float, tuple[float | None, float]] = {}  # cclint: guarded-by(_lock)
        # Zero-bounce flips (serve/ handoff + ccmanager prestage): parked
        # requests migrated to a peer at drain time by outcome (accepted
        # = a peer took them inside the ack window; fallback = no
        # accepting peer, local requeue), and how long the most recent
        # spare pre-staging (annotation-driven full flip + warmup ahead
        # of the rollout wave) took.
        self._serve_handoff_totals: dict[str, int] = {}  # cclint: guarded-by(_lock)
        self._spare_prestage_seconds: float | None = None  # cclint: guarded-by(_lock)
        # Continuous prestage (ccmanager/rolling.py capacity ledger,
        # record v7): how many regular nodes are in prestage transition
        # right now (reserved or armed — held costs nothing), the
        # allowance the headroom gate last granted, and lifecycle
        # outcomes (reserved/armed/held/converged/invalidated/degraded/
        # paused/aborted/failed) as a labeled counter.
        self._prestage_reserved: int | None = None  # cclint: guarded-by(_lock)
        self._prestage_headroom_nodes: int | None = None  # cclint: guarded-by(_lock)
        self._prestage_totals: dict[str, int] = {}  # cclint: guarded-by(_lock)
        # Fail-slow vetting (tpu_cc_failslow_* families; obs/failslow.py):
        # per-node suspicion flag and last peer-relative deviation ratio
        # (node window median / fleet median — 1.0 is "moving with the
        # fleet"), plus concluded verdicts (confirmed/cleared) as a
        # labeled counter. The gray-failure readout: a node can be deep
        # in suspicion here while every watchdog probe stays green.
        self._failslow_suspect: dict[str, bool] = {}  # cclint: guarded-by(_lock)
        self._failslow_deviation: dict[str, float] = {}  # cclint: guarded-by(_lock)
        self._failslow_verdict_totals: dict[tuple[str, str], int] = {}  # cclint: guarded-by(_lock)

    def start(self, mode: str) -> ReconcileMetrics:
        m = ReconcileMetrics(mode=mode, registry=self)
        with self._lock:
            self._history.append(m)
            # Bound memory: keep the last 256 reconciles.
            if len(self._history) > 256:
                del self._history[: len(self._history) - 256]
        return m

    def observe_phase(self, mode: str, phase: str, seconds: float) -> None:
        """Fold one phase latency into the cumulative histogram."""
        with self._lock:
            hist = self._phase_hist.setdefault(
                (mode, phase), [0] * (len(HISTOGRAM_BUCKETS) + 1)
            )
            for i, bound in enumerate(HISTOGRAM_BUCKETS):
                if seconds <= bound:
                    hist[i] += 1
            hist[-1] += 1  # +Inf

    def record_failure(self, reason: str) -> None:
        """Count a failed reconcile by machine-readable reason (the same
        string the failed.reason node label carries)."""
        with self._lock:
            self._failure_totals[reason] = self._failure_totals.get(reason, 0) + 1

    def record_retry(self, op: str, reason: str) -> None:
        """Count one retry through the shared policy (utils/retry.py)."""
        with self._lock:
            key = (op, reason)
            self._retry_totals[key] = self._retry_totals.get(key, 0) + 1

    def retry_totals(self) -> dict[tuple[str, str], int]:
        with self._lock:
            return dict(self._retry_totals)

    def set_breaker_state(self, name: str, state: str) -> None:
        with self._lock:
            self._breaker_states[name] = state

    def breaker_states(self) -> dict[str, str]:
        with self._lock:
            return dict(self._breaker_states)

    def set_health_tier(self, tier: str, strength: int, healthy: bool) -> None:
        """Record the runtime-health watchdog's active probe tier (strength
        is the tier's rank — device-node existence being the weakest) and
        the latest probe verdict."""
        with self._lock:
            self._health_tier = (tier, strength)
            self._runtime_healthy = healthy

    def health_tier(self) -> tuple[str, int] | None:
        with self._lock:
            return self._health_tier

    def set_quarantined(self, quarantined: bool) -> None:
        """Record this node's quarantine state (remediation ladder)."""
        with self._lock:
            self._quarantined = bool(quarantined)

    def record_remediation_step(self, step: str, outcome: str) -> None:
        """Count one remediation-ladder action by step and outcome
        (``ok`` / ``failed`` / ``escalated``)."""
        with self._lock:
            key = (step, outcome)
            self._remediation_totals[key] = (
                self._remediation_totals.get(key, 0) + 1
            )

    def remediation_totals(self) -> dict[tuple[str, str], int]:
        with self._lock:
            return dict(self._remediation_totals)

    def record_barrier_fenced(self) -> None:
        """Count one slice-barrier fence event (a barrier round aborted
        with a new fencing generation so peers fail fast)."""
        with self._lock:
            self._barrier_fenced_total += 1

    def record_rollout_resume(self) -> None:
        """Count one rollout resumed from a persisted record (a successor
        picking up a dead orchestrator's checkpoint)."""
        with self._lock:
            self._rollout_resumes_total += 1

    def record_lease_transition(self) -> None:
        """Count one rollout-lease acquisition/takeover (the fencing
        token increments with each)."""
        with self._lock:
            self._rollout_lease_transitions_total += 1

    def record_fenced_write(self) -> None:
        """Count one write REFUSED because the rollout lease was lost
        (a stale orchestrator's patch stopped by the fence)."""
        with self._lock:
            self._rollout_fenced_writes_total += 1

    def record_federation_sync(self, outcome: str) -> None:
        """Count one regional shard's wave-boundary exchange with the
        federated parent record by outcome (``ok`` / ``fenced``)."""
        with self._lock:
            self._federation_sync_totals[outcome] = (
                self._federation_sync_totals.get(outcome, 0) + 1
            )

    def record_federation_fence(self, reason: str) -> None:
        """Count one hierarchical fence refusal by reason
        (``parent-generation`` after a force-abort bumped the parent,
        ``parent-aborted`` when the whole federation was discarded)."""
        with self._lock:
            self._federation_fence_totals[reason] = (
                self._federation_fence_totals.get(reason, 0) + 1
            )

    def set_federation_budget_spent(self, count: int) -> None:
        """Record the GLOBAL failure-budget spend size (distinct node
        names charged across every region) this shard last read off the
        parent record."""
        with self._lock:
            self._federation_budget_spent = max(0, int(count))

    def set_federation_offline_seconds(self, seconds: float) -> None:
        """Record how long the current PARENT-plane blackout has lasted
        for this regional shard (0 when the last parent sync landed)."""
        with self._lock:
            self._federation_offline_seconds = max(0.0, float(seconds))

    def set_federation_escrow(self, reserved: int, spent: int) -> None:
        """Record this shard's escrow ledger: the budget slice reserved
        on the parent for autonomous degraded-mode spending, and how
        many dark charges are pending reconciliation against it (0 once
        a reconnect sync union-merges them into the global ledger)."""
        with self._lock:
            self._federation_escrow_reserved = max(0, int(reserved))
            self._federation_escrow_spent = max(0, int(spent))

    def set_apiserver_connected(self, connected: bool) -> None:
        """Record whether the last apiserver interaction succeeded (the
        disconnected-mode ladder's outward signal)."""
        with self._lock:
            self._apiserver_connected = bool(connected)

    def set_offline_seconds(self, seconds: float) -> None:
        """Record how long the current total apiserver outage has lasted
        (0 when connected)."""
        with self._lock:
            self._offline_seconds = max(0.0, seconds)

    def record_journal_replay(self, outcome: str) -> None:
        """Count one intent-journal replay resolution by outcome
        (``completed`` / ``rolled-back`` / ``clean`` / ``failed-closed``)."""
        with self._lock:
            self._journal_replay_totals[outcome] = (
                self._journal_replay_totals.get(outcome, 0) + 1
            )

    def record_deferred_patch(self) -> None:
        """Count one node-label write deferred into the intent journal
        because the apiserver was unreachable."""
        with self._lock:
            self._deferred_patch_total += 1

    def journal_replay_totals(self) -> dict[str, int]:
        with self._lock:
            return dict(self._journal_replay_totals)

    def record_preemption(self, outcome: str) -> None:
        """Count one handled preemption notice by outcome: ``handoff``
        (mid-flip, handoff record published for the replacement),
        ``clean`` (no transition in flight), ``handoff-failed`` (the
        publish itself failed before the kill), ``resumed`` (this agent
        consumed a predecessor's handoff and completed the flip)."""
        with self._lock:
            self._preemption_totals[outcome] = (
                self._preemption_totals.get(outcome, 0) + 1
            )

    def preemption_totals(self) -> dict[str, int]:
        with self._lock:
            return dict(self._preemption_totals)

    def record_node_adoption(self, count: int = 1) -> None:
        """Count nodes created mid-rollout (autoscaler scale-up) that the
        orchestrator adopted into a trailing wave."""
        with self._lock:
            self._node_adoptions_total += count

    def node_adoptions_total(self) -> int:
        with self._lock:
            return self._node_adoptions_total

    def set_fast_drain_seconds(self, seconds: float) -> None:
        """Record how long the most recent preemption fast-drain took
        (checkpoint handshake + compressed eviction, against the hard
        termination deadline)."""
        with self._lock:
            self._fast_drain_seconds = max(0.0, seconds)

    def set_phase_overlap_seconds(self, seconds: float) -> None:
        """Record how many seconds the most recent reconcile saved by
        running phases concurrently (pipelined transitions): the sum of
        its phase latencies minus its wall time, floored at 0."""
        with self._lock:
            self._phase_overlap_seconds = max(0.0, seconds)

    def record_smoke_fastpath(self, outcome: str) -> None:
        """Count one attestation-digest smoke fast-path decision by
        outcome (``hit`` / ``miss`` / ``cold``; ccmanager/manager.py,
        CC_SMOKE_DIGEST_FAST_PATH)."""
        with self._lock:
            self._smoke_fastpath_totals[outcome] = (
                self._smoke_fastpath_totals.get(outcome, 0) + 1
            )

    def smoke_fastpath_totals(self) -> dict[str, int]:
        with self._lock:
            return dict(self._smoke_fastpath_totals)

    def record_apiserver_request(self, verb: str) -> None:
        """Count one apiserver HTTP round trip by verb (kubeclient)."""
        with self._lock:
            self._apiserver_request_totals[verb] = (
                self._apiserver_request_totals.get(verb, 0) + 1
            )

    def apiserver_request_totals(self) -> dict[str, int]:
        with self._lock:
            return dict(self._apiserver_request_totals)

    # -- live serving telemetry (serve/, obs/slo.py) -----------------------

    def observe_serve_request(self, node: str, seconds: float) -> None:
        """Fold one completed request's end-to-end latency (bounces
        included — the latency the user saw) into the per-node serve
        histogram."""
        with self._lock:
            hist = self._serve_hist.setdefault(
                node, [0] * (len(SERVE_HISTOGRAM_BUCKETS) + 1)
            )
            for i, bound in enumerate(SERVE_HISTOGRAM_BUCKETS):
                if seconds <= bound:
                    hist[i] += 1
            hist[-1] += 1  # +Inf
            self._serve_hist_sum[node] = (
                self._serve_hist_sum.get(node, 0.0) + max(0.0, seconds)
            )

    def set_serve_queue_depth(self, node: str, depth: int) -> None:
        """Requests queued (accepted, not yet executing) on a node."""
        with self._lock:
            self._serve_queue_depth[node] = max(0, int(depth))

    def set_serve_inflight(self, node: str, inflight: int) -> None:
        """Requests in the executing batch on a node."""
        with self._lock:
            self._serve_inflight[node] = max(0, int(inflight))

    def set_serve_hbm_bw_util(self, node: str, util: float) -> None:
        """Last observed HBM bandwidth utilization (0..1) on a node —
        the serve driver's batch-ladder signal, exported so the fleet
        capacity ledger can judge headroom against its ceiling."""
        with self._lock:
            self._serve_hbm_bw_util[node] = min(1.0, max(0.0, float(util)))

    def set_prestage_in_progress(self, in_progress: bool) -> None:
        """Whether a spare pre-stage (annotation-driven full flip +
        warmup ahead of a rollout wave) is currently running on this
        agent. A prestaging node is warming, not serving headroom."""
        with self._lock:
            self._prestage_in_progress = bool(in_progress)

    def record_serve_outcome(
        self, node: str, outcome: str, count: int = 1
    ) -> None:
        """Count request dispositions per node: ``completed`` (finished
        and returned), ``bounced`` (checkpoint-and-requeued by a drain
        bracket, progress intact), ``requeued`` (returned unsubmitted
        after losing the submit race with a drain)."""
        with self._lock:
            key = (node, outcome)
            self._serve_outcome_totals[key] = (
                self._serve_outcome_totals.get(key, 0) + count
            )

    def record_serve_lost(self, count: int = 1) -> None:
        """Count requests that never completed after traffic stopped
        and the grace drain expired — the zero-loss headline's counter
        (not per-node: a lost request by definition has no owner)."""
        with self._lock:
            self._serve_lost_total += count

    def record_serve_deadline_miss(self, node: str, count: int = 1) -> None:
        """Count ACCEPTED requests that completed past their deadline —
        the broken promise, separate from ``outcome=shed`` (the counted,
        deliberate refusal at intake)."""
        with self._lock:
            self._serve_deadline_miss_totals[node] = (
                self._serve_deadline_miss_totals.get(node, 0) + count
            )

    def set_serve_offered_rps(self, rps: float) -> None:
        """Open-loop offered (scheduled) arrival rate — the load the
        pool was asked to absorb, independent of what it completed."""
        with self._lock:
            self._serve_offered_rps = max(0.0, rps)

    def record_serve_handoff(self, outcome: str, count: int = 1) -> None:
        """Count parked requests a draining node's drain bracket handed
        to the driver's migration sink, by outcome: ``accepted`` (an
        accepting peer took them inside the ack window — the zero-bounce
        path) or ``fallback`` (no accepting peer; requeued locally,
        today's behavior)."""
        with self._lock:
            self._serve_handoff_totals[outcome] = (
                self._serve_handoff_totals.get(outcome, 0) + count
            )

    def serve_handoff_totals(self) -> dict[str, int]:
        with self._lock:
            return dict(self._serve_handoff_totals)

    def set_spare_prestage_seconds(self, seconds: float) -> None:
        """Record how long the most recent spare pre-staging took — the
        annotation-driven full flip + compile warmup a surge spare runs
        BEFORE the rollout wave that needs it opens (ccmanager/manager.py
        prestage; the wave then converges in ~drain+readmit time)."""
        with self._lock:
            self._spare_prestage_seconds = max(0.0, seconds)

    def record_slo_pause(self) -> None:
        """Count one SLO-gate pause of a rolling rollout's next wave
        (ccmanager/rolling.py wave boundaries)."""
        with self._lock:
            self._rollout_slo_pauses_total += 1

    def set_prestage_reserved(self, count: int) -> None:
        """Gauge: capacity-ledger entries currently in prestage
        TRANSITION (reserved or armed — a held entry's node is serving
        at the target mode and costs no headroom), maintained by the
        rolling orchestrator's continuous-prestage pass."""
        with self._lock:
            self._prestage_reserved = max(0, int(count))

    def set_prestage_headroom_nodes(self, count: int) -> None:
        """Gauge: the prestage allowance the headroom gate last granted
        — whole nodes of slack under the serving knee, capped at
        max_unavailable (serve.sweep.knee_slack_nodes). Zero while the
        gate fails closed or offered load fills the knee."""
        with self._lock:
            self._prestage_headroom_nodes = max(0, int(count))

    def record_prestage(self, outcome: str) -> None:
        """Count one continuous-prestage lifecycle step by outcome:
        ``reserved``/``armed``/``held`` (the happy path), ``converged``
        (charge settled at the flip window), ``invalidated`` (stale
        plan digest), ``degraded`` (prestage-path failure downgraded
        the node to the full flip), ``paused`` (SLO burn skipped a
        top-up) and ``aborted``/``failed`` (terminal drains)."""
        with self._lock:
            self._prestage_totals[outcome] = (
                self._prestage_totals.get(outcome, 0) + 1
            )

    def prestage_totals(self) -> dict[str, int]:
        with self._lock:
            return dict(self._prestage_totals)

    def set_serve_goodput(self, rps: float) -> None:
        """Completed-requests-per-second over the SLO window."""
        with self._lock:
            self._serve_goodput = max(0.0, rps)

    def set_serve_slo(
        self, window_s: float, p99_s: float | None, burn_rate: float
    ) -> None:
        """Record one SLO window's readout (obs/slo.py): rolling p99
        (None while the window is empty — no sample beats a fake one)
        and error-budget burn rate."""
        with self._lock:
            self._serve_slo[float(window_s)] = (p99_s, burn_rate)

    def set_failslow_suspect(self, node: str, suspect: bool) -> None:
        """Whether peer-relative fail-slow vetting (obs/failslow.py)
        currently suspects this node of a gray failure (>= 1 strike or
        confirmed). 0/1 gauge per node."""
        with self._lock:
            self._failslow_suspect[node] = bool(suspect)

    def set_failslow_deviation(self, node: str, deviation: float) -> None:
        """Last vetting window's peer-relative deviation ratio for this
        node (window median / fleet median-of-medians): 1.0 moves with
        the fleet, the confirm threshold defaults to 2.0."""
        with self._lock:
            self._failslow_deviation[node] = max(0.0, float(deviation))

    def record_failslow_verdict(self, node: str, verdict: str) -> None:
        """Count one concluded fail-slow verdict for a node:
        ``confirmed`` (sustained deviation beyond the threshold for
        min_windows consecutive windows — feeds the remediation ladder)
        or ``cleared`` (recovered below the clear threshold for
        clear_windows consecutive windows — suspicion lifted)."""
        with self._lock:
            key = (node, verdict)
            self._failslow_verdict_totals[key] = (
                self._failslow_verdict_totals.get(key, 0) + 1
            )

    def failslow_totals(self) -> dict:
        with self._lock:
            return {
                "suspects": dict(self._failslow_suspect),
                "deviation": dict(self._failslow_deviation),
                "verdicts": dict(self._failslow_verdict_totals),
            }

    def serve_totals(self) -> dict:
        with self._lock:
            return {
                "outcomes": dict(self._serve_outcome_totals),
                "lost": self._serve_lost_total,
                "deadline_misses": dict(self._serve_deadline_miss_totals),
                "offered_rps": self._serve_offered_rps,
                "queue_depth": dict(self._serve_queue_depth),
                "inflight": dict(self._serve_inflight),
                "goodput_rps": self._serve_goodput,
                "slo": dict(self._serve_slo),
                "handoffs": dict(self._serve_handoff_totals),
            }

    def rollout_totals(self) -> dict[str, int]:
        with self._lock:
            return {
                "resumes": self._rollout_resumes_total,
                "lease_transitions": self._rollout_lease_transitions_total,
                "fenced_writes": self._rollout_fenced_writes_total,
                "slo_pauses": self._rollout_slo_pauses_total,
            }

    def _accumulate(self, m: ReconcileMetrics) -> None:
        with self._lock:
            self._result_totals[m.result] = self._result_totals.get(m.result, 0) + 1
            for p in m.phases:
                tot = self._phase_totals.setdefault((m.mode, p.name), [0.0, 0])
                tot[0] += p.seconds
                tot[1] += 1
        for p in m.phases:
            self.observe_phase(m.mode, p.name, p.seconds)
        if m.phases:
            # Pipelined transitions: phases that ran concurrently sum to
            # more than the reconcile's wall time; the difference is the
            # overlap the pipeline saved (0 when fully serialized).
            self.set_phase_overlap_seconds(
                sum(p.seconds for p in m.phases) - m.total_seconds
            )

    def result_totals(self) -> dict[str, int]:
        with self._lock:
            return dict(self._result_totals)

    def failure_totals(self) -> dict[str, int]:
        with self._lock:
            return dict(self._failure_totals)

    @property
    def history(self) -> list[ReconcileMetrics]:
        with self._lock:
            return list(self._history)

    def last(self) -> ReconcileMetrics | None:
        with self._lock:
            return self._history[-1] if self._history else None

    def render_prometheus(self) -> str:
        """Render the registry in Prometheus text exposition format."""
        lines = [
            "# HELP tpu_cc_reconcile_seconds Total seconds for the most recent reconcile.",
            "# TYPE tpu_cc_reconcile_seconds gauge",
        ]
        last = self.last()
        if last is not None:
            lines.append(
                "tpu_cc_reconcile_seconds%s %.3f"
                % (_labels(mode=last.mode, result=last.result), last.total_seconds)
            )
            lines.append("# HELP tpu_cc_last_phase_seconds Seconds per phase of the most recent reconcile.")
            lines.append("# TYPE tpu_cc_last_phase_seconds gauge")
            for p in last.phases:
                lines.append(
                    "tpu_cc_last_phase_seconds%s %.3f"
                    % (
                        _labels(mode=last.mode, phase=p.name, ok=str(p.ok).lower()),
                        p.seconds,
                    )
                )
        lines.append("# HELP tpu_cc_reconciles_total Reconciles since process start.")
        lines.append("# TYPE tpu_cc_reconciles_total counter")
        with self._lock:
            result_totals = dict(self._result_totals)
            phase_totals = {k: list(v) for k, v in self._phase_totals.items()}
            phase_hist = {k: list(v) for k, v in self._phase_hist.items()}
            failure_totals = dict(self._failure_totals)
            retry_totals = dict(self._retry_totals)
            breaker_states = dict(self._breaker_states)
            health_tier = self._health_tier
            runtime_healthy = self._runtime_healthy
            quarantined = self._quarantined
            remediation_totals = dict(self._remediation_totals)
            barrier_fenced_total = self._barrier_fenced_total
            rollout_resumes = self._rollout_resumes_total
            rollout_transitions = self._rollout_lease_transitions_total
            rollout_fenced = self._rollout_fenced_writes_total
            federation_syncs = dict(self._federation_sync_totals)
            federation_fences = dict(self._federation_fence_totals)
            federation_budget_spent = self._federation_budget_spent
            federation_offline_seconds = self._federation_offline_seconds
            federation_escrow_reserved = self._federation_escrow_reserved
            federation_escrow_spent = self._federation_escrow_spent
            apiserver_connected = self._apiserver_connected
            offline_seconds = self._offline_seconds
            journal_replays = dict(self._journal_replay_totals)
            deferred_patches = self._deferred_patch_total
            apiserver_requests = dict(self._apiserver_request_totals)
            preemption_totals = dict(self._preemption_totals)
            node_adoptions = self._node_adoptions_total
            fast_drain_seconds = self._fast_drain_seconds
            phase_overlap_seconds = self._phase_overlap_seconds
            smoke_fastpath_totals = dict(self._smoke_fastpath_totals)
            serve_hist = {k: list(v) for k, v in self._serve_hist.items()}
            serve_hist_sum = dict(self._serve_hist_sum)
            serve_queue_depth = dict(self._serve_queue_depth)
            serve_inflight = dict(self._serve_inflight)
            serve_hbm_bw_util = dict(self._serve_hbm_bw_util)
            prestage_in_progress = self._prestage_in_progress
            serve_outcomes = dict(self._serve_outcome_totals)
            serve_lost = self._serve_lost_total
            serve_deadline_misses = dict(self._serve_deadline_miss_totals)
            serve_offered = self._serve_offered_rps
            rollout_slo_pauses = self._rollout_slo_pauses_total
            serve_goodput = self._serve_goodput
            serve_slo = dict(self._serve_slo)
            serve_handoffs = dict(self._serve_handoff_totals)
            spare_prestage_seconds = self._spare_prestage_seconds
            prestage_reserved = self._prestage_reserved
            prestage_headroom = self._prestage_headroom_nodes
            prestage_totals = dict(self._prestage_totals)
            failslow_suspect = dict(self._failslow_suspect)
            failslow_deviation = dict(self._failslow_deviation)
            failslow_verdicts = dict(self._failslow_verdict_totals)
        for result in ("ok", "failed", "noop"):
            lines.append(
                "tpu_cc_reconciles_total%s %d"
                % (_labels(result=result), result_totals.get(result, 0))
            )
        lines.append(
            "# HELP tpu_cc_failures_total Failed reconciles by machine-"
            "readable reason (the failed.reason node label)."
        )
        lines.append("# TYPE tpu_cc_failures_total counter")
        for reason in sorted(failure_totals):
            lines.append(
                "tpu_cc_failures_total%s %d"
                % (_labels(reason=reason), failure_totals[reason])
            )
        if retry_totals:
            lines.append(
                "# HELP tpu_cc_retries_total Retries through the shared "
                "backoff policy (utils/retry.py), by operation and reason."
            )
            lines.append("# TYPE tpu_cc_retries_total counter")
            for (op, reason), count in sorted(retry_totals.items()):
                lines.append(
                    "tpu_cc_retries_total%s %d"
                    % (_labels(op=op, reason=reason), count)
                )
        if breaker_states:
            lines.append(
                "# HELP tpu_cc_breaker_state Circuit breaker state per "
                "dependency path (0=closed, 1=half_open, 2=open)."
            )
            lines.append("# TYPE tpu_cc_breaker_state gauge")
            state_value = {"closed": 0, "half_open": 1, "open": 2}
            for name in sorted(breaker_states):
                lines.append(
                    "tpu_cc_breaker_state%s %d"
                    % (
                        _labels(path=name),
                        state_value.get(breaker_states[name], 2),
                    )
                )
        if health_tier is not None:
            tier, strength = health_tier
            lines.append(
                "# HELP tpu_cc_health_probe_tier Active runtime-health probe "
                "tier; the value is the tier's strength rank (higher = "
                "stronger signal; 1 = bare device-node existence)."
            )
            lines.append("# TYPE tpu_cc_health_probe_tier gauge")
            lines.append(
                "tpu_cc_health_probe_tier%s %d" % (_labels(tier=tier), strength)
            )
        if runtime_healthy is not None:
            lines.append(
                "# HELP tpu_cc_runtime_healthy Last watchdog probe verdict "
                "(1 = healthy)."
            )
            lines.append("# TYPE tpu_cc_runtime_healthy gauge")
            lines.append(
                "tpu_cc_runtime_healthy %d" % (1 if runtime_healthy else 0)
            )
        if quarantined is not None:
            lines.append(
                "# HELP tpu_cc_quarantined Whether this node is quarantined "
                "by the remediation ladder (1 = quarantined)."
            )
            lines.append("# TYPE tpu_cc_quarantined gauge")
            lines.append("tpu_cc_quarantined %d" % (1 if quarantined else 0))
        if remediation_totals:
            lines.append(
                "# HELP tpu_cc_remediation_step_total Remediation-ladder "
                "actions by step and outcome (ccmanager/remediation.py)."
            )
            lines.append("# TYPE tpu_cc_remediation_step_total counter")
            for (step, outcome), count in sorted(remediation_totals.items()):
                lines.append(
                    "tpu_cc_remediation_step_total%s %d"
                    % (_labels(step=step, outcome=outcome), count)
                )
        if barrier_fenced_total:
            lines.append(
                "# HELP tpu_cc_barrier_fenced_total Slice barrier rounds "
                "aborted with a fencing generation (peers fail fast "
                "instead of burning the barrier deadline)."
            )
            lines.append("# TYPE tpu_cc_barrier_fenced_total counter")
            lines.append(
                "tpu_cc_barrier_fenced_total %d" % barrier_fenced_total
            )
        if rollout_resumes or rollout_transitions or rollout_fenced:
            lines.append(
                "# HELP tpu_cc_rollout_resumes_total Pool rollouts resumed "
                "from a persisted record (a successor picking up a dead "
                "orchestrator's checkpoint)."
            )
            lines.append("# TYPE tpu_cc_rollout_resumes_total counter")
            lines.append(
                "tpu_cc_rollout_resumes_total %d" % rollout_resumes
            )
            lines.append(
                "# HELP tpu_cc_rollout_lease_transitions_total Rollout-"
                "lease acquisitions/takeovers (the fencing token "
                "increments with each)."
            )
            lines.append("# TYPE tpu_cc_rollout_lease_transitions_total counter")
            lines.append(
                "tpu_cc_rollout_lease_transitions_total %d"
                % rollout_transitions
            )
            lines.append(
                "# HELP tpu_cc_rollout_fenced_writes_total Writes refused "
                "because the rollout lease was lost (stale orchestrator "
                "stopped by the fence)."
            )
            lines.append("# TYPE tpu_cc_rollout_fenced_writes_total counter")
            lines.append(
                "tpu_cc_rollout_fenced_writes_total %d" % rollout_fenced
            )
        if federation_syncs:
            lines.append(
                "# HELP tpu_cc_federation_syncs_total Regional shard "
                "exchanges with the federated parent record by outcome "
                "(ok / fenced; ccmanager/federation.py)."
            )
            lines.append("# TYPE tpu_cc_federation_syncs_total counter")
            for outcome in sorted(federation_syncs):
                lines.append(
                    "tpu_cc_federation_syncs_total%s %d"
                    % (_labels(outcome=outcome), federation_syncs[outcome])
                )
        if federation_fences:
            lines.append(
                "# HELP tpu_cc_federation_fences_total Hierarchical fence "
                "refusals by reason (parent-generation after a force-"
                "abort, parent-aborted when the federation was discarded)."
            )
            lines.append("# TYPE tpu_cc_federation_fences_total counter")
            for reason in sorted(federation_fences):
                lines.append(
                    "tpu_cc_federation_fences_total%s %d"
                    % (_labels(reason=reason), federation_fences[reason])
                )
        if federation_budget_spent is not None:
            lines.append(
                "# HELP tpu_cc_federation_budget_spent Global failure-"
                "budget spend (distinct node names charged across every "
                "region) this shard last read off the parent record."
            )
            lines.append("# TYPE tpu_cc_federation_budget_spent gauge")
            lines.append(
                "tpu_cc_federation_budget_spent %d" % federation_budget_spent
            )
        if federation_offline_seconds is not None:
            lines.append(
                "# HELP tpu_cc_federation_offline_seconds How long the "
                "current PARENT-plane blackout has lasted for this "
                "regional shard (0 when the last parent sync landed; "
                "degraded mode engages past CC_FEDERATION_OFFLINE_GRACE_S)."
            )
            lines.append("# TYPE tpu_cc_federation_offline_seconds gauge")
            lines.append(
                "tpu_cc_federation_offline_seconds %.3f"
                % federation_offline_seconds
            )
        if federation_escrow_reserved is not None:
            lines.append(
                "# HELP tpu_cc_federation_escrow_reserved This shard's "
                "escrowed slice of the global failure budget — what it "
                "may charge autonomously while the parent plane is dark."
            )
            lines.append("# TYPE tpu_cc_federation_escrow_reserved gauge")
            lines.append(
                "tpu_cc_federation_escrow_reserved %d"
                % federation_escrow_reserved
            )
        if federation_escrow_spent is not None:
            lines.append(
                "# HELP tpu_cc_federation_escrow_spent Dark charges "
                "pending reconciliation against the escrowed slice (0 "
                "once a reconnect sync union-merges them into the global "
                "ledger)."
            )
            lines.append("# TYPE tpu_cc_federation_escrow_spent gauge")
            lines.append(
                "tpu_cc_federation_escrow_spent %d" % federation_escrow_spent
            )
        if apiserver_connected is not None:
            lines.append(
                "# HELP tpu_cc_apiserver_connected Whether the last "
                "apiserver interaction succeeded (0 = total outage; the "
                "disconnected-mode ladder is engaged once the outage "
                "outlasts CC_OFFLINE_GRACE_S)."
            )
            lines.append("# TYPE tpu_cc_apiserver_connected gauge")
            lines.append(
                "tpu_cc_apiserver_connected %d"
                % (1 if apiserver_connected else 0)
            )
        if offline_seconds is not None:
            lines.append(
                "# HELP tpu_cc_offline_seconds How long the current total "
                "apiserver outage has lasted (0 when connected)."
            )
            lines.append("# TYPE tpu_cc_offline_seconds gauge")
            lines.append("tpu_cc_offline_seconds %.3f" % offline_seconds)
        if journal_replays:
            lines.append(
                "# HELP tpu_cc_journal_replays_total Intent-journal replay "
                "resolutions by outcome (completed / rolled-back / clean / "
                "failed-closed; ccmanager/intent_journal.py)."
            )
            lines.append("# TYPE tpu_cc_journal_replays_total counter")
            for outcome in sorted(journal_replays):
                lines.append(
                    "tpu_cc_journal_replays_total%s %d"
                    % (_labels(outcome=outcome), journal_replays[outcome])
                )
        if deferred_patches:
            lines.append(
                "# HELP tpu_cc_journal_deferred_patches_total Node-label "
                "writes deferred into the intent journal while the "
                "apiserver was unreachable (flushed on reconnect)."
            )
            lines.append(
                "# TYPE tpu_cc_journal_deferred_patches_total counter"
            )
            lines.append(
                "tpu_cc_journal_deferred_patches_total %d" % deferred_patches
            )
        if preemption_totals:
            lines.append(
                "# HELP tpu_cc_preemptions_total Platform preemption "
                "notices handled, by outcome (handoff / clean / resumed / "
                "handoff-failed; docs/operations.md \"Preemption, "
                "autoscaler & surge\")."
            )
            lines.append("# TYPE tpu_cc_preemptions_total counter")
            for outcome in sorted(preemption_totals):
                lines.append(
                    "tpu_cc_preemptions_total%s %d"
                    % (_labels(outcome=outcome), preemption_totals[outcome])
                )
        if node_adoptions:
            lines.append(
                "# HELP tpu_cc_node_adoptions_total Nodes created mid-"
                "rollout (autoscaler scale-up) adopted into a trailing "
                "rollout wave."
            )
            lines.append("# TYPE tpu_cc_node_adoptions_total counter")
            lines.append(
                "tpu_cc_node_adoptions_total %d" % node_adoptions
            )
        if fast_drain_seconds is not None:
            lines.append(
                "# HELP tpu_cc_fast_drain_seconds Duration of the most "
                "recent preemption fast-drain (checkpoint handshake + "
                "compressed eviction) against the hard termination "
                "deadline."
            )
            lines.append("# TYPE tpu_cc_fast_drain_seconds gauge")
            lines.append(
                "tpu_cc_fast_drain_seconds %.3f" % fast_drain_seconds
            )
        if phase_overlap_seconds is not None:
            lines.append(
                "# HELP tpu_cc_phase_overlap_seconds Seconds the most "
                "recent reconcile saved by overlapping phases (sum of "
                "phase latencies minus wall time; pipelined transitions)."
            )
            lines.append("# TYPE tpu_cc_phase_overlap_seconds gauge")
            lines.append(
                "tpu_cc_phase_overlap_seconds %.3f" % phase_overlap_seconds
            )
        if smoke_fastpath_totals:
            lines.append(
                "# HELP tpu_cc_smoke_fastpath_total Attestation-digest "
                "smoke fast-path decisions by outcome (hit = smoke "
                "skipped on an unchanged verified digest, miss = digest "
                "changed so the full smoke ran, cold = no digest on "
                "record; CC_SMOKE_DIGEST_FAST_PATH)."
            )
            lines.append("# TYPE tpu_cc_smoke_fastpath_total counter")
            for outcome in sorted(smoke_fastpath_totals):
                lines.append(
                    "tpu_cc_smoke_fastpath_total%s %d"
                    % (_labels(outcome=outcome), smoke_fastpath_totals[outcome])
                )
        if apiserver_requests:
            lines.append(
                "# HELP tpu_cc_apiserver_requests_total Apiserver HTTP "
                "round trips by verb (kubeclient; retries included — the "
                "QPS the server actually absorbs)."
            )
            lines.append("# TYPE tpu_cc_apiserver_requests_total counter")
            for verb in sorted(apiserver_requests):
                lines.append(
                    "tpu_cc_apiserver_requests_total%s %d"
                    % (_labels(verb=verb), apiserver_requests[verb])
                )
        if serve_hist:
            lines.append(
                "# HELP tpu_cc_serve_request_seconds End-to-end serving "
                "request latency per node (submission to completion, "
                "checkpoint bounces included — what the user saw)."
            )
            lines.append("# TYPE tpu_cc_serve_request_seconds histogram")
            for node in sorted(serve_hist):
                hist = serve_hist[node]
                for i, bound in enumerate(SERVE_HISTOGRAM_BUCKETS):
                    lines.append(
                        "tpu_cc_serve_request_seconds_bucket%s %d"
                        % (_labels(node=node, le=_bucket_le(bound)), hist[i])
                    )
                lines.append(
                    "tpu_cc_serve_request_seconds_bucket%s %d"
                    % (_labels(node=node, le="+Inf"), hist[-1])
                )
                lines.append(
                    "tpu_cc_serve_request_seconds_sum%s %.6f"
                    % (_labels(node=node), serve_hist_sum.get(node, 0.0))
                )
                lines.append(
                    "tpu_cc_serve_request_seconds_count%s %d"
                    % (_labels(node=node), hist[-1])
                )
        if serve_queue_depth:
            lines.append(
                "# HELP tpu_cc_serve_queue_depth Requests accepted but "
                "not yet executing on a node."
            )
            lines.append("# TYPE tpu_cc_serve_queue_depth gauge")
            for node in sorted(serve_queue_depth):
                lines.append(
                    "tpu_cc_serve_queue_depth%s %d"
                    % (_labels(node=node), serve_queue_depth[node])
                )
        if serve_inflight:
            lines.append(
                "# HELP tpu_cc_serve_inflight Requests in the executing "
                "batch on a node."
            )
            lines.append("# TYPE tpu_cc_serve_inflight gauge")
            for node in sorted(serve_inflight):
                lines.append(
                    "tpu_cc_serve_inflight%s %d"
                    % (_labels(node=node), serve_inflight[node])
                )
        if serve_hbm_bw_util:
            lines.append(
                "# HELP tpu_cc_hbm_bw_util Last observed HBM bandwidth "
                "utilization (0..1) per node — the serve driver's batch-"
                "ladder signal; the fleet capacity ledger judges headroom "
                "against its ceiling."
            )
            lines.append("# TYPE tpu_cc_hbm_bw_util gauge")
            for node in sorted(serve_hbm_bw_util):
                lines.append(
                    "tpu_cc_hbm_bw_util%s %.6f"
                    % (_labels(node=node), serve_hbm_bw_util[node])
                )
        if prestage_in_progress is not None:
            lines.append(
                "# HELP tpu_cc_prestage_in_progress Whether a spare pre-"
                "stage (annotation-driven flip + warmup ahead of a rollout "
                "wave) is running on this agent (1) or not (0) — a "
                "prestaging node is warming, not serving headroom."
            )
            lines.append("# TYPE tpu_cc_prestage_in_progress gauge")
            lines.append(
                "tpu_cc_prestage_in_progress %d"
                % (1 if prestage_in_progress else 0)
            )
        if serve_outcomes:
            lines.append(
                "# HELP tpu_cc_serve_requests_total Serving request "
                "dispositions per node: completed, bounced (checkpoint-"
                "and-requeued by a drain with progress intact), requeued "
                "(returned unsubmitted after losing the submit race)."
            )
            lines.append("# TYPE tpu_cc_serve_requests_total counter")
            for (node, outcome), count in sorted(serve_outcomes.items()):
                lines.append(
                    "tpu_cc_serve_requests_total%s %d"
                    % (_labels(node=node, outcome=outcome), count)
                )
        if serve_lost:
            lines.append(
                "# HELP tpu_cc_serve_lost_total Requests that never "
                "completed after traffic stopped and the grace drain "
                "expired (the zero-loss serving contract's violation "
                "counter)."
            )
            lines.append("# TYPE tpu_cc_serve_lost_total counter")
            lines.append("tpu_cc_serve_lost_total %d" % serve_lost)
        if serve_deadline_misses:
            lines.append(
                "# HELP tpu_cc_serve_deadline_miss_total Accepted "
                "requests that completed past their deadline, per node "
                "(separate from outcome=shed — the deliberate refusal at "
                "intake; a miss is the broken promise)."
            )
            lines.append("# TYPE tpu_cc_serve_deadline_miss_total counter")
            for node in sorted(serve_deadline_misses):
                lines.append(
                    "tpu_cc_serve_deadline_miss_total%s %d"
                    % (_labels(node=node), serve_deadline_misses[node])
                )
        if serve_offered is not None:
            lines.append(
                "# HELP tpu_cc_serve_offered_rps Open-loop offered "
                "(scheduled) arrival rate — the load the pool was asked "
                "to absorb, which goodput is judged against."
            )
            lines.append("# TYPE tpu_cc_serve_offered_rps gauge")
            lines.append("tpu_cc_serve_offered_rps %.3f" % serve_offered)
        if serve_handoffs:
            lines.append(
                "# HELP tpu_cc_serve_handoffs_total Parked in-flight "
                "requests a draining node handed to the driver's "
                "migration sink, by outcome (accepted = re-dispatched "
                "to an accepting peer inside the ack window; fallback = "
                "no accepting peer, local requeue)."
            )
            lines.append("# TYPE tpu_cc_serve_handoffs_total counter")
            for outcome in sorted(serve_handoffs):
                lines.append(
                    "tpu_cc_serve_handoffs_total%s %d"
                    % (_labels(outcome=outcome), serve_handoffs[outcome])
                )
        if spare_prestage_seconds is not None:
            lines.append(
                "# HELP tpu_cc_spare_prestage_seconds Duration of the "
                "most recent spare pre-staging (annotation-driven full "
                "flip + compile warmup run ahead of the rollout wave "
                "that needs the spare)."
            )
            lines.append("# TYPE tpu_cc_spare_prestage_seconds gauge")
            lines.append(
                "tpu_cc_spare_prestage_seconds %.3f" % spare_prestage_seconds
            )
        if rollout_slo_pauses:
            lines.append(
                "# HELP tpu_cc_rollout_slo_pauses_total Rollout waves "
                "paused by the SLO gate at a wave boundary (error-budget "
                "burn or p99 above target; ccmanager/rolling.py)."
            )
            lines.append("# TYPE tpu_cc_rollout_slo_pauses_total counter")
            lines.append(
                "tpu_cc_rollout_slo_pauses_total %d" % rollout_slo_pauses
            )
        if prestage_reserved is not None:
            lines.append(
                "# HELP tpu_cc_prestage_reserved Capacity-ledger entries "
                "currently in prestage transition (reserved or armed; a "
                "held entry's node serves at target mode and costs no "
                "headroom) — ccmanager/rolling.py continuous prestage."
            )
            lines.append("# TYPE tpu_cc_prestage_reserved gauge")
            lines.append("tpu_cc_prestage_reserved %d" % prestage_reserved)
        if prestage_headroom is not None:
            lines.append(
                "# HELP tpu_cc_prestage_headroom_nodes Prestage allowance "
                "the headroom gate last granted: whole nodes of slack "
                "under the serving knee, capped at max_unavailable "
                "(serve/sweep.py knee_slack_nodes)."
            )
            lines.append("# TYPE tpu_cc_prestage_headroom_nodes gauge")
            lines.append(
                "tpu_cc_prestage_headroom_nodes %d" % prestage_headroom
            )
        if prestage_totals:
            lines.append(
                "# HELP tpu_cc_prestage_total Continuous-prestage "
                "lifecycle steps by outcome (reserved/armed/held/"
                "converged/invalidated/degraded/paused/aborted) — the "
                "ledger balances when charges equal releases."
            )
            lines.append("# TYPE tpu_cc_prestage_total counter")
            for outcome in sorted(prestage_totals):
                lines.append(
                    "tpu_cc_prestage_total%s %d"
                    % (_labels(outcome=outcome), prestage_totals[outcome])
                )
        if serve_goodput is not None:
            lines.append(
                "# HELP tpu_cc_serve_goodput_rps Completed requests per "
                "second over the SLO window."
            )
            lines.append("# TYPE tpu_cc_serve_goodput_rps gauge")
            lines.append("tpu_cc_serve_goodput_rps %.3f" % serve_goodput)
        if serve_slo:
            lines.append(
                "# HELP tpu_cc_serve_slo_p99_seconds Rolling-window p99 "
                "request latency (obs/slo.py; absent while the window "
                "is empty)."
            )
            lines.append("# TYPE tpu_cc_serve_slo_p99_seconds gauge")
            p99_lines = [
                "tpu_cc_serve_slo_p99_seconds%s %.6f"
                % (_labels(window=_bucket_le(w)), p99)
                for w, (p99, _burn) in sorted(serve_slo.items())
                if p99 is not None
            ]
            lines.extend(p99_lines)
            lines.append(
                "# HELP tpu_cc_serve_error_budget_burn Error-budget burn "
                "rate over the rolling window (error rate / budget; 1.0 "
                "= spending exactly as provisioned — the halt signal a "
                "latency-gated rollout polls)."
            )
            lines.append("# TYPE tpu_cc_serve_error_budget_burn gauge")
            for w, (_p99, burn) in sorted(serve_slo.items()):
                lines.append(
                    "tpu_cc_serve_error_budget_burn%s %.6f"
                    % (_labels(window=_bucket_le(w)), burn)
                )
        if failslow_suspect:
            lines.append(
                "# HELP tpu_cc_failslow_suspect Whether peer-relative "
                "fail-slow vetting currently suspects this node of a "
                "gray failure (obs/failslow.py; 1 = >= 1 strike or "
                "confirmed — the watchdog probe can be green "
                "throughout)."
            )
            lines.append("# TYPE tpu_cc_failslow_suspect gauge")
            for node in sorted(failslow_suspect):
                lines.append(
                    "tpu_cc_failslow_suspect%s %d"
                    % (_labels(node=node), 1 if failslow_suspect[node] else 0)
                )
        if failslow_deviation:
            lines.append(
                "# HELP tpu_cc_failslow_deviation Last vetting window's "
                "peer-relative deviation ratio per node (window median "
                "/ fleet median-of-medians; 1.0 = moving with the "
                "fleet, confirm threshold defaults to 2.0)."
            )
            lines.append("# TYPE tpu_cc_failslow_deviation gauge")
            for node in sorted(failslow_deviation):
                lines.append(
                    "tpu_cc_failslow_deviation%s %.4f"
                    % (_labels(node=node), failslow_deviation[node])
                )
        if failslow_verdicts:
            lines.append(
                "# HELP tpu_cc_failslow_verdicts_total Concluded "
                "fail-slow verdicts by node and verdict (confirmed = "
                "sustained deviation, feeds the remediation ladder; "
                "cleared = recovered below the clear threshold)."
            )
            lines.append("# TYPE tpu_cc_failslow_verdicts_total counter")
            for (node, verdict), count in sorted(failslow_verdicts.items()):
                lines.append(
                    "tpu_cc_failslow_verdicts_total%s %d"
                    % (_labels(node=node, verdict=verdict), count)
                )
        # The cumulative per-phase sums/counts are served exclusively as
        # the histogram's _sum/_count series below — separate
        # tpu_cc_phase_seconds_total/_runs_total counters would duplicate
        # them AND collide with the histogram family name under
        # OpenMetrics (where a counter named X_total belongs to family X).
        lines.append(
            "# HELP tpu_cc_phase_seconds Per-phase latency histogram "
            "(fixed buckets around the 90 s SLO)."
        )
        lines.append("# TYPE tpu_cc_phase_seconds histogram")
        for (mode, phase), hist in sorted(phase_hist.items()):
            total_s = phase_totals.get((mode, phase), [0.0, 0])[0]
            for i, bound in enumerate(HISTOGRAM_BUCKETS):
                lines.append(
                    "tpu_cc_phase_seconds_bucket%s %d"
                    % (
                        _labels(mode=mode, phase=phase, le=_bucket_le(bound)),
                        hist[i],
                    )
                )
            lines.append(
                "tpu_cc_phase_seconds_bucket%s %d"
                % (_labels(mode=mode, phase=phase, le="+Inf"), hist[-1])
            )
            lines.append(
                "tpu_cc_phase_seconds_sum%s %.3f"
                % (_labels(mode=mode, phase=phase), total_s)
            )
            lines.append(
                "tpu_cc_phase_seconds_count%s %d"
                % (_labels(mode=mode, phase=phase), hist[-1])
            )
        return "\n".join(lines) + "\n"


REGISTRY = MetricsRegistry()
