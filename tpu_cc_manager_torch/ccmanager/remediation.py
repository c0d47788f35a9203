"""Failure containment: the per-node remediation escalation ladder.

The reference's only answer to a failed mode flip is a ``failed`` label and
an operator page (main.py:499-581); the agent added retries, breakers and a
health watchdog — but a *terminally* failing node still backoff-retried
forever, stayed eligible for rollouts and pool attestation, and kept its
ICI peers burning full barrier deadlines. This module adds the missing
layer: isolate a bad node fast, keep the rest of the pool converging.

The ladder, per node::

    backoff-retry  ->  device-reset  ->  runtime-restart  ->  quarantine

Each rung gets ``failures_per_step`` consecutive failed reconciles before
the ladder escalates; any successful reconcile resets it. The first rung
is the manager's existing backoff retry (no extra action); ``device-reset``
re-resets the chip set, ``runtime-restart`` bounces the TPU runtime
(:meth:`NodeBackend.restart_runtime`), and ``quarantine`` is terminal:

- a ``NoSchedule`` taint (:data:`~tpu_cc_manager_torch.labels.QUARANTINE_TAINT_KEY`)
  keeps new workloads off the node,
- the :data:`~tpu_cc_manager_torch.labels.QUARANTINED_LABEL` label makes the
  rolling orchestrator and pool attestation skip it (and the pool failure
  budget count it),
- ``cc.ready.state`` flips to ``false`` and a ``CCNodeQuarantined`` event
  is emitted,
- if the node is part of a multi-host slice, the slice barrier is aborted
  with a new fencing generation (slicecoord.fence_slice) so peers fail
  fast instead of timing out.

Ladder state (failure count, current step, quarantine flag) is persisted
in a node annotation, so a DaemonSet crash-restart resumes the ladder
instead of restarting it from rung zero — a terminally bad node cannot
dodge quarantine by crashing the agent.

Quarantine auto-lifts after a **probation window**: the health watchdog's
probes feed :meth:`RemediationLadder.note_probe`, and once the runtime has
reported healthy continuously for ``probation_s`` the taint/label are
removed, ready state is restored from the current mode.state, and the
ladder resets (``CCNodeUnquarantined`` event). Operators can force either
edge with ``tpu-cc-ctl quarantine`` / ``unquarantine``.
"""

from __future__ import annotations

import json
import logging
import time
from typing import Callable

from tpu_cc_manager_torch.ccmanager import intent_journal as intent_mod
from tpu_cc_manager_torch.ccmanager import slicecoord
from tpu_cc_manager_torch.kubeclient.api import (
    KubeApi,
    KubeApiError,
    node_annotations,
    node_labels,
)
from tpu_cc_manager_torch import labels as labels_mod
from tpu_cc_manager_torch.labels import (
    CC_MODE_STATE_LABEL,
    CC_READY_STATE_LABEL,
    QUARANTINE_TAINT_KEY,
    QUARANTINED_LABEL,
    SLICE_ID_LABEL,
    label_safe,
    ready_state_for,
)
from tpu_cc_manager_torch.ccmanager.node import NodeBackend, GpuError
from tpu_cc_manager_torch.utils import metrics as metrics_mod
from tpu_cc_manager_torch.utils import locks as locks_mod

log = logging.getLogger(__name__)

#: Ladder rungs, mild to terminal.
STEP_RETRY = "backoff-retry"
STEP_DEVICE_RESET = "device-reset"
STEP_RUNTIME_RESTART = "runtime-restart"
STEP_QUARANTINE = "quarantine"
STEPS = (STEP_RETRY, STEP_DEVICE_RESET, STEP_RUNTIME_RESTART, STEP_QUARANTINE)

#: Node annotation carrying the persisted ladder state (JSON). Wire name
#: centralized in labels.py (cclint surface contract); re-exported here.
REMEDIATION_ANNOTATION = labels_mod.REMEDIATION_ANNOTATION

#: Failure reasons that say nothing about THIS node's hardware: a fenced
#: or timed-out barrier is a PEER's failure (escalating here would cascade
#: one bad host into device resets and quarantine of its healthy
#: slice-mates), and an apiserver outage is nobody's hardware fault.
#: These never climb the ladder.
NON_ESCALATING_REASONS = frozenset({
    "barrier-fenced",
    "barrier-timeout",
    "apiserver-error",
})

#: Failure reasons that climb the ladder but must NOT trigger the
#: hardware rungs' actions: a drain timeout means workloads are still on
#: the chips — resetting them out from under the pods would destroy the
#: exact guarantee strict eviction refused to break. Sustained drain
#: failure still ends in quarantine (stop scheduling onto a node that
#: cannot drain), just without intermediate resets.
NO_HARDWARE_ACTION_REASONS = frozenset({"drain-timeout"})

QUARANTINE_TAINT = {
    "key": QUARANTINE_TAINT_KEY,
    "value": "true",
    "effect": "NoSchedule",
}

DEFAULT_FAILURES_PER_STEP = 2
DEFAULT_PROBATION_S = 300.0


def quarantined_nodes(nodes: list[dict]) -> list[str]:
    """Names of quarantined nodes in a listing, sorted (the rolling
    orchestrator's skip/budget predicate; pool attestation checks the
    label per-node inline while walking each node's labels anyway)."""
    return sorted(
        n["metadata"]["name"]
        for n in nodes
        if node_labels(n).get(QUARANTINED_LABEL) == "true"
    )


class RemediationLadder:
    """One node's escalating remediation state machine.

    ``emit_event`` matches CCManager._emit_node_event's signature; all
    label/taint writes are best-effort-logged but quarantine is only
    *recorded* when the label write (the part every consumer keys on)
    landed.
    """

    def __init__(
        self,
        api: KubeApi,
        node_name: str,
        backend: NodeBackend | None = None,
        failures_per_step: int = DEFAULT_FAILURES_PER_STEP,
        probation_s: float = DEFAULT_PROBATION_S,
        emit_event: Callable[[str, str, str], None] | None = None,
        metrics: metrics_mod.MetricsRegistry | None = None,
        clock: Callable[[], float] = time.monotonic,
        intents: "intent_mod.IntentJournal | None" = None,
    ) -> None:
        self.api = api
        self.node_name = node_name
        self.backend = backend
        # Node-local intent WAL: the hardware rungs journal a
        # KIND_REMEDIATION intent BEFORE touching the device (the cclint
        # journal-before-reset contract). None = unjournaled (tests,
        # CC_INTENT_JOURNAL=0), matching the manager's own degradation.
        self.intents = intents
        self.failures_per_step = max(1, failures_per_step)
        self.probation_s = probation_s
        self.emit_event = emit_event or (lambda *_: None)
        self.metrics = metrics if metrics is not None else metrics_mod.REGISTRY
        self.clock = clock
        self.failures = 0  # cclint: guarded-by(_lock)
        self.step = STEP_RETRY  # cclint: guarded-by(_lock)
        self.quarantined = False  # cclint: guarded-by(_lock)
        self.last_reason = ""  # cclint: guarded-by(_lock)
        # Confirmed fail-slow verdicts acted on (obs/failslow.py feed):
        # a NON-probe signal ladder — verdict 1 restarts the runtime,
        # verdict 2 quarantines reason=fail-slow. Persisted with the
        # rest of the ladder so an agent restart mid-escalation cannot
        # reset a gray node back to the cheap rung. Cleared when the
        # peer-relative stats recover (note_failslow_recovered) or on
        # unquarantine.
        self.failslow_signals = 0  # cclint: guarded-by(_lock)
        # Probation: monotonic timestamp of the first healthy probe of the
        # current healthy streak while quarantined; None = not in a streak.
        # In-memory only — an agent restart restarts probation, which errs
        # conservative (a crashing agent is itself a bad sign).
        self._healthy_since: float | None = None  # cclint: guarded-by(_lock)
        # The ladder is mutated from two threads — the watch loop
        # (note_failure/note_success) and the watchdog (note_probe →
        # unquarantine) — so every public mutator holds this lock; a
        # probation lift can no longer interleave with a failure note.
        self._lock = locks_mod.make_rlock("remediation")
        # Whether the persisted state has been read successfully; a failed
        # startup load is retried lazily so a quarantined node cannot slip
        # back to reconciling through one apiserver blip at boot.
        self._loaded = False
        self._load()
        self.metrics.set_quarantined(self.quarantined)

    # -- persistence -------------------------------------------------------

    def _load(self) -> None:  # cclint: requires(_lock)
        """Resume ladder state from the node annotation (agent restart must
        not reset a terminally bad node back to rung zero)."""
        try:
            raw = node_annotations(self.api.get_node(self.node_name)).get(
                REMEDIATION_ANNOTATION
            )
        except KubeApiError as e:
            log.warning(
                "remediation: could not load ladder state (%s); will retry "
                "before acting", e,
            )
            return
        self._loaded = True
        if not raw:
            return
        try:
            state = json.loads(raw)
            self.failures = int(state.get("failures", 0))
            step = str(state.get("step", STEP_RETRY))
            self.step = step if step in STEPS else STEP_RETRY
            self.quarantined = bool(state.get("quarantined", False))
            self.last_reason = str(state.get("reason", ""))
            self.failslow_signals = int(state.get("failslow", 0))
        except (ValueError, TypeError) as e:
            log.warning("remediation: corrupt ladder annotation (%s); reset", e)
            return
        if self.failures or self.quarantined:
            log.info(
                "remediation: resumed ladder state from annotation "
                "(failures=%d step=%s quarantined=%s)",
                self.failures, self.step, self.quarantined,
            )

    def _persist(self) -> None:  # cclint: requires(_lock)
        """Best-effort write-through of the ladder state; a lost write costs
        at most one rung of progress after a crash-restart."""
        value: str | None
        if (
            not self.failures and not self.quarantined
            and not self.failslow_signals
        ):
            value = None  # clean state: drop the annotation entirely
        else:
            value = json.dumps({
                "failures": self.failures,
                "step": self.step,
                "quarantined": self.quarantined,
                "reason": self.last_reason,
                "failslow": self.failslow_signals,
                "ts": int(time.time()),
            }, sort_keys=True)
        try:
            self.api.patch_node_annotations(
                self.node_name, {REMEDIATION_ANNOTATION: value}
            )
        except KubeApiError as e:
            log.warning("remediation: could not persist ladder state: %s", e)

    def _ensure_loaded(self) -> None:  # cclint: requires(_lock)
        """Lazy retry of a failed startup load: a quarantined node whose
        agent rebooted through an apiserver blip must re-learn its
        quarantine before any ladder decision runs against clean state."""
        if not self._loaded:
            self._load()
            if self._loaded:
                self.metrics.set_quarantined(self.quarantined)

    # -- ladder ------------------------------------------------------------

    def step_for_failures(self, failures: int) -> str:
        """Which rung failure number ``failures`` (1-based) lands on."""
        if failures <= 0:
            return STEP_RETRY
        return STEPS[min((failures - 1) // self.failures_per_step, len(STEPS) - 1)]

    def note_success(self) -> None:
        """A reconcile converged: the ladder resets (quarantine does NOT
        auto-lift here — release goes through probation or the operator)."""
        with self._lock:
            self._ensure_loaded()
            if not self.failures and not self.quarantined:
                return
            if self.quarantined:
                # The mode label may have been reconciled while quarantined;
                # the ladder stays latched until probation/operator lifts.
                return
            log.info(
                "remediation: reconcile succeeded; ladder reset from "
                "(failures=%d step=%s)", self.failures, self.step,
            )
            self.failures = 0
            self.step = STEP_RETRY
            self._persist()

    def note_failure(self, reason: str = "") -> str:
        """One failed reconcile: count it, run the rung's action, persist.
        Returns the rung that ran."""
        with self._lock:
            self._ensure_loaded()
            return self._note_failure_locked(reason)

    def _note_failure_locked(self, reason: str) -> str:  # cclint: requires(_lock)
        if self.quarantined:
            return STEP_QUARANTINE  # already contained; nothing to escalate
        if reason in NON_ESCALATING_REASONS:
            log.info(
                "remediation: failure reason %s is not this node's fault; "
                "ladder not escalated", reason,
            )
            return self.step
        self.failures += 1
        self.last_reason = reason
        step = self.step_for_failures(self.failures)
        escalated = step != self.step
        self.step = step
        outcome = "ok"
        hardware_ok = reason not in NO_HARDWARE_ACTION_REASONS
        try:
            if step == STEP_DEVICE_RESET and hardware_ok:
                self._device_reset()
            elif step == STEP_RUNTIME_RESTART and hardware_ok:
                self._runtime_restart()
            elif step == STEP_QUARANTINE:
                self.quarantine(reason=reason or "remediation-ladder")
            elif not hardware_ok and step in (
                STEP_DEVICE_RESET, STEP_RUNTIME_RESTART
            ):
                # The node cannot drain: a reset would rip the chips out
                # from under still-running workloads (the strict-eviction
                # guarantee). Count the failure, skip the action.
                outcome = "skipped"
        except (GpuError, KubeApiError) as e:
            outcome = "failed"
            log.error(
                "remediation step %s failed on %s: %s", step, self.node_name, e
            )
        self.metrics.record_remediation_step(
            step, "escalated" if escalated and outcome == "ok" else outcome
        )
        if step != STEP_QUARANTINE:
            log.warning(
                "remediation: failure %d (%s) on %s -> step %s (%s)",
                self.failures, reason or "unspecified", self.node_name,
                step, outcome,
            )
        self._persist()
        return step

    def note_failslow(self, deviation: float | None = None) -> str:
        """One CONFIRMED peer-relative fail-slow verdict
        (obs/failslow.py): the gray-failure entry into the ladder.
        Unlike note_failure this is a non-probe signal — the watchdog
        is green throughout, nothing ever errored — so it enters at the
        hardware rungs directly: the first confirmed verdict restarts
        the TPU runtime (the cheapest action that un-wedges a degraded
        runtime), a re-concluded verdict after that quarantines with
        ``reason=fail-slow`` (probation plus recovered peer-relative
        stats lift it). Returns the rung that ran."""
        with self._lock:
            self._ensure_loaded()
            if self.quarantined:
                return STEP_QUARANTINE  # already contained
            self.failslow_signals += 1
            self.last_reason = "fail-slow"
            if self.failslow_signals == 1:
                outcome = "ok"
                try:
                    if self.backend is not None:
                        self._runtime_restart()
                    else:
                        outcome = "skipped"
                except (GpuError, KubeApiError) as e:
                    outcome = "failed"
                    log.error(
                        "remediation: fail-slow runtime restart failed on "
                        "%s: %s", self.node_name, e,
                    )
                self.metrics.record_remediation_step(
                    STEP_RUNTIME_RESTART, outcome
                )
                log.warning(
                    "remediation: fail-slow verdict %d on %s "
                    "(deviation=%s) -> %s (%s)",
                    self.failslow_signals, self.node_name,
                    f"{deviation:.2f}x" if deviation else "n/a",
                    STEP_RUNTIME_RESTART, outcome,
                )
                self._persist()
                return STEP_RUNTIME_RESTART
            self._quarantine_locked(reason="fail-slow", manual=False)
            return STEP_QUARANTINE

    def note_failslow_recovered(self) -> None:
        """The vetter CLEARED the node before the ladder reached
        quarantine (peer-relative stats recovered — e.g. the runtime
        restart fixed it): forget the escalation so the next confirmed
        verdict, if any, starts from the cheap rung again. A
        quarantined node is NOT released here — that goes through
        probation (note_probe) or the operator, same as every other
        quarantine."""
        with self._lock:
            self._ensure_loaded()
            if self.quarantined or not self.failslow_signals:
                return
            log.info(
                "remediation: fail-slow suspicion cleared on %s after %d "
                "verdict(s); escalation reset", self.node_name,
                self.failslow_signals,
            )
            self.failslow_signals = 0
            self._persist()

    def _journal_hardware_intent(self, op: str) -> str | None:
        """Journal-before-reset: a KIND_REMEDIATION intent fsync'd BEFORE
        the rung's disruptive work. No intent record, no hardware action
        (same discipline as the manager's transition bracket); replay of
        an open one simply closes it — the backend's pending markers and
        the persisted ladder annotation already carry recovery."""
        if self.intents is None:
            return None
        try:
            return self.intents.begin(
                intent_mod.KIND_REMEDIATION, op=op, node=self.node_name
            )
        except intent_mod.JournalError as e:
            raise GpuError(
                f"could not journal remediation {op} intent: {e}"
            ) from e

    def _journal_close(self, txn: str | None, ok: bool) -> None:
        if txn is None or self.intents is None:
            return
        try:
            if ok:
                self.intents.commit(txn)
            else:
                self.intents.abort(txn)
        except intent_mod.JournalError as e:
            log.warning("could not close remediation intent %s: %s", txn, e)

    def _device_reset(self) -> None:
        if self.backend is None:
            raise GpuError("no backend wired for device-reset remediation")
        chips = self.backend.discover().chips
        log.warning(
            "remediation: re-resetting %d chip(s) on %s", len(chips),
            self.node_name,
        )
        txn = self._journal_hardware_intent("device-reset")
        try:
            self.backend.reset(chips)
        except Exception:
            # Ordinary failures abort the intent; a modeled SIGKILL
            # (BaseException) escapes with it OPEN — replay closes it.
            self._journal_close(txn, ok=False)
            raise
        self._journal_close(txn, ok=True)

    def _runtime_restart(self) -> None:
        if self.backend is None:
            raise GpuError("no backend wired for runtime-restart remediation")
        log.warning("remediation: restarting TPU runtime on %s", self.node_name)
        txn = self._journal_hardware_intent("runtime-restart")
        try:
            self.backend.restart_runtime()
        except Exception:
            self._journal_close(txn, ok=False)
            raise
        self._journal_close(txn, ok=True)

    # -- quarantine --------------------------------------------------------

    def quarantine(self, reason: str = "manual", manual: bool = False) -> None:
        """Contain the node: taint + label + ready=false + event, and fence
        any in-flight slice barrier. Idempotent."""
        with self._lock:
            self._ensure_loaded()
            self._quarantine_locked(reason, manual)

    def _quarantine_locked(self, reason: str, manual: bool) -> None:  # cclint: requires(_lock)
        if self.quarantined:
            return
        # The label patch is the authoritative edge (rollouts, attestation
        # and the budget all key on it) — it runs first and a failure
        # propagates so the ladder retries on the next failed reconcile.
        self.api.patch_node_labels(self.node_name, {
            QUARANTINED_LABEL: "true",
            CC_READY_STATE_LABEL: "false",
        })
        self.quarantined = True
        self._healthy_since = None
        self.last_reason = reason
        try:
            self.api.patch_node_taints(
                self.node_name, [dict(QUARANTINE_TAINT)], []
            )
        except KubeApiError as e:
            # Clients without taint support (or a lost patch) still get the
            # control-plane containment from the label; log loudly.
            log.warning(
                "remediation: could not apply quarantine taint on %s: %s",
                self.node_name, e,
            )
        self._fence_own_slice(reason)
        self.metrics.set_quarantined(True)
        if manual:
            self.metrics.record_remediation_step(STEP_QUARANTINE, "manual")
        log.error(
            "node %s QUARANTINED (%s): NoSchedule taint + %s=true, "
            "ready.state=false; probation window %.0fs",
            self.node_name, reason, QUARANTINED_LABEL, self.probation_s,
        )
        self.emit_event(
            "Warning", "CCNodeQuarantined",
            f"node quarantined by the remediation ladder ({reason}); "
            f"NoSchedule taint applied, probation {self.probation_s:.0f}s",
        )
        self._persist()

    def unquarantine(self, reason: str = "manual") -> None:
        """Release the node: remove taint + label, restore ready state from
        the current mode.state, reset the ladder. Idempotent."""
        with self._lock:
            self._unquarantine_locked(reason)

    def _unquarantine_locked(self, reason: str) -> None:  # cclint: requires(_lock)
        try:
            state = node_labels(self.api.get_node(self.node_name)).get(
                CC_MODE_STATE_LABEL, ""
            )
        except KubeApiError:
            state = ""
        self.api.patch_node_labels(self.node_name, {
            QUARANTINED_LABEL: None,
            CC_READY_STATE_LABEL: ready_state_for(state),
        })
        try:
            self.api.patch_node_taints(
                self.node_name, [], [QUARANTINE_TAINT_KEY]
            )
        except KubeApiError as e:
            log.warning(
                "remediation: could not remove quarantine taint on %s: %s",
                self.node_name, e,
            )
        was = self.quarantined
        self.quarantined = False
        self._healthy_since = None
        self.failures = 0
        self.step = STEP_RETRY
        self.failslow_signals = 0
        self.metrics.set_quarantined(False)
        if was:
            log.warning(
                "node %s unquarantined (%s); ladder reset", self.node_name,
                reason,
            )
            self.emit_event(
                "Normal", "CCNodeUnquarantined",
                f"quarantine lifted ({reason}); node rejoins the pool",
            )
        self._persist()

    def condemn(self, reason: str = "watchdog-condemned") -> None:
        """Fence this host's slice WITHOUT quarantining (the watchdog's
        demote edge: peers mid-barrier must not wait out the deadline on a
        host that just went unhealthy)."""
        self._fence_own_slice(reason)

    def _fence_own_slice(self, reason: str) -> None:
        """Abort any in-flight barrier of this host's slice with a new
        fencing generation. Best-effort: containment of THIS node never
        fails because peers couldn't be told."""
        slice_id = None
        if self.backend is not None:
            try:
                topo = self.backend.discover()
                if not topo.is_multi_host:
                    return  # no peers to fence out
                slice_id = topo.slice_id
            except GpuError as e:
                log.warning(
                    "remediation: discovery failed (%s); fencing from the "
                    "slice label instead", e,
                )
        if slice_id is None:
            # No device layer here (the operator CLI, or discovery down):
            # the published slice-membership label is the peers' discovery
            # medium anyway, so fence through it. Fencing a single-host
            # slice is harmless — nobody is listening.
            try:
                slice_id = node_labels(
                    self.api.get_node(self.node_name)
                ).get(SLICE_ID_LABEL)
            except KubeApiError as e:
                log.warning("remediation: cannot read slice label: %s", e)
            if not slice_id:
                return
        try:
            slicecoord.fence_slice(
                self.api, self.node_name, slice_id, reason=reason,
                metrics=self.metrics,
            )
        except KubeApiError as e:
            log.warning(
                "remediation: could not fence slice %s: %s", slice_id, e
            )

    # -- probation ---------------------------------------------------------

    def note_probe(self, healthy: bool) -> None:
        """Watchdog probe feed: continuous health for ``probation_s`` while
        quarantined lifts the quarantine."""
        with self._lock:
            self._ensure_loaded()
            if not self.quarantined:
                return
            if not healthy:
                if self._healthy_since is not None:
                    log.info(
                        "remediation: probation reset on %s (probe unhealthy)",
                        self.node_name,
                    )
                self._healthy_since = None
                return
            now = self.clock()
            if self._healthy_since is None:
                self._healthy_since = now
                return
            if now - self._healthy_since >= self.probation_s:
                self._unquarantine_locked(reason="probation-elapsed")

    # -- reporting ---------------------------------------------------------

    def describe(self) -> str:
        """One label-safe token for `tpu-cc-ctl status` notes."""
        with self._lock:
            if self.quarantined:
                return "quarantined"
            if self.failslow_signals:
                return f"fail-slow({self.failslow_signals})"
            if self.failures:
                return f"{self.step}({self.failures})"
            return ""


def describe_annotation(raw: str | None) -> str:
    """Render a persisted ladder annotation for status output ("" when
    clean/absent/corrupt)."""
    if not raw:
        return ""
    try:
        state = json.loads(raw)
    except ValueError:
        return "remediation:corrupt"
    if state.get("quarantined"):
        reason = label_safe(str(state.get("reason") or "")) or "unknown"
        return f"quarantined({reason})"
    failures = state.get("failures") or 0
    step = state.get("step") or STEP_RETRY
    return f"remediation:{step}({failures})" if failures else ""


def from_env(
    api: KubeApi,
    node_name: str,
    backend: NodeBackend | None = None,
    emit_event: Callable[[str, str, str], None] | None = None,
    metrics: metrics_mod.MetricsRegistry | None = None,
    intents: "intent_mod.IntentJournal | None" = None,
) -> RemediationLadder | None:
    """CLI wiring: CC_REMEDIATION_FAILURES_PER_STEP (0 disables the whole
    ladder), CC_QUARANTINE_PROBATION_S."""
    import os

    per_step = int(os.environ.get(
        "CC_REMEDIATION_FAILURES_PER_STEP", str(DEFAULT_FAILURES_PER_STEP)
    ))
    if per_step <= 0:
        log.info("remediation ladder disabled (CC_REMEDIATION_FAILURES_PER_STEP<=0)")
        return None
    return RemediationLadder(
        api,
        node_name,
        backend=backend,
        failures_per_step=per_step,
        probation_s=float(os.environ.get(
            "CC_QUARANTINE_PROBATION_S", str(DEFAULT_PROBATION_S)
        )),
        emit_event=emit_event,
        metrics=metrics,
        intents=intents,
    )
