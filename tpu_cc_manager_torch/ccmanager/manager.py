"""CCManager: the per-node reconciler.

Reference analogue: the CCManager class (main.py:105-695; call stacks in
SURVEY.md §3). The protocol is preserved — desired mode read from a node
label, idempotency check, drain-before-reconfigure, phased
stage/reset/verify, crash-as-retry on unrecoverable misconfiguration,
``failed`` state label on errors, watch with resourceVersion tracking /
410 resync / consecutive-error cap — with the TPU-structural changes:

- the device unit is the ICI slice, so stage/reset/wait act on the whole
  chip set (tpudev/contract.py);
- verification is upgraded from "query equals desired" to query + slice
  attestation + an optional end-to-end JAX smoke workload (SURVEY.md §3.4);
- every phase is timed (utils/metrics.py) because the north-star metric is
  the drain→CC-on→ready latency (BASELINE.md).

Reference bugs deliberately fixed (SURVEY.md §8): ``time`` is imported (§8.1),
there is no dead ``last_label`` state (§8.2), label writes are merge-patches
(§8.3).
"""

from __future__ import annotations

import json
import logging
import os
import sys
import threading
import time
from typing import Callable

from tpu_cc_manager_torch.ccmanager import intent_journal as intent_mod
from tpu_cc_manager_torch.ccmanager import slicecoord
from tpu_cc_manager_torch.drain import evict, state
from tpu_cc_manager_torch.kubeclient.api import (
    KubeApi,
    KubeApiError,
    node_labels,
    resource_version,
)
from tpu_cc_manager_torch import labels as labels_mod
from tpu_cc_manager_torch.labels import (
    CC_MODE_LABEL,
    MODE_DEVTOOLS,
    MODE_OFF,
    MODE_SLICE,
    STATE_FAILED,
    VALID_MODES,
    canonical_mode,
    label_safe,
)
from tpu_cc_manager_torch.obs import journal as journal_mod
from tpu_cc_manager_torch.obs import trace as trace_mod
from tpu_cc_manager_torch.gpudev import attestation
from tpu_cc_manager_torch.ccmanager.node import SliceView, NodeBackend, ChipView, GpuError
from tpu_cc_manager_torch.utils import locks as locks_mod
from tpu_cc_manager_torch.utils import metrics as metrics_mod
from tpu_cc_manager_torch.utils import retry as retry_mod

log = logging.getLogger(__name__)


class ModeUnsupported(GpuError):
    """The requested mode cannot run on this node's hardware — a stable
    misconfiguration that fails soft (failed label + reason), unlike mixed
    capability which keeps the reference's crash-as-retry."""

    def __init__(self, message: str, reason: str):
        super().__init__(message)
        self.reason = reason


DEFAULT_READINESS_FILE = "/run/tpu/validations/.tpu-cc-manager-ctr-ready"
# Reference operational constants (SURVEY.md §6).
WATCH_TIMEOUT_S = 300
WATCH_RECONNECT_DELAY_S = 5.0
MAX_CONSECUTIVE_WATCH_ERRORS = 10
DEFAULT_READY_TIMEOUT_S = 300.0

# Preemption fast-drain (spot/preemptible nodes): the hard termination
# deadline the platform gives between notice and kill, and how often the
# monitor polls the backend's notice source (GCE: metadata-server
# ``instance/preempted``). CC_PREEMPTION_DEADLINE_S=0 disables the
# monitor entirely.
DEFAULT_PREEMPTION_DEADLINE_S = 30.0
DEFAULT_PREEMPTION_POLL_S = 5.0

#: Node annotation carrying the handoff record of a transition a
#: preemption notice interrupted: {mode, phase, chips, slice_id, from,
#: ts} as JSON. Published by the departing agent BEFORE the kill and
#: consumed by the replacement node's agent at startup — the preempted
#: VM's disk (and with it the intent journal) dies in the reclaim, so
#: the apiserver copy is the only record that reaches the successor.
HANDOFF_ANNOTATION = labels_mod.HANDOFF_ANNOTATION

#: Spare pre-staging (zero-bounce flips): the request annotation names
#: the mode to pre-stage; the status annotation carries the agent's JSON
#: record {"mode", "prior", "seconds", "ts"} once the pre-staged flip
#: completed. See labels.py for the full protocol.
PRESTAGE_ANNOTATION = labels_mod.PRESTAGE_ANNOTATION
PRESTAGED_ANNOTATION = labels_mod.PRESTAGED_ANNOTATION


class _PipelineTask:
    """One overlapped pipeline step on a worker thread, with the caller's
    trace context propagated so its phase spans nest under the reconcile
    root. ``join()`` re-raises whatever escaped the step — BaseException
    included, so a modeled SIGKILL inside an overlapped step unwinds the
    main pipeline exactly like one on the serial path (intent left open,
    no except-Exception cleanup)."""

    def __init__(self, name: str, fn: Callable[[], None]) -> None:
        self._error: BaseException | None = None

        def run() -> None:
            try:
                fn()
            except BaseException as e:  # noqa: BLE001  # cclint: crash-ok(worker trampoline - join re-raises, SIGKILL unwinds the owning pipeline)
                self._error = e

        self._thread = threading.Thread(
            target=trace_mod.in_current_context(run),
            name=f"cc-pipeline-{name}", daemon=True,
        )
        self._thread.start()

    def join(self) -> None:
        self._thread.join()
        if self._error is not None:
            raise self._error

    def join_quiet(self) -> BaseException | None:
        """Join without raising; returns the captured error (the caller
        is already on a failure path and must not mask its own cause)."""
        self._thread.join()
        return self._error


class _ReadmitOnce:
    """Runs the readmit bracket exactly once — either early, overlapped
    with the smoke workload (``start_async``), or synchronously from the
    owner's finally (``finish``). ``finish`` always represents the
    bracket's true outcome: it joins an early run and re-raises its
    failure, so the caller's drain-intent close still only happens after
    a readmit that actually succeeded."""

    _SYNC = object()  # claimed by finish(); any later start_async no-ops

    def __init__(
        self, fn: Callable[[], None],
        on_start: Callable[[], None] | None = None,
    ) -> None:
        self._fn = fn
        self._on_start = on_start
        self._task: object | None = None
        self._lock = locks_mod.make_lock("manager.readmit-once")

    def start_async(self) -> None:
        with self._lock:
            if self._task is not None:
                return
            if self._on_start is not None:
                self._on_start()
            self._task = _PipelineTask("readmit", self._fn)

    def finish(self) -> None:
        with self._lock:
            task = self._task
            if task is None:
                self._task = self._SYNC
        if isinstance(task, _PipelineTask):
            task.join()
        elif task is None:
            self._fn()


class CCManager:
    def __init__(
        self,
        api: KubeApi,
        backend: NodeBackend,
        node_name: str,
        default_mode: str = "on",
        host_cc_capable: bool = True,
        operator_namespace: str | None = None,
        evict_components: bool | None = None,
        smoke_workload: str | None = None,
        smoke_runner: Callable[[str], dict] | None = None,
        eviction_timeout_s: float | None = None,
        eviction_poll_interval_s: float = evict.DEFAULT_POLL_INTERVAL_S,
        strict_eviction: bool | None = None,
        drain_ack_timeout_s: float | None = None,
        ready_timeout_s: float = DEFAULT_READY_TIMEOUT_S,
        slice_barrier_timeout_s: float | None = None,
        slice_barrier_poll_interval_s: float = 1.0,
        allow_fake_quotes: bool | None = None,
        readiness_file: str | None = None,
        watch_timeout_s: int = WATCH_TIMEOUT_S,
        reconnect_delay_s: float = WATCH_RECONNECT_DELAY_S,
        max_watch_errors: int = MAX_CONSECUTIVE_WATCH_ERRORS,
        retry_backoff_s: float | None = None,
        retry_backoff_max_s: float | None = None,
        metrics: metrics_mod.MetricsRegistry | None = None,
        journal: journal_mod.Journal | None = None,
        remediation=None,
        intent_journal: intent_mod.IntentJournal | None = None,
        offline_grace_s: float | None = None,
        use_slice_informer: bool | None = None,
        preemption_deadline_s: float | None = None,
        preemption_poll_s: float | None = None,
        pipeline_transitions: bool | None = None,
        smoke_digest_fastpath: bool | None = None,
        smoke_warmup: bool | None = None,
        smoke_warmup_factory: Callable[[str], object] | None = None,
        state_dir: str | None = None,
        prestage: bool | None = None,
    ) -> None:
        self.api = api
        self.backend = backend
        self.node_name = node_name
        self.default_mode = canonical_mode(default_mode)
        self.host_cc_capable = host_cc_capable
        # Env-var configuration, same names modulo prefix as the reference
        # (main.py:116-119: OPERATOR_NAMESPACE, EVICT_OPERATOR_COMPONENTS).
        self.operator_namespace = operator_namespace or os.environ.get(
            "OPERATOR_NAMESPACE", "tpu-operator"
        )
        if evict_components is None:
            evict_components = os.environ.get(
                "EVICT_OPERATOR_COMPONENTS", "true"
            ).lower() in ("true", "1", "yes")
        self.evict_components = evict_components
        self.smoke_workload = (
            smoke_workload
            if smoke_workload is not None
            else os.environ.get("CC_SMOKE_WORKLOAD", "none")
        )
        self.smoke_runner = smoke_runner
        if eviction_timeout_s is None:
            eviction_timeout_s = float(
                os.environ.get(
                    "CC_EVICTION_TIMEOUT_S", evict.DEFAULT_EVICTION_TIMEOUT_S
                )
            )
        self.eviction_timeout_s = eviction_timeout_s
        self.eviction_poll_interval_s = eviction_poll_interval_s
        # Workload drain handshake (drain/handshake.py): how long registered
        # training jobs get to checkpoint+ack before components are paused.
        # 0 disables (the reference has no workload protocol at all).
        if drain_ack_timeout_s is None:
            drain_ack_timeout_s = float(
                os.environ.get("CC_DRAIN_ACK_TIMEOUT_S", "0")
            )
        self.drain_ack_timeout_s = drain_ack_timeout_s
        # The reference proceeds to the hardware phase on a drain timeout
        # (gpu_operator_eviction.py:205-207) — risky but deliberate; strict
        # mode (CC_STRICT_EVICTION=1) fails the reconcile instead
        # (SURVEY.md §8.5: "preserve behavior behind a flag").
        if strict_eviction is None:
            strict_eviction = os.environ.get(
                "CC_STRICT_EVICTION", ""
            ).lower() in ("true", "1", "yes")
        self.strict_eviction = strict_eviction
        self.ready_timeout_s = ready_timeout_s
        if slice_barrier_timeout_s is None:
            slice_barrier_timeout_s = float(
                os.environ.get(
                    "CC_SLICE_BARRIER_TIMEOUT_S",
                    slicecoord.DEFAULT_BARRIER_TIMEOUT_S,
                )
            )
        self.slice_barrier_timeout_s = slice_barrier_timeout_s
        self.slice_barrier_poll_interval_s = slice_barrier_poll_interval_s
        # Slice-peer informer (ccmanager/informer.py, CC_SLICE_INFORMER):
        # one watch over this node's slice membership label replaces the
        # barrier's 1/s peer listings — N hosts × barrier-deadline seconds
        # of O(slice) listings collapse to O(changes) watch events. Opt-in
        # via env (the DaemonSet sets it); without it the barrier polls
        # listings exactly as before.
        if use_slice_informer is None:
            use_slice_informer = os.environ.get(
                "CC_SLICE_INFORMER", ""
            ).lower() in ("true", "1", "yes")
        self.use_slice_informer = use_slice_informer
        self._peer_informer = None
        if allow_fake_quotes is None:
            env = os.environ.get("CC_ALLOW_FAKE_QUOTES")
            if env is not None:
                allow_fake_quotes = env.lower() in ("true", "1", "yes")
            else:
                # Fake-platform quotes are trustworthy exactly when the
                # operator explicitly chose the fake device layer; a
                # production (tpuvm) verifier must reject them
                # (tpudev/attestation.py).
                from tpu_cc_manager_torch.ccmanager.node import is_fake_backend

                allow_fake_quotes = is_fake_backend(backend)
        self.allow_fake_quotes = allow_fake_quotes
        self.readiness_file = readiness_file or os.environ.get(
            "CC_READINESS_FILE", DEFAULT_READINESS_FILE
        )
        self.watch_timeout_s = watch_timeout_s
        self.reconnect_delay_s = reconnect_delay_s
        self.max_watch_errors = max_watch_errors
        # Watch-reconnect backoff through the shared policy: full jitter
        # under an exponential cap keyed on the consecutive-error count, so
        # a pool of agents doesn't reconnect to a flapping apiserver in
        # lockstep every reconnect_delay_s (the reference's fixed 5 s).
        self._reconnect_policy = retry_mod.RetryPolicy(
            base_delay_s=max(0.001, reconnect_delay_s),
            max_delay_s=max(reconnect_delay_s, 60.0),
        )
        # Failed-reconcile retry with exponential backoff: the reference
        # leaves a transiently-failed node 'failed' until the label is
        # touched again (main.py only re-applies on label *change*); a
        # periodic re-apply is cheap and converges. <=0 disables.
        if retry_backoff_s is None:
            retry_backoff_s = float(os.environ.get("CC_RETRY_BACKOFF_S", "5"))
        self.retry_backoff_s = retry_backoff_s
        if retry_backoff_max_s is None:
            retry_backoff_max_s = float(
                os.environ.get("CC_RETRY_BACKOFF_MAX_S", "300")
            )
        self.retry_backoff_max_s = retry_backoff_max_s
        self.metrics = metrics if metrics is not None else metrics_mod.REGISTRY
        # Span journal for the reconcile trace (obs/): every phase, drain
        # step, barrier wait, attestation and smoke run of one reconcile
        # shares one trace_id, served at /tracez and (optionally,
        # CC_TRACE_FILE) written as JSONL.
        self.journal = journal if journal is not None else journal_mod.JOURNAL
        # True while a reconcile (set_cc_mode) is in flight; the CLI's
        # shutdown path consults it so a hard exit never interrupts a
        # half-applied hardware transition when grace time remains.
        self.reconciling = False
        # Whether the most recent failure could plausibly clear on a fast
        # retry. Stable misconfigurations (ModeUnsupported, invalid mode)
        # set this False: they are retried only at the slow
        # retry_backoff_max_s cadence — enough that a later hardware/pool
        # fix still converges without a label edit, without re-failing an
        # identical reconcile every few seconds.
        self.retryable_failure = True
        # Machine-readable reason of the most recent failure (what the
        # failed.reason label carries); feeds the remediation ladder.
        self.last_failure_reason: str | None = None
        # Escalating remediation ladder (ccmanager/remediation.py): fed a
        # note per reconcile outcome from the watch loop; while it holds
        # the node quarantined, reconciles are deferred (slow re-check
        # cadence) instead of hammering known-bad hardware. None disables.
        self.remediation = remediation
        # Node-local write-ahead intent log (ccmanager/intent_journal.py):
        # every hardware-effecting transition and drain bracket is
        # journaled intent→(committed|aborted), so a crash-restart replays
        # the journal BEFORE touching the apiserver and completes or rolls
        # back the in-flight transition from local truth alone. None
        # disables (behavior reverts to apiserver-only state).
        self.intents = intent_journal
        # Disconnected-mode ladder: after CC_OFFLINE_GRACE_S of total
        # apiserver outage the agent keeps serving its last-known desired
        # mode and defers label writes into the journal as pending
        # patches, flushed idempotently (RMW) on reconnect.
        self.offline = intent_mod.OfflineTracker(offline_grace_s)
        self._flushing_patches = False
        # Preemption fast-drain (spot/preemptible nodes): the hard
        # termination deadline the platform's notice leaves us, and how
        # often to poll the backend's notice source. deadline<=0 or
        # poll<=0 disables the monitor.
        if preemption_deadline_s is None:
            preemption_deadline_s = float(
                os.environ.get(
                    "CC_PREEMPTION_DEADLINE_S",
                    str(DEFAULT_PREEMPTION_DEADLINE_S),
                )
            )
        self.preemption_deadline_s = preemption_deadline_s
        if preemption_poll_s is None:
            preemption_poll_s = float(
                os.environ.get(
                    "CC_PREEMPTION_POLL_S", str(DEFAULT_PREEMPTION_POLL_S)
                )
            )
        self.preemption_poll_s = preemption_poll_s
        # Pipelined transitions (default on; CC_PIPELINE_TRANSITIONS=0
        # restores the fully serial reference ordering): stage (and the
        # slice barrier's staged publication) overlaps the pod-drain
        # bracket, attestation prep overlaps wait_ready, and re-admission
        # overlaps the smoke workload. The hard orderings are untouched —
        # this host never resets before its own drain completed, and the
        # drain intent closes only after readmit actually succeeded.
        if pipeline_transitions is None:
            pipeline_transitions = os.environ.get(
                "CC_PIPELINE_TRANSITIONS", "1"
            ).lower() not in ("0", "false", "no")
        self.pipeline_transitions = pipeline_transitions
        # Attestation-digest smoke fast path (CC_SMOKE_DIGEST_FAST_PATH,
        # default off): when a flip lands on a runtime whose measured
        # digest equals the last digest a FULL smoke verified, the smoke
        # is skipped in favor of the attest-only verify. A changed digest
        # always falls through to the full smoke.
        if smoke_digest_fastpath is None:
            smoke_digest_fastpath = os.environ.get(
                "CC_SMOKE_DIGEST_FAST_PATH", ""
            ).lower() in ("true", "1", "yes")
        self.smoke_digest_fastpath = smoke_digest_fastpath
        # Boot-wait∥COMPILE smoke warmup (CC_SMOKE_WARMUP, default on;
        # effective only while pipeline_transitions is on): the smoke
        # subprocess is launched alongside wait_ready in a compile-only
        # warmup mode (smoke/runner.py dispatch gate) and its device
        # dispatch is released only after the runtime is ready AND
        # attestation passed — the ~20 s boot wait absorbs the smoke's
        # interpreter-start + jax-import + compile span. An injected
        # smoke_runner (tests, custom harnesses) disables it unless a
        # warmup factory is injected too.
        if smoke_warmup is None:
            smoke_warmup = os.environ.get(
                "CC_SMOKE_WARMUP", "1"
            ).lower() not in ("0", "false", "no")
        self.smoke_warmup = smoke_warmup
        self.smoke_warmup_factory = smoke_warmup_factory
        # Where the verified-digest record lives (the backend state dir,
        # like the intent journal); None disables persistence — the fast
        # path then never has a digest on record and every flip runs the
        # full smoke.
        if state_dir is None:
            state_dir = (
                os.environ.get("CC_STATE_DIR")
                or getattr(backend, "state_dir", None)
            )
        self._state_dir = state_dir
        self._preemption_stop: threading.Event | None = None
        self._preemption_thread: threading.Thread | None = None
        self._preemption_handled = False
        # The transition currently in flight (mode, chip indices, phase,
        # slice identity), maintained by _apply_direct so the preemption
        # handler — running on the monitor thread, concurrently with a
        # reconcile blocked in a barrier wait — knows exactly what to
        # hand off. None outside the hardware pipeline. Shared between
        # the reconcile thread (writes) and the preemption monitor
        # (reads), hence the dedicated leaf lock.
        self._transition_lock = locks_mod.make_lock("manager.transition")
        self._inflight_transition: dict | None = None  # cclint: guarded-by(_transition_lock)
        # A predecessor's handoff record consumed at startup; retired
        # (annotation cleared + outcome=resumed counted) after the first
        # successful reconcile completes the handed-off flip.
        self._handoff: dict | None = None
        # Event dedup state (see _emit_node_event).
        self._last_event_key: tuple[str, str, str] | None = None
        # Cross-process trace stitching (labels.ROLLOUT_TRACE_LABEL):
        # the orchestrator span identity stamped into the most recent
        # desired-mode patch, adopted as the reconcile root span's
        # remote parent so /tracez renders one causal tree from `ctl
        # rollout` down through this node's drain/reset/smoke. Written
        # and read on the watch-loop thread only (the reconcile runs
        # inline in it); a stale value is truthful — it names the
        # rollout that most recently set the desired mode, which IS the
        # causal parent of every reconcile converging toward it,
        # retries included.
        self._rollout_trace_parent: tuple[str, str] | None = None
        # Verifier-challenge re-attestation (multislice.py): the last
        # challenge nonce this agent answered, so the MODIFIED event our
        # own answer generates doesn't loop into another answer.
        self._answered_challenge_nonce: str | None = None
        # Spare pre-staging (zero-bounce flips, CC_PRESTAGE, default on):
        # a PRESTAGE annotation asks this agent to run the full journaled
        # transition + warmup to a mode AHEAD of the rollout wave that
        # will request it, publish the truthful state label, and HOLD
        # there until the desired label catches up (or the annotation is
        # deleted — the abort path). Caches are written on the watch-loop
        # thread only, like _rollout_trace_parent.
        if prestage is None:
            prestage = os.environ.get(
                "CC_PRESTAGE", "1"
            ).lower() not in ("0", "false", "no")
        self.prestage = prestage
        self._prestage_request: str | None = None
        self._prestaged: dict | None = None
        # In-process copy of the last COMPLETED prestage record: watch
        # events queued behind the (long) prestage pass carry stale node
        # snapshots from mid-transition, and trusting them alone would
        # re-run the pass once per queued event and let a stale view
        # drop the hold. This copy is authoritative until consumed,
        # aborted, or superseded by a different-mode reconcile.
        self._prestage_done: dict | None = None
        self._in_prestage = False
        # True when the most recent reconcile resolved as a prestage
        # HOLD (no hardware touched, desired deliberately not applied):
        # the success-path housekeeping must not treat it as a completed
        # desired-mode flip — consuming the prestage record there would
        # clear the very annotations the hold runs on.
        self._prestage_held = False

    # ------------------------------------------------------------------
    # Label plumbing
    # ------------------------------------------------------------------

    def _emit_node_event(self, type_: str, reason: str, message: str) -> None:
        """Best-effort core/v1 Event on this node (`kubectl describe node`
        visibility — the reference's only outward signals are labels and a
        file; SURVEY.md §5). Deduplicated on (type, reason, message) so
        idempotent re-applies and retry loops don't spam the event stream;
        never fails a reconcile. Not all clients support events — the
        KubeApi default raises — hence the broad non-fatal handling."""
        key = (type_, reason, message)
        if key == self._last_event_key:
            return
        try:
            now = time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())
            # Events for cluster-scoped objects (Node) must live in the
            # "default" namespace — apiserver validation rejects any other
            # when involvedObject.namespace is empty.
            metadata: dict = {"generateName": "tpu-cc-manager."}
            trace_id = trace_mod.current_trace_id()
            if trace_id is not None:
                # kubectl-describe readers can jump from the event to the
                # reconcile's span tree (/tracez?trace_id=...).
                metadata["annotations"] = {
                    labels_mod.TRACE_ID_ANNOTATION: trace_id
                }
            self.api.create_event("default", {
                "metadata": metadata,
                "involvedObject": {
                    "kind": "Node", "name": self.node_name, "apiVersion": "v1",
                },
                "reason": reason,
                "message": message[:1024],
                "type": type_,
                "source": {"component": "tpu-cc-manager", "host": self.node_name},
                "firstTimestamp": now,
                "lastTimestamp": now,
                "count": 1,
            })
            self._last_event_key = key
        except Exception as e:  # noqa: BLE001 - "never fails a reconcile"
            # must hold for ANY failure shape (a malformed 201 body raises
            # JSONDecodeError, not KubeApiError) — a verified mode change
            # must not be re-reported failed over a convenience signal.
            log.debug("event emission failed (non-fatal): %s", e)

    def _record_failure(self, reason: str) -> None:
        """Count a failed reconcile and remember its reason for the
        remediation ladder."""
        self.last_failure_reason = reason
        self.metrics.record_failure(reason)

    def _publish_trace_annotation(self, trace_id: str) -> None:
        """Advertise the last reconcile's trace id on the node
        (labels.TRACE_ID_ANNOTATION) so operators can jump from `ctl
        status` to /tracez?trace_id=. Best-effort, like every other
        coordination metadata write: a minimal client without
        annotation patching (or an apiserver blip) must never fail a
        verified mode change."""
        try:
            self.api.patch_node_annotations(
                self.node_name,
                {labels_mod.TRACE_ID_ANNOTATION: trace_id},
            )
        except Exception as e:  # noqa: BLE001 - advisory metadata only
            log.debug(
                "could not publish trace-id annotation (non-fatal): %s", e
            )

    # ------------------------------------------------------------------
    # Apiserver connectivity + intent journal (disconnected mode)
    # ------------------------------------------------------------------

    def _note_api_ok(self) -> None:
        """An apiserver interaction succeeded: reset the outage clock and,
        if deferred label writes are queued in the intent journal, flush
        them — this is the reconnect edge of the disconnected-mode
        ladder."""
        self.offline.note_success()
        self.metrics.set_apiserver_connected(True)
        self.metrics.set_offline_seconds(0.0)
        if self.intents is not None and self.intents.has_pending_patches():
            self._flush_pending_patches()

    def _note_api_err(self, e: BaseException | None = None) -> None:
        """A transport-level apiserver failure: advance the outage clock
        (HTTP-status errors are a server that ANSWERED and never count)."""
        if e is not None and not intent_mod.is_outage_error(e):
            return
        self.offline.note_failure()
        self.metrics.set_apiserver_connected(False)
        self.metrics.set_offline_seconds(self.offline.offline_seconds)

    def _flush_pending_patches(self) -> None:
        """Flush label writes deferred while disconnected. Idempotent RMW,
        not blind replay: the merged pending state is compared against the
        node's CURRENT labels and only differing keys are patched — a
        value some other writer (or a fresher reconcile) already landed is
        neither duplicated nor clobbered back. A failed flush keeps the
        patches queued for the next successful interaction."""
        if self._flushing_patches or self.intents is None:
            return
        self._flushing_patches = True
        try:
            pending, upto = self.intents.pending_snapshot()
            if not pending:
                return
            node = self.api.get_node(self.node_name)
            labels = node_labels(node)
            patch: dict = {}
            for key, value in pending.items():
                if value is None:
                    if key in labels:
                        patch[key] = None
                elif labels.get(key) != value:
                    patch[key] = value
            if patch:
                self.api.patch_node_labels(self.node_name, patch)
            # Only the snapshot is flushed: a patch deferred concurrently
            # (seq > upto) stays queued for the next flush.
            self.intents.patches_flushed(upto)
            log.info(
                "flushed %d deferred label write(s) after reconnect "
                "(%d key(s) still differed and were patched)",
                len(pending), len(patch),
            )
        except KubeApiError as e:
            self._note_api_err(e)
            log.warning("deferred-patch flush failed; will retry: %s", e)
        except intent_mod.JournalError as e:
            log.warning("could not mark deferred patches flushed: %s", e)
        finally:
            self._flushing_patches = False

    def _defer_patch(self, patch) -> bool:
        """Queue a label write in the intent journal for the reconnect
        flush; False when there is no journal (or it cannot persist)."""
        if self.intents is None:
            return False
        try:
            self.intents.defer_patch(dict(patch))
        except intent_mod.JournalError as e:
            log.warning("could not defer label write to the journal: %s", e)
            return False
        self.metrics.record_deferred_patch()
        return True

    def note_direct_patch(self, patch) -> None:
        """A label write LANDED directly while deferred patches are still
        queued (an earlier flush failed or is racing): journal the fresh
        values as a superseding patch record, so the eventual flush's
        journal-order merge carries them and cannot clobber the labels
        back to the stale pre-outage values."""
        if self.intents is None or not self.intents.has_pending_patches():
            return
        try:
            self.intents.defer_patch(dict(patch))
        except intent_mod.JournalError as e:
            log.warning(
                "could not journal a superseding label write: %s", e
            )

    def defer_patch_if_offline(self, patch, error: BaseException) -> bool:
        """Hook for co-located writers (the runtime-health watchdog): when
        a label write failed on a transport-level error during an ENGAGED
        outage, journal it as a pending patch and report it handled. The
        watchdog's condemn-while-offline rides this: the demote patch is
        deferred and flushed, in journal order, on reconnect."""
        if not intent_mod.is_outage_error(error):
            return False
        self._note_api_err(error)
        if not self.offline.engaged:
            return False
        return self._defer_patch(patch)

    def _report_state(
        self, state_value: str, reason: str | None = None,
        force_defer: bool = False,
    ) -> None:
        """Report actual state like drain/state.py, but disconnected-
        aware: when the apiserver is in an engaged outage (or
        ``force_defer``, the journal-replay path while still dark), the
        patch is journaled as a pending write instead of failing the
        reconcile — the node's local truth keeps advancing and the labels
        catch up idempotently on reconnect."""
        patch = state.state_label_patch(state_value, reason)
        try:
            state.set_cc_state_label(
                self.api, self.node_name, state_value, reason=reason
            )
            # BEFORE the reconnect-edge flush: if stale pre-outage patches
            # are still queued (a flush failed earlier), this fresher
            # direct write supersedes them in journal order.
            self.note_direct_patch(patch)
            self._note_api_ok()
        except KubeApiError as e:
            self._note_api_err(e)
            if (
                intent_mod.is_outage_error(e)
                and (force_defer or self.offline.engaged)
                and self._defer_patch(patch)
            ):
                log.warning(
                    "apiserver unreachable; state report (%s) deferred to "
                    "the intent journal", state_value,
                )
                return
            raise

    def _journal_begin(self, kind: str, **fields) -> str | None:
        if self.intents is None:
            return None
        try:
            return self.intents.begin(kind, **fields)
        except intent_mod.JournalError as e:
            log.warning(
                "intent journal unavailable; %s runs unjournaled: %s",
                kind, e,
            )
            return None

    def _journal_mark(self, txn: str | None, phase: str) -> None:
        if txn is None or self.intents is None:
            return
        try:
            self.intents.mark(txn, phase)
        except intent_mod.JournalError as e:
            log.warning("intent journal mark failed: %s", e)

    def _journal_close(self, txn: str | None, ok: bool, **fields) -> None:
        if txn is None or self.intents is None:
            return
        try:
            if ok:
                self.intents.commit(txn, **fields)
            else:
                self.intents.abort(txn, **fields)
        except intent_mod.JournalError as e:
            log.warning("intent journal close failed: %s", e)

    def with_default(self, label_value: str | None) -> str:
        """Absent/empty desired label means the configured default
        (reference main.py:686-691)."""
        if not label_value:
            log.info("no %s label; defaulting to %s", CC_MODE_LABEL, self.default_mode)
            return self.default_mode
        return canonical_mode(label_value)

    def _note_rollout_trace(self, labels: dict) -> None:
        """Remember the orchestrator trace identity riding in the
        desired-mode patch (tentpole: cross-process stitching). Garbled
        values parse to None — a stitching hint must never fail a
        reconcile."""
        self._rollout_trace_parent = trace_mod.parse_parent(
            labels.get(labels_mod.ROLLOUT_TRACE_LABEL)
        )

    def get_node_cc_mode_label(self) -> tuple[str | None, str]:
        """Read the desired-mode label and the node's resourceVersion.

        Apiserver errors propagate — at startup that is fatal by design
        (reference main.py:596-598, crash-as-retry)."""
        node = self.api.get_node(self.node_name)
        labels = node_labels(node)
        self._note_rollout_trace(labels)
        return labels.get(CC_MODE_LABEL), resource_version(node)

    def create_readiness_file(self) -> None:
        """Touch the readiness file after the first successful apply; failures
        are non-fatal (reference main.py:66-78)."""
        try:
            os.makedirs(os.path.dirname(self.readiness_file), exist_ok=True)
            with open(self.readiness_file, "w", encoding="utf-8"):
                pass
            log.info("created readiness file %s", self.readiness_file)
        except OSError as e:
            log.warning("could not create readiness file %s: %s", self.readiness_file, e)

    # ------------------------------------------------------------------
    # Mode application (reference call stack 3.2/3.3)
    # ------------------------------------------------------------------

    def set_cc_mode(self, mode: str) -> bool:
        self.reconciling = True
        self.retryable_failure = True
        if self.intents is not None:
            # Boot-time local truth: a restart that cannot reach the
            # apiserver serves this journaled desired mode instead of
            # crash-looping with no record of what it was converging on.
            try:
                self.intents.note_desired(canonical_mode(mode))
            except intent_mod.JournalError as e:
                log.warning("could not journal desired mode: %s", e)
        try:
            # One reconcile = one trace: every phase span, drain step,
            # barrier wait and log line below nests under this root —
            # and when the desired mode came from a rolling orchestrator
            # the root itself adopts the ROLLOUT trace as its remote
            # parent (labels.ROLLOUT_TRACE_LABEL), so the orchestrator's
            # /tracez renders `ctl rollout` and this node's
            # drain/reset/smoke as one causal tree.
            with trace_mod.root_span(
                "reconcile", journal=self.journal,
                parent=self._rollout_trace_parent,
                mode=mode, node=self.node_name,
            ) as sp:
                ok = self._set_cc_mode(mode)
                sp.set_attribute("ok", ok)
                if not ok:
                    sp.status = trace_mod.STATUS_ERROR
                # Republish this reconcile's trace id on the node so
                # `ctl status` can surface a TRACE column (the event
                # annotation alone dies with the event's TTL).
                self._publish_trace_annotation(sp.trace_id)
                if ok:
                    # A reconcile republishes the quote under a fresh
                    # self-chosen nonce, so any verifier challenge this
                    # agent answered earlier is no longer reflected in
                    # the published evidence — forget the answer marker
                    # so a still-outstanding challenge is re-answered on
                    # the next watch event.
                    self._answered_challenge_nonce = None
                    # A consumed handoff is complete once any reconcile
                    # succeeds: the handed-off flip either committed or
                    # was superseded by a newer desired mode.
                    if not self._prestage_held:
                        # A prestage HOLD is not a completed flip: the
                        # handoff record and prestage annotations must
                        # survive it untouched.
                        self._retire_handoff()
                        # Prestage housekeeping: a desired write matching
                        # the pre-staged mode consumes the request; one
                        # that moved past it clears the stale record.
                        self._consume_prestage(mode)
                return ok
        finally:
            self.reconciling = False

    def _set_cc_mode(self, mode: str) -> bool:
        mode = canonical_mode(mode)
        self._prestage_held = False
        if self.remediation is not None and self.remediation.quarantined:
            # Containment: a quarantined node stops hammering known-bad
            # hardware. The reconcile is deferred (slow re-check cadence);
            # probation or `tpu-cc-ctl unquarantine` releases it and the
            # pending retry then re-applies the desired mode.
            log.warning(
                "node is quarantined; deferring reconcile of mode %s "
                "(probation or operator lift releases it)", mode,
            )
            self.retryable_failure = False
            return False
        if mode not in VALID_MODES:
            # A typo'd label is as stable as unsupported hardware: report
            # failed with a reason (the reference refuses silently, leaving
            # no outward signal) and retry only at the slow cadence.
            log.error(
                "invalid CC mode %r (valid: %s) — refusing to act", mode, VALID_MODES
            )
            self.retryable_failure = False
            self._record_failure("invalid-mode")
            self._report_state(STATE_FAILED, reason="invalid-mode")
            self._emit_node_event(
                "Warning", "CCModeInvalid", f"invalid desired CC mode {mode!r}"
            )
            return False
        if not self.host_cc_capable and mode != MODE_OFF:
            # Warning only; the backend/attestation will produce the hard
            # failure (reference main.py:224-225).
            log.warning(
                "host/VM is not CC-capable but mode %s requested; "
                "attestation will likely fail", mode,
            )

        try:
            topo = self.backend.discover()
        except GpuError as e:
            log.error("TPU discovery failed: %s", e)
            self._record_failure("discovery-failed")
            self._report_state(STATE_FAILED, reason="discovery-failed")
            self._emit_node_event(
                "Warning", "CCModeFailed", f"TPU discovery failed: {e}"
            )
            return False

        if not topo.chips:
            log.info("no TPU chips on this node; nothing to do")
            return True

        try:
            if mode == MODE_SLICE:
                chips = self._slice_mode_chips(topo)
            else:
                chips = self._cc_mode_chips(topo, mode)
        except ModeUnsupported as e:
            # Fail SOFT: a mislabeled node (e.g. slice mode on single-host
            # hardware) reports failed + reason and keeps watching — a crash
            # loop can't be fixed by a label edit the agent never sees.
            # Crash-as-retry stays only for mixed capability (reference
            # main.py:237-240), where a restart can genuinely re-enumerate.
            log.error("mode %s unsupported on this node: %s", mode, e)
            self.retryable_failure = False  # only a label/pool edit helps
            self._record_failure(e.reason)
            self._report_state(STATE_FAILED, reason=e.reason)
            self._emit_node_event(
                "Warning", "CCModeUnsupported",
                f"mode {mode} unsupported on this node: {e}",
            )
            return False
        if chips is None:  # nothing to reconfigure; state already reported
            return True

        if self._prestage_hold(mode, chips):
            # Deliberate desired!=state: the node pre-staged a mode for
            # an upcoming rollout wave and holds it. Not a failure, not
            # drift — the wave's desired write (or a deleted request
            # annotation) resolves it.
            self._prestage_held = True
            return True

        if self._mode_is_set(chips, mode):
            # Idempotent path (reference main.py:255-258) — but a restarted
            # agent must still re-attest and re-publish coordination labels:
            # slice grouping and pool attestation read them, and quotes age
            # out. A failed re-attestation falls through to the full apply.
            quote = None
            if mode != MODE_OFF:
                try:
                    nonce = attestation.fresh_nonce()
                    quote = self.backend.fetch_attestation(nonce)
                    attestation.verify_quote(
                        quote,
                        nonce,
                        expected_mode=mode,
                        expected_slice_id=topo.slice_id,
                        debug_policy=(mode == MODE_DEVTOOLS),
                        allow_fake=self.allow_fake_quotes,
                    )
                    # A node that rebooted in a CC mode holds CUDA work back.
                    self.backend.set_gpus_ready()
                except GpuError as e:
                    log.warning(
                        "mode %s reads as set but re-attestation failed (%s); "
                        "running the full apply", mode, e,
                    )
                    quote = None
            if mode == MODE_OFF or quote is not None:
                log.info("CC mode %s already set on all %d chip(s)", mode, len(chips))
                # A crash (or apiserver failure) BETWEEN the mode landing
                # and re-admission leaves components paused; the next
                # reconcile takes this idempotent path — which skips the
                # drain/readmit bracket — so it must restore them (found
                # by the chaos soak). BEFORE the state labels: a node must
                # not advertise ready while its components are known to
                # still be paused.
                self._readmit_leftover_paused()
                self._report_state(mode)
                self._publish_coordination_labels(topo, quote)
                return True

        barrier = None
        if topo.is_multi_host:
            barrier = slicecoord.SliceBarrier(
                self.api,
                self.node_name,
                topo,
                timeout_s=self.slice_barrier_timeout_s,
                poll_interval_s=self.slice_barrier_poll_interval_s,
                informer=self._slice_peer_informer(topo),
            )
        m = self.metrics.start(mode)
        try:
            if self.evict_components:
                ok = self._apply_with_eviction(topo, chips, mode, m, barrier)
            else:
                ok = self._apply_direct(topo, chips, mode, m, barrier)
        except BaseException:
            # An escaping exception (e.g. KubeApiError mid-drain) must not be
            # recorded as a successful reconcile.
            if m.result == "pending":
                m.result = "failed"
            raise
        finally:
            m.finish(m.result if m.result != "pending" else "noop")
        if ok and barrier is not None:
            # Barrier completion AFTER re-admit: the leader's (bounded) wait
            # for peers to clear their staged markers before retiring the
            # commit marker must never keep this host's components paused —
            # only the leader's own watch loop lingers, not the drain window.
            barrier.complete(mode)
        return ok

    def _slice_peer_informer(self, topo):
        """The (lazily started, reused) informer over this node's slice
        membership selector, or None when disabled/unsupported — the
        barrier then falls back to polling listings, so a degraded cache
        can never block a commit."""
        if not self.use_slice_informer or not topo.is_multi_host:
            return None
        from tpu_cc_manager_torch.ccmanager.informer import NodeInformer
        from tpu_cc_manager_torch.labels import SLICE_ID_LABEL, label_safe

        selector = f"{SLICE_ID_LABEL}={label_safe(topo.slice_id)}"
        if (
            self._peer_informer is not None
            and self._peer_informer.selector == selector
        ):
            return self._peer_informer
        self._stop_peer_informer()
        try:
            self._peer_informer = NodeInformer(
                self.api, selector,
                name=f"slice-peers[{topo.slice_id}]",
            ).start()
        except KubeApiError as e:
            log.warning(
                "slice-peer informer unavailable (%s); the barrier falls "
                "back to peer listings", e,
            )
            self._peer_informer = None
        return self._peer_informer

    def _stop_peer_informer(self) -> None:
        if self._peer_informer is not None:
            self._peer_informer.stop()
            self._peer_informer = None

    def _readmit_leftover_paused(self) -> None:
        """Unpause components a previous run left paused (it died between
        committing the mode and re-admitting). ``original={}`` means the
        restore derives purely from the current label values — exactly the
        crash-recovery semantics readmit_components documents. An apiserver
        failure here propagates: the reconcile is noted failed and the
        backoff retry re-attempts the restore — reporting success over
        still-stranded components would end the retry ladder with the node
        not serving. A successful restore also retires any drain intents a
        crashed run left open in the journal — the stranding they recorded
        no longer exists."""
        evict.readmit_components(self.api, self.node_name, {})
        if self.intents is not None:
            try:
                self.intents.close_open("drain", recovered="readmitted")
            except intent_mod.JournalError as e:
                log.warning("could not close recovered drain intents: %s", e)

    def _cc_mode_chips(
        self, topo: SliceView, mode: str
    ) -> tuple[ChipView, ...] | None:
        """Select chips for a non-slice mode change, with the reference's
        mixed-capability policy (main.py:232-253)."""
        cc_capable = topo.cc_capable_chips()
        if 0 < len(cc_capable) < len(topo.chips) and mode != MODE_OFF:
            # Mixed capability is unrecoverable misconfiguration: crash so the
            # DaemonSet restart surfaces it loudly (reference main.py:237-240).
            log.error(
                "node has %d CC-capable of %d chips — mixed capability cannot "
                "host mode %s; exiting (DaemonSet restart acts as retry)",
                len(cc_capable), len(topo.chips), mode,
            )
            sys.exit(1)
        if not cc_capable:
            log.info("no CC-capable chips; reporting state off")
            self._report_state(MODE_OFF)
            return None
        return topo.chips if mode == MODE_OFF else cc_capable

    def _slice_mode_chips(self, topo: SliceView) -> tuple[ChipView, ...]:
        """Slice-wide CC requires every chip in the ICI domain to support it
        (the reference's all-devices-must-support-PPCIe rule, main.py:279-282).

        Divergence from the reference's sys.exit(1): unsupported hardware is
        a *stable* misconfiguration — restarting cannot change it — so it
        fails soft (failed + reason) instead of crash-looping."""
        lacking = [c for c in topo.chips if not c.slice_cc_supported]
        if lacking:
            raise ModeUnsupported(
                f"{len(lacking)} of {len(topo.chips)} chips lack slice-wide "
                f"CC support ({', '.join(c.name for c in lacking[:4])}); "
                "cannot form a slice CC domain",
                reason="slice-mode-unsupported",
            )
        return topo.chips

    def _mode_is_set(self, chips: tuple[ChipView, ...], mode: str) -> bool:
        """Idempotency check (reference mode_is_set, main.py:428-447)."""
        try:
            return all(self.backend.query_cc_mode(c) == mode for c in chips)
        except GpuError as e:
            log.warning("query during idempotency check failed (%s); proceeding", e)
            return False

    def _apply_with_eviction(
        self, topo: SliceView, chips: tuple[ChipView, ...], mode: str,
        m: metrics_mod.ReconcileMetrics,
        barrier: slicecoord.SliceBarrier | None = None,
    ) -> bool:
        """Drain, reconfigure, re-admit (reference main.py:544-578),
        pipelined (unless CC_PIPELINE_TRANSITIONS=0): staging — a pure
        staged.json write touching no workload-visible hardware — runs
        CONCURRENTLY with the pod-drain bracket. The hard orderings are
        untouched: this host's reset still waits for both the drain AND
        the stage to complete, and on multi-host slices the barrier's
        staged marker is only published AFTER the drain (the marker means
        "staged and drained"; publishing it mid-drain would let peers
        half-bounce the fabric under a strict drain that then fails), so
        no reset ever runs under undrained workloads anywhere in the
        slice.

        Re-admission runs even when the reconfigure fails, so components
        are never left paused by a failed toggle — including a strict-mode
        drain timeout, which fails the reconcile with the staging rolled
        back and no disruptive hardware touched. On the happy path the
        readmit bracket is kicked off while the smoke workload runs
        (_apply_direct), and ``readmit.finish()`` below joins it — its
        true outcome still gates the drain-intent close.

        The drain bracket is journaled intent→commit around pause/readmit:
        a crash (or SIGKILL) between the pause landing and re-admission
        leaves the intent open, and journal replay restores the paused set
        at the next boot even when the apiserver read that used to reveal
        the stranding is unavailable. The transition intent begins BEFORE
        the overlapped stage (write-ahead), so a crash anywhere in the
        drain window replays as a clean pre-reset rollback."""
        dtxn = self._journal_begin("drain", mode=mode)
        txn = None
        stage_task: _PipelineTask | None = None
        if self.pipeline_transitions:
            txn = self._begin_transition_intent(topo, chips, mode)
            stage_task = _PipelineTask(
                "stage",
                lambda: self._stage_for_pipeline(chips, mode, m, txn),
            )
        try:
            with m.phase(metrics_mod.PHASE_DRAIN):
                original = evict.evict_components(
                    self.api,
                    self.node_name,
                    self.operator_namespace,
                    timeout_s=self.eviction_timeout_s,
                    poll_interval_s=self.eviction_poll_interval_s,
                    proceed_on_timeout=not self.strict_eviction,
                    workload_ack_timeout_s=self.drain_ack_timeout_s,
                )
        except evict.EvictionTimeout as e:
            log.error("strict eviction failed: %s — not touching hardware", e)
            self._unwind_pipelined_stage(stage_task, chips, txn,
                                         reason="drain-timeout")
            txn = None
            m.result = "failed"
            self._record_failure("drain-timeout")
            self._emit_node_event(
                "Warning", "CCModeDrainTimeout",
                f"strict eviction timed out before mode {mode}: {e}",
            )
            try:
                self._report_state(STATE_FAILED, reason="drain-timeout")
            finally:
                # Re-admit even if the state-label patch itself fails —
                # components must never stay paused behind a failed toggle.
                with m.phase(metrics_mod.PHASE_READMIT):
                    evict.readmit_components(self.api, self.node_name, e.original)
                self._journal_close(dtxn, ok=True, outcome="drain-timeout")
            return False
        except BaseException:
            # Any other exception escaping the drain (e.g. a transport
            # error during the pod wait, AFTER the pause patch landed)
            # leaves the drain intent OPEN on purpose: components may
            # genuinely be paused, and replay's recovery readmit is a
            # no-op when they are not. The overlapped stage thread must
            # not outlive the reconcile, and the open transition intent
            # (phase begun/staged) replays as a clean rollback.
            if stage_task is not None:
                stage_err = stage_task.join_quiet()
                if stage_err is not None:
                    log.warning(
                        "overlapped stage also failed during the aborted "
                        "drain: %s", stage_err,
                    )
            with self._transition_lock:
                self._inflight_transition = None
            raise
        # Re-admission is kicked off by _apply_direct while the smoke
        # workload runs (readmit ∥ smoke); finish() below joins it — or
        # runs it synchronously when the pipeline never got that far.
        readmit = _ReadmitOnce(
            lambda: self._readmit_bracket(m, original),
            on_start=lambda: self._journal_mark(
                dtxn, intent_mod.PHASE_READMIT
            ),
        )
        try:
            return self._apply_direct(
                topo, chips, mode, m, barrier,
                txn=txn, stage_task=stage_task, readmit=readmit,
            )
        finally:
            readmit.finish()
            # Only after a SUCCESSFUL readmit (a readmit aborted by an
            # apiserver error must leave the intent open for replay); the
            # restore covered any stranding, so older leftover drain
            # intents retire with this one.
            self._journal_close(dtxn, ok=True)
            if self.intents is not None:
                try:
                    self.intents.close_open("drain", recovered="readmitted")
                except intent_mod.JournalError as err:
                    log.warning("could not close drain intents: %s", err)

    def _begin_transition_intent(
        self, topo: SliceView, chips: tuple[ChipView, ...], mode: str,
    ) -> str | None:
        """Write-ahead intent: the journal record lands (fsync'd) BEFORE
        the first hardware-effecting step, so a crash anywhere in the
        pipeline restarts with a local record of exactly what was in
        flight — phase marks tell replay whether the disruptive reset had
        begun (roll back) or may have landed (ask the hardware). Also
        publishes the in-flight record the preemption monitor thread
        hands off to a replacement node (handle_preemption_notice)."""
        txn = self._journal_begin(
            "transition", mode=mode, chips=[c.index for c in chips],
        )
        with self._transition_lock:
            self._inflight_transition = {
                "mode": mode,
                "chips": [c.index for c in chips],
                "phase": intent_mod.PHASE_BEGUN,
                "slice_id": topo.slice_id,
                "multi_host": topo.is_multi_host,
            }
        return txn

    def _readmit_bracket(self, m: metrics_mod.ReconcileMetrics,
                         original: dict) -> None:
        with m.phase(metrics_mod.PHASE_READMIT):
            evict.readmit_components(self.api, self.node_name, original)

    def _stage_for_pipeline(
        self, chips: tuple[ChipView, ...], mode: str,
        m: metrics_mod.ReconcileMetrics,
        txn: str | None,
    ) -> None:
        """The overlapped half of stage-during-drain: stage the chips —
        a pure staged.json write, no workload-visible hardware.

        Deliberately NOT overlapped: the slice barrier's staged-marker
        publication. The marker means "this host is staged AND DRAINED";
        publishing it mid-drain would let the leader commit — and peers
        reset, disrupting the whole ICI fabric — while this host's pods
        are still draining (or while a strict drain is about to fail
        without ever touching hardware). It is published at drain-join
        in _apply_direct, exactly as honest as before."""
        with m.phase(metrics_mod.PHASE_STAGE):
            self.backend.stage_cc_mode(chips, mode)
        self._journal_mark(txn, intent_mod.PHASE_STAGED)
        with self._transition_lock:
            if self._inflight_transition is not None:
                self._inflight_transition["phase"] = intent_mod.PHASE_STAGED

    def _unwind_pipelined_stage(
        self, stage_task: _PipelineTask | None,
        chips: tuple[ChipView, ...],
        txn: str | None,
        reason: str,
    ) -> None:
        """Roll an overlapped stage back out on a pre-hardware failure
        (strict drain timeout): nothing disruptive ran — and no barrier
        marker was published (publication waits for the drain) — so the
        clean exit is clear_staged + an aborted intent, the same shape
        journal replay produces for a pre-reset crash."""
        if stage_task is None:
            self._journal_close(txn, ok=False, reason=reason)
            with self._transition_lock:
                self._inflight_transition = None
            return
        stage_err = stage_task.join_quiet()
        if stage_err is not None:
            log.warning("overlapped stage failed (%s); rolling back anyway",
                        stage_err)
        try:
            self.backend.clear_staged(chips)
        except GpuError as e:
            log.warning("could not clear staged mode during unwind: %s", e)
        self._journal_close(txn, ok=False, reason=reason)
        with self._transition_lock:
            self._inflight_transition = None

    def _apply_direct(
        self, topo: SliceView, chips: tuple[ChipView, ...], mode: str,
        m: metrics_mod.ReconcileMetrics,
        barrier: slicecoord.SliceBarrier | None = None,
        txn: str | None = None,
        stage_task: _PipelineTask | None = None,
        readmit: _ReadmitOnce | None = None,
    ) -> bool:
        """The phased hardware transition (reference main.py:449-542,
        restructured: slice atomicity is structural in the backend contract,
        and verify is upgraded with attestation + smoke), pipelined where
        the contract allows:

        - ``stage_task`` (from _apply_with_eviction) means the stage (and
          multi-host staged publication) already ran overlapped with the
          drain; it is joined here — strictly before any barrier wait or
          reset — so stage/publish failures surface exactly like serial
          ones and a modeled SIGKILL in the overlapped step unwinds as a
          crash.
        - attestation prep (measured-file hashing) overlaps wait_ready.
        - ``readmit`` (when provided) is kicked off right before the smoke
          workload: re-admission is pure apiserver label writes and the
          hardware transition is already committed and attested by then.
        - the attestation-digest fast path (CC_SMOKE_DIGEST_FAST_PATH)
          skips the full smoke when the verified runtime digest is
          unchanged since the last full-smoke-verified flip.

        On a multi-host slice, ANY mode change disrupts the whole ICI
        domain, so the reset is gated behind the slice-wide commit barrier
        (``barrier``, built by set_cc_mode): no host resets before every
        host of the slice is staged — the cross-host generalization of the
        reference's PPCIe stage-all/reset-all fabric atomicity
        (main.py:362-368) — and never before its OWN drain completed.
        Barrier COMPLETION (marker cleanup, the leader's bounded wait for
        peers) happens in set_cc_mode after re-admission, so it never
        extends the drain window."""
        if txn is None:
            # The pipelined evict path began the intent before the drain;
            # the serial/direct path begins it here.
            txn = self._begin_transition_intent(topo, chips, mode)
        warmup = None
        try:
            if stage_task is not None:
                # Joined strictly before the staged publication, the
                # barrier wait and the reset: the drain has already
                # completed by the time we are called, so the published
                # marker's "staged and drained" claim is true.
                stage_task.join()
            else:
                with m.phase(metrics_mod.PHASE_STAGE):
                    self.backend.stage_cc_mode(chips, mode)
                self._journal_mark(txn, intent_mod.PHASE_STAGED)
                with self._transition_lock:
                    self._inflight_transition["phase"] = intent_mod.PHASE_STAGED
            if barrier is not None:
                with m.phase(metrics_mod.PHASE_BARRIER):
                    barrier.publish_staged(mode)
                    barrier.await_commit(mode)
            self._journal_mark(txn, intent_mod.PHASE_RESET)
            with self._transition_lock:
                self._inflight_transition["phase"] = intent_mod.PHASE_RESET
            with m.phase(metrics_mod.PHASE_RESET):
                self.backend.reset(chips)
            # Attestation prep (tpuvm: hashing an O(100 MB) libtpu into
            # the measured-file memo) needs nothing from the post-reset
            # runtime — overlap it with the boot wait. Advisory: a prep
            # failure is swallowed; fetch_attestation re-does the work.
            prep_task = None
            if self.pipeline_transitions and mode != MODE_OFF:
                prep_task = _PipelineTask("attest-prep", self._attest_prep)
            # Smoke warmup ∥ wait_ready: the smoke subprocess starts NOW
            # in compile-only mode (dispatch gated), so the boot wait
            # absorbs its interpreter-start + import + compile span. The
            # gate is released only at the smoke phase below — after the
            # runtime is verifiably ready and attestation passed — and
            # every failure path cancels the child instead of releasing.
            run_smoke = bool(self.smoke_workload) and self.smoke_workload != "none"
            if run_smoke and self.pipeline_transitions and self.smoke_warmup:
                warmup = self._start_smoke_warmup()
            try:
                with m.phase(metrics_mod.PHASE_WAIT_READY):
                    self.backend.wait_ready(chips, self.ready_timeout_s)
            finally:
                if prep_task is not None:
                    prep_err = prep_task.join_quiet()
                    if prep_err is not None:
                        log.debug("attestation prep failed (advisory): %s",
                                  prep_err)
            # Verify 1: committed mode matches (reference main.py:524-528).
            for chip in chips:
                got = self.backend.query_cc_mode(chip)
                if got != mode:
                    raise GpuError(
                        f"verification failed on {chip.name}: "
                        f"wanted {mode}, device reports {got}"
                    )
            # The hardware transition is now fact: commit the intent before
            # the (non-hardware) attest/smoke verifies — their failure
            # labels the node failed but must not make replay re-reset
            # chips that verifiably hold the mode.
            self._journal_close(txn, ok=True)
            txn = None
            # Verify 2: attestation (new; skipped for plain 'off').
            quote = None
            if mode != MODE_OFF:
                with m.phase(metrics_mod.PHASE_ATTEST):
                    nonce = attestation.fresh_nonce()
                    quote = self.backend.fetch_attestation(nonce)
                    attestation.verify_quote(
                        quote,
                        nonce,
                        expected_mode=mode,
                        expected_slice_id=topo.slice_id,
                        debug_policy=(mode == MODE_DEVTOOLS),
                        allow_fake=self.allow_fake_quotes,
                    )
                    # CUDA work is held back until the GPUs' ready state is set.
                    self.backend.set_gpus_ready()
            # Verify 3: end-to-end JAX smoke workload (new), with the
            # attestation-digest fast path (env-gated, default off): a
            # flip landing on the exact runtime digest the last FULL
            # smoke verified may skip the workload — attest-only verify.
            fastpath_hit = False
            if run_smoke and quote is not None and self.smoke_digest_fastpath:
                fastpath_hit = self._smoke_fastpath_check(quote)
            if readmit is not None and self.pipeline_transitions:
                # Safe-to-release point: every chip verifiably holds the
                # committed mode, the intent is closed, and attestation
                # passed. Re-admission (pure apiserver label writes) runs
                # while the smoke compiles/executes; its true outcome is
                # joined by the owner's finish() before the drain intent
                # closes.
                readmit.start_async()
            if warmup is not None and warmup.died_during_warmup():
                # The child died BEFORE any release — a warmup
                # infrastructure failure (e.g. client init against the
                # mid-boot runtime), not a smoke verdict. The serial
                # smoke below runs against the now-ready, attested
                # runtime, so the flip is judged by the same evidence
                # the pre-warmup pipeline used.
                log.warning(
                    "smoke warmup child died before release; falling "
                    "back to the synchronous smoke"
                )
                warmup.cancel("died-during-warmup")
                warmup = None
            if run_smoke and not fastpath_hit:
                with m.phase(metrics_mod.PHASE_SMOKE):
                    if warmup is not None:
                        # Dispatch release point: ready + attested, by
                        # construction of everything above this line.
                        result = warmup.release_and_result()
                        warmup = None
                        log.info(
                            "smoke warmup overlapped %.2fs of compile "
                            "with the boot wait (dispatch %.2fs)",
                            result.get("warmup_overlap_s") or 0.0,
                            result.get("warmup_dispatch_s") or 0.0,
                        )
                    else:
                        self._run_smoke(self.smoke_workload)
                if quote is not None:
                    self._store_verified_digest(quote)
            elif warmup is not None and fastpath_hit:
                # The digest fast path decided the full smoke is not
                # needed; the warmed child must never dispatch.
                warmup.cancel("digest-fastpath")
                warmup = None
        except Exception as e:  # noqa: BLE001 - reference parity:
            # any failure labels the node 'failed' and keeps the loop alive
            # (main.py:531-538). BaseExceptions (sys.exit, a modeled
            # SIGKILL) bypass this handler and leave the intent OPEN —
            # exactly the crash record replay recovers from.
            self._journal_close(txn, ok=False, reason=self._failure_reason(e))
            txn = None
            log.error("CC mode change to %s failed: %s", mode, e, exc_info=True)
            if barrier is not None:
                # This host is about to re-admit components, so "staged and
                # drained" no longer describes it: withdraw from the barrier.
                barrier.abort()
            reason = self._failure_reason(e)
            self._record_failure(reason)
            self._report_state(STATE_FAILED, reason=reason)
            self._emit_node_event(
                "Warning", "CCModeFailed", f"CC mode change to {mode} failed: {e}"
            )
            m.result = "failed"
            return False
        finally:
            # The hardware pipeline is over (committed, failed, or a
            # modeled crash unwinding) — there is no transition left to
            # hand off. A warmup child that was never consumed must not
            # dispatch (failure paths, unwinding): kill it. (On a REAL
            # SIGKILL no finally runs; the child covers that itself via
            # the gate's parent-pid watch and exits instead of orphaning.)
            if warmup is not None:
                try:
                    warmup.cancel("pipeline-unwound")
                except Exception as e:  # noqa: BLE001 - never mask the cause
                    log.warning("could not cancel the smoke warmup: %s", e)
            with self._transition_lock:
                self._inflight_transition = None
        self._report_state(mode)
        # The publish patch below also withdraws this host's staged marker
        # (it is no longer mid-transition); the leader's commit-marker
        # retirement waits until set_cc_mode's post-readmit completion.
        self._publish_coordination_labels(topo, quote)
        m.result = "ok"
        log.info("CC mode %s applied and verified on %d chip(s)", mode, len(chips))
        self._emit_node_event(
            "Normal", "CCModeApplied",
            f"CC mode {mode} applied and verified on {len(chips)} chip(s)",
        )
        return True

    @staticmethod
    def _failure_reason(e: Exception) -> str:
        """Machine-readable failed.reason for an apply/verify failure.

        Every ``failed`` state carries a reason (the stateful property
        test's invariant — an operator staring at ``failed`` with no
        reason has only the logs, which a label watcher never sees)."""
        from tpu_cc_manager_torch.smoke.runner import SmokeError

        if isinstance(e, slicecoord.BarrierFenced):
            return "barrier-fenced"
        if isinstance(e, slicecoord.BarrierTimeout):
            return "barrier-timeout"
        if isinstance(e, attestation.AttestationError):
            return "attestation-failed"
        if isinstance(e, SmokeError):
            return "smoke-failed"
        if isinstance(e, KubeApiError):
            return "apiserver-error"
        return "apply-failed"

    def _publish_coordination_labels(self, topo: SliceView, quote) -> None:
        """Advertise slice membership + attestation digest on the node so the
        rolling orchestrator can group hosts by slice and the multi-slice
        verifier can compare runtime digests (ccmanager/rolling.py,
        ccmanager/multislice.py). Best-effort: coordination metadata must
        never fail a reconcile."""
        try:
            from tpu_cc_manager_torch.ccmanager import multislice
            from tpu_cc_manager_torch.ccmanager.rolling import SLICE_ID_LABEL

            # One merge-patch for slice id + quote labels (or None-clears
            # when mode off): a single apiserver round trip, and no window
            # where the slice label is visible with a stale quote. On
            # multi-host topologies the same patch retires the slice staged
            # marker — the mode is set, so "mid-transition" no longer
            # describes this host (covers both the normal apply path and a
            # marker left by a crash between barrier commit and clear,
            # which the idempotent path would otherwise never clean up).
            patch = {SLICE_ID_LABEL: label_safe(topo.slice_id)}
            patch.update(multislice.quote_label_patch(quote))
            if topo.is_multi_host:
                # Best-effort, like the rest of this patch (clear_staged
                # always was — slicecoord.py:197 swallows KubeApiError). A
                # clear lost to an outage is retried by barrier.complete()
                # on the apply path and cleared at the next barrier entry
                # otherwise; followers never act on a staged marker without
                # re-verifying full staging.
                patch[slicecoord.SLICE_STAGED_LABEL] = None
                patch[slicecoord.SLICE_STAGED_GEN_LABEL] = None
            self.api.patch_node_labels(self.node_name, patch)
            # The full signed quote (or a clear when there is none) rides
            # in an annotation so PEERS can re-verify the signature instead
            # of trusting the digest labels (multislice.py trust model).
            multislice.publish_quote_annotation(
                self.api, self.node_name, quote
            )
            if quote is not None:
                log.info(
                    "published attestation for %s: digest=%s mode=%s",
                    self.node_name,
                    patch[f"{multislice.QUOTE_ANNOTATION}.digest"],
                    quote.mode,
                )
        except Exception as e:  # noqa: BLE001 - advisory metadata only
            log.warning("could not publish coordination labels: %s", e)

    def _maybe_answer_challenge(self, node: dict) -> None:
        """Answer an outstanding verifier challenge (multislice.py,
        VERDICT weak #5): re-quote bound to the verifier's nonce and
        republish, giving pool attestation peer-chosen-challenge
        freshness — a replayed old quote cannot carry a nonce the
        verifier only just minted. Best-effort like all coordination
        metadata: an un-answerable challenge (device busy, apiserver
        flake) is logged and re-attempted on the next watch event, and
        verification fails loudly on its own timeout."""
        try:
            from tpu_cc_manager_torch.ccmanager import multislice
            from tpu_cc_manager_torch.labels import CC_MODE_STATE_LABEL

            nonce = multislice.challenge_nonce_of(node)
            if nonce is None or nonce == self._answered_challenge_nonce:
                return
            if self.reconciling:
                return  # the reconcile republishes; answer on the next event
            state = canonical_mode(
                node_labels(node).get(CC_MODE_STATE_LABEL) or ""
            )
            if state not in VALID_MODES or state == MODE_OFF:
                # No committed CC mode -> no quote to re-bind. Remember
                # the nonce so an off node doesn't re-log every event;
                # verification already treats the node as unattested.
                log.info(
                    "challenge %s ignored: no attested mode on this node "
                    "(state=%r)", nonce[:8], state,
                )
                self._answered_challenge_nonce = nonce
                return
            topo = self.backend.discover()
            quote = self.backend.fetch_attestation(nonce)
            attestation.verify_quote(
                quote,
                nonce,
                expected_mode=state,
                expected_slice_id=topo.slice_id,
                debug_policy=(state == MODE_DEVTOOLS),
                allow_fake=self.allow_fake_quotes,
            )
            # strict: a swallowed annotation-patch failure must NOT mark
            # the challenge answered (the verifier would time out on a
            # healthy node that never retries) — it raises into the
            # except below and the next watch event re-answers.
            multislice.publish_quote(
                self.api, self.node_name, quote, strict=True
            )
            self._answered_challenge_nonce = nonce
            # Retire the answered challenge so it cannot re-arm after the
            # next reconcile republishes a self-nonce quote — but only if
            # it still holds OUR nonce: a newer challenge issued during
            # the quote fetch must stay for the next event to answer.
            multislice.retire_answered_challenge(
                self.api, self.node_name, nonce
            )
            log.info(
                "answered verifier challenge %s… with a re-quote bound to "
                "it (mode=%s)", nonce[:8], state,
            )
        except Exception as e:  # noqa: BLE001 - advisory; next event retries
            log.warning("could not answer verifier challenge: %s", e)

    def _start_smoke_warmup(self):
        """Spawn the smoke subprocess in compile-only warmup mode (the
        dispatch gate armed), to run concurrently with wait_ready.

        Returns a handle with ``release_and_result()`` / ``cancel()`` —
        the :class:`~tpu_cc_manager_torch.smoke.runner.SmokeWarmup` contract —
        or None when the warmup can't apply: an injected smoke_runner
        with no matching warmup factory (tests, custom harnesses) keeps
        today's synchronous smoke, and a spawn failure degrades the same
        way (advisory: the serial path still verifies end to end)."""
        factory = self.smoke_warmup_factory
        if factory is None:
            if self.smoke_runner is not None:
                return None
            from tpu_cc_manager_torch.smoke.runner import SmokeWarmup

            factory = SmokeWarmup
        try:
            return factory(self.smoke_workload)
        except Exception as e:  # noqa: BLE001 - warmup is an optimization
            log.warning(
                "smoke warmup spawn failed (falling back to the "
                "synchronous smoke): %s", e,
            )
            return None

    def _run_smoke(self, workload: str) -> dict:
        if self.smoke_runner is not None:
            return self.smoke_runner(workload)
        from tpu_cc_manager_torch.smoke.runner import run_workload_subprocess

        return run_workload_subprocess(workload)

    def _attest_prep(self) -> None:
        """Overlapped attestation prep (runs during wait_ready)."""
        with trace_mod.span("attest.prep"):
            self.backend.prepare_attestation()

    # ------------------------------------------------------------------
    # Attestation-digest smoke fast path (CC_SMOKE_DIGEST_FAST_PATH)
    # ------------------------------------------------------------------

    def _digest_store_path(self) -> str | None:
        if not self._state_dir:
            return None
        return os.path.join(self._state_dir, "verified_digest.json")

    def _load_verified_digest(self) -> dict | None:
        path = self._digest_store_path()
        if path is None:
            return None
        try:
            with open(path, "r", encoding="utf-8") as f:
                record = json.load(f)
        except FileNotFoundError:
            return None
        except (OSError, ValueError) as e:
            log.warning("unreadable verified-digest record %s: %s", path, e)
            return None
        return record if isinstance(record, dict) else None

    def _store_verified_digest(self, quote) -> None:
        """Persist the runtime measurement digest a FULL smoke just
        verified (atomic write in the backend state dir). Best-effort:
        the fast path degrades to 'cold' (full smoke every flip) when it
        cannot persist — never the other way around."""
        path = self._digest_store_path()
        if path is None:
            return
        record = {
            "digest": attestation.quote_digest(quote),
            "mode": quote.mode,
            "ts": round(time.time(), 3),
        }
        try:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            tmp = path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(record, f)
            os.replace(tmp, path)
        except OSError as e:
            log.warning("could not persist the verified digest: %s", e)

    def _smoke_fastpath_check(self, quote) -> bool:
        """Whether this flip may skip the full smoke: True only when the
        quote's measurement digest equals the digest the last FULL smoke
        verified (same mode included — the digest binds cc_mode, but the
        record is double-checked so a hand-edited file cannot cross
        modes). Any change — or no record at all — falls through to the
        full smoke. Counted per outcome in tpu_cc_smoke_fastpath_total."""
        digest = attestation.quote_digest(quote)
        stored = self._load_verified_digest()
        if stored is None:
            outcome, hit = "cold", False
        elif (
            stored.get("digest") == digest
            and stored.get("mode") == quote.mode
        ):
            outcome, hit = "hit", True
        else:
            outcome, hit = "miss", False
        self.metrics.record_smoke_fastpath(outcome)
        with trace_mod.span(
            "smoke.fastpath", outcome=outcome, digest=digest[:12],
        ):
            if hit:
                log.info(
                    "smoke fast path: runtime digest %s… unchanged since "
                    "the last full-smoke verify; skipping the %s workload "
                    "(attest-only verify)", digest[:12], self.smoke_workload,
                )
            else:
                log.info(
                    "smoke fast path: %s (digest %s…); running the full "
                    "smoke", outcome, digest[:12],
                )
        return hit

    # ------------------------------------------------------------------
    # Intent-journal boot recovery (before the first apiserver read)
    # ------------------------------------------------------------------

    def recover_from_journal(self) -> None:
        """Replay the intent journal and resolve whatever a crash left in
        flight — from LOCAL truth (journal + hardware), before the first
        apiserver read, so recovery works identically whether the control
        plane is back or still dark.

        Per open transition intent: if every journaled chip already
        reports the intended mode, the reset landed before the crash —
        the intent completes with NO second reset, and the state report
        is queued (deferred while dark). If the crash hit before the
        reset phase, nothing disruptive ran: the staging is rolled back
        and the intent aborted. If the reset had begun but the hardware
        doesn't hold the mode, the reset provably never committed (the
        tpuvm backend's pending markers keep reporting ``resetting``) —
        the intent aborts and the normal reconcile re-applies: each chip
        is reset at most once across the crash, never twice.

        Open drain intents get their components re-admitted when the
        apiserver answers; while dark they stay open and the first
        reconcile's readmit retires them.

        A journal that fails closed (mid-file corruption) feeds the
        remediation ladder instead of guessing at half-applied state."""
        if self.intents is None:
            return
        try:
            replayed = self.intents.replay()
        except intent_mod.JournalCorrupt as e:
            log.error("intent journal failed closed: %s", e)
            self.metrics.record_journal_replay("failed-closed")
            self.last_failure_reason = "journal-corrupt"
            if self.remediation is not None:
                try:
                    self.remediation.note_failure("journal-corrupt")
                except Exception as err:  # noqa: BLE001 - ladder is advisory
                    log.warning("could not feed remediation ladder: %s", err)
            return
        transitions = self.intents.open_intents("transition")
        drains = self.intents.open_intents("drain")
        remediations = self.intents.open_intents(intent_mod.KIND_REMEDIATION)
        if replayed.records and not transitions and not drains and not remediations:
            self.metrics.record_journal_replay("clean")
        for intent in remediations:
            # A crash mid-remediation-rung: the backend's pending markers
            # already force a clean re-apply if the reset never committed,
            # and the ladder state is persisted in the node annotation —
            # close the intent and let the normal reconcile re-drive.
            self._journal_close(
                intent["txn"], ok=False, recovered="remediation-interrupted"
            )
            self.metrics.record_journal_replay("rolled-back")
            log.warning(
                "journal replay: remediation %s (%s) was interrupted; the "
                "ladder re-drives from its persisted annotation",
                intent["txn"], intent.get("op"),
            )
        for intent in transitions:
            self._recover_transition(intent)
        if drains:
            # Stranded paused components from a crashed drain bracket:
            # restore them now if the apiserver answers; otherwise the
            # intents stay open and the first post-reconnect reconcile's
            # readmit retires them.
            try:
                self._readmit_leftover_paused()
                log.info(
                    "journal replay restored components from %d open drain "
                    "intent(s)", len(drains),
                )
            except KubeApiError as e:
                self._note_api_err(e)
                log.warning(
                    "apiserver unreachable; %d open drain intent(s) kept "
                    "for the first post-reconnect reconcile: %s",
                    len(drains), e,
                )

    def _recover_transition(self, intent: dict) -> None:
        mode = canonical_mode(str(intent.get("mode") or ""))
        txn = intent["txn"]
        phase = intent.get("phase")
        try:
            topo = self.backend.discover()
        except GpuError as e:
            log.error(
                "journal replay cannot resolve %s (discovery failed: %s); "
                "intent stays open for the next restart", txn, e,
            )
            self.metrics.record_journal_replay("failed-closed")
            return
        by_index = {c.index: c for c in topo.chips}
        chips = tuple(
            by_index[i] for i in (intent.get("chips") or []) if i in by_index
        )
        committed = bool(chips) and self._mode_is_set(chips, mode)
        if committed:
            log.info(
                "journal replay: transition %s to %s already committed on "
                "the hardware; completing without a second reset", txn, mode,
            )
            self._journal_close(txn, ok=True, recovered="hardware-committed")
            self.metrics.record_journal_replay("completed")
            if not self.intents.open_intents("drain"):
                # Queue the truthful state report (deferred while dark);
                # with a drain still open the first reconcile readmits
                # BEFORE reporting — a node must not advertise ready over
                # known-stranded components.
                try:
                    self._report_state(mode, force_defer=True)
                except KubeApiError as e:
                    log.warning(
                        "recovered state report failed (%s); the first "
                        "reconcile re-reports", e,
                    )
            return
        if phase in (intent_mod.PHASE_BEGUN, intent_mod.PHASE_STAGED, None):
            # The disruptive reset never started: roll the staging back.
            try:
                self.backend.clear_staged(chips)
            except GpuError as e:
                log.warning("could not clear staged mode during replay: %s", e)
            self._journal_close(txn, ok=False, recovered="rolled-back")
            self.metrics.record_journal_replay("rolled-back")
            log.info(
                "journal replay: transition %s to %s rolled back "
                "(crash before reset; nothing disruptive ran)", txn, mode,
            )
        else:
            # Reset begun but the mode never landed: the backend's own
            # crash markers (pending.json → 'resetting') already force the
            # full re-apply; close the intent so it isn't re-judged.
            self._journal_close(txn, ok=False, recovered="reset-incomplete")
            self.metrics.record_journal_replay("rolled-back")
            log.warning(
                "journal replay: transition %s to %s was interrupted "
                "mid-reset and did not commit; the reconcile will re-apply",
                txn, mode,
            )

    # ------------------------------------------------------------------
    # Preemption fast-drain + handoff (spot/preemptible nodes)
    # ------------------------------------------------------------------

    def handle_preemption_notice(self) -> str:
        """React to a platform preemption notice inside the hard
        termination deadline (CC_PREEMPTION_DEADLINE_S ≪ the 300 s drain
        budget), in strict priority order:

        1. **fast drain** — workload checkpoint handshake first
           (checkpoint-before-pause; the training job's unsaved state is
           the one thing the kill destroys for good), then component
           eviction compressed into the remaining budget, proceeding on
           timeout (the VM dies at the deadline either way);
        2. **handoff publish** — the in-flight transition (if any) is
           journaled as a ``handoff`` intent AND mirrored to the node's
           handoff annotation, so the replacement node — fresh disk, no
           journal — resumes the flip instead of rediscovering it;
        3. **slice fence** — on a multi-host slice the fencing generation
           is bumped, so peers mid-barrier abort fast (BarrierFenced)
           instead of burning their barrier deadline on the departing
           host's staged marker.

        Idempotent per process (the platform signal is level-triggered;
        one fast drain per VM lifetime). Returns the recorded outcome:
        ``handoff`` / ``clean`` / ``handoff-failed`` / ``duplicate``."""
        if self._preemption_handled:
            return "duplicate"
        self._preemption_handled = True
        started = time.monotonic()
        with self._transition_lock:
            inflight = (
                dict(self._inflight_transition)
                if self._inflight_transition is not None else None
            )
        log.warning(
            "PREEMPTION notice: fast-draining within %.0fs (%s)",
            self.preemption_deadline_s,
            f"transition to {inflight['mode']} in flight "
            f"(phase={inflight['phase']})"
            if inflight else "no transition in flight",
        )
        self._emit_node_event(
            "Warning", "CCNodePreempted",
            f"platform preemption notice; fast-draining within "
            f"{self.preemption_deadline_s:.0f}s",
        )
        with trace_mod.root_span(
            "preemption", journal=self.journal, node=self.node_name,
            deadline_s=self.preemption_deadline_s,
        ):
            if self.evict_components:
                try:
                    evict.fast_drain_components(
                        self.api,
                        self.node_name,
                        self.operator_namespace,
                        deadline_s=self.preemption_deadline_s,
                        poll_interval_s=min(
                            self.eviction_poll_interval_s,
                            evict.FAST_DRAIN_POLL_INTERVAL_S,
                        ),
                    )
                except Exception as e:  # noqa: BLE001 - the handoff
                    # publish below matters more than a clean drain; any
                    # failure shape here must not consume its window.
                    log.warning(
                        "fast drain failed (%s); proceeding to the "
                        "handoff publish", e,
                    )
            # Re-read AFTER the drain: the fast drain can run for most of
            # the deadline, and a transition the watch loop started during
            # it must still be handed off — while one that COMPLETED
            # during the drain must NOT be (the pre-drain snapshot above
            # is only for the log line; publishing it would make the
            # replacement spuriously count a 'resumed' flip). Copy
            # defensively — the reconcile thread keeps advancing the
            # phase field while the publish serializes it.
            with self._transition_lock:
                live = self._inflight_transition
                inflight = dict(live) if live is not None else None
            outcome = "clean"
            if inflight is not None:
                outcome = self._publish_handoff(inflight)
                if inflight.get("multi_host"):
                    slicecoord.fence_departed_peer(
                        self.api, self.node_name,
                        str(inflight.get("slice_id") or ""),
                        reason="preempted", metrics=self.metrics,
                    )
        self.metrics.set_fast_drain_seconds(time.monotonic() - started)
        self.metrics.record_preemption(outcome)
        log.warning(
            "preemption handling finished in %.2fs (outcome=%s); awaiting "
            "the platform kill", time.monotonic() - started, outcome,
        )
        return outcome

    def _publish_handoff(self, inflight: dict) -> str:
        """Journal + publish the interrupted transition for the
        replacement node. The journal record is local crash truth (a
        cancelled reclaim replays it as a no-op commit); the annotation
        is what actually survives — the reclaim takes the disk."""
        record = {
            "mode": inflight.get("mode"),
            "phase": inflight.get("phase"),
            "chips": inflight.get("chips"),
            "slice_id": inflight.get("slice_id"),
            "from": self.node_name,
            "ts": round(time.time(), 3),
        }
        txn = self._journal_begin(intent_mod.KIND_HANDOFF, **record)
        try:
            self.api.patch_node_annotations(
                self.node_name,
                {HANDOFF_ANNOTATION: json.dumps(record, sort_keys=True)},
            )
        except Exception as e:  # noqa: BLE001 - count + log; the kill is
            # coming regardless and the caller still fences the slice.
            self._journal_close(txn, ok=False, reason="publish-failed")
            log.error("could not publish the handoff record: %s", e)
            return "handoff-failed"
        self._journal_close(txn, ok=True, published=True)
        log.warning(
            "handoff published: transition to %s (phase=%s) awaits the "
            "replacement node", record["mode"], record["phase"],
        )
        return "handoff"

    def consume_handoff(self) -> None:
        """Startup (replacement-node) half of the handoff: read the
        annotation a preempted predecessor left on this node, remember it
        until the flip completes, and seed the journal's desired-mode
        local truth so even a dark boot knows what it was converging on.
        Best-effort — without the record the normal reconcile still
        converges from the desired label; the handoff only adds intent
        continuity (and the resumed/cleared bookkeeping)."""
        try:
            node = self.api.get_node(self.node_name)
            self._note_api_ok()
        except KubeApiError as e:
            self._note_api_err(e)
            log.debug("handoff check skipped (apiserver unreachable): %s", e)
            return
        from tpu_cc_manager_torch.kubeclient.api import node_annotations

        # Same GET serves the prestage caches: a restarted agent must
        # know it is holding a pre-staged mode BEFORE its initial apply,
        # or that apply would bounce the spare back to the desired mode.
        self._note_prestage(node)
        raw = node_annotations(node).get(HANDOFF_ANNOTATION)
        if not raw:
            return
        try:
            record = json.loads(raw)
            mode = (
                canonical_mode(str(record.get("mode") or ""))
                if isinstance(record, dict)
                else ""
            )
        except ValueError:
            record, mode = None, ""
        if not isinstance(record, dict) or mode not in VALID_MODES:
            log.warning("garbled handoff annotation %r; clearing it", raw[:128])
            self._clear_handoff_annotation()
            return
        self._handoff = record
        log.warning(
            "handoff record found: predecessor %s was preempted mid-flip "
            "to %s (phase=%s); this node resumes the transition",
            record.get("from"), mode, record.get("phase"),
        )
        if self.intents is not None:
            try:
                self.intents.note_desired(mode)
            except intent_mod.JournalError as e:
                log.warning("could not journal the handed-off mode: %s", e)

    def _retire_handoff(self) -> None:
        """After a successful reconcile with a consumed handoff pending:
        the flip the predecessor started is now committed — clear the
        annotation and count the resumption. A failed clear retries on
        the next successful reconcile (the record is stale but harmless:
        consume_handoff runs only at startup)."""
        if self._handoff is None:
            return
        if not self._clear_handoff_annotation():
            return
        self.metrics.record_preemption("resumed")
        self._emit_node_event(
            "Normal", "CCHandoffResumed",
            f"completed the flip to {self._handoff.get('mode')} handed "
            f"off by preempted node agent {self._handoff.get('from')}",
        )
        self._handoff = None

    def _clear_handoff_annotation(self) -> bool:
        try:
            self.api.patch_node_annotations(
                self.node_name, {HANDOFF_ANNOTATION: None}
            )
            return True
        except KubeApiError as e:
            log.warning("could not clear the handoff annotation: %s", e)
            return False

    # ------------------------------------------------------------------
    # Spare pre-staging (zero-bounce flips)
    # ------------------------------------------------------------------

    def _note_prestage(self, node: dict) -> None:
        """Cache the prestage request/status annotations off a node
        object (watch event or startup GET). Garbled values parse to
        None — a pre-staging hint must never fail a reconcile."""
        from tpu_cc_manager_torch.kubeclient.api import node_annotations

        ann = node_annotations(node)
        raw = ann.get(PRESTAGE_ANNOTATION)
        mode = canonical_mode(str(raw)) if raw else ""
        self._prestage_request = mode if mode in VALID_MODES else None
        raw = ann.get(PRESTAGED_ANNOTATION)
        prestaged = None
        if raw:
            try:
                obj = json.loads(raw)
            except ValueError:
                obj = None
            if (
                isinstance(obj, dict)
                and canonical_mode(str(obj.get("mode") or "")) in VALID_MODES
            ):
                prestaged = obj
        if prestaged is None:
            # A snapshot without the status record may simply predate
            # our own publish (events queue behind the prestage pass):
            # the in-process done record outranks a stale view.
            prestaged = self._prestage_done
        self._prestaged = prestaged

    def _maybe_prestage(self, node: dict) -> bool | None:
        """Run a pre-staging pass when the node's annotations ask for
        one: the PRESTAGE annotation names a mode != desired, and the
        node does not already hold it. Returns the pass's outcome for
        the watch loop's backoff bookkeeping (the abort path — request
        deleted mid-hold — returns the revert reconcile's outcome), or
        None when nothing ran."""
        self._note_prestage(node)
        if not self.prestage:
            return None
        labels = node_labels(node)
        desired = self.with_default(labels.get(CC_MODE_LABEL))
        state_label = labels.get(labels_mod.CC_MODE_STATE_LABEL)
        req = self._prestage_request
        done_mode = (
            canonical_mode(str(self._prestaged.get("mode") or ""))
            if self._prestaged is not None else None
        )
        if req is None:
            if done_mode is not None and done_mode == state_label != desired:
                # Possible abort: the request annotation is gone while
                # the node still HOLDS the pre-staged mode. Confirm
                # against a FRESH read first — watch events queued
                # behind a long reconcile can show this shape
                # transiently (e.g. mid-consume after the wave landed).
                fresh = self.api.get_node(self.node_name)
                self._note_prestage(fresh)
                fresh_labels = node_labels(fresh)
                desired = self.with_default(fresh_labels.get(CC_MODE_LABEL))
                state_label = fresh_labels.get(labels_mod.CC_MODE_STATE_LABEL)
                done_mode = (
                    canonical_mode(str(self._prestaged.get("mode") or ""))
                    if self._prestaged is not None else None
                )
                if not (
                    self._prestage_request is None
                    and done_mode is not None
                    and done_mode == state_label != desired
                ):
                    return None
                # Confirmed: clear the status record and reconcile back
                # to the desired mode.
                log.warning(
                    "prestage of mode %s aborted (request annotation "
                    "deleted); reverting to desired mode %s",
                    done_mode, desired,
                )
                self._prestage_done = None
                self._clear_prestaged_annotation()
                return self.set_cc_mode(desired)
            return None
        if req == desired:
            # Moot: the wave arrived before (or instead of) the
            # prestage pass — the normal desired-mode reconcile owns
            # convergence and its success consumes the request.
            return None
        if done_mode == req and state_label == req:
            return None  # already pre-staged and holding
        if self._prestage_done is not None and canonical_mode(
            str(self._prestage_done.get("mode") or "")
        ) == req:
            # This process already completed the pass; the snapshot is a
            # stale mid-transition view queued behind it.
            return None
        return self._run_prestage(req, desired)

    def _run_prestage(self, mode: str, prior: str) -> bool:
        """The pre-staging pass itself: the FULL journaled transition
        (drain/stage/reset/verify/warmup-backed smoke/readmit — crash
        replay included) run against the annotation's mode while the
        desired label still says ``prior``. The state label ends
        truthful (it reports what the hardware holds); the hold guard
        in _set_cc_mode keeps later reconciles from bouncing the spare
        back until the wave's desired write lands or the request is
        deleted."""
        log.warning(
            "pre-staging CC mode %s ahead of its rollout wave "
            "(desired stays %s until the wave opens)", mode, prior,
        )
        t0 = time.monotonic()
        self._in_prestage = True
        self.metrics.set_prestage_in_progress(True)
        try:
            ok = self.set_cc_mode(mode)
        finally:
            self._in_prestage = False
            self.metrics.set_prestage_in_progress(False)
        seconds = round(time.monotonic() - t0, 3)
        self.metrics.set_spare_prestage_seconds(seconds)
        if not ok:
            # The spare stays on the normal failed-reconcile path (the
            # backoff retry re-applies the DESIRED mode, reverting any
            # partial prestage); the orchestrator's prestage await times
            # out and the wave falls back to a full flip.
            log.error(
                "pre-staging of mode %s FAILED after %.1fs; the wave "
                "falls back to a full flip", mode, seconds,
            )
            self._emit_node_event(
                "Warning", "CCPrestageFailed",
                f"pre-staging of CC mode {mode} failed",
            )
            return False
        record = {
            "mode": mode,
            "prior": prior,
            "seconds": seconds,
            "ts": round(time.time(), 3),
        }
        self._prestage_done = record
        try:
            self.api.patch_node_annotations(
                self.node_name,
                {PRESTAGED_ANNOTATION: json.dumps(record, sort_keys=True)},
            )
        except KubeApiError as e:
            # The orchestrator never sees the record and falls back to a
            # full-flip await; the hold still engages off the local
            # cache, and the next successful publish heals it.
            log.warning("could not publish the prestaged record: %s", e)
        self._prestaged = record
        self._emit_node_event(
            "Normal", "CCNodePrestaged",
            f"pre-staged CC mode {mode} in {seconds}s; holding for the "
            "rollout wave",
        )
        return True

    def _prestage_hold(self, mode: str, chips: tuple[ChipView, ...]) -> bool:
        """True while this node deliberately HOLDS a pre-staged mode
        that differs from the desired one — the PRESTAGE annotation is
        the suppression: without it, the first desired!=state reconcile
        would bounce the spare straight back and waste the pre-staged
        flip. The hold only binds against the desired mode recorded at
        prestage time: a desired change to any THIRD mode breaks it and
        reconciles normally (the pool moved on; the prestage is stale)."""
        if self._in_prestage or not self.prestage:
            return False
        req, done = self._prestage_request, self._prestaged
        if req is None or done is None or req == mode:
            return False
        if canonical_mode(str(done.get("mode") or "")) != req:
            return False
        if canonical_mode(str(done.get("prior") or "")) != mode:
            return False
        if not self._mode_is_set(chips, req):
            return False
        log.info(
            "holding pre-staged mode %s (desired %s unchanged since the "
            "prestage); the rollout wave's desired write completes the "
            "flip instantly", req, mode,
        )
        return True

    def _consume_prestage(self, mode: str) -> None:
        """Housekeeping after a successful DESIRED-mode reconcile: a
        matching prestage request is consumed (the wave arrived — the
        PRESTAGED status record stays behind as the operator-visible
        explanation of why the wave opened instantly); a record for a
        DIFFERENT mode is stale (the pool moved on past it) and both
        annotations clear so the hold cannot re-engage."""
        if self._in_prestage:
            return
        cleared_req = False
        if self._prestage_request is not None and self._prestage_request == mode:
            cleared_req = self._clear_prestage_request()
        done = self._prestaged
        if done is not None and canonical_mode(
            str(done.get("mode") or "")
        ) != mode:
            # The pool moved past the pre-staged mode: the record (and
            # this process's done copy) is stale.
            self._prestage_done = None
            if not cleared_req and self._prestage_request is not None:
                self._clear_prestage_request()
            self._clear_prestaged_annotation()

    def _clear_prestage_request(self) -> bool:
        try:
            self.api.patch_node_annotations(
                self.node_name, {PRESTAGE_ANNOTATION: None}
            )
        except KubeApiError as e:
            # Cache keeps the value; the next successful reconcile
            # retries the clear.
            log.warning("could not clear the prestage request: %s", e)
            return False
        self._prestage_request = None
        return True

    def _clear_prestaged_annotation(self) -> None:
        try:
            self.api.patch_node_annotations(
                self.node_name, {PRESTAGED_ANNOTATION: None}
            )
        except KubeApiError as e:
            log.warning("could not clear the prestaged record: %s", e)
            return
        self._prestaged = None

    def _start_preemption_monitor(self) -> None:
        """Poll the backend's preemption-notice source (GCE: metadata
        ``instance/preempted``) on a daemon thread; the first notice runs
        handle_preemption_notice and the thread retires (the signal is
        level-triggered — one reclaim per VM lifetime)."""
        if self.preemption_poll_s <= 0 or self.preemption_deadline_s <= 0:
            return
        if self._preemption_thread is not None:
            return
        stop = threading.Event()

        def loop() -> None:
            while not stop.wait(self.preemption_poll_s):
                try:
                    if self.backend.preemption_notice():
                        self.handle_preemption_notice()
                        return
                except Exception as e:  # noqa: BLE001 - a flaky notice
                    # source must never kill the monitor (or the agent).
                    log.debug("preemption poll failed (non-fatal): %s", e)

        self._preemption_stop = stop
        self._preemption_thread = threading.Thread(
            target=loop, name="preemption-monitor", daemon=True
        )
        self._preemption_thread.start()

    def _stop_preemption_monitor(self) -> None:
        if self._preemption_stop is not None:
            self._preemption_stop.set()
        if self._preemption_thread is not None:
            self._preemption_thread.join(timeout=2.0)
        self._preemption_stop = None
        self._preemption_thread = None

    # ------------------------------------------------------------------
    # Watch loop (reference call stack 3.4)
    # ------------------------------------------------------------------

    def _startup_mode_read(
        self, stop: threading.Event | None = None
    ) -> tuple[str | None, str] | None:
        """The boot-time desired-mode read, ordered journal → hardware →
        apiserver (recover_from_journal has already run).

        Two divergences from the reference's fatal first GET:

        - **Outage autonomy**: when the apiserver is unreachable AND the
          journal holds a last-known desired mode, the agent keeps serving
          that mode and retries the read on the jittered ladder instead of
          crash-looping — the hardware is already converged (or journal
          replay converged it) and a restart loop would add nothing. With
          no local truth (fresh node, no journal) the GET stays fatal by
          design: crash-as-retry.
        - **Stale-read guard**: a first read that DISAGREES with the
          journaled last-acted-on mode is confirmed with a second read
          before anything acts on it. During a flaky boot (a blackout
          ending mid-boot, a lagging replica) a single stale label must
          not trigger a spurious hardware transition; the confirming read
          either re-errors with an outage (still flaky — keep serving
          local truth, wait out the ladder, retry), fails fatally on a
          real API error (the server answered: same semantics as the
          first read), or returns the fresher value, which wins.

        Returns (label, rv), or None when ``stop`` was set while waiting
        out an outage."""
        attempts = 0

        def wait_out() -> bool:
            """One jittered-ladder wait between boot-time read attempts;
            False when ``stop`` was set while waiting."""
            nonlocal attempts
            attempts += 1
            delay = self._reconnect_policy.delay_for(min(attempts - 1, 8))
            return not retry_mod.wait(delay, stop)

        while True:
            try:
                label, rv = self.get_node_cc_mode_label()
                self._note_api_ok()
            except KubeApiError as e:
                self._note_api_err(e)
                local = (
                    self.intents.last_desired_mode
                    if self.intents is not None else None
                )
                if local is None or not intent_mod.is_outage_error(e):
                    raise  # no local truth (or a real API error): fatal
                log.warning(
                    "apiserver unreachable at boot (%s); serving last-known "
                    "desired mode %r from the intent journal "
                    "(offline %.0fs)", e, local, self.offline.offline_seconds,
                )
                if not wait_out():
                    return None
                continue
            local = (
                self.intents.last_desired_mode
                if self.intents is not None else None
            )
            if local is not None and self.with_default(label) != local:
                try:
                    label2, rv2 = self.get_node_cc_mode_label()
                    self._note_api_ok()
                except KubeApiError as e:
                    self._note_api_err(e)
                    if not intent_mod.is_outage_error(e):
                        raise  # the server ANSWERED: fatal, like read 1
                    log.warning(
                        "boot-time desired mode %r disagrees with the "
                        "journaled %r and could not be confirmed (%s); "
                        "keeping local truth and retrying", label, local, e,
                    )
                    if not wait_out():
                        return None
                    continue
                if (label2, rv2) != (label, rv):
                    log.info(
                        "boot-time confirm read superseded %r with %r",
                        label, label2,
                    )
                label, rv = label2, rv2
            return label, rv

    def watch_and_apply(self, stop: threading.Event | None = None) -> None:
        try:
            self._watch_and_apply(stop)
        finally:
            # The slice-peer informer's watch thread must not outlive the
            # agent loop (tests and clean shutdowns alike).
            self._stop_peer_informer()
            self._stop_preemption_monitor()

    def _watch_and_apply(self, stop: threading.Event | None = None) -> None:
        """Initial apply, then watch the node label forever.

        Semantics preserved from the reference (main.py:600-684): rv
        tracking, 300 s server-side watch timeout, ERROR-event handling,
        410-Gone resync via re-GET + conditional re-apply, consecutive-error
        cap of 10 (reset on any successful event — documented quirk,
        SURVEY.md §8.6), 5 s reconnect delay (with ``time`` imported; the
        reference's missing import made this path fatal, SURVEY.md §8.1).
        ``stop`` makes the loop exitable for tests and graceful shutdown.

        Divergence from the reference (deliberate): a FAILED reconcile is
        retried with exponential backoff (retry_backoff_s, doubling to
        retry_backoff_max_s) without requiring the label to change — the
        reference leaves the node 'failed' until the next label edit. That
        includes a reconcile ABORTED by an apiserver error escaping the
        apply (the failed-state patch itself failing): it is noted failed
        and retried, not lost until the next label edit.
        """
        last_label_value: str | None = None
        consecutive_errors = 0
        # Failed-reconcile retry state (VERDICT r2 item 6): a failed apply
        # schedules a re-apply with exponential backoff instead of waiting
        # for the next label change.
        retry_at: float | None = None
        backoff = self.retry_backoff_s

        def note_result(ok: bool) -> bool:
            nonlocal retry_at, backoff
            # Feed the remediation ladder (ccmanager/remediation.py): a
            # success resets it; a RETRYABLE failure escalates it (stable
            # misconfigurations — invalid mode, unsupported hardware —
            # can't be remediated by resets, and a quarantined node's
            # deferred reconciles must not re-escalate).
            if self.remediation is not None:
                if ok:
                    self.remediation.note_success()
                elif self.retryable_failure and not self.remediation.quarantined:
                    self.remediation.note_failure(
                        self.last_failure_reason or "apply-failed"
                    )
            if ok or self.retry_backoff_s <= 0:
                retry_at = None
                backoff = self.retry_backoff_s
            else:
                # Stable misconfigurations skip the fast doubling ladder and
                # go straight to the slow cadence: an identical re-fail
                # every few seconds helps nobody, but a later hardware/pool
                # fix should still converge without a label edit.
                delay = (
                    backoff if self.retryable_failure
                    else self.retry_backoff_max_s
                )
                retry_at = time.monotonic() + delay
                log.warning(
                    "reconcile failed; retrying in %.0fs without waiting for "
                    "a label change", delay,
                )
                backoff = min(backoff * 2, self.retry_backoff_max_s)
            return ok

        def apply_noted(value: str | None) -> bool:
            """In-watch reconcile: an apiserver error ESCAPING the apply
            (e.g. the failed-state patch itself exhausted its retries) is
            noted as a failed reconcile so the backoff retry still fires —
            before this, the exception unwound to the reconnect handler and
            the reconcile was silently lost until the next label edit.
            Device-layer crash-as-retry (sys.exit on mixed capability) and
            the fatal startup GET are unaffected."""
            try:
                return note_result(self.set_cc_mode(self.with_default(value)))
            except KubeApiError as e:
                self._note_api_err(e)
                log.warning(
                    "reconcile aborted by apiserver error (%s); scheduling "
                    "backoff retry", e,
                )
                # No record_failure here: most escape paths already counted
                # their reason before the state patch raised, and a second
                # count would make sum(tpu_cc_failures_total) exceed the
                # failed-reconcile total during every apiserver incident.
                return note_result(False)

        def maybe_retry() -> None:
            if retry_at is not None and time.monotonic() >= retry_at:
                log.info("retrying failed reconcile")
                apply_noted(last_label_value)

        def prestage_noted(node: dict) -> None:
            """Prestage pass with the same escaped-apiserver-error
            discipline as apply_noted: an aborted pass schedules the
            backoff retry (which re-applies the DESIRED mode, reverting
            any partial prestage — the safe direction)."""
            try:
                pre = self._maybe_prestage(node)
            except KubeApiError as e:
                self._note_api_err(e)
                log.warning(
                    "pre-staging aborted by apiserver error (%s); "
                    "scheduling backoff retry", e,
                )
                pre = False
            if pre is not None:
                note_result(pre)

        # The preemption monitor starts FIRST: a spot VM can be reclaimed
        # while the agent is still booting, and the fast-drain + handoff
        # window is too short to wait for the watch loop to settle.
        self._start_preemption_monitor()
        # Boot ordering: journal replay and hardware-truth recovery run
        # BEFORE the first apiserver read, and that read is stale-guarded
        # and outage-tolerant (_startup_mode_read).
        self.recover_from_journal()
        first = self._startup_mode_read(stop)
        if first is None:
            return  # stopped while riding out an apiserver outage
        label, rv = first
        # A handoff record a preempted predecessor left on this node: the
        # first reconcile below completes (or supersedes) the handed-off
        # flip and retires the record.
        self.consume_handoff()
        note_result(self.set_cc_mode(self.with_default(label)))
        self.create_readiness_file()
        last_label_value = label
        try:
            # A challenge issued while the agent was down must not wait
            # for the next label edit to be answered.
            node0 = self.api.get_node(self.node_name)
            self._maybe_answer_challenge(node0)
        except KubeApiError as e:
            log.debug("startup challenge check failed (non-fatal): %s", e)
        else:
            # Likewise a prestage request that landed while the agent
            # was down (or survived its restart) runs now, not at the
            # next annotation edit.
            prestage_noted(node0)

        while not (stop and stop.is_set()):
            timeout = self.watch_timeout_s
            if retry_at is not None:
                # Bound the watch so the retry fires even on a quiet node.
                timeout = max(
                    1, min(timeout, int(retry_at - time.monotonic()) + 1)
                )
            try:
                for event in self.api.watch_nodes(
                    self.node_name, rv or None, timeout
                ):
                    if stop and stop.is_set():
                        return
                    if event.type == "ERROR":
                        code = (event.object or {}).get("code")
                        if code == 410:
                            raise KubeApiError(410, "watch ERROR event: Gone")
                        consecutive_errors += 1
                        log.warning(
                            "watch ERROR event (%s/%s): %s",
                            consecutive_errors, self.max_watch_errors, event.object,
                        )
                        if consecutive_errors >= self.max_watch_errors:
                            # Divergence from the reference, which only caps
                            # ApiExceptions (main.py:659-668): a stream of
                            # ERROR events is equally hopeless.
                            raise RuntimeError(
                                f"{consecutive_errors} consecutive watch ERROR "
                                f"events; giving up (pod restart acts as recovery)"
                            )
                        break
                    consecutive_errors = 0
                    self._note_api_ok()
                    rv = resource_version(event.object) or rv
                    if event.type == "BOOKMARK":
                        # Bookmarks carry ONLY metadata.resourceVersion — no
                        # labels. Falling through would misread the desired
                        # mode as absent and fire a spurious reconcile to
                        # the default. Track the rv (that is their whole
                        # point: a fresh rv on quiet nodes keeps reconnects
                        # from 410-expiring) and move on.
                        maybe_retry()
                        continue
                    event_labels = node_labels(event.object)
                    value = event_labels.get(CC_MODE_LABEL)
                    # The stitching hint rides in the SAME patch as the
                    # desired mode, so this event carries both.
                    self._note_rollout_trace(event_labels)
                    self._maybe_answer_challenge(event.object)
                    # Refresh the prestage caches on EVERY event: the
                    # apply below consults them (hold guard + consume)
                    # even when this event is a desired-label change.
                    self._note_prestage(event.object)
                    if value != last_label_value:
                        log.info(
                            "%s changed: %r -> %r",
                            CC_MODE_LABEL, last_label_value, value,
                        )
                        last_label_value = value
                        if not apply_noted(value):
                            # The already-open stream keeps its original
                            # (up to 300 s) server-side timeout; on a quiet
                            # node that would delay the backoff retry far
                            # past retry_at. Reconnect with the bounded
                            # timeout instead (rv is tracked, nothing is
                            # lost).
                            break
                    else:
                        # Prestage requests ride node-annotation events;
                        # only considered while the desired label is
                        # quiet — a pending desired change always wins.
                        prestage_noted(event.object)
                        maybe_retry()
                else:
                    # Stream ended normally (server-side timeout): the
                    # apiserver answered, so the outage clock resets and
                    # any deferred patches flush even on a QUIET node
                    # whose stream carries no events. Then retry a failed
                    # reconcile if due — unless shutdown is in progress (a
                    # retry started after SIGTERM would race the hard-exit
                    # fallback) — and reconnect with the tracked rv.
                    self._note_api_ok()
                    if not (stop and stop.is_set()):
                        maybe_retry()
                    continue
            except KubeApiError as e:
                self._note_api_err(e)
                consecutive_errors += 1
                # Disconnected-mode ladder: once a TOTAL outage outlasts
                # CC_OFFLINE_GRACE_S (and the journal holds local truth),
                # the agent stops treating the error cap as fatal — a
                # crash-exit would gain nothing, and the node keeps
                # serving its last-known desired mode while label writes
                # defer into the journal. Reconnects continue on the
                # capped jittered ladder.
                offline_autonomy = (
                    self.intents is not None
                    and self.offline.engaged
                    and intent_mod.is_outage_error(e)
                )
                if consecutive_errors >= self.max_watch_errors:
                    if not offline_autonomy:
                        raise RuntimeError(
                            f"{consecutive_errors} consecutive watch errors; "
                            f"giving up (pod restart acts as recovery)"
                        ) from e
                    log.warning(
                        "disconnected mode: apiserver dark for %.0fs "
                        "(%d consecutive watch errors); serving last-known "
                        "desired mode %r from the intent journal",
                        self.offline.offline_seconds, consecutive_errors,
                        self.intents.last_desired_mode,
                    )
                delay = self._reconnect_policy.delay_for(
                    min(max(0, consecutive_errors - 1), 16)
                )
                if e.status == 410:
                    log.info("watch resourceVersion expired; resyncing")
                    try:
                        value, rv = self.get_node_cc_mode_label()
                    except KubeApiError as e2:
                        log.warning("resync GET failed: %s", e2)
                        self.metrics.record_retry("watch.resync", "apiserver")
                        if retry_mod.wait(delay, stop):
                            return
                        continue
                    if value != last_label_value:
                        last_label_value = value
                        apply_noted(value)
                    continue
                log.warning(
                    "watch error (%s/%s): %s — reconnecting in %.1fs",
                    consecutive_errors, self.max_watch_errors, e, delay,
                )
                self.metrics.record_retry("watch.reconnect", "watch-error")
                if retry_mod.wait(delay, stop):
                    return

    def remove_readiness_file(self) -> None:
        """Best-effort in-process counterpart of the preStop ``/bin/rm``
        hook (reference Dockerfile.distroless:45-46): a gracefully stopping
        agent withdraws its readiness signal itself, so the operator's
        validation framework notices even when the preStop hook is skipped
        (e.g. node shutdown)."""
        try:
            os.remove(self.readiness_file)
            log.info("removed readiness file %s", self.readiness_file)
        except FileNotFoundError:
            pass
        except OSError as e:
            log.warning("could not remove readiness file: %s", e)

    def run(self, stop: threading.Event | None = None) -> None:
        """Entry point (reference main.py:693-695). On a graceful stop the
        readiness file is withdrawn before returning."""
        log.info(
            "starting tpu-cc-manager on node %s (default=%s evict=%s smoke=%s ns=%s)",
            self.node_name, self.default_mode, self.evict_components,
            self.smoke_workload, self.operator_namespace,
        )
        try:
            self.watch_and_apply(stop)
        finally:
            if stop is not None and stop.is_set():
                self.remove_readiness_file()
