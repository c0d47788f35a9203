"""Per-node synthetic inference server riding the drain handshake.

The serving contract under a CC flip: a request accepted by a node is
NEVER lost. The server subscribes to the node's drain protocol
(:class:`~tpu_cc_manager_torch.drain.handshake.DrainSubscriber`); when the
manager requests a drain the server

1. stops accepting new batches (the driver routes around it),
2. lets the in-flight batch park — the executor checkpoints each
   sequence's partial decode state at the next token boundary instead of
   running the batch to completion,
3. charges one simulated durable-checkpoint write, sized to whatever a
   published ``drain.deadline-s`` hint's budget share the park wait left
   over (a preemption fast-drain's hard window must bound the whole
   bracket, not truncate it — normal drains pay the full write), and
4. hands every unfinished request to the driver's ``on_handoff`` sink
   (when wired — SERVE_r03's zero-bounce path): the sink re-dispatches
   them DIRECTLY to an accepting peer, still inside the ack window, and
   whatever finds no accepting peer falls back to the plain requeue —
   so conservation (issued = completed + shed + lost) holds by
   construction whichever path each request takes. Without a sink,
   requeues everything to the driver — progress (``tokens_done``)
   preserved, so the retry only pays the remaining tokens — before the
   subscriber acks the cycle (a batch that outruns the park budget is
   the one exception: it requeues the moment it parks, which under
   deadline pressure may land just after the ack — conserved either
   way). The durable-checkpoint write is charged only for requests that
   did NOT migrate live: a handed-off request's decode state transfers
   with it and is paid as a restore at the receiving executor
   (:meth:`SimulatedExecutor.resume_from_progress`), not as a durable
   write here.

The executor is a latency/bandwidth model by default
(:class:`SimulatedExecutor`, calibratable from a real llama smoke
result); the protocol half — intake, drain, checkpoint, requeue — is the
real code path the report measures.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time

from tpu_cc_manager_torch.drain import handshake
from tpu_cc_manager_torch.kubeclient.api import KubeApi
from tpu_cc_manager_torch.utils import locks as locks_mod
from tpu_cc_manager_torch.utils import metrics as metrics_mod
from tpu_cc_manager_torch.utils import retry as retry_mod

log = logging.getLogger(__name__)

STATE_ACCEPTING = "accepting"
STATE_DRAINING = "draining"

#: Fraction of a published drain deadline the checkpoint bracket may
#: spend: the rest of the window belongs to the manager's own eviction
#: and (on a preemption) the handoff publish.
DEFAULT_CHECKPOINT_BUDGET_FRACTION = 0.5

#: Restoring a handed-off request's checkpointed decode state on the
#: receiving node re-ingests its ``tokens_done`` context at prefill
#: speed, which is roughly an order of magnitude faster than decode
#: (weights stream once for the whole re-ingest instead of once per
#: token) — so the restore charge is this fraction of the decode-side
#: per-token rate. Deliberately not a calibration parameter:
#: ``from_smoke_result`` stays untouched.
RESTORE_PREFILL_FRAC = 0.1


@dataclasses.dataclass
class Request:
    """One synthetic inference request: ``decode_tokens`` of work, with
    checkpointable progress. ``submitted_at`` is stamped when the request
    enters the system (driver clock) — for open-loop traffic that is the
    SCHEDULED arrival time, so reported latency includes every second of
    queue wait (no coordinated omission) — and a checkpoint-and-requeue
    bounce does NOT restamp it, so reported latency is what the user saw.
    ``deadline_at`` (open-loop mode) is the absolute completion deadline:
    admission control sheds the request once the deadline budget is
    provably spent, and a completion past it counts as a deadline miss.
    ``started_at`` is the FIRST executor dispatch (bounces keep it), so
    ``started_at - submitted_at`` is the queue delay the sweep reports."""

    req_id: int
    decode_tokens: int
    submitted_at: float
    tokens_done: int = 0
    attempts: int = 0
    checkpoints: int = 0
    completed_at: float | None = None
    deadline_at: float | None = None
    started_at: float | None = None
    shed_at: float | None = None
    # Serving-state handoff (SERVE_r03): how many times this request
    # migrated from a draining node to an accepting peer, and whether
    # its checkpointed decode state still awaits the restore charge at
    # the next executor dispatch (cleared by resume_from_progress).
    handoffs: int = 0
    restore_pending: bool = False

    def remaining(self) -> int:
        return max(0, self.decode_tokens - self.tokens_done)


class SimulatedExecutor:
    """Latency + bandwidth model of one batched decode step.

    Wall time: ``base_s`` dispatch overhead + ``per_token_s`` per decode
    step (steps run batch-parallel, so the batch pays the LONGEST
    remaining sequence, not the sum). Interruptible at token boundaries:
    a set ``interrupt`` event parks the batch with each sequence's
    ``tokens_done`` advanced to the boundary — the checkpointable state
    the drain protocol preserves.

    ``hbm_bw_util``: mirrors the llama smoke accounting shape — one
    weight stream shared by the whole batch plus one full-allocated KV
    stream per sequence (``weight_frac + batch * kv_frac``, capped at
    1.0). Like the real number it is a useful-traffic LOWER bound (see
    smoke/llama_infer.py), which is why the driver's ladder treats its
    headroom read as conservative and keeps a ceiling below 1.0.
    """

    def __init__(
        self,
        base_s: float = 0.002,
        per_token_s: float = 0.002,
        weight_frac: float = 0.30,
        kv_frac: float = 0.05,
    ) -> None:
        self.base_s = base_s
        self.per_token_s = per_token_s
        self.weight_frac = weight_frac
        self.kv_frac = kv_frac
        # Brownout (gray failure, faults/plan.py seed_brownout): > 1
        # while the node's token rate is degraded. Scales base_s AND
        # per_token_s in place so estimate_s, the admission math that
        # reads per_token_s, and the execute charge all slow down
        # together — the node stays honest about its own degradation,
        # it just IS slower.
        self.brownout_factor = 1.0

    def set_brownout(self, factor: float) -> None:
        """Arm (factor > 1) or clear (factor = 1) a degraded token
        rate: every dispatch and decode step runs ``factor`` times
        slower while the executor keeps succeeding — the seeded gray
        failure the fail-slow detector must catch peer-relatively,
        because nothing on this node ever errors."""
        f = max(1.0, float(factor))
        if self.brownout_factor != 1.0:
            # Restore the nominal rate before re-scaling.
            self.per_token_s /= self.brownout_factor
            self.base_s /= self.brownout_factor
        self.per_token_s *= f
        self.base_s *= f
        self.brownout_factor = f

    @classmethod
    def from_smoke_result(cls, smoke: dict) -> "SimulatedExecutor":
        """Calibrate the model from a real llama smoke artifact: measured
        ``ms_per_token`` becomes the per-step latency and the measured
        ``hbm_bw_util`` at the smoke's batch anchors the bandwidth model
        (weight stream modeled as the batch-independent part)."""
        ex = cls()
        ms = smoke.get("ms_per_token")
        if ms:
            ex.per_token_s = max(1e-4, float(ms) / 1e3)
        util = smoke.get("hbm_bw_util")
        batch = smoke.get("batch") or 1
        if util:
            # Split the measured point: weights amortize across the
            # batch, KV does not — the same shape the accounting models.
            ex.weight_frac = 0.5 * float(util)
            ex.kv_frac = max(1e-3, 0.5 * float(util) / max(1, int(batch)))
        return ex

    def hbm_bw_util(self, batch_size: int) -> float:
        return min(1.0, self.weight_frac + batch_size * self.kv_frac)

    def estimate_s(self, tokens: int) -> float:
        """Predicted wall time for ``tokens`` of batch-parallel decode —
        the calibrated per-token rate admission control multiplies queue
        depth by (serve/server.py intake). The same model ``execute``
        charges, so the estimate and the charge cannot drift."""
        return self.base_s + self.per_token_s * max(0, tokens)

    def resume_from_progress(
        self, batch: list[Request], stop: threading.Event,
    ) -> float:
        """Charge the one-time restore of checkpointed decode state for
        requests handed off from a draining peer: one dispatch overhead
        plus a prefill-speed re-ingest of the LONGEST checkpointed
        context in the batch (restores run batch-parallel like decode).
        Requests without ``restore_pending`` cost nothing — the method
        is a no-op outside the handoff path, so closed-loop/requeue
        behavior is byte-identical to before. Returns the seconds
        charged and clears the flags."""
        tokens = max(
            (r.tokens_done for r in batch if r.restore_pending), default=0
        )
        restored = [r for r in batch if r.restore_pending]
        if not restored:
            return 0.0
        cost = self.base_s + RESTORE_PREFILL_FRAC * self.per_token_s * tokens
        retry_mod.wait(cost, stop)
        for r in restored:
            r.restore_pending = False
        return cost

    def execute(
        self, batch: list[Request], interrupt: threading.Event,
        stop: threading.Event,
    ) -> float:
        """Run the batch to completion or to the interrupt boundary;
        returns the modeled ``hbm_bw_util`` for this batch size."""
        retry_mod.wait(self.base_s, stop)
        steps = max((r.remaining() for r in batch), default=0)
        for _ in range(steps):
            if interrupt.is_set() or stop.is_set():
                break
            retry_mod.wait(self.per_token_s, stop)
            for r in batch:
                if r.remaining() > 0:
                    r.tokens_done += 1
        return self.hbm_bw_util(len(batch))


class NodeServer:
    """One node's serving loop + its side of the drain handshake."""

    def __init__(
        self,
        api: KubeApi,
        node_name: str,
        on_complete,
        on_requeue,
        on_shed=None,
        on_handoff=None,
        executor: SimulatedExecutor | None = None,
        job_name: str = "serve",
        poll_interval_s: float = 0.05,
        checkpoint_full_s: float = 0.2,
        checkpoint_budget_fraction: float = DEFAULT_CHECKPOINT_BUDGET_FRACTION,
        restore_s: float = 0.0,
        metrics: metrics_mod.MetricsRegistry | None = None,
        clock=time.monotonic,
    ) -> None:
        self.api = api
        self.node_name = node_name
        # Live telemetry (tpu_cc_serve_* families): queue depth and
        # in-flight gauges plus the bounced counter come from the
        # server — it is the only component that knows both. None =
        # unexported (unit tests); the harness passes ONE shared
        # registry across servers + driver so /metrics shows the pool.
        self.metrics = metrics
        self.executor = executor if executor is not None else SimulatedExecutor()
        self._on_complete = on_complete  # (node_name, Request, util)
        self._on_requeue = on_requeue    # (node_name, list[Request])
        # Admission control / load shedding (open-loop overload): when a
        # submitted request carries a deadline, intake estimates the
        # queue delay ahead of it (queue depth x the executor's
        # calibrated per-token rate) and sheds it if it provably cannot
        # complete in time — admitting it would burn capacity on a
        # guaranteed deadline miss and drag every request queued behind
        # it past ITS deadline too. Shed requests go to this callback
        # (counted outcome=shed by the driver; never lost).
        self._on_shed = on_shed          # (node_name, list[Request])
        # Serving-state handoff (SERVE_r03): the drain bracket hands its
        # parked in-flight + queued requests to this driver-side sink
        # instead of requeueing them locally; the sink re-dispatches
        # them to an accepting peer INSIDE the ack window and returns
        # how many a peer accepted (it requeues the rest itself — the
        # no-accepting-peer fallback IS today's local requeue, so
        # conservation holds whichever path each request takes). None =
        # the pre-handoff behavior, unchanged.
        self._on_handoff = on_handoff    # (node_name, list[Request]) -> int
        self.checkpoint_full_s = checkpoint_full_s
        self.checkpoint_budget_fraction = checkpoint_budget_fraction
        self.restore_s = restore_s
        # Must share the driver's time domain: request stamps
        # (submitted_at/deadline_at from the driver, started_at/
        # completed_at from here) are compared against each other by the
        # admission check and the latency report.
        self.clock = clock
        self._lock = locks_mod.make_lock("serve.server")
        self._state = STATE_ACCEPTING  # cclint: guarded-by(_lock)
        self._queue: list[list[Request]] = []  # cclint: guarded-by(_lock)
        self._inflight: list[Request] = []  # cclint: guarded-by(_lock)
        # In-flight partials parked by the worker WHILE a drain bracket is
        # collecting (the bracket requeues them inside the ack window);
        # once the bracket stops collecting, the worker requeues directly
        # so nothing can strand here between drains.
        self._parked: list[Request] = []  # cclint: guarded-by(_lock)
        self._drain_collecting = False  # cclint: guarded-by(_lock)
        self._work = threading.Event()
        self._idle = threading.Event()
        self._idle.set()
        self._drain_break = threading.Event()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.subscriber = handshake.DrainSubscriber(
            api, node_name, job_name,
            on_drain=self._on_drain, on_resume=self._on_resume,
            poll_interval_s=poll_interval_s,
        )
        # Observability for the harness report / tests (single-writer
        # fields: the subscriber thread writes, readers tolerate lag).
        self.drains = 0
        self.resumes = 0
        self.last_checkpoint_s: float | None = None
        self.last_checkpoint_deadline_s: float | None = None
        self.last_checkpoint_requeued = 0
        self.last_handoff_accepted = 0
        self.handoffs_accepted = 0
        self.last_hbm_bw_util: float | None = None

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        # Register synchronously BEFORE traffic starts so a drain
        # requested in the first poll interval still awaits this server.
        self.subscriber.register()
        self.subscriber.start()
        self._thread = threading.Thread(
            target=self._worker, daemon=True,
            name=f"serve-{self.node_name}",
        )
        self._thread.start()

    def stop(self, timeout_s: float = 10.0) -> None:
        self._stop.set()
        self._work.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout_s)
        self.subscriber.stop(timeout_s=timeout_s)

    # -- intake ------------------------------------------------------------

    def accepting(self) -> bool:
        with self._lock:
            return self._state == STATE_ACCEPTING

    def _export_gauges(self) -> None:
        """Push the queue-depth / in-flight gauges (tpu_cc_serve_*) —
        called at every transition that changes either, so a mid-flip
        scrape sees the live pipeline, not an end-of-run summary."""
        if self.metrics is None:
            return
        with self._lock:
            depth = sum(len(b) for b in self._queue)
            inflight = len(self._inflight)
        self.metrics.set_serve_queue_depth(self.node_name, depth)
        self.metrics.set_serve_inflight(self.node_name, inflight)

    def _queue_delay_estimate_s(self) -> float:  # cclint: requires(_lock)
        """Predicted wait before a newly-accepted batch starts executing:
        every queued batch's modeled wall time (batch-parallel, so each
        pays its LONGEST remaining sequence) plus whatever the in-flight
        batch still owes. Uses the executor's calibrated per-token rate
        (``estimate_s``) — the same model that charges the work — so the
        admission decision is as honest as the simulation itself."""
        est = 0.0
        for b in self._queue:
            est += self.executor.estimate_s(
                max((r.remaining() for r in b), default=0)
            )
        if self._inflight:
            # tokens_done advances live at each boundary, so this reads
            # the true remaining work, not the batch's original size.
            est += self.executor.per_token_s * max(
                (r.remaining() for r in self._inflight), default=0
            )
        return est

    def queue_delay_estimate_s(self) -> float:
        with self._lock:
            return self._queue_delay_estimate_s()

    def submit(self, batch: list[Request], front: bool = False) -> bool:
        """Accept one batch for execution; False while draining/drained
        (the driver keeps the requests and routes them elsewhere).
        ``front`` queues the batch AHEAD of waiting work — the handoff
        sink uses it because migrated requests are the oldest in-flight
        work in the system and re-queueing them behind the peer's fresh
        pipe would compound the bounce delay they already paid.

        Admission control: requests carrying a deadline are shed at
        intake when the estimated queue delay plus their own service
        time already overruns the deadline budget — handed to
        ``on_shed`` (outcome=shed), never queued to miss. Requests
        without a deadline are always admitted (closed-loop traffic is
        unchanged)."""
        if not batch:
            return True
        now = self.clock()
        shed: list[Request] = []
        with self._lock:
            if self._state != STATE_ACCEPTING or self._stop.is_set():
                return False
            est = self._queue_delay_estimate_s()
            accepted: list[Request] = []
            for r in batch:
                # No shed sink = no shedding: a deadline-carrying request
                # submitted without an on_shed callback must be admitted,
                # not silently dropped.
                if self._on_shed is not None and r.deadline_at is not None and (
                    now + est + self.executor.estimate_s(r.remaining())
                    > r.deadline_at
                ):
                    shed.append(r)
                    continue
                r.attempts += 1
                accepted.append(r)
            if accepted:
                if front:
                    self._queue.insert(0, accepted)
                else:
                    self._queue.append(accepted)
                self._work.set()
        self._export_gauges()
        if shed and self._on_shed is not None:
            self._on_shed(self.node_name, shed)
        return True

    # -- serving loop ------------------------------------------------------

    def _worker(self) -> None:
        while not self._stop.is_set():
            if not self._work.wait(timeout=0.2):
                continue
            batch = None
            with self._lock:
                if self._queue and self._state == STATE_ACCEPTING:
                    batch = self._queue.pop(0)
                    self._inflight = list(batch)
                    self._idle.clear()
                if not self._queue:
                    self._work.clear()
            if batch is None:
                continue
            self._export_gauges()
            dispatch_t = self.clock()
            for r in batch:
                if r.started_at is None:
                    # First dispatch only: a bounced request keeps its
                    # original start, so queue delay measures the wait
                    # before ANY service, not the latest hop's.
                    r.started_at = dispatch_t
            # Handed-off requests pay their state-transfer restore here,
            # at the receiving executor (no-op for everything else).
            self.executor.resume_from_progress(batch, self._stop)
            util = self.executor.execute(batch, self._drain_break, self._stop)
            now = self.clock()
            with self._lock:
                self._inflight = []
                done = [r for r in batch if r.remaining() == 0]
                partial = [r for r in batch if r.remaining() > 0]
                for r in partial:
                    r.checkpoints += 1
                if partial and self._drain_collecting:
                    # A drain bracket is waiting on us: hand the parked
                    # partials to IT (under this same lock, before _idle
                    # is set) so they are requeued — and counted — inside
                    # the ack window.
                    self._parked.extend(partial)
                    partial = []
                self._idle.set()
            self._export_gauges()
            self.last_hbm_bw_util = util
            for r in done:
                r.completed_at = now
                self._on_complete(self.node_name, r, util)
            if partial:
                # No bracket collecting (normal interrupt-free stop, or a
                # batch that outran the drain's park budget): requeue
                # directly so nothing can strand in the parked list —
                # checkpointed progress rides back to the driver either
                # way, nothing dies with the node.
                self._on_requeue(self.node_name, partial)

    # -- drain handshake ---------------------------------------------------

    def _on_drain(self) -> None:
        """Checkpoint-and-drain, run on the subscriber thread BEFORE the
        ack is published — the manager's bounded ack wait covers exactly
        this bracket: park the in-flight batch (bounded), hand everything
        unfinished to the peer-migration sink (or checkpoint + requeue it
        locally without one), then let the ack go out. The park
        wait and the checkpoint write share ONE budget (the hint's
        fraction): each bounded separately could consume 2× the share of
        a hard window that also has to fit the manager's eviction and
        handoff. A batch that outruns the park budget is still conserved
        — the worker requeues it directly the moment it parks (the
        checkpoint then lands after the ack, the one compromise deadline
        pressure can force)."""
        t0 = time.monotonic()
        with self._lock:
            self._state = STATE_DRAINING
            self._drain_collecting = True
            pending: list[Request] = [
                r for b in self._queue for r in b
            ]
            self._queue.clear()
        self._drain_break.set()
        deadline = self.subscriber.drain_deadline_s
        budget = (
            deadline * self.checkpoint_budget_fraction
            if deadline else None
        )
        # Let the in-flight batch park at its token boundary (the
        # executor breaks within one per-token step).
        self._idle.wait(timeout=budget if budget is not None else 5.0)
        with self._lock:
            parked = self._parked[:]
            self._parked.clear()
            # From here the worker requeues any late partials directly —
            # nothing can strand in the parked list between drains.
            self._drain_collecting = False
        to_requeue = pending + parked
        # Serving-state handoff: migrate the parked batch + queued
        # requests to an accepting peer FIRST, still inside the ack
        # window — a live migration carries the decode state with the
        # request (the restore is charged at the receiving executor),
        # so migrated requests skip the durable write entirely. The
        # sink requeues whatever found no accepting peer itself; the
        # durable-checkpoint charge below then covers exactly that
        # remainder (its progress survives only in the written copy),
        # and the ack still waits out the write as before.
        accepted = 0
        fallback = 0
        if self._on_handoff is not None and to_requeue:
            # The sink owns every request from here (migrated ones may
            # already be EXECUTING on a peer — this thread must not
            # touch them again); it requeues the fallback remainder
            # itself and stamps those requests' checkpoint counts.
            accepted, fallback = self._on_handoff(self.node_name, to_requeue)
            to_requeue = []
        self.last_handoff_accepted = accepted
        self.handoffs_accepted += accepted
        # Simulated durable checkpoint write: the full write when no
        # deadline pressure; under a hint, whatever of the budget the
        # park wait left over — the hint exists so jobs can fit the
        # window instead of starting a write the kill would truncate
        # (drain/handshake.py). Skipped when nothing took the local
        # requeue path (migrated requests carry their state with them;
        # peer-shed ones left the system) — only fallback requests
        # depend on the durable copy.
        if self._on_handoff is not None and fallback == 0:
            ckpt_s = 0.0
        elif budget is not None:
            remaining = max(0.0, budget - (time.monotonic() - t0))
            ckpt_s = min(self.checkpoint_full_s, remaining)
        else:
            ckpt_s = self.checkpoint_full_s
        retry_mod.wait(ckpt_s, self._stop)
        if self._on_handoff is None:
            for r in pending:
                r.checkpoints += 1
        # else: the sink stamped the fallback requests' checkpoint
        # counts itself; migrated requests may already be executing on a
        # peer and must not be touched from this thread.
        self.last_checkpoint_s = time.monotonic() - t0
        self.last_checkpoint_deadline_s = deadline
        # Requests that took the LOCAL requeue path this drain (the
        # durable write covers exactly these; migrated/shed ones do not
        # count — see last_handoff_accepted for the migrations).
        self.last_checkpoint_requeued = len(to_requeue) + fallback
        self.drains += 1
        self._export_gauges()
        if to_requeue:
            self._on_requeue(self.node_name, to_requeue)
        log.info(
            "server %s drained: %d requeued (%d handed off), checkpoint "
            "%.3fs (hint=%s)",
            self.node_name, self.last_checkpoint_requeued, accepted,
            self.last_checkpoint_s, deadline,
        )

    def _on_resume(self) -> None:
        """The drain request cleared (node re-admitted, post-flip):
        restore and reopen intake."""
        if self.restore_s:
            retry_mod.wait(self.restore_s, self._stop)
        self._drain_break.clear()
        with self._lock:
            self._state = STATE_ACCEPTING
        self.resumes += 1
        log.info("server %s resumed intake", self.node_name)
