"""Traffic driver: sustained batched inference across a pool under flip.

Two traffic modes share one dispatch/accounting core:

**Closed loop** (default, SERVE_r01): keeps each accepting server's pipe
~``pipe_depth`` batches deep, minting requests as the pipes drain. The
load adapts to the pool — which is exactly why a closed-loop driver can
never observe queueing collapse: when nodes drain it backs off, the
classic coordinated-omission trap.

**Open loop** (``schedule=``, SERVE_r02): a rate-driven arrival process
(:class:`PoissonSchedule` / :class:`RampSchedule`, seeded rng) submits
on schedule regardless of pipe depth — millions of real users do not
slow down because a pool is flipping. Every request is stamped at its
SCHEDULED arrival time and never restamped, so reported latency includes
all queue wait (no coordinated omission), and carries a ``deadline_s``
budget: servers shed at intake when the deadline budget is provably
spent (admission control, serve/server.py), the driver sheds requests
that die of old age in its own queue, and a completion past the deadline
counts as a deadline miss. Goodput = completed WITHIN deadline.

Both modes:

- route around draining/bounced nodes (their requests come back via
  checkpoint-and-requeue and are re-dispatched with progress intact);
- adapt each node's batch size from its reported ``hbm_bw_util``:
  below ``util_ceiling`` there is headroom → step the batch up ONE rung;
  above it step down. One rung at a time, and a ceiling strictly below
  1.0, because the utilization read is a useful-traffic LOWER bound
  (smoke/llama_infer.py — the padded+masked KV stream makes the
  marginal-cost model worst-case): the ladder's headroom read is
  deliberately conservative, never optimistic.

The report splits completions into steady-state vs a caller-marked
rollout window (membership by OVERLAP of the in-system interval with the
window — shed and deadline-miss counts use the same rule, so the
during-rollout shed rate is not polluted by steady-state arrivals) and
carries the headline the harness commits:
``requests_lost_per_node_bounced`` (target: zero — a request is lost
only if it never completed after traffic stopped and the grace drain
expired; a SHED request is an explicit, counted refusal, never lost).
Conservation holds by construction: issued = completed + shed + lost.
"""

from __future__ import annotations

import logging
import random
import threading
import time

from tpu_cc_manager_torch.obs import slo as slo_mod
from tpu_cc_manager_torch.obs.slo import percentile as _percentile
from tpu_cc_manager_torch.serve.server import NodeServer, Request
from tpu_cc_manager_torch.utils import locks as locks_mod
from tpu_cc_manager_torch.utils import metrics as metrics_mod
from tpu_cc_manager_torch.utils import retry as retry_mod

log = logging.getLogger(__name__)

#: Pseudo-node label for requests shed by the DRIVER's own queue (their
#: deadline expired before any server had pipe room); server-side sheds
#: carry the real node name.
DRIVER_SHED_NODE = "driver"


class PoissonSchedule:
    """Open-loop Poisson arrivals at a constant ``rate_rps``. Seeded:
    the same seed yields the same arrival schedule, independent of how
    fast the pool absorbs it (the whole point of open loop)."""

    def __init__(self, rate_rps: float, seed: int = 0) -> None:
        if rate_rps <= 0:
            raise ValueError("rate_rps must be > 0")
        self.rate_rps = float(rate_rps)
        self._rng = random.Random(seed)

    def rate_at(self, t_s: float) -> float:
        return self.rate_rps

    def next_interarrival_s(self, t_s: float) -> float:
        return self._rng.expovariate(self.rate_rps)


class RampSchedule:
    """Open-loop arrivals ramping linearly from ``rate0_rps`` to
    ``rate1_rps`` over ``duration_s`` (holding ``rate1_rps`` after) — a
    time-varying Poisson process, seeded like :class:`PoissonSchedule`.
    The shape that walks a pool INTO overload instead of teleporting it
    there."""

    def __init__(
        self, rate0_rps: float, rate1_rps: float, duration_s: float,
        seed: int = 0,
    ) -> None:
        if rate0_rps <= 0 or rate1_rps <= 0:
            raise ValueError("rates must be > 0")
        self.rate0_rps = float(rate0_rps)
        self.rate1_rps = float(rate1_rps)
        self.duration_s = max(0.0, float(duration_s))
        self._rng = random.Random(seed)

    def rate_at(self, t_s: float) -> float:
        if self.duration_s <= 0 or t_s >= self.duration_s:
            return self.rate1_rps
        frac = max(0.0, t_s) / self.duration_s
        return self.rate0_rps + (self.rate1_rps - self.rate0_rps) * frac

    def next_interarrival_s(self, t_s: float) -> float:
        return self._rng.expovariate(self.rate_at(t_s))


class TrafficDriver:
    def __init__(
        self,
        servers: dict[str, NodeServer],
        request_tokens: int = 8,
        initial_batch: int = 2,
        min_batch: int = 1,
        max_batch: int = 16,
        util_ceiling: float = 0.9,
        ladder_interval_s: float = 0.25,
        submit_interval_s: float = 0.01,
        pipe_depth: int = 2,
        metrics: metrics_mod.MetricsRegistry | None = None,
        slo: slo_mod.SloEvaluator | None = None,
        schedule=None,
        deadline_s: float | None = None,
        clock=time.monotonic,
    ) -> None:
        self.servers = servers
        # Open-loop mode: a rate-driven arrival process (PoissonSchedule
        # / RampSchedule) decides when requests enter the system; the
        # pool's absorption rate decides nothing. ``deadline_s`` is each
        # request's completion budget (admission control + deadline-miss
        # accounting hang off it); ``clock`` is injectable for
        # deterministic tests, but the servers stamp on the same clock —
        # a non-default clock must be passed to every NodeServer too
        # (server.py ``clock=``), or admission/latency math would mix
        # time domains.
        self.schedule = schedule
        self.deadline_s = deadline_s
        self.clock = clock
        # Live serving telemetry: completions feed the per-node latency
        # histogram + outcome counters (tpu_cc_serve_*) and the SLO
        # evaluator; the ladder tick exports the windowed p99 /
        # burn-rate / goodput gauges, so a scrape DURING a flip reads
        # the live SLO — the contract the latency-gated rollout polls.
        self.metrics = metrics
        self.slo = slo
        self.request_tokens = request_tokens
        self.min_batch = min_batch
        self.max_batch = max_batch
        self.util_ceiling = util_ceiling
        self.ladder_interval_s = ladder_interval_s
        self.submit_interval_s = submit_interval_s
        self.pipe_depth = pipe_depth
        self._lock = locks_mod.make_lock("serve.driver")
        self._pending: list[Request] = []  # cclint: guarded-by(_lock)
        self._completed: list[Request] = []  # cclint: guarded-by(_lock)
        self._outstanding: dict[str, int] = {  # cclint: guarded-by(_lock)
            name: 0 for name in servers
        }
        self._batch: dict[str, int] = {  # cclint: guarded-by(_lock)
            name: initial_batch for name in servers
        }
        self._next_id = 0  # cclint: guarded-by(_lock)
        self._requeues = 0  # cclint: guarded-by(_lock)
        self._handoffs_accepted = 0  # cclint: guarded-by(_lock)
        self._handoffs_fallback = 0  # cclint: guarded-by(_lock)
        self._shed: list[Request] = []  # cclint: guarded-by(_lock)
        self._offered = 0  # cclint: guarded-by(_lock)
        self._offered_at_tick = 0  # cclint: guarded-by(_lock)
        self._offered_tick_t: float | None = None  # cclint: guarded-by(_lock)
        self._next_arrival_t: float | None = None  # cclint: guarded-by(_lock)
        self._open_loop_t0: float | None = None  # cclint: guarded-by(_lock)
        self._traffic_stopped_t: float | None = None  # cclint: guarded-by(_lock)
        # Fail-slow de-weighting (obs/failslow.py): nodes under
        # peer-relative suspicion are capped at min_batch IN FLIGHT —
        # their trickle is bounded by their own service rate, not a
        # share of the offered load — which holds the tail while the
        # verdict is still out yet keeps vetting fed so recovery stays
        # observable. Ignored when EVERY accepting node is suspect:
        # de-weighting the whole pool would just shed it.
        self._suspects: frozenset[str] = frozenset()  # cclint: guarded-by(_lock)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def set_suspects(self, names) -> None:
        """Replace the fail-slow suspect set the dispatcher de-weights
        (the vetting loop publishes :meth:`FailslowVetter.suspects`
        here each window)."""
        with self._lock:
            self._suspects = frozenset(names)

    # -- server callbacks --------------------------------------------------

    def on_complete(self, node: str, req: Request, util: float) -> None:
        # A completion past the request's deadline is a counted miss: the
        # request was ACCEPTED (admission control judged it feasible) and
        # the pool still blew its budget — the SLO violation the gate and
        # the error budget exist to see. Sheds are the separate,
        # deliberate refusal; misses are the broken promise.
        missed = (
            req.deadline_at is not None
            and req.completed_at is not None
            and req.completed_at > req.deadline_at
        )
        with self._lock:
            self._completed.append(req)
            self._outstanding[node] = max(0, self._outstanding[node] - 1)
        if req.completed_at is not None:
            lat = max(0.0, req.completed_at - req.submitted_at)
            if self.metrics is not None:
                self.metrics.observe_serve_request(node, lat)
                self.metrics.record_serve_outcome(node, "completed")
                if missed:
                    self.metrics.record_serve_deadline_miss(node)
            if self.slo is not None:
                self.slo.observe(lat, ok=not missed)

    def on_shed(self, node: str, reqs: list[Request]) -> None:
        """Requests refused at a server's intake (deadline budget
        provably spent): out of the system, counted ``outcome=shed`` —
        never lost, never an accepted-request SLO error. The error
        budget governs the promise made to ADMITTED requests; shedding
        is the mechanism that keeps that promise keepable past the
        knee."""
        now = self.clock()
        with self._lock:
            for r in reqs:
                r.shed_at = now
            self._shed.extend(reqs)
            if node in self._outstanding:
                self._outstanding[node] = max(
                    0, self._outstanding[node] - len(reqs)
                )
        if self.metrics is not None:
            self.metrics.record_serve_outcome(node, "shed", len(reqs))

    def on_handoff(self, node: str, reqs: list[Request]) -> tuple[int, int]:
        """Serving-state handoff sink (SERVE_r03): a draining server's
        parked in-flight + queued requests, re-dispatched DIRECTLY to
        accepting peers instead of requeueing into the driver's queue —
        called synchronously from the drain bracket, so the migration
        lands inside the ack window. Requests are chunked by each
        peer's current batch-ladder rung and offered round-robin;
        whatever finds no accepting peer (every peer draining, or a
        submit losing its own drain race) falls back to the plain
        :meth:`on_requeue` — today's behavior, so conservation
        (issued = completed + shed + lost) holds by construction.
        Returns ``(migrated, fallback)`` counts: a request the peer's
        admission control SHED at intake is neither — it left the
        system as a counted shed, not a migration (counting it
        accepted would inflate the zero-bounce evidence).

        A migrated request keeps its original ``submitted_at`` (latency
        stays stamped at arrival), carries its ``tokens_done`` progress,
        and pays the state-transfer restore at the receiving executor
        (``restore_pending`` → ``resume_from_progress``)."""
        queue = list(reqs)
        accepted_total = 0
        fallback: list[Request] = []
        # Snapshot targets + rungs under the lock; submit OUTSIDE it —
        # a peer's intake may synchronously shed into on_shed, which
        # takes this same (non-reentrant) lock.
        with self._lock:
            rungs = dict(self._batch)
        peers = [
            (name, server) for name, server in self.servers.items()
            if name != node and server.accepting()
        ]
        while queue and peers:
            still_accepting = []
            for pname, server in peers:
                if not queue:
                    break
                chunk = queue[: max(1, rungs.get(pname, 1))]
                for r in chunk:
                    # Progress-carrying requests owe a restore at the
                    # new executor; fresh (queued, zero-progress) ones
                    # have no state to transfer.
                    r.handoffs += 1
                    r.restore_pending = r.tokens_done > 0
                with self._lock:
                    self._outstanding[node] = max(
                        0, self._outstanding[node] - len(chunk)
                    )
                    self._outstanding[pname] = (
                        self._outstanding.get(pname, 0) + len(chunk)
                    )
                # front=True: migrated requests are the oldest in-flight
                # work in the system; they resume ahead of the peer's
                # queued fresh traffic (its executing batch still
                # finishes first).
                if server.submit(chunk, front=True):
                    del queue[: len(chunk)]
                    # The peer's intake may have SHED part of the chunk
                    # (on_shed stamps shed_at synchronously inside
                    # submit): those left the system as counted sheds,
                    # not migrations — excluded from the accepted count
                    # and their handoff marks reverted.
                    for r in chunk:
                        if r.shed_at is not None:
                            r.handoffs -= 1
                            r.restore_pending = False
                        else:
                            accepted_total += 1
                    still_accepting.append((pname, server))
                else:
                    # Lost the race with the peer's own drain: undo the
                    # outstanding transfer and stop offering to it.
                    with self._lock:
                        self._outstanding[pname] = max(
                            0, self._outstanding[pname] - len(chunk)
                        )
                        self._outstanding[node] += len(chunk)
                    for r in chunk:
                        r.handoffs -= 1
                        r.restore_pending = False
            peers = still_accepting
        fallback = queue
        with self._lock:
            self._handoffs_accepted += accepted_total
            self._handoffs_fallback += len(fallback)
        if self.metrics is not None:
            if accepted_total:
                self.metrics.record_serve_handoff("accepted", accepted_total)
            if fallback:
                self.metrics.record_serve_handoff("fallback", len(fallback))
        if fallback:
            for r in fallback:
                # The durable checkpoint the draining node charges
                # covers exactly these — they survive in the driver's
                # queue on the written copy alone.
                r.checkpoints += 1
            self.on_requeue(node, fallback)
        return accepted_total, len(fallback)

    def on_requeue(self, node: str, reqs: list[Request]) -> None:
        """Checkpointed requests coming back from a draining server:
        front of the queue (oldest first) so the bounce delay they
        already paid is not compounded by re-queueing behind fresh
        traffic."""
        with self._lock:
            self._requeues += len(reqs)
            self._outstanding[node] = max(
                0, self._outstanding[node] - len(reqs)
            )
            self._pending[:0] = reqs
        if self.metrics is not None:
            self.metrics.record_serve_outcome(node, "bounced", len(reqs))

    # -- driving loop ------------------------------------------------------

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="serve-driver"
        )
        self._thread.start()

    def stop(self, timeout_s: float = 10.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout_s)

    def _run(self) -> None:
        open_loop = self.schedule is not None
        if open_loop:
            t0 = self.clock()
            with self._lock:
                self._open_loop_t0 = t0
                self._next_arrival_t = t0 + self.schedule.next_interarrival_s(0.0)
        last_ladder = self.clock()
        while not self._stop.is_set():
            now = self.clock()
            if now - last_ladder >= self.ladder_interval_s:
                self._ladder_step()
                last_ladder = now
            if open_loop:
                self._mint_arrivals(now)
            # Open loop never mints from the dispatch path: arrivals are
            # the schedule's decision alone, regardless of pipe depth.
            self._dispatch_round(top_up=not open_loop)
            retry_mod.wait(self.submit_interval_s, self._stop)
        with self._lock:
            self._traffic_stopped_t = self.clock()

    def _mint_arrivals(self, now: float) -> None:
        """Submit every arrival the schedule placed at or before ``now``
        into the pending queue — stamped at its SCHEDULED arrival time
        (not the dispatch loop's wake-up), so a laggy driver thread
        cannot hide queue wait from the latency it reports (the
        coordinated-omission fix, applied to the driver itself too)."""
        with self._lock:
            t0 = self._open_loop_t0 if self._open_loop_t0 is not None else now
            while (
                self._next_arrival_t is not None
                and self._next_arrival_t <= now
            ):
                t = self._next_arrival_t
                self._next_id += 1
                self._offered += 1
                self._pending.append(Request(
                    req_id=self._next_id,
                    decode_tokens=self.request_tokens,
                    submitted_at=t,
                    deadline_at=(
                        t + self.deadline_s
                        if self.deadline_s is not None else None
                    ),
                ))
                self._next_arrival_t = t + max(
                    1e-6, self.schedule.next_interarrival_s(t - t0)
                )

    def _shed_expired_pending(self, now: float) -> None:
        """Driver-side load shedding: a request whose deadline expired
        while it waited in the DRIVER's queue (every server's intake was
        full or draining) is shed here — its budget is spent, submitting
        it would only be refused at intake one hop later. Keeps the
        open-loop pending queue bounded by the deadline instead of
        growing without limit past the knee."""
        with self._lock:
            # The pending queue is NEAR-deadline-ordered: arrivals append
            # in schedule order (deadline = arrival + constant) and
            # requeues go to the front carrying older arrivals, so
            # expired requests form a prefix in the common case and the
            # scan stops at the first live one instead of walking the
            # whole overload backlog every dispatch round. Interleaved
            # requeue groups from CONCURRENT node drains can hide an
            # expired request behind a younger live one — such a
            # straggler is still shed, one hop later at server intake
            # (attributed to that node instead of "driver"); conservation
            # is unaffected either way.
            n = 0
            for r in self._pending:
                if r.deadline_at is not None and r.deadline_at <= now:
                    n += 1
                else:
                    break
            if not n:
                return
            expired = self._pending[:n]
            del self._pending[:n]
        self.on_shed(DRIVER_SHED_NODE, expired)

    def _dispatch_round(self, top_up: bool) -> None:
        """Fill each accepting server's pipe to ``pipe_depth`` batches.
        ``top_up`` mints fresh requests when the pending queue runs dry
        (closed-loop traffic); open-loop dispatch (and the drain pass
        after stop()) leaves it off so only scheduled/in-system requests
        flow."""
        if self.deadline_s is not None:
            self._shed_expired_pending(self.clock())
        with self._lock:
            suspects = self._suspects
        accepting = [n for n, s in self.servers.items() if s.accepting()]
        if suspects and accepting and all(n in suspects for n in accepting):
            suspects = frozenset()
        # Suspects draw their (one-in-flight) trickle first: with fleet
        # headroom the healthy nodes would otherwise drain the pending
        # queue every round and starve the suspect of the very samples
        # vetting needs to clear it. The CAP is the de-weight — a
        # suspect can never hold more than min_batch requests — so
        # going first costs the tail at most min_batch slow slots.
        ordered = sorted(
            self.servers.items(), key=lambda kv: kv[0] not in suspects
        )
        for name, server in ordered:
            if not server.accepting():
                continue
            with self._lock:
                if name in suspects:
                    bsz = self.min_batch
                    cap = self.min_batch
                else:
                    bsz = self._batch[name]
                    cap = self.pipe_depth * bsz
                if self._outstanding[name] >= cap:
                    continue
                if top_up:
                    now = self.clock()
                    while len(self._pending) < bsz:
                        self._next_id += 1
                        self._pending.append(Request(
                            req_id=self._next_id,
                            decode_tokens=self.request_tokens,
                            submitted_at=now,
                        ))
                batch = self._pending[:bsz]
                if not batch:
                    continue
                del self._pending[:len(batch)]
                self._outstanding[name] += len(batch)
            if not server.submit(batch):
                # Lost the race with a drain: keep the requests, let the
                # next round route them to an accepting server.
                with self._lock:
                    self._outstanding[name] = max(
                        0, self._outstanding[name] - len(batch)
                    )
                    self._pending[:0] = batch
                if self.metrics is not None:
                    self.metrics.record_serve_outcome(
                        name, "requeued", len(batch)
                    )

    def _export_slo(self) -> None:
        """Export the live windowed SLO readout + goodput gauges —
        piggybacked on the ladder tick so the gauges stay fresh at the
        ladder's cadence without a dedicated timer thread."""
        if self.slo is None:
            return
        snap = self.slo.snapshot()
        for w in snap["windows"]:
            if self.metrics is not None:
                self.metrics.set_serve_slo(
                    w["window_s"], w["p99_s"], w["burn_rate"]
                )
        if self.metrics is not None and snap["windows"]:
            self.metrics.set_serve_goodput(
                snap["windows"][0]["goodput_rps"]
            )

    def _export_offered(self) -> None:
        """Open-loop only: export the offered (scheduled) arrival rate
        since the last export — the load the pool was ASKED to absorb,
        which goodput is judged against. Divided by the MEASURED elapsed
        time, not the nominal ladder interval: under overload the
        dispatch loop runs late, and nominal division would overstate
        the very number operators compare goodput against."""
        if self.metrics is None or self.schedule is None:
            return
        now = self.clock()
        with self._lock:
            delta = self._offered - self._offered_at_tick
            self._offered_at_tick = self._offered
            last_t = self._offered_tick_t
            self._offered_tick_t = now
        if last_t is None:
            return  # first tick: no window to rate over yet
        elapsed = now - last_t
        if elapsed > 0:
            self.metrics.set_serve_offered_rps(delta / elapsed)

    def _ladder_step(self) -> None:
        """One conservative rung per interval, per node, off the last
        reported ``hbm_bw_util``: the read is a lower bound, so the
        ceiling sits below 1.0 and the ladder never jumps rungs."""
        self._export_slo()
        self._export_offered()
        for name, server in self.servers.items():
            util = server.last_hbm_bw_util
            if util is None:
                continue
            if self.metrics is not None:
                # Export the ladder's own signal: the fleet capacity
                # ledger (obs/fleet.py) judges per-node headroom off it.
                self.metrics.set_serve_hbm_bw_util(name, util)
            with self._lock:
                if util < self.util_ceiling and self._batch[name] < self.max_batch:
                    self._batch[name] += 1
                elif util > self.util_ceiling and self._batch[name] > self.min_batch:
                    self._batch[name] -= 1

    def drain_outstanding(self, grace_s: float = 10.0) -> None:
        """After stop(): keep dispatching ONLY in-system requests until
        everything completed or the grace expires (whatever remains is
        counted lost — the harness's zero-loss claim hinges here)."""

        def settled() -> bool:
            self._dispatch_round(top_up=False)
            with self._lock:
                return (
                    not self._pending
                    and all(v == 0 for v in self._outstanding.values())
                )

        retry_mod.poll_until(settled, grace_s, 0.02)
        with self._lock:
            lost = len(self._pending) + sum(self._outstanding.values())
        if lost:
            # Each lost request is a counted SLO error AND a counter
            # bump — the zero-loss contract's violation is visible both
            # in the burn-rate gauge and in tpu_cc_serve_lost_total.
            if self.metrics is not None:
                self.metrics.record_serve_lost(lost)
            if self.slo is not None:
                for _ in range(lost):
                    self.slo.observe_error()
        self._export_slo()

    # -- reporting ---------------------------------------------------------

    def snapshot_batches(self) -> dict[str, int]:
        with self._lock:
            return dict(self._batch)

    def report(
        self,
        rollout_window: tuple[float, float] | None = None,
        nodes_bounced: int = 0,
    ) -> dict:
        """Latency/loss summary. ``rollout_window`` is (start, end) on
        the driver's monotonic clock; the during-rollout bucket is every
        request whose in-system interval [submitted_at, completed_at]
        OVERLAPS the window — exactly the requests a user had in flight
        while the pool flipped. (Bucketing by completion time alone
        would park a request bounced by the LAST node's drain — which
        completes just after the rollout returns — in the steady bucket,
        inflating steady p99 and understating the disruption the
        artifact headlines.)"""
        with self._lock:
            completed = list(self._completed)
            shed = list(self._shed)
            in_system = len(self._pending) + sum(
                self._outstanding.values()
            )
            requeues = self._requeues
            handoffs_accepted = self._handoffs_accepted
            handoffs_fallback = self._handoffs_fallback
            issued = self._next_id
            open_loop_t0 = self._open_loop_t0
            traffic_stopped_t = self._traffic_stopped_t

        def in_window(start: float, end: float) -> bool:
            """Membership-by-overlap of an in-system interval with the
            rollout window — the shared rule for latency, shed AND
            deadline-miss bucketing (a request shed while the pool
            flipped belongs to the disruption it headlines, wherever
            its arrival landed)."""
            return bool(rollout_window) and (
                end >= rollout_window[0] and start <= rollout_window[1]
            )

        lat_all, lat_roll, lat_steady = [], [], []
        qd_all: list[float] = []
        misses = miss_roll = miss_steady = 0
        within_deadline = 0
        for r in completed:
            if r.completed_at is None:
                continue
            lat = r.completed_at - r.submitted_at
            lat_all.append(lat)
            rolled = in_window(r.submitted_at, r.completed_at)
            (lat_roll if rolled else lat_steady).append(lat)
            if r.started_at is not None:
                qd_all.append(max(0.0, r.started_at - r.submitted_at))
            if r.deadline_at is not None:
                if r.completed_at > r.deadline_at:
                    misses += 1
                    if rolled:
                        miss_roll += 1
                    else:
                        miss_steady += 1
                else:
                    within_deadline += 1
            else:
                within_deadline += 1
        shed_roll = sum(
            1 for r in shed
            if r.shed_at is not None and in_window(r.submitted_at, r.shed_at)
        )
        lat_all.sort(); lat_roll.sort(); lat_steady.sort(); qd_all.sort()
        lost = in_system  # after drain_outstanding: nothing should remain

        def stats(vals: list[float]) -> dict:
            return {
                "count": len(vals),
                "p50_ms": round(1e3 * _percentile(vals, 0.50), 2) if vals else None,
                "p99_ms": round(1e3 * _percentile(vals, 0.99), 2) if vals else None,
                "max_ms": round(1e3 * vals[-1], 2) if vals else None,
            }

        denom = len(completed) + lost
        # Offered rate: the schedule's arrivals over the open-loop
        # traffic window (None for closed-loop runs, where "offered" is
        # whatever the pool absorbed — the number means nothing).
        offered_rps = None
        if open_loop_t0 is not None:
            t1 = traffic_stopped_t if traffic_stopped_t is not None else self.clock()
            span = max(1e-9, t1 - open_loop_t0)
            offered_rps = round(issued / span, 3)
        goodput_rps = (
            round(within_deadline / max(
                1e-9,
                (traffic_stopped_t if traffic_stopped_t is not None
                 else self.clock()) - open_loop_t0,
            ), 3)
            if open_loop_t0 is not None else None
        )
        return {
            "requests_issued": issued,
            "requests_completed": len(completed),
            "requests_lost": lost,
            "requests_requeued": requeues,
            # Serving-state handoff: parked requests a draining node
            # migrated straight to an accepting peer (accepted) vs ones
            # that found no peer and fell back to the local requeue
            # (fallback, a subset of requests_requeued).
            "handoffs": {
                "accepted": handoffs_accepted,
                "fallback": handoffs_fallback,
            },
            "requests_shed": len(shed),
            "shed_rate": round(len(shed) / issued, 6) if issued else 0.0,
            "deadline_misses": misses,
            "completed_within_deadline": within_deadline,
            # issued = completed + shed + lost, by construction; exported
            # so every artifact (and the property tests) can assert it.
            "conserved": issued == len(completed) + len(shed) + lost,
            "offered_rps": offered_rps,
            "goodput_rps": goodput_rps,
            "error_rate": round(lost / denom, 6) if denom else 0.0,
            "nodes_bounced": nodes_bounced,
            "requests_lost_per_node_bounced": (
                round(lost / nodes_bounced, 6) if nodes_bounced else lost
            ),
            "latency": stats(lat_all),
            "latency_during_rollout": stats(lat_roll),
            "latency_steady_state": stats(lat_steady),
            "queue_delay": stats(qd_all),
            "shed_during_rollout": shed_roll,
            "shed_steady_state": len(shed) - shed_roll,
            "deadline_miss_during_rollout": miss_roll,
            "deadline_miss_steady_state": miss_steady,
            "batch_ladder": self.snapshot_batches(),
            "slo": self.slo.snapshot() if self.slo is not None else None,
        }
