"""Seeded fault plans: reproducible chaos schedules.

A fault plan is a pure function of (seed, call sequence): every decision
draws from one ``random.Random(seed)``, so running the same operations
against the same plan yields the same injected faults — the property the
chaos-seed reproduction test (tests/test_chaos.py) locks in. The seed
comes from ``CC_CHAOS_SEED`` so a soak failure in CI is replayable on a
laptop with one env var.

``max_faults`` bounds the total injections; a converging system must
eventually see clean weather, and the soak asserts convergence AFTER the
fault budget runs dry.
"""

from __future__ import annotations

import os
import random
from dataclasses import dataclass, field

CHAOS_SEED_ENV = "CC_CHAOS_SEED"


class OrchestratorKilled(BaseException):
    """A seeded SIGKILL of the rolling orchestrator (FaultPlan
    ``decide_orchestrator_kill``). Derives from BaseException so no
    except-Exception cleanup path in the orchestrator can swallow it —
    the whole point is modeling a death that runs NO handlers: the lease
    is not released, the record not finalized, and the successor must
    recover from exactly what was durably checkpointed."""

    def __init__(self, point: str, seq: int):
        super().__init__(f"orchestrator killed at {point} (seq={seq})")
        self.point = point
        self.seq = seq

#: Fault kinds the kube wrapper understands.
KINDS = (
    "http-429",      # throttled, with a Retry-After header
    "http-5xx",      # transient server error (500/502/503/504)
    "conn-reset",    # transport-level failure (status=None)
    "slow",          # response delayed by ``slow_s``
)
WATCH_KINDS = (
    "watch-hangup",  # stream dies mid-flight with a transport error
    "stale-rv",      # 410 Gone on connect (forces the resync path)
)
#: Total-outage mode (``blackout_rate``): while a window is open EVERY
#: verb — watch connects included — refuses with a connection reset, the
#: signature of a dead apiserver/load balancer. This is the fault the
#: disconnected-mode ladder (ccmanager/intent_journal.py) exists for.
BLACKOUT_KIND = "blackout"


@dataclass(frozen=True)
class Fault:
    kind: str
    op: str
    seq: int                      # decision index within the plan
    status: int | None = None
    retry_after_s: float | None = None
    slow_s: float | None = None

    def describe(self) -> str:
        extra = ""
        if self.status is not None:
            extra = f" status={self.status}"
        if self.retry_after_s is not None:
            extra += f" retry_after={self.retry_after_s}"
        return f"{self.kind} on {self.op} (seq={self.seq}{extra})"


@dataclass
class FaultPlan:
    """Draws one decision per API call; deterministic given the seed."""

    seed: int = 0
    # Probability an eligible call gets a fault (split evenly over kinds).
    rate: float = 0.2
    watch_rate: float = 0.3
    # Probability a crash point kills the orchestrator (0 = kill mode off;
    # decide_orchestrator_kill). Separate from ``rate``: orchestrator
    # deaths are rare catastrophic events, not per-call weather.
    kill_rate: float = 0.0
    max_kills: int | None = None
    max_faults: int | None = None
    retry_after_s: float = 0.05
    slow_s: float = 0.02
    # Apiserver-blackout mode: probability an eligible call STARTS a total-
    # outage window (0 disables), and the window's length in API calls,
    # drawn uniformly from [blackout_min_calls, blackout_max_calls]. The
    # windows are seeded — a DERIVED stream, so enabling blackouts does not
    # reshuffle the per-call fault schedule other modes draw from the main
    # stream — and each whole window counts ONCE against max_faults.
    blackout_rate: float = 0.0
    blackout_min_calls: int = 5
    blackout_max_calls: int = 20
    max_blackouts: int | None = None
    # Preemption-notice mode (spot/preemptible churn): probability that
    # schedule_preemption arms a platform preemption notice on the fake
    # backend, and the hard termination deadline the scenario models —
    # deliberately FAR below the 300 s drain budget (GCE gives ~30 s),
    # which is the whole point: the normal drain cannot finish, the
    # fast-drain path (drain/evict.py) must.
    preemption_rate: float = 0.0
    preemption_deadline_s: float = 30.0
    # Per-verb slow latency overrides: when the drawn kind is ``slow``,
    # the delay for ``op`` comes from here (falling back to the global
    # ``slow_s``). Consulted with ZERO extra rng draws, so arming
    # per-verb weather composes with existing chaos seeds without
    # reshuffling the schedule other modes draw from the main stream.
    slow_s_by_op: dict[str, float] = field(default_factory=dict)
    # Brownout mode (gray failure, Huang HotOS'17): a SEEDED node fails
    # SLOW, not stop — its executor token rate degrades by
    # ``brownout_token_rate_factor``, its per-chip reset/boot walls
    # inflate by ``brownout_reset_factor``, and its kube ops/probes go
    # intermittently slow (``brownout_kube_slow_rate`` of calls sleep
    # ``brownout_kube_slow_s``) while still SUCCEEDING — the watchdog
    # stays green by construction. Per-call slowness draws from a
    # DERIVED stream so arming a brownout never reshuffles the per-call
    # fault schedule, and the intermittent delays are weather, not
    # budget: they do not count against ``max_faults``.
    brownout_token_rate_factor: float = 4.0
    brownout_reset_factor: float = 3.0
    brownout_kube_slow_rate: float = 0.35
    brownout_kube_slow_s: float = 0.2
    rng: random.Random = field(init=False, repr=False)
    injected: list[Fault] = field(init=False, repr=False)
    _seq: int = field(init=False, repr=False)

    def __post_init__(self) -> None:
        self.rng = random.Random(self.seed)
        self.injected = []
        self._seq = 0
        # Derived, not the main stream (see blackout_rate above).
        self._blackout_rng = random.Random((self.seed << 1) ^ 0x0B1AC0)
        self._blackout_left = 0
        self._forced_blackout = False
        self.blackout_windows = 0
        self.blackout_refusals = 0
        # One-shot forced kill point (seed_prestage_kill): the next
        # decide_orchestrator_kill at exactly this point raises,
        # regardless of kill_rate.
        self._forced_kill_point: str | None = None
        # Derived, not the main stream (see brownout_* above).
        self._brownout_rng = random.Random((self.seed << 2) ^ 0xB70B0)
        self._brownout: int | None = None
        self.brownout_slow_ops = 0

    @classmethod
    def from_env(cls, default_seed: int = 20260803, **kwargs) -> "FaultPlan":
        seed = int(os.environ.get(CHAOS_SEED_ENV, str(default_seed)))
        return cls(seed=seed, **kwargs)

    @property
    def exhausted(self) -> bool:
        return (
            self.max_faults is not None
            and len(self.injected) >= self.max_faults
        )

    def _draw(self, op: str, rate: float, kinds: tuple[str, ...]) -> Fault | None:
        # ALWAYS advance the rng, even when the budget is exhausted — the
        # schedule must stay a pure function of (seed, call sequence), not
        # of how many faults earlier calls happened to absorb.
        self._seq += 1
        roll = self.rng.random()
        kind = kinds[self.rng.randrange(len(kinds))]
        status_5xx = self.rng.choice((500, 502, 503, 504))
        if roll >= rate or self.exhausted:
            return None
        fault = Fault(
            kind=kind,
            op=op,
            seq=self._seq,
            status=(
                429 if kind == "http-429"
                else status_5xx if kind == "http-5xx"
                else 410 if kind == "stale-rv"
                else None
            ),
            retry_after_s=self.retry_after_s if kind == "http-429" else None,
            slow_s=(
                self.slow_s_by_op.get(op, self.slow_s)
                if kind == "slow" else None
            ),
        )
        self.injected.append(fault)
        return fault

    # ---- apiserver-blackout mode ----------------------------------------

    @property
    def in_blackout(self) -> bool:
        return self._forced_blackout or self._blackout_left > 0

    def begin_blackout(self, calls: int | None = None) -> None:
        """Open a total-outage window deterministically (tests and drills):
        ``calls`` bounds it, None keeps it open until :meth:`end_blackout`.
        """
        if calls is None:
            self._forced_blackout = True
        else:
            self._blackout_left = max(self._blackout_left, calls)
        self.blackout_windows += 1

    def end_blackout(self) -> None:
        self._forced_blackout = False
        self._blackout_left = 0

    def _blackout_tick(self, op: str) -> Fault | None:
        """One blackout decision per API call: refuse while a window is
        open, otherwise (blackout_rate > 0) maybe open a seeded one. Both
        draws come from the derived blackout stream on EVERY call, so the
        schedule stays a pure function of (seed, call sequence)."""
        if self.in_blackout:
            if self._blackout_left > 0:
                self._blackout_left -= 1
            self._seq += 1
            self.blackout_refusals += 1
            return Fault(kind=BLACKOUT_KIND, op=op, seq=self._seq)
        if self.blackout_rate <= 0:
            return None
        roll = self._blackout_rng.random()
        span = self._blackout_rng.randint(
            self.blackout_min_calls, max(self.blackout_min_calls,
                                         self.blackout_max_calls)
        )
        if roll >= self.blackout_rate or self.exhausted or (
            self.max_blackouts is not None
            and self.blackout_windows >= self.max_blackouts
        ):
            return None
        self._seq += 1
        self._blackout_left = span - 1  # this call is the first refusal
        self.blackout_windows += 1
        self.blackout_refusals += 1
        fault = Fault(kind=BLACKOUT_KIND, op=op, seq=self._seq)
        self.injected.append(fault)  # the window counts once
        return fault

    def decide(self, op: str) -> Fault | None:
        """One decision for a unary API call."""
        fault = self._blackout_tick(op)
        if fault is not None:
            return fault
        return self._draw(op, self.rate, KINDS)

    def decide_watch(self, op: str = "watch") -> Fault | None:
        """One decision for a watch-stream connect."""
        fault = self._blackout_tick(op)
        if fault is not None:
            return fault
        return self._draw(op, self.watch_rate, WATCH_KINDS)

    def decide_orchestrator_kill(self, point: str) -> None:
        """One decision per orchestrator crash point (window start, mid-
        window, checkpoint boundary): with probability ``kill_rate``,
        raise :class:`OrchestratorKilled` — simulating a SIGKILL landing
        exactly there. Like every decision, drawn from the single seeded
        stream (same seed + same call sequence → the kill lands at the
        same point), and ALWAYS advances the rng even when kill mode is
        off so enabling kills doesn't reshuffle the other faults'
        schedule. ``max_kills`` bounds deaths so a soak's final successor
        gets clean weather to converge in."""
        self._seq += 1
        roll = self.rng.random()
        kills = sum(1 for f in self.injected if f.kind == "orch-kill")
        if self._forced_kill_point == point:
            # Seeded scenario kill (seed_prestage_kill): one-shot, fires
            # at exactly the armed point, bypasses kill_rate but is
            # recorded like a drawn kill. The rng already advanced
            # above, so arming never reshuffles the drawn schedule.
            self._forced_kill_point = None
            fault = Fault(kind="orch-kill", op=point, seq=self._seq)
            self.injected.append(fault)
            raise OrchestratorKilled(point, self._seq)
        if roll >= self.kill_rate or self.exhausted or (
            self.max_kills is not None and kills >= self.max_kills
        ):
            return
        fault = Fault(kind="orch-kill", op=point, seq=self._seq)
        self.injected.append(fault)
        raise OrchestratorKilled(point, self._seq)

    def schedule_journal_fault(self, journal) -> bool:
        """Optionally arm ONE disk fault on the node-local intent journal
        (ccmanager/intent_journal.py ``fail_appends``): the next append
        raises as if the state-dir disk faulted mid-write. Drawn from the
        seeded main stream like the backend faults — the agent must keep
        reconciling (loudly, unjournaled) when its WAL cannot persist.
        Returns whether a fault was armed."""
        self._seq += 1
        roll = self.rng.random()
        if roll >= self.rate or self.exhausted:
            return False
        self.injected.append(
            Fault(kind="journal-disk", op="journal.append", seq=self._seq)
        )
        journal.fail_appends += 1
        return True

    def schedule_backend_fault(self, backend, ops: tuple[str, ...]) -> str | None:
        """Optionally arm ONE fault on a fake device backend
        (tpudev/fake.py ``fail_next``), drawn from the same seeded stream —
        device-layer chaos composes with apiserver chaos under one seed.
        Returns the op armed, or None."""
        self._seq += 1
        roll = self.rng.random()
        op = ops[self.rng.randrange(len(ops))]
        if roll >= self.rate or self.exhausted:
            return None
        self.injected.append(Fault(kind="backend", op=op, seq=self._seq))
        backend.fail_next(op)
        return op

    def schedule_preemption(self, backend) -> bool:
        """Optionally arm a platform preemption notice on a fake device
        backend (tpudev/fake.py ``set_preempted``), drawn from the seeded
        main stream like every other decision — same seed, same VMs get
        reclaimed at the same points. The armed notice carries the plan's
        ``preemption_deadline_s`` semantics: the scenario's agent has that
        long to fast-drain, checkpoint and publish its handoff before the
        modeled kill. Always advances the rng (an armed schedule must not
        reshuffle other modes' decisions). Returns whether armed."""
        self._seq += 1
        roll = self.rng.random()
        if roll >= self.preemption_rate or self.exhausted:
            return False
        self.injected.append(
            Fault(kind="preemption", op="preemption-notice", seq=self._seq)
        )
        backend.set_preempted(True)
        return True

    def seed_preemption(self, backend) -> None:
        """Arm one preemption notice unconditionally (acceptance tests and
        drills that need the scenario, not the odds). Recorded in the
        injected schedule like a drawn one; does not consume rng state."""
        self._seq += 1
        self.injected.append(
            Fault(kind="preemption", op="preemption-notice", seq=self._seq)
        )
        backend.set_preempted(True)

    def seed_prestage_kill(self, points: tuple[str, ...] = (
        "prestage-reserved", "prestage-armed", "prestage-invalidate",
    )) -> str:
        """Arm ONE orchestrator kill at a continuous-prestage crash
        point, the point drawn from the seeded main stream (the
        chaos_soak dual-wave leg needs the scenario — a SIGKILL landing
        mid-prestage of wave N+1 while wave N drains — not the odds;
        WHICH prestage point stays a pure function of the seed so a
        soak failure replays exactly). The armed point fires through
        :meth:`decide_orchestrator_kill`'s normal path via a one-shot
        force, recorded in the injected schedule like a drawn kill.
        Returns the point armed."""
        self._seq += 1
        point = points[self.rng.randrange(len(points))]
        self._forced_kill_point = point
        return point

    def seed_blackout_window(self) -> int:
        """Open ONE total-outage window unconditionally, its length in
        API calls drawn from the derived blackout stream (acceptance
        drills — SCALE_r04's parent-plane blackout — need the scenario,
        not the odds; the LENGTH stays a pure function of the seed so
        the drill replays exactly). Recorded in the injected schedule
        like a drawn window. Returns the window length armed."""
        span = self._blackout_rng.randint(
            self.blackout_min_calls, max(self.blackout_min_calls,
                                         self.blackout_max_calls)
        )
        self._seq += 1
        self.begin_blackout(calls=span)
        self.injected.append(
            Fault(kind=BLACKOUT_KIND, op="seeded-window", seq=self._seq)
        )
        return span

    # ---- brownout (gray-failure) mode -----------------------------------

    @property
    def brownout_active(self) -> bool:
        return self._brownout is not None

    @property
    def brownout_node(self) -> int | None:
        """Index of the node currently browning out, or None."""
        return self._brownout

    def seed_brownout(self, nodes: int = 1) -> int:
        """Arm a brownout on ONE node unconditionally, the victim's
        index drawn uniformly from ``nodes`` via the seeded main stream
        (the GRAY_r01 drill needs the scenario — a gray node the
        watchdog can't see — not the odds; WHICH node stays a pure
        function of the seed so a soak failure replays exactly).
        Recorded in the injected schedule like a drawn fault but NOT
        counted against ``max_faults`` — a brownout is weather the
        detector must see through, not budget the soak spends. The
        caller applies the factors to that node's executor/backend
        (serve/server.py ``set_brownout``, tpudev/fake.py
        ``set_brownout``) and routes its kube client's per-call
        slowness through :meth:`decide_brownout_slow`. Returns the
        victim index."""
        self._seq += 1
        idx = self.rng.randrange(max(1, nodes))
        self._brownout = idx
        self.injected.append(
            Fault(kind="brownout", op=f"node-{idx}", seq=self._seq)
        )
        return idx

    def clear_brownout(self) -> None:
        """Model the gray hardware recovering (the probation-lift leg):
        per-call slowness stops; the caller clears the executor/backend
        factors it applied at seed time."""
        self._brownout = None

    def decide_brownout_slow(self, op: str) -> float:
        """One intermittent-slowness decision for a kube call on the
        browning-out node: returns seconds to sleep (0.0 = this call is
        fast). The call still SUCCEEDS either way — brownout never
        errors, that is the point. Draws from the derived brownout
        stream on every call while armed so the schedule stays a pure
        function of (seed, call sequence) and never perturbs the main
        stream; decisions are not appended to ``injected`` (weather,
        not budget)."""
        if self._brownout is None:
            return 0.0
        roll = self._brownout_rng.random()
        jitter = self._brownout_rng.random()
        if roll >= self.brownout_kube_slow_rate:
            return 0.0
        self.brownout_slow_ops += 1
        return self.brownout_kube_slow_s * (0.5 + jitter)

    def seed_terminal_backend_fault(self, backend, ops: tuple[str, ...]) -> str:
        """Arm one TERMINAL device fault (``times=-1``: never clears) on an
        op drawn from the seeded stream — the chaos mode that drives the
        remediation ladder end-to-end: retries cannot fix it, device
        re-reset and runtime restart keep failing, and the node must end
        quarantined. Which op is condemned is a pure function of the seed,
        like every other decision; the caller clears the fault
        (``backend.fail.pop(op)``) to model hardware recovery for the
        probation-lift leg. Always injects (a terminal-fault soak without
        a terminal fault proves nothing). Returns the op armed."""
        self._seq += 1
        op = ops[self.rng.randrange(len(ops))]
        self.injected.append(Fault(kind="backend-terminal", op=op, seq=self._seq))
        backend.fail_next(op, times=-1)
        return op
