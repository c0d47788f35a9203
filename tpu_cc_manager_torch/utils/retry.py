"""Unified retry/backoff policy, deadline-bounded polling, circuit breakers.

Before this module every transient-failure path rolled its own loop: the
REST client doubled a delay with no jitter and ignored ``Retry-After``
(kubeclient/rest.py), the slice barrier and the tpuvm backend open-coded
poll/sleep loops, the manager's watch reconnect slept a fixed 5 s. A
thundering herd of node agents retrying in lockstep against a flapping
apiserver is exactly the failure mode a CC control plane must survive, so
the policy lives in ONE place with the three properties the ad-hoc loops
lacked:

- **full jitter** (AWS-style: ``uniform(0, min(cap, base·2^n))``) via an
  *injected* rng, so a pool of agents desynchronizes and tests/chaos runs
  are reproducible with a seeded rng;
- **Retry-After honoring**: a 429/503 that names its own backoff is obeyed
  (never undershot by jitter);
- **classification + budgets**: the caller says what is transient vs
  permanent (a 404 never improves; a connection reset usually does) and may
  cap the whole operation with a deadline so retries cannot eat a
  reconcile's latency SLO.

Every retry is observable: counted in
``tpu_cc_retries_total{op,reason}`` (utils/metrics.py) and annotated on
the current obs span so /tracez shows which phase burned time retrying.

:class:`CircuitBreaker` protects the two remote dependencies — the
apiserver (kubeclient/rest.py) and the host device-command path
(tpudev/tpuvm.py) — from retry storms: after ``failure_threshold``
consecutive transient failures the circuit opens and calls fail fast until
a recovery window passes; the first call after the window (half-open)
probes, and its outcome decides closed vs re-open.
"""

from __future__ import annotations

import email.utils
import logging
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, NamedTuple

from tpu_cc_manager_torch.utils import locks as locks_mod

log = logging.getLogger(__name__)


class Classification(NamedTuple):
    """A classifier's verdict on one failure."""

    transient: bool
    reason: str = "error"
    # Server-directed minimum backoff (e.g. a 429's Retry-After), seconds.
    retry_after_s: float | None = None


#: Convenience verdicts for classifiers.
PERMANENT = Classification(False, "permanent")


def parse_retry_after(value: str | None) -> float | None:
    """Parse an HTTP ``Retry-After`` header: delta-seconds or HTTP-date.

    Returns seconds (clamped to >= 0) or None when absent/unparseable — an
    unparseable header must degrade to policy backoff, never crash the
    retry path that is already handling a failure.
    """
    if not value:
        return None
    value = value.strip()
    try:
        return max(0.0, float(value))
    except ValueError:
        pass
    try:
        dt = email.utils.parsedate_to_datetime(value)
    except (TypeError, ValueError):
        return None
    if dt is None:
        return None
    if dt.tzinfo is None:
        import datetime as _dt

        dt = dt.replace(tzinfo=_dt.timezone.utc)
    return max(0.0, dt.timestamp() - time.time())


def _default_metrics():
    # Imported lazily: metrics -> obs is a heavier import chain than most
    # retry.py consumers need at module-import time, and keeping retry.py
    # import-light avoids cycles (kubeclient.api may import retry).
    from tpu_cc_manager_torch.utils import metrics as metrics_mod

    return metrics_mod.REGISTRY


def _annotate_span(op: str, reason: str, attempt: int, delay: float) -> None:
    """Record the retry on the current obs span (bounded), so /tracez
    answers "where did the reconcile's time go" when the answer is
    "re-asking a flaky apiserver"."""
    try:
        from tpu_cc_manager_torch.obs import trace as obs_trace

        sp = obs_trace.current_span()
        if sp is None:
            return
        retries = sp.attributes.setdefault("retries", [])
        if len(retries) < 32:  # a span must not grow unboundedly
            retries.append(
                {
                    "op": op,
                    "reason": reason,
                    "attempt": attempt,
                    "delay_s": round(delay, 3),
                }
            )
    except Exception:  # noqa: BLE001 - observability must never fail a retry
        pass


@dataclass
class RetryPolicy:
    """Exponential backoff with full jitter, classification and budgets.

    ``rng``/``sleep``/``clock`` are injectable so tests and the chaos
    harness get reproducible schedules and zero wall-clock cost.
    """

    max_attempts: int = 3
    base_delay_s: float = 0.5
    max_delay_s: float = 30.0
    # Ceiling on a server-directed Retry-After: honored as a floor below
    # this, clamped above it — a misconfigured proxy saying "come back in
    # an hour" must not park a control-plane thread for an hour.
    retry_after_cap_s: float = 120.0
    # Whole-operation budget (first attempt to last), seconds; None = no cap.
    deadline_s: float | None = None
    jitter: bool = True
    rng: random.Random = field(default_factory=random.Random)
    sleep: Callable[[float], None] = time.sleep
    clock: Callable[[], float] = time.monotonic
    metrics: object | None = None

    def backoff_cap(self, attempt: int) -> float:
        """The un-jittered delay ceiling for retry number ``attempt`` (0-based)."""
        return min(self.max_delay_s, self.base_delay_s * (2.0 ** attempt))

    def delay_for(self, attempt: int, retry_after_s: float | None = None) -> float:
        """Sleep before retry ``attempt``: full jitter under the exponential
        cap, but never less than a server-directed Retry-After (itself
        clamped to ``retry_after_cap_s``)."""
        cap = self.backoff_cap(attempt)
        delay = self.rng.uniform(0.0, cap) if self.jitter else cap
        if retry_after_s is not None:
            delay = max(delay, min(retry_after_s, self.retry_after_cap_s))
        return delay

    def _record(self, op: str, reason: str, attempt: int, delay: float) -> None:
        metrics = self.metrics if self.metrics is not None else _default_metrics()
        try:
            metrics.record_retry(op, reason)
        except Exception:  # noqa: BLE001 - a metrics bug must not break retries
            pass
        _annotate_span(op, reason, attempt, delay)

    def call(
        self,
        fn: Callable[[], object],
        *,
        op: str,
        classify: Callable[[BaseException], Classification | None],
        max_attempts: int | None = None,
    ):
        """Run ``fn`` with classified retries.

        ``classify(exc)`` returns a :class:`Classification`; a permanent (or
        None) verdict re-raises immediately. The LAST failure always
        re-raises the original exception — callers keep their existing
        exception contracts (KubeApiError, TpuError, …).
        """
        attempts = max(1, max_attempts if max_attempts is not None else self.max_attempts)
        deadline = (
            self.clock() + self.deadline_s if self.deadline_s is not None else None
        )
        for attempt in range(attempts):
            try:
                return fn()
            except BaseException as e:  # noqa: BLE001 - classifier decides
                verdict = classify(e)
                if verdict is None or not verdict.transient:
                    raise
                if attempt == attempts - 1:
                    raise
                delay = self.delay_for(attempt, verdict.retry_after_s)
                if deadline is not None and self.clock() + delay > deadline:
                    log.warning(
                        "retry budget exhausted for %s after %d attempt(s) "
                        "(deadline %.1fs): %s",
                        op, attempt + 1, self.deadline_s, e,
                    )
                    raise
                log.warning(
                    "transient failure in %s (attempt %d/%d, reason=%s): %s — "
                    "retrying in %.2fs",
                    op, attempt + 1, attempts, verdict.reason, e, delay,
                )
                self._record(op, verdict.reason, attempt + 1, delay)
                self.sleep(delay)
        raise AssertionError("unreachable")  # loop always returns or raises


def poll_until(
    predicate: Callable[[], bool],
    timeout_s: float,
    interval_s: float,
    *,
    sleep: Callable[[float], None] = time.sleep,
    clock: Callable[[], float] = time.monotonic,
) -> bool:
    """Deadline-bounded polling: the one shape every "wait for X" loop in
    the control plane shares (slice barrier, drain pod-wait, runtime
    wait-ready, rollout await). Calls ``predicate`` immediately, then every
    ``interval_s`` until it returns truthy (-> True) or the deadline passes
    (-> False). Never sleeps past the deadline.
    """
    deadline = clock() + timeout_s
    while True:
        if predicate():
            return True
        remaining = deadline - clock()
        if remaining <= 0:
            return False
        sleep(min(interval_s, remaining))


def wait(delay_s: float, stop: "threading.Event | None" = None) -> bool:
    """The one sanctioned bare wait outside this module (cclint's
    ``waits`` checker forbids direct ``time.sleep`` elsewhere): sleep
    ``delay_s``, stop-aware when the caller has a stop event. Returns
    True when ``stop`` was set during the wait — the caller should wind
    down instead of continuing its loop."""
    delay_s = max(0.0, delay_s)
    if stop is not None:
        return stop.wait(delay_s)
    time.sleep(delay_s)
    return False


# ---------------------------------------------------------------------------
# Circuit breaker
# ---------------------------------------------------------------------------

BREAKER_CLOSED = "closed"
BREAKER_OPEN = "open"
BREAKER_HALF_OPEN = "half_open"


class CircuitOpenError(Exception):
    """The breaker is open: the dependency failed repeatedly and the
    recovery window has not passed — fail fast instead of piling on."""

    def __init__(self, name: str, retry_in_s: float):
        super().__init__(
            f"circuit {name!r} open; next probe allowed in {retry_in_s:.1f}s"
        )
        self.name = name
        self.retry_in_s = retry_in_s


class CircuitBreaker:
    """Closed / open / half-open breaker, thread-safe.

    Callers bracket the protected call:

        breaker.before_call()            # raises CircuitOpenError when open
        try:    result = do_the_call()
        except TransientThing:  breaker.record_failure(); raise
        else:   breaker.record_success()

    Only *transient* failures should be recorded — a 404 says nothing about
    the dependency's health. State changes are exported via
    ``metrics.set_breaker_state`` (``tpu_cc_breaker_state{path}``).
    """

    def __init__(
        self,
        name: str,
        failure_threshold: int = 10,
        recovery_time_s: float = 30.0,
        clock: Callable[[], float] = time.monotonic,
        metrics: object | None = None,
    ) -> None:
        self.name = name
        self.failure_threshold = max(1, failure_threshold)
        self.recovery_time_s = recovery_time_s
        self.clock = clock
        self._metrics = metrics
        self._lock = locks_mod.make_lock(f"retry.breaker.{name}")
        self._state = BREAKER_CLOSED
        self._consecutive_failures = 0
        self._opened_at = 0.0
        self._probe_in_flight = False
        self._probe_started_at = 0.0
        self._export()

    @property
    def state(self) -> str:
        with self._lock:
            self._maybe_half_open_locked()
            return self._state

    def _export(self) -> None:
        metrics = self._metrics if self._metrics is not None else _default_metrics()
        try:
            metrics.set_breaker_state(self.name, self._state)
        except Exception:  # noqa: BLE001 - metrics must never break the breaker
            pass

    def _maybe_half_open_locked(self) -> None:
        if (
            self._state == BREAKER_OPEN
            and self.clock() - self._opened_at >= self.recovery_time_s
        ):
            self._state = BREAKER_HALF_OPEN
            self._probe_in_flight = False
            self._export()

    def before_call(self) -> None:
        """Gate a call: raises :class:`CircuitOpenError` when the circuit is
        open (or half-open with the single probe already in flight)."""
        with self._lock:
            self._maybe_half_open_locked()
            if self._state == BREAKER_OPEN:
                raise CircuitOpenError(
                    self.name,
                    max(0.0, self._opened_at + self.recovery_time_s - self.clock()),
                )
            if self._state == BREAKER_HALF_OPEN:
                # A probe whose outcome was never recorded (caller died, or
                # failed with an exception its classifier had no verdict
                # for) must not wedge the breaker half-open forever: the
                # probe slot is a LEASE that expires after the recovery
                # window, after which the next caller takes over as probe.
                if (
                    self._probe_in_flight
                    and self.clock() - self._probe_started_at
                    < self.recovery_time_s
                ):
                    raise CircuitOpenError(
                        self.name,
                        max(
                            0.0,
                            self._probe_started_at
                            + self.recovery_time_s
                            - self.clock(),
                        ),
                    )
                self._probe_in_flight = True  # this caller IS the probe
                self._probe_started_at = self.clock()

    def record_success(self) -> None:
        with self._lock:
            changed = self._state != BREAKER_CLOSED
            self._state = BREAKER_CLOSED
            self._consecutive_failures = 0
            self._probe_in_flight = False
            if changed:
                log.info("circuit %s closed (dependency recovered)", self.name)
                self._export()

    def record_permanent(self) -> None:
        """The call failed for a reason that says nothing about the
        dependency's health (bad input, missing binary): release a held
        half-open probe slot without moving the state machine, so the next
        caller can probe instead of waiting out the lease."""
        with self._lock:
            self._probe_in_flight = False

    def record_failure(self) -> None:
        with self._lock:
            self._consecutive_failures += 1
            if self._state == BREAKER_HALF_OPEN or (
                self._state == BREAKER_CLOSED
                and self._consecutive_failures >= self.failure_threshold
            ):
                self._state = BREAKER_OPEN
                self._opened_at = self.clock()
                self._probe_in_flight = False
                log.warning(
                    "circuit %s OPEN after %d consecutive transient failure(s); "
                    "failing fast for %.0fs",
                    self.name, self._consecutive_failures, self.recovery_time_s,
                )
                self._export()
