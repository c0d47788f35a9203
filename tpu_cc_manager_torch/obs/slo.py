"""Windowed serving-SLO evaluation: rolling p99 and error-budget burn.

ROADMAP item 1 (SLO-paced rollouts) needs the orchestrator to ask one
question while a pool flips under live traffic: *is the user-visible SLO
holding right now?* This module is that answer's single implementation —
the TrafficDriver feeds it every completion (and every loss), it keeps a
bounded rolling window of samples, and both consumers read the same
numbers:

- ``tpu_cc_serve_slo_p99_seconds`` / ``tpu_cc_serve_error_budget_burn``
  metric gauges (utils/metrics.py, exported per window), and
- :meth:`SloEvaluator.snapshot` — the Python contract a latency-gated
  rollout will poll at wave boundaries (``breached()`` is the halt
  predicate, shaped like the failure budget's).

Definitions (the SRE-workbook shapes, kept deliberately boring):

- **p99**: the 99th-percentile latency of the samples inside the
  window (nearest-rank on the sorted list).
- **error rate**: failed samples / all samples in the window.
- **burn rate**: error rate / error budget — 1.0 means the budget is
  being spent exactly as provisioned; a burn of 14 on a short window is
  the classic page-now threshold.

The math is conservation-friendly on purpose (tests/test_slo.py holds
it to property tests): error *counts* over a window equal the sum over
any split of that window, p99 is monotone under added slow requests,
and an empty window reports ``None`` p99 with zero burn rather than
inventing a number.
"""

from __future__ import annotations

import bisect
import collections
import time

from tpu_cc_manager_torch.utils import locks as locks_mod

#: Default rolling windows (seconds): a fast window for paging-speed
#: reaction and a slow one for pacing decisions.
DEFAULT_WINDOWS_S = (30.0, 300.0)

#: Default error budget: 99.9 % of requests succeed.
DEFAULT_ERROR_BUDGET = 1e-3

#: Bound on retained samples; beyond this the OLDEST samples are
#: dropped (the windows are time-bounded anyway — this is the memory
#: backstop for a driver pushing 100k+ rps through a long soak).
DEFAULT_MAX_SAMPLES = 200_000


def percentile(sorted_vals: list[float], q: float) -> float | None:
    """Nearest-rank percentile of an ascending list (None when empty)."""
    if not sorted_vals:
        return None
    idx = min(
        len(sorted_vals) - 1, max(0, round(q * (len(sorted_vals) - 1)))
    )
    return sorted_vals[idx]


def breach_verdict(
    burn_rate: float,
    p99_s: float | None,
    max_burn_rate: float,
    p99_target_s: float | None,
) -> bool:
    """THE breach predicate — the single comparison both gate forms
    share (:meth:`SloEvaluator.breached` in-process,
    :func:`breached_from_metrics_text` over a remote scrape), so the
    thresholds can never drift between them: burn above budget, or p99
    above target when both exist (a None p99 is no evidence, never a
    breach)."""
    if burn_rate > max_burn_rate:
        return True
    return (
        p99_target_s is not None
        and p99_s is not None
        and p99_s > p99_target_s
    )


class SloEvaluator:
    """Thread-safe rolling-window SLO evaluator.

    ``observe(latency_s, ok=...)`` records one finished request;
    ``snapshot()`` reports per-window p99 / error rate / burn rate /
    goodput; ``breached(...)`` is the boolean the pacing loop polls.
    ``clock`` is injectable for deterministic tests.
    """

    def __init__(
        self,
        windows_s: tuple[float, ...] = DEFAULT_WINDOWS_S,
        error_budget: float = DEFAULT_ERROR_BUDGET,
        p99_target_s: float | None = None,
        max_samples: int = DEFAULT_MAX_SAMPLES,
        clock=time.monotonic,
    ) -> None:
        if not windows_s:
            raise ValueError("at least one window is required")
        if error_budget <= 0:
            raise ValueError("error_budget must be > 0")
        self.windows_s = tuple(sorted(float(w) for w in windows_s))
        self.error_budget = float(error_budget)
        self.p99_target_s = p99_target_s
        self.max_samples = max(1, int(max_samples))
        self.clock = clock
        self._lock = locks_mod.make_lock("obs.slo")
        # (t, latency_s, ok) in arrival order; pruned past the longest
        # window on every observe.
        self._samples: collections.deque[tuple[float, float, bool]] = (  # cclint: guarded-by(_lock)
            collections.deque()
        )
        self._total = 0  # cclint: guarded-by(_lock)
        self._errors_total = 0  # cclint: guarded-by(_lock)

    # -- recording ---------------------------------------------------------

    def observe(
        self, latency_s: float, ok: bool = True, now: float | None = None
    ) -> None:
        t = self.clock() if now is None else now
        with self._lock:
            self._samples.append((t, max(0.0, float(latency_s)), bool(ok)))
            self._total += 1
            if not ok:
                self._errors_total += 1
            self._prune(t)

    def observe_error(self, now: float | None = None) -> None:
        """A request that never completed (lost / deadline-dead): all
        error, no meaningful latency."""
        self.observe(0.0, ok=False, now=now)

    def _prune(self, now: float) -> None:  # cclint: requires(_lock)
        horizon = now - self.windows_s[-1]
        while self._samples and (
            self._samples[0][0] < horizon
            or len(self._samples) > self.max_samples
        ):
            self._samples.popleft()

    # -- reading -----------------------------------------------------------

    def counts_between(self, t0: float, t1: float) -> tuple[int, int]:
        """(samples, errors) with ``t0 <= t < t1`` — the conservation
        primitive: counts over a window equal the sum over any split of
        it (tests/test_slo.py)."""
        with self._lock:
            total = errors = 0
            for t, _lat, ok in self._samples:
                if t0 <= t < t1:
                    total += 1
                    if not ok:
                        errors += 1
            return total, errors

    def stats(
        self, window_s: float | None = None, now: float | None = None
    ) -> dict:
        """One window's readout. ``window_s`` defaults to the fastest
        configured window."""
        if window_s is None:
            window_s = self.windows_s[0]
        t = self.clock() if now is None else now
        horizon = t - window_s
        with self._lock:
            # Samples arrive in clock order, so walking from the newest
            # end and stopping at the horizon costs O(window), not
            # O(everything retained) — this runs on the driver's
            # dispatch thread every ladder tick, and the retention
            # backstop is 200k samples. (An out-of-order straggler
            # stamped older than the window's newest sample may be
            # missed by the early stop — acceptable for telemetry;
            # counts_between keeps the exact full scan.)
            in_window = []
            for s in reversed(self._samples):
                if s[0] < horizon:
                    break
                in_window.append(s)
        lats = sorted(lat for _, lat, ok in in_window if ok)
        count = len(in_window)
        errors = sum(1 for _, _, ok in in_window if not ok)
        error_rate = (errors / count) if count else 0.0
        p99 = percentile(lats, 0.99)
        return {
            "window_s": window_s,
            "count": count,
            "errors": errors,
            "ok": count - errors,
            "error_rate": error_rate,
            # An empty window burns nothing: no evidence is not bad
            # evidence (the pacing loop must not halt a rollout because
            # traffic paused).
            "burn_rate": error_rate / self.error_budget,
            "p99_s": p99,
            "p50_s": percentile(lats, 0.50),
            "goodput_rps": (count - errors) / window_s if window_s else 0.0,
        }

    def snapshot(self, now: float | None = None) -> dict:
        """Every configured window's stats plus lifetime totals — the
        poll contract for the latency-gated rollout AND the payload the
        serve metrics export."""
        with self._lock:
            total, errors_total = self._total, self._errors_total
        return {
            "error_budget": self.error_budget,
            "p99_target_s": self.p99_target_s,
            "windows": [
                self.stats(w, now=now) for w in self.windows_s
            ],
            "total": total,
            "errors_total": errors_total,
        }

    def breached(
        self,
        max_burn_rate: float = 1.0,
        window_s: float | None = None,
        now: float | None = None,
        p99_target_s: float | None = None,
    ) -> bool:
        """True when the SLO is being violated over ``window_s``: the
        burn rate exceeds ``max_burn_rate``, or the window p99 exceeds
        the target (``p99_target_s`` argument, falling back to the
        evaluator's configured target). The halt predicate a
        latency-gated rollout checks at wave boundaries, same shape as
        the failure budget's — and its ONLY implementation: callers
        (ServeHarness's in-process gate, the remote
        ``breached_from_metrics_text``) must not re-derive it."""
        target = p99_target_s if p99_target_s is not None else self.p99_target_s
        s = self.stats(window_s, now=now)
        return breach_verdict(
            s["burn_rate"], s["p99_s"], max_burn_rate, target
        )


#: Exposition families the remote gate reads. One sample line looks like
#: ``tpu_cc_serve_error_budget_burn{window="30"} 1.500000``.
_GAUGE_RE_TMPL = r'^%s\{window="([^"]+)"\}\s+([0-9.eE+-]+)\s*$'


def parse_serve_slo_text(text: str) -> dict[float, dict[str, float]]:
    """Parse the ``tpu_cc_serve_slo_p99_seconds`` /
    ``tpu_cc_serve_error_budget_burn`` gauges out of a Prometheus
    exposition scrape: window seconds -> {"p99_s": ..., "burn_rate":
    ...}. A window exporting only burn (empty window: no invented p99)
    yields no ``p99_s`` key — the same no-sample contract the local
    evaluator keeps."""
    import re

    out: dict[float, dict[str, float]] = {}
    for family, key in (
        ("tpu_cc_serve_slo_p99_seconds", "p99_s"),
        ("tpu_cc_serve_error_budget_burn", "burn_rate"),
    ):
        pat = re.compile(_GAUGE_RE_TMPL % re.escape(family), re.MULTILINE)
        for window, value in pat.findall(text):
            try:
                w = float(window)
                v = float(value)
            except ValueError:
                continue
            out.setdefault(w, {})[key] = v
    return out


def parse_serve_offered_rps(text: str) -> float | None:
    """Parse the ``tpu_cc_serve_offered_rps`` gauge (no labels, unlike
    the windowed SLO gauges) out of an exposition scrape — the input
    the continuous-prestage headroom gate converts into knee slack
    (rolling.headroom_gate_from_source). None when the pool exports no
    offered-rate gauge: no evidence of slack."""
    import re

    m = re.search(
        r"^tpu_cc_serve_offered_rps\s+([0-9.eE+-]+)\s*$",
        text, re.MULTILINE,
    )
    if m is None:
        return None
    try:
        return float(m.group(1))
    except ValueError:
        return None


def breached_from_metrics_text(
    text: str,
    max_burn_rate: float = 1.0,
    p99_target_s: float | None = None,
    window_s: float | None = None,
) -> bool:
    """The remote twin of :meth:`SloEvaluator.breached`, judged from a
    scraped ``/metrics`` payload (a serving pool's live exposition)
    instead of an in-process evaluator — what ``tpu-cc-ctl rollout
    --slo-source`` polls at wave boundaries. ``window_s`` selects one
    exported window (default: the fastest exported). A scrape with no
    serve SLO gauges at all reads as NOT breached — no evidence is not
    bad evidence, same as the empty-window rule."""
    windows = parse_serve_slo_text(text)
    if not windows:
        return False
    if window_s is not None:
        stats = windows.get(float(window_s))
        if stats is None:
            return False
    else:
        stats = windows[min(windows)]
    return breach_verdict(
        stats.get("burn_rate", 0.0), stats.get("p99_s"),
        max_burn_rate, p99_target_s,
    )


def merge_p99(sorted_a: list[float], sorted_b: list[float]) -> float | None:
    """p99 of the union of two ascending latency lists (no re-sort of
    the inputs' concatenation beyond a linear merge) — the helper the
    monotonicity property tests exercise: p99(A ∪ slow_extras) >=
    p99(A)."""
    if not sorted_a:
        return percentile(sorted_b, 0.99)
    if not sorted_b:
        return percentile(sorted_a, 0.99)
    merged = list(sorted_a)
    for v in sorted_b:
        bisect.insort(merged, v)
    return percentile(merged, 0.99)
