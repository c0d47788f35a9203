"""Peer-relative fail-slow (gray-failure) vetting.

Every failure the manager survives elsewhere is fail-stop or fail-dark;
production fleets lose far more SLO to *gray* failures — nodes that pass
every watchdog probe while serving 10x latency (Huang et al., HotOS'17;
Gunawi et al., "Fail-Slow at Scale", FAST'18). A gray node cannot be
caught by an absolute threshold (load moves the whole fleet's latency
together) nor by its own health probe (green by definition), so this
module judges each node *against its peers*:

- **samples**: per-node request latencies, fed either directly
  (:meth:`FailslowVetter.observe`, the ServeHarness path) or scraped
  (:meth:`FailslowVetter.ingest_exposition` deltas the cumulative
  ``tpu_cc_serve_request_seconds_sum``/``_count`` families between
  calls — the FleetGateway-rollup path);
- **vetting window**: each :meth:`FailslowVetter.vet` call closes one
  window; a node's window statistic is its sample **median** (robust to
  a stray tail) and the fleet baseline is the **median of the per-node
  medians** (robust to the suspect itself dragging the mean);
- **hysteresis**: a node must deviate beyond ``threshold`` x fleet for
  ``min_windows`` CONSECUTIVE windows to be confirmed (one bad window
  is weather), and a confirmed node must recover below
  ``clear_threshold`` for ``clear_windows`` consecutive windows to be
  cleared (flapping is not recovery);
- **false-positive bound**: with the default ``threshold`` of 2.0, a
  healthy homogeneous fleet under ±20 % latency jitter can reach a
  peer ratio of at most 1.2/0.8 = 1.5 — strictly inside the threshold,
  so no strike is ever possible from jitter alone
  (tests/test_failslow.py holds this to a 200-trial seeded property
  test). ``min_peers`` floors the jury: below it there is no fleet to
  be relative to, and the vetter abstains rather than guess.

Verdicts are **re-concluding**: while a node stays confirmed, every
further deviant window emits another confirmed verdict under a fresh
monotonic id. That is what lets the consumer escalate — the remediation
ladder turns verdict #1 into a runtime restart and verdict #2 into a
quarantine (``reason=fail-slow``) — while the ids keep journaled
exactly-once acting trivial (ccmanager/rolling.py ``failslow-vetted``
crash point: the successor resumes acting from the record by id, never
double-quarantining).
"""

from __future__ import annotations

import os
import re
import statistics
import time

from tpu_cc_manager_torch.utils import locks as locks_mod

VERDICT_CONFIRMED = "confirmed"
VERDICT_CLEARED = "cleared"

FAILSLOW_WINDOW_S_ENV = "CC_FAILSLOW_WINDOW_S"
FAILSLOW_THRESHOLD_ENV = "CC_FAILSLOW_THRESHOLD"
FAILSLOW_MIN_WINDOWS_ENV = "CC_FAILSLOW_MIN_WINDOWS"
FAILSLOW_MIN_PEERS_ENV = "CC_FAILSLOW_MIN_PEERS"
FAILSLOW_CLEAR_WINDOWS_ENV = "CC_FAILSLOW_CLEAR_WINDOWS"

#: Exposition families the scrape-fed path deltas (per-node cumulative
#: latency sum and completion count, exported by utils/metrics.py).
_SUM_RE = re.compile(
    r'^tpu_cc_serve_request_seconds_sum\{node="([^"]*)"\}\s+([0-9.eE+-]+)\s*$',
    re.MULTILINE,
)
_COUNT_RE = re.compile(
    r'^tpu_cc_serve_request_seconds_count\{node="([^"]*)"\}\s+([0-9.eE+-]+)\s*$',
    re.MULTILINE,
)


class FailslowVetter:
    """Thread-safe peer-relative outlier vetter.

    Feed per-node latencies with :meth:`observe` (or scrape deltas with
    :meth:`ingest_exposition`); the caller paces the windows by calling
    :meth:`vet` once per ``window_s`` — each call closes the current
    window, judges every participating node against the fleet median,
    and appends any verdicts to the non-draining :meth:`concluded` list
    (monotonic ids, so consumers dedup by id). ``clock`` is injectable
    for deterministic tests.
    """

    def __init__(
        self,
        window_s: float = 5.0,
        threshold: float = 2.0,
        clear_threshold: float = 1.3,
        min_windows: int = 2,
        clear_windows: int = 2,
        min_peers: int = 3,
        min_samples: int = 3,
        metrics=None,
        clock=time.monotonic,
    ) -> None:
        if threshold <= 1.0:
            raise ValueError("threshold must be > 1.0")
        if clear_threshold > threshold:
            raise ValueError("clear_threshold must be <= threshold")
        self.window_s = float(window_s)
        self.threshold = float(threshold)
        self.clear_threshold = float(clear_threshold)
        self.min_windows = max(1, int(min_windows))
        self.clear_windows = max(1, int(clear_windows))
        self.min_peers = max(2, int(min_peers))
        self.min_samples = max(1, int(min_samples))
        self.metrics = metrics
        self.clock = clock
        self._lock = locks_mod.make_lock("obs.failslow")
        self._window: dict[str, list[float]] = {}  # cclint: guarded-by(_lock)
        self._strikes: dict[str, int] = {}  # cclint: guarded-by(_lock)
        self._clear_streak: dict[str, int] = {}  # cclint: guarded-by(_lock)
        self._confirmed: set[str] = set()  # cclint: guarded-by(_lock)
        self._suspect: set[str] = set()  # cclint: guarded-by(_lock)
        self._deviation: dict[str, float] = {}  # cclint: guarded-by(_lock)
        self._concluded: list[dict] = []  # cclint: guarded-by(_lock)
        self._next_id = 1  # cclint: guarded-by(_lock)
        self.windows_vetted = 0  # cclint: guarded-by(_lock)
        # Last cumulative (sum, count) per node the scrape path saw.
        self._scrape_prev: dict[str, tuple[float, float]] = {}  # cclint: guarded-by(_lock)

    @classmethod
    def from_env(cls, **kwargs) -> "FailslowVetter":
        """Build from the CC_FAILSLOW_* env knobs (docs/operations.md
        env table); explicit kwargs win over the environment."""
        env = {
            "window_s": float(os.environ.get(FAILSLOW_WINDOW_S_ENV, "5.0")),
            "threshold": float(os.environ.get(FAILSLOW_THRESHOLD_ENV, "2.0")),
            "min_windows": int(os.environ.get(FAILSLOW_MIN_WINDOWS_ENV, "2")),
            "min_peers": int(os.environ.get(FAILSLOW_MIN_PEERS_ENV, "3")),
            "clear_windows": int(
                os.environ.get(FAILSLOW_CLEAR_WINDOWS_ENV, "2")
            ),
        }
        env.update(kwargs)
        return cls(**env)

    # -- feeding -----------------------------------------------------------

    def observe(self, node: str, seconds: float) -> None:
        """Fold one completed request's latency into the current
        window's per-node sample set (the ServeHarness feeds every
        completion through here from the driver's on_complete)."""
        with self._lock:
            self._window.setdefault(node, []).append(
                max(0.0, float(seconds))
            )

    def ingest_exposition(self, text: str) -> int:
        """Scrape-fed path: delta the cumulative per-node
        ``tpu_cc_serve_request_seconds_sum``/``_count`` families against
        the previous call and fold each node's interval MEAN latency in
        as one weighted window sample per completed request (capped at
        ``min_samples`` — the mean already summarizes the interval).
        Returns how many nodes contributed. First call only primes the
        cumulative baseline (a cumulative counter's first read is not a
        rate)."""
        sums = {n: float(v) for n, v in _SUM_RE.findall(text)}
        counts = {n: float(v) for n, v in _COUNT_RE.findall(text)}
        contributed = 0
        with self._lock:
            for node, count in counts.items():
                total = sums.get(node)
                if total is None:
                    continue
                prev = self._scrape_prev.get(node)
                self._scrape_prev[node] = (total, count)
                if prev is None:
                    continue
                d_sum = total - prev[0]
                d_count = count - prev[1]
                if d_count <= 0 or d_sum < 0:
                    continue  # counter reset or idle interval
                mean = d_sum / d_count
                reps = min(self.min_samples, int(d_count))
                self._window.setdefault(node, []).extend([mean] * reps)
                contributed += 1
        return contributed

    # -- vetting -----------------------------------------------------------

    def vet(self) -> list[dict]:
        """Close the current vetting window and judge it. Returns the
        verdicts newly concluded by THIS call (also appended to
        :meth:`concluded`): ``{"id", "node", "verdict", "deviation"}``.
        Abstains (returns []) when fewer than ``min_peers`` nodes
        produced ``min_samples`` samples — strikes neither advance nor
        reset without a fleet to be relative to."""
        new: list[dict] = []
        with self._lock:
            window, self._window = self._window, {}
            self.windows_vetted += 1
            medians = {
                n: statistics.median(s)
                for n, s in window.items()
                if len(s) >= self.min_samples
            }
            if len(medians) < self.min_peers:
                return []
            fleet = statistics.median(medians.values())
            if fleet <= 0:
                return []
            for node, med in sorted(medians.items()):
                ratio = med / fleet
                self._deviation[node] = ratio
                if node in self._confirmed:
                    if ratio <= self.clear_threshold:
                        streak = self._clear_streak.get(node, 0) + 1
                        self._clear_streak[node] = streak
                        if streak >= self.clear_windows:
                            self._confirmed.discard(node)
                            self._suspect.discard(node)
                            self._strikes[node] = 0
                            self._clear_streak[node] = 0
                            new.append(self._conclude_locked(
                                node, VERDICT_CLEARED, ratio
                            ))
                    else:
                        self._clear_streak[node] = 0
                        if ratio >= self.threshold:
                            # Re-conclude: still deviant while
                            # confirmed — a fresh verdict id lets the
                            # consumer's ladder escalate.
                            new.append(self._conclude_locked(
                                node, VERDICT_CONFIRMED, ratio
                            ))
                    continue
                if ratio >= self.threshold:
                    strikes = self._strikes.get(node, 0) + 1
                    self._strikes[node] = strikes
                    self._suspect.add(node)
                    if strikes >= self.min_windows:
                        self._confirmed.add(node)
                        self._clear_streak[node] = 0
                        new.append(self._conclude_locked(
                            node, VERDICT_CONFIRMED, ratio
                        ))
                else:
                    self._strikes[node] = 0
                    self._suspect.discard(node)
            self._export_locked(medians)
        return new

    def _conclude_locked(self, node, verdict, ratio) -> dict:  # cclint: requires(_lock)
        entry = {
            "id": self._next_id,
            "node": node,
            "verdict": verdict,
            "deviation": round(ratio, 4),
        }
        self._next_id += 1
        self._concluded.append(entry)
        if self.metrics is not None:
            self.metrics.record_failslow_verdict(node, verdict)
        # Bound memory across a long soak; consumers dedup by id and
        # have long since acted on anything this old.
        if len(self._concluded) > 256:
            del self._concluded[: len(self._concluded) - 256]
        return entry

    def _export_locked(self, medians) -> None:  # cclint: requires(_lock)
        if self.metrics is None:
            return
        for node in medians:
            self.metrics.set_failslow_suspect(
                node, node in self._suspect or node in self._confirmed
            )
            self.metrics.set_failslow_deviation(
                node, self._deviation.get(node, 1.0)
            )

    # -- reading -----------------------------------------------------------

    def suspects(self) -> set[str]:
        """Nodes currently under suspicion (>= 1 strike) or confirmed —
        the set the serve driver de-weights and the prestage headroom
        gate excludes while vetting runs."""
        with self._lock:
            return set(self._suspect) | set(self._confirmed)

    def confirmed(self) -> set[str]:
        with self._lock:
            return set(self._confirmed)

    def concluded(self) -> list[dict]:
        """Every verdict concluded so far (non-draining, ids monotonic):
        the poll contract for the rolling orchestrator's journaled
        exactly-once acting — reading never consumes, so a successor
        resuming after a SIGKILL sees the same list."""
        with self._lock:
            return [dict(e) for e in self._concluded]

    def deviation(self, node: str) -> float | None:
        with self._lock:
            return self._deviation.get(node)


def publish_suspect_labels(api, added, removed) -> None:
    """Best-effort label publication for the ``ctl status`` SUSPECT
    column: mark newly suspected nodes, clear recovered ones. Failures
    are swallowed — suspicion labels are operator telemetry, never
    control flow (the record journal, not the label, is authoritative
    for acting)."""
    from tpu_cc_manager_torch.labels import FAILSLOW_SUSPECT_LABEL

    for name in added:
        try:
            api.patch_node_labels(name, {FAILSLOW_SUSPECT_LABEL: "true"})
        except Exception:
            pass
    for name in removed:
        try:
            api.patch_node_labels(name, {FAILSLOW_SUSPECT_LABEL: None})
        except Exception:
            pass
