"""Fleet observability plane: metrics federation + the capacity ledger.

The rollout work gave every node agent a flight recorder, SLO telemetry and
``/metrics``/``/statusz``/``/rolloutz`` endpoints — per node. At 10k+
nodes nobody scrapes 10k endpoints by hand: this module is the layer
above, the standard Prometheus-federation / hierarchical-collection
pattern applied to the ``tpu_cc_*`` families:

- :class:`FleetGateway` scrapes every agent (informer-discovered or
  injected targets, bounded worker pool, per-node scrape deadline on
  the shared :class:`~tpu_cc_manager_torch.utils.retry.RetryPolicy`), marks
  nodes **stale** instead of silently omitting them, and serves the
  merged truth at fleet ``/metrics`` + ``/fleetz``;
- :func:`merge_expositions` is the merge engine: histogram families
  merge bucket-wise with exact ``_sum``/``_count`` conservation (the
  fixed bucket sets in utils/metrics.py guarantee mergeable bounds),
  counters and gauges sum label-preserving (``sum by`` over the full
  label set), HELP/TYPE pairing survives federation (the exposition
  lint runs over the MERGED text too — lint/expo.py);
- the fleet p99 is computed through ``obs/slo.py`` :func:`~tpu_cc_manager_torch.obs.slo.merge_p99`
  over per-node latency shards reconstructed from the serve histogram;
- the **capacity ledger**: per-node headroom judged from
  ``hbm_bw_util``, serve queue depth, prestage-in-progress and
  quarantine/offline state, rolled into ``tpu_cc_fleet_headroom_nodes``
  — the signal ROADMAP item 2's prestage pacer and item 4's per-class
  admission gate consume.

Staleness contract (the fleet-scale bug this kills): a dead agent's
cached exposition must not be merged as live forever. Each sweep a
node either scrapes fresh (and its ``/statusz`` ``snapshot_ts`` must
ADVANCE — a frozen timestamp means a proxy replayed a stale body), or
its age grows; at ``stale_after_sweeps`` (default 2) the node leaves
the rollups but stays LISTED in ``/fleetz`` with its error — absence
of evidence is surfaced, never silent.

Server form: ``hack/obs_gateway.py`` (CLI, informer-discovered
targets). In-process form: construct with :func:`local_target`
fetchers — what tests, ``scale_bench.py`` and ``serve_bench.py`` do.
"""

from __future__ import annotations

import heapq
import http.server
import json
import logging
import threading
import time
import urllib.request
from urllib.parse import parse_qs, urlparse

from tpu_cc_manager_torch.obs import flight as flight_mod
from tpu_cc_manager_torch.obs import slo as slo_mod
from tpu_cc_manager_torch.utils import locks as locks_mod
from tpu_cc_manager_torch.utils import retry as retry_mod

log = logging.getLogger(__name__)

#: The per-node serve-latency histogram the fleet p99 is pooled from.
SERVE_HIST_FAMILY = "tpu_cc_serve_request_seconds"

#: Families the capacity ledger reads per node (utils/metrics.py).
HBM_FAMILY = "tpu_cc_hbm_bw_util"
QUEUE_FAMILY = "tpu_cc_serve_queue_depth"
PRESTAGE_FAMILY = "tpu_cc_prestage_in_progress"
QUARANTINE_FAMILY = "tpu_cc_quarantined"
CONNECTED_FAMILY = "tpu_cc_apiserver_connected"

_HIST_SUFFIXES = ("_bucket", "_sum", "_count")


# ---------------------------------------------------------------------------
# Exposition parsing / rendering (text format, the subset the agents emit)
# ---------------------------------------------------------------------------


def _unescape_label_value(raw: str) -> str:
    out: list[str] = []
    i = 0
    while i < len(raw):
        c = raw[i]
        if c == "\\" and i + 1 < len(raw):
            out.append({"\\": "\\", '"': '"', "n": "\n"}.get(
                raw[i + 1], raw[i + 1]
            ))
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


def _escape_label_value(value: str) -> str:
    return (
        value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
    )


def _parse_label_body(raw: str) -> tuple[tuple[str, str], ...] | None:
    """``k="v",...`` -> ordered (k, v) pairs; None when malformed."""
    pairs: list[tuple[str, str]] = []
    i, n = 0, len(raw)
    while i < n:
        eq = raw.find("=", i)
        if eq < 0 or eq + 1 >= n or raw[eq + 1] != '"':
            return None
        name = raw[i:eq]
        j = eq + 2
        chars: list[str] = []
        while j < n:
            c = raw[j]
            if c == "\\":
                if j + 1 >= n:
                    return None
                chars.append(raw[j:j + 2])
                j += 2
            elif c == '"':
                break
            else:
                chars.append(c)
                j += 1
        else:
            return None
        pairs.append((name, _unescape_label_value("".join(chars))))
        i = j + 1
        if i < n:
            if raw[i] != ",":
                return None
            i += 1
    return tuple(pairs)


class ParsedExposition:
    """One scrape, parsed: family HELP/TYPE in declaration order plus
    every sample as ``(series, ordered-labels, value)``."""

    def __init__(self) -> None:
        self.helps: dict[str, str] = {}
        self.types: dict[str, str] = {}
        self.family_order: list[str] = []
        # (series name, ordered (k, v) pairs, float value) in file order.
        self.samples: list[tuple[str, tuple[tuple[str, str], ...], float]] = []
        self.unparseable = 0

    def family_of(self, series: str) -> str:
        for suffix in _HIST_SUFFIXES:
            if series.endswith(suffix):
                base = series[: -len(suffix)]
                if self.types.get(base) in ("histogram", "summary"):
                    return base
        return series

    def series_values(self, family: str) -> list[tuple[dict, float]]:
        """Samples of one (non-histogram) family as (labels, value)."""
        return [
            (dict(labels), value)
            for series, labels, value in self.samples
            if series == family
        ]


def parse_exposition(text: str) -> ParsedExposition:
    """Parse a Prometheus text exposition (the agents' own renders are
    always well-formed; garbled lines are counted, never fatal — the
    gateway must keep serving the rest of a partially-broken scrape)."""
    parsed = ParsedExposition()
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) >= 3 and parts[1] in ("HELP", "TYPE"):
                name = parts[2]
                if name not in parsed.helps and name not in parsed.types:
                    parsed.family_order.append(name)
                if parts[1] == "HELP":
                    parsed.helps.setdefault(
                        name, parts[3] if len(parts) > 3 else ""
                    )
                else:
                    parsed.types.setdefault(
                        name, parts[3].strip() if len(parts) > 3 else ""
                    )
            continue
        brace = line.find("{")
        if brace >= 0:
            close = line.rfind("}")
            if close < brace:
                parsed.unparseable += 1
                continue
            name = line[:brace]
            labels = _parse_label_body(line[brace + 1:close])
            rest = line[close + 1:].split()
        else:
            fields = line.split()
            if len(fields) < 2:
                parsed.unparseable += 1
                continue
            name = fields[0]
            labels = ()
            rest = fields[1:]
        if labels is None or not rest:
            parsed.unparseable += 1
            continue
        try:
            value = float(rest[0].replace("Inf", "inf"))
        except ValueError:
            parsed.unparseable += 1
            continue
        parsed.samples.append((name, labels, value))
    return parsed


def _format_value(value: float) -> str:
    if value == int(value) and abs(value) < 1e15:
        return "%d" % int(value)
    return "%.6f" % value


def _render_sample(
    series: str, labels: tuple[tuple[str, str], ...], value: float
) -> str:
    if not labels:
        return f"{series} {_format_value(value)}"
    body = ",".join(
        f'{k}="{_escape_label_value(v)}"' for k, v in labels
    )
    return f"{series}{{{body}}} {_format_value(value)}"


def merge_expositions(scrapes: dict[str, str]) -> str:
    """Merge N agents' expositions into one fleet exposition.

    Counters and gauges **sum by their full label set** (label-
    preserving: per-node families carry a ``node`` label and stay per
    node; unlabeled control-plane families sum across agents, so e.g.
    the merged ``tpu_cc_quarantined`` counts quarantined agents).
    Histogram series merge the same way — identical fixed bucket bounds
    (utils/metrics.py) make bucket-wise summation exact, so bucket
    cumulativeness and ``_sum``/``_count`` conservation hold by
    construction. HELP/TYPE come from the first scrape declaring the
    family and are emitted ONCE, before the family's first sample, so
    the pairing the exposition lint enforces survives federation.
    """
    family_order: list[str] = []
    helps: dict[str, str] = {}
    types: dict[str, str] = {}
    # (series, sorted-label-key) -> [ordered labels, summed value]
    merged: dict[tuple, list] = {}
    per_family_series: dict[str, list[tuple]] = {}

    for _node in sorted(scrapes):
        parsed = parse_exposition(scrapes[_node])
        for fam in parsed.family_order:
            if fam not in helps and fam not in types:
                family_order.append(fam)
            if fam in parsed.helps:
                helps.setdefault(fam, parsed.helps[fam])
            if fam in parsed.types:
                types.setdefault(fam, parsed.types[fam])
        for series, labels, value in parsed.samples:
            key = (series, tuple(sorted(labels)))
            entry = merged.get(key)
            if entry is None:
                merged[key] = [labels, value]
                fam = parsed.family_of(series)
                per_family_series.setdefault(fam, []).append(key)
            else:
                entry[1] += value

    lines: list[str] = []
    for fam in family_order:
        series_keys = per_family_series.pop(fam, [])
        if fam in helps:
            lines.append(f"# HELP {fam} {helps[fam]}")
        if fam in types:
            lines.append(f"# TYPE {fam} {types[fam]}")
        for key in series_keys:
            labels, value = merged[key]
            lines.append(_render_sample(key[0], labels, value))
    # Families sampled without any HELP/TYPE declaration (shouldn't
    # happen with our agents, but a federation layer must not drop data).
    for fam, series_keys in per_family_series.items():
        for key in series_keys:
            labels, value = merged[key]
            lines.append(_render_sample(key[0], labels, value))
    return "\n".join(lines) + "\n" if lines else ""


# ---------------------------------------------------------------------------
# Fleet p99 through obs/slo.merge_p99
# ---------------------------------------------------------------------------


def histogram_shard(
    parsed: ParsedExposition, family: str = SERVE_HIST_FAMILY
) -> list[float]:
    """One node's latency samples reconstructed from its histogram
    buckets (each observation represented by its bucket's upper bound;
    the +Inf overflow by the top finite bound — the standard pooled-
    histogram approximation). Ascending, ready for merge_p99."""
    series = family + "_bucket"
    by_set: dict[tuple, list[tuple[float, float]]] = {}
    for name, labels, value in parsed.samples:
        if name != series:
            continue
        lab = dict(labels)
        le_raw = lab.pop("le", None)
        if le_raw is None:
            continue
        try:
            le = float("inf") if le_raw == "+Inf" else float(le_raw)
        except ValueError:
            continue
        by_set.setdefault(tuple(sorted(lab.items())), []).append((le, value))
    out: list[float] = []
    for buckets in by_set.values():
        buckets.sort()
        prev = 0.0
        top_finite = max(
            (le for le, _ in buckets if le != float("inf")), default=None
        )
        for le, cumulative in buckets:
            delta = int(max(0.0, cumulative - prev))
            prev = cumulative
            if delta <= 0:
                continue
            rep = le if le != float("inf") else top_finite
            if rep is None:
                continue
            out.extend([rep] * delta)
    out.sort()
    return out


def fleet_p99(shards: list[list[float]]) -> float | None:
    """p99 of the pooled per-node latency shards, via obs/slo.py
    ``merge_p99``: the first N-1 ascending shards are linearly merged
    into one union, then merge_p99 folds in the last — so the fleet
    number and the single-node number share ONE percentile
    implementation (nearest-rank, tests/test_slo.py)."""
    nonempty = [s for s in shards if s]
    if not nonempty:
        return None
    if len(nonempty) == 1:
        return slo_mod.percentile(nonempty[0], 0.99)
    union = list(heapq.merge(*nonempty[:-1]))
    return slo_mod.merge_p99(union, nonempty[-1])


# ---------------------------------------------------------------------------
# Scrape targets
# ---------------------------------------------------------------------------


def http_target(base_url: str, timeout_s: float = 2.0):
    """Fetcher for a real agent endpoint: ``fetch(path) -> text``."""
    base = base_url.rstrip("/")

    def fetch(path: str) -> str:
        with urllib.request.urlopen(base + path, timeout=timeout_s) as resp:
            return resp.read().decode()

    return fetch


def local_target(
    registry,
    flight=None,
    version: str | None = None,
    clock=time.monotonic,
):
    """In-process twin of an agent's debug endpoints — what tests and
    the benches hand the gateway instead of URLs. Serves the same three
    paths from live objects: ``/metrics`` renders the registry,
    ``/statusz`` carries the monotonic ``snapshot_ts`` + agent version
    the staleness check reads, ``/rolloutz`` snapshots the flight
    recorder."""
    if version is None:
        from tpu_cc_manager_torch.version import __version__ as version

    def fetch(path: str) -> str:
        if path in ("", "/metrics"):
            return registry.render_prometheus()
        if path == "/statusz":
            return json.dumps({
                "agent_version": version,
                "snapshot_ts": round(clock(), 6),
            })
        if path == "/rolloutz":
            payload = (
                flight.snapshot() if flight is not None
                else {"enabled": False}
            )
            return json.dumps(payload)
        raise ValueError(f"local target: unknown path {path!r}")

    return fetch


def targets_from_nodes(nodes: list[dict], port: int) -> dict[str, str]:
    """Informer-discovered scrape endpoints: node name -> base URL,
    address preference InternalIP > ExternalIP > Hostname > name (the
    same resolution ``ctl node-debug`` uses)."""
    out: dict[str, str] = {}
    for node in nodes:
        name = (node.get("metadata") or {}).get("name")
        if not name:
            continue
        addresses = (node.get("status") or {}).get("addresses") or []
        by_type = {
            a.get("type"): a.get("address")
            for a in addresses if a.get("address")
        }
        addr = (
            by_type.get("InternalIP")
            or by_type.get("ExternalIP")
            or by_type.get("Hostname")
            or name
        )
        out[name] = f"http://{addr}:{port}"
    return out


# ---------------------------------------------------------------------------
# The gateway
# ---------------------------------------------------------------------------


def _classify_scrape(exc: BaseException) -> retry_mod.Classification:
    # Every scrape failure is transient from the fleet's seat — the
    # per-node deadline (policy.deadline_s) bounds how long one slow or
    # dead agent can hold a worker; staleness handles persistence.
    return retry_mod.Classification(True, type(exc).__name__.lower())


class FleetGateway:
    """Scrape-merge-serve loop over a fleet of agent endpoints.

    ``targets`` maps node name -> base URL (scraped over HTTP) or a
    ``fetch(path) -> text`` callable (in-process). Thread-safe;
    :meth:`scrape_once` is one full sweep (bounded worker pool,
    per-node deadline), :meth:`serve` exposes the merged results, and
    :meth:`run` loops sweeps until ``stop`` is set.
    """

    def __init__(
        self,
        targets: dict | None = None,
        interval_s: float = 5.0,
        scrape_deadline_s: float = 2.0,
        stale_after_sweeps: int = 2,
        workers: int = 8,
        hbm_ceiling: float = 0.9,
        max_queue_depth: int = 16,
        slow_scrape_s: float | None = None,
        clock=time.monotonic,
    ) -> None:
        self.interval_s = float(interval_s)
        self.scrape_deadline_s = float(scrape_deadline_s)
        # A scrape that SUCCEEDS but takes this long is a gray signal:
        # the agent is alive (not dead, not stale) yet something on the
        # node is dragging — surfaced as scrape_slow in /fleetz and
        # excluded from the headroom ledger, but NOT from the rollups
        # (its telemetry is real; a fail-slow vetter needs it).
        self.slow_scrape_s = (
            float(slow_scrape_s)
            if slow_scrape_s is not None
            else self.scrape_deadline_s / 2.0
        )
        self.stale_after_sweeps = max(1, int(stale_after_sweeps))
        self.workers = max(1, int(workers))
        self.hbm_ceiling = float(hbm_ceiling)
        self.max_queue_depth = int(max_queue_depth)
        self.clock = clock
        self._lock = locks_mod.make_lock("obs.fleet")
        self._targets: dict[str, object] = {}  # cclint: guarded-by(_lock)
        self._scrapes: dict[str, dict] = {}  # cclint: guarded-by(_lock)
        self._sweep = 0  # cclint: guarded-by(_lock)
        self._scrape_errors_total = 0  # cclint: guarded-by(_lock)
        self._last_sweep_seconds: float | None = None  # cclint: guarded-by(_lock)
        self._merged_text = ""  # cclint: guarded-by(_lock)
        self._ledger: dict[str, dict] = {}  # cclint: guarded-by(_lock)
        if targets:
            self.set_targets(targets)

    # -- target management (informer refresh path) -------------------------

    def _normalize(self, target):
        if callable(target):
            return target
        return http_target(str(target), timeout_s=self.scrape_deadline_s)

    def set_targets(self, targets: dict) -> None:
        """Replace the target set (the informer-refresh path: nodes that
        left the pool drop out of the ledger with their scrapes)."""
        normalized = {
            name: self._normalize(t) for name, t in targets.items()
        }
        with self._lock:
            self._targets = normalized
            for gone in set(self._scrapes) - set(normalized):
                del self._scrapes[gone]

    def add_target(self, name: str, target) -> None:
        with self._lock:
            self._targets[name] = self._normalize(target)

    def remove_target(self, name: str) -> None:
        with self._lock:
            self._targets.pop(name, None)
            self._scrapes.pop(name, None)

    def target_names(self) -> list[str]:
        with self._lock:
            return sorted(self._targets)

    # -- one sweep ---------------------------------------------------------

    def _scrape_node(self, name: str, fetch, prev: dict | None) -> dict:
        policy = retry_mod.RetryPolicy(
            max_attempts=2,
            base_delay_s=0.05,
            max_delay_s=0.25,
            deadline_s=self.scrape_deadline_s,
            clock=self.clock if callable(self.clock) else time.monotonic,
        )

        def fetch_all() -> dict:
            metrics_text = fetch("/metrics")
            try:
                statusz = json.loads(fetch("/statusz"))
            except (ValueError, TypeError):
                statusz = {}
            try:
                rolloutz = json.loads(fetch("/rolloutz"))
            except (ValueError, TypeError):
                rolloutz = {}
            return {
                "metrics_text": metrics_text,
                "statusz": statusz if isinstance(statusz, dict) else {},
                "rolloutz": rolloutz if isinstance(rolloutz, dict) else {},
            }

        clock = self.clock if callable(self.clock) else time.monotonic
        t0 = clock()
        try:
            got = policy.call(
                fetch_all, op=f"fleet.scrape.{name}",
                classify=_classify_scrape,
            )
        except Exception as e:  # noqa: BLE001 - a dead agent is data, not a crash
            return {"ok": False, "error": f"{type(e).__name__}: {e}"}
        scrape_seconds = clock() - t0
        snapshot_ts = got["statusz"].get("snapshot_ts")
        prev_ts = prev.get("snapshot_ts") if prev else None
        if (
            snapshot_ts is not None
            and prev_ts is not None
            and snapshot_ts == prev_ts
        ):
            # The scrape "succeeded" but time did not advance on the
            # agent: a cached/replayed body. Dead node wearing a live
            # exposition — exactly the staleness bug /statusz's
            # monotonic snapshot_ts exists to catch. Compared against
            # the last KNOWN timestamp (not just the last OK sweep),
            # else a frozen agent flip-flops ok/fail and never ages
            # out. A DECREASED timestamp is an agent restart
            # (monotonic clock reset) and is accepted as fresh.
            return {
                "ok": False,
                "error": "snapshot-ts-not-advancing",
                "snapshot_ts": snapshot_ts,
            }
        return {
            "ok": True,
            "error": None,
            "metrics_text": got["metrics_text"],
            "snapshot_ts": snapshot_ts,
            "agent_version": got["statusz"].get("agent_version"),
            "rollout_recent": got["rolloutz"].get("recent") or [],
            "rollout_torn": got["rolloutz"].get("torn_lines") or 0,
            # Slow-but-successful is a DISTINCT verdict from dead: the
            # agent answered (telemetry stays in the rollups) but took
            # long enough that the node itself is suspect.
            "scrape_seconds": round(scrape_seconds, 4),
            "slow": scrape_seconds >= self.slow_scrape_s,
        }

    def scrape_once(self) -> dict:
        """One full-fleet sweep: scrape every target through the worker
        pool, refresh staleness, rebuild the merged exposition and the
        capacity ledger. Returns the ``/fleetz`` payload."""
        t0 = time.monotonic()
        with self._lock:
            targets = dict(self._targets)
            prevs = {
                name: dict(scrape)
                for name, scrape in self._scrapes.items()
            }
            sweep = self._sweep + 1
        results: dict[str, dict] = {}
        results_lock = threading.Lock()
        work = list(targets.items())
        cursor = [0]

        def worker() -> None:
            while True:
                with results_lock:
                    if cursor[0] >= len(work):
                        return
                    name, fetch = work[cursor[0]]
                    cursor[0] += 1
                row = self._scrape_node(name, fetch, prevs.get(name))
                with results_lock:
                    results[name] = row

        threads = [
            threading.Thread(target=worker, daemon=True, name=f"fleet-{i}")
            for i in range(min(self.workers, max(1, len(work))))
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()

        with self._lock:
            self._sweep = sweep
            for name, row in results.items():
                prev = self._scrapes.get(name) or {}
                if row["ok"]:
                    row["last_ok_sweep"] = sweep
                    self._scrapes[name] = row
                else:
                    self._scrape_errors_total += 1
                    kept = dict(prev)
                    kept["ok"] = False
                    kept["error"] = row["error"]
                    kept.setdefault("last_ok_sweep", 0)
                    self._scrapes[name] = kept
            self._rebuild_locked()
            self._last_sweep_seconds = round(time.monotonic() - t0, 4)
        return self.fleetz()

    # -- merge + ledger (under lock) ---------------------------------------

    def _stale_locked(self, scrape: dict) -> bool:  # cclint: requires(_lock)
        age = self._sweep - scrape.get("last_ok_sweep", 0)
        return age >= self.stale_after_sweeps

    def _rebuild_locked(self) -> None:  # cclint: requires(_lock)
        live: dict[str, str] = {}
        ledger: dict[str, dict] = {}
        shards: list[list[float]] = []
        for name, scrape in self._scrapes.items():
            stale = self._stale_locked(scrape)
            text = scrape.get("metrics_text")
            entry: dict = {
                "stale": stale,
                "error": scrape.get("error"),
                "agent_version": scrape.get("agent_version"),
                "snapshot_ts": scrape.get("snapshot_ts"),
                "age_sweeps": self._sweep - scrape.get("last_ok_sweep", 0),
                "scrape_slow": bool(scrape.get("slow")),
                "scrape_seconds": scrape.get("scrape_seconds"),
            }
            if text is not None and not stale:
                live[name] = text
                parsed = parse_exposition(text)
                entry.update(self._headroom(parsed))
                shards.append(histogram_shard(parsed))
                burns = slo_mod.parse_serve_slo_text(text)
                if burns:
                    fastest = burns[min(burns)]
                    entry["slo_burn"] = fastest.get("burn_rate")
                    entry["slo_p99_s"] = fastest.get("p99_s")
                if entry["scrape_slow"]:
                    # Slow != dead: the telemetry stays in the rollups
                    # (the fail-slow vetter needs the suspect's own
                    # samples), but its capacity is phantom — the
                    # prestage pacer must not spend it.
                    entry["has_headroom"] = False
            else:
                entry["has_headroom"] = False
            ledger[name] = entry
        merged = merge_expositions(live)
        p99 = fleet_p99(shards)
        n_stale = sum(1 for e in ledger.values() if e["stale"])
        n_slow = sum(
            1 for e in ledger.values()
            if e.get("scrape_slow") and not e["stale"]
        )
        n_headroom = sum(
            1 for e in ledger.values() if e.get("has_headroom")
        )
        lines = [merged.rstrip("\n")] if merged else []
        lines += [
            "# HELP tpu_cc_fleet_nodes Scrape targets known to the fleet "
            "gateway (informer-discovered agent endpoints).",
            "# TYPE tpu_cc_fleet_nodes gauge",
            "tpu_cc_fleet_nodes %d" % len(self._scrapes),
            "# HELP tpu_cc_fleet_nodes_stale Targets whose scrape has "
            "been failing (or whose snapshot_ts stopped advancing) for "
            "stale_after_sweeps sweeps — listed in /fleetz, excluded "
            "from the rollups.",
            "# TYPE tpu_cc_fleet_nodes_stale gauge",
            "tpu_cc_fleet_nodes_stale %d" % n_stale,
            "# HELP tpu_cc_fleet_nodes_slow Targets whose scrape "
            "SUCCEEDED but ran past slow_scrape_s — alive-but-dragging "
            "gray signal: kept in the rollups, excluded from the "
            "headroom ledger, surfaced per node as scrape_slow in "
            "/fleetz.",
            "# TYPE tpu_cc_fleet_nodes_slow gauge",
            "tpu_cc_fleet_nodes_slow %d" % n_slow,
            "# HELP tpu_cc_fleet_headroom_nodes The capacity ledger: "
            "nodes with serving headroom (fresh scrape, not quarantined"
            "/offline/prestaging, hbm_bw_util under the ceiling, queue "
            "under the bound) — what the prestage pacer consumes.",
            "# TYPE tpu_cc_fleet_headroom_nodes gauge",
            "tpu_cc_fleet_headroom_nodes %d" % n_headroom,
            "# HELP tpu_cc_fleet_scrape_errors_total Failed per-node "
            "scrapes since gateway start (deadline, refused, frozen "
            "snapshot_ts), cumulative.",
            "# TYPE tpu_cc_fleet_scrape_errors_total counter",
            "tpu_cc_fleet_scrape_errors_total %d"
            % self._scrape_errors_total,
        ]
        if p99 is not None:
            lines += [
                "# HELP tpu_cc_fleet_serve_p99_seconds Fleet-pooled "
                "p99 serving latency (per-node histogram shards merged "
                "through obs/slo.py merge_p99).",
                "# TYPE tpu_cc_fleet_serve_p99_seconds gauge",
                "tpu_cc_fleet_serve_p99_seconds %.6f" % p99,
            ]
        self._merged_text = "\n".join(lines) + "\n"
        self._ledger = ledger

    def _headroom(self, parsed: ParsedExposition) -> dict:
        hbm = max(
            (v for _, v in parsed.series_values(HBM_FAMILY)), default=None
        )
        queue = sum(
            v for _, v in parsed.series_values(QUEUE_FAMILY)
        )
        prestaging = any(
            v > 0 for _, v in parsed.series_values(PRESTAGE_FAMILY)
        )
        quarantined = any(
            v > 0 for _, v in parsed.series_values(QUARANTINE_FAMILY)
        )
        connected = parsed.series_values(CONNECTED_FAMILY)
        offline = bool(connected) and all(v == 0 for _, v in connected)
        return {
            "hbm_bw_util": hbm,
            "queue_depth": int(queue),
            "prestage_in_progress": prestaging,
            "quarantined": quarantined,
            "offline": offline,
            "has_headroom": bool(
                not quarantined
                and not offline
                and not prestaging
                and (hbm is None or hbm < self.hbm_ceiling)
                and queue <= self.max_queue_depth
            ),
        }

    # -- read side ---------------------------------------------------------

    def metrics_text(self) -> str:
        with self._lock:
            return self._merged_text

    def fleetz(self) -> dict:
        with self._lock:
            ledger = {
                name: dict(entry)
                for name, entry in sorted(self._ledger.items())
            }
            sweep = self._sweep
            errors = self._scrape_errors_total
            sweep_seconds = self._last_sweep_seconds
        stale = sorted(n for n, e in ledger.items() if e["stale"])
        # Slow-but-successful is reported apart from dead/stale: a gray
        # node's telemetry is still live (rollups keep it) but its
        # capacity is not trusted — operators need to see which is which.
        slow = sorted(
            n for n, e in ledger.items()
            if e.get("scrape_slow") and not e["stale"]
        )
        burns = [
            e["slo_burn"] for e in ledger.values()
            if e.get("slo_burn") is not None
        ]
        return {
            "sweep": sweep,
            "sweep_seconds": sweep_seconds,
            "interval_s": self.interval_s,
            "stale_after_sweeps": self.stale_after_sweeps,
            "nodes": ledger,
            "fleet": {
                "nodes": len(ledger),
                "stale": len(stale),
                "stale_nodes": stale,
                "slow": len(slow),
                "slow_nodes": slow,
                "headroom_nodes": sum(
                    1 for e in ledger.values() if e.get("has_headroom")
                ),
                "max_slo_burn": max(burns) if burns else None,
                "scrape_errors_total": errors,
            },
        }

    def stitched_rollout(self) -> dict:
        """The federated rollout view (``/fleetz?rollout=``): every
        node's ``/rolloutz`` recent-event stream stitched into one
        seq-consistent timeline (obs/flight.py) plus its exactly-once
        reconstruction."""
        with self._lock:
            streams = {
                name: list(scrape.get("rollout_recent") or [])
                for name, scrape in sorted(self._scrapes.items())
            }
            torn = sum(
                scrape.get("rollout_torn") or 0
                for scrape in self._scrapes.values()
            )
        nonempty = {n: s for n, s in streams.items() if s}
        events = flight_mod.stitch_timelines(
            list(nonempty.values()), labels=list(nonempty)
        )
        return {
            "streams": len(nonempty),
            "events": len(events),
            "torn_lines": torn,
            "reconstruction": flight_mod.reconstruct(events),
        }

    # -- serving -----------------------------------------------------------

    def serve(
        self, port: int, bind: str = "127.0.0.1"
    ) -> http.server.ThreadingHTTPServer:
        """Serve fleet ``/metrics``, ``/fleetz`` (``?rollout=`` for the
        stitched timeline) and ``/healthz`` on ``bind:port`` (port 0 =
        ephemeral; read it back off ``server_address``)."""
        gateway = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 - http.server API
                url = urlparse(self.path)
                path = url.path.rstrip("/")
                content_type = "application/json"
                if path in ("", "/metrics"):
                    body = gateway.metrics_text().encode()
                    content_type = "text/plain; version=0.0.4"
                    code = 200
                elif path == "/healthz":
                    body = b"ok\n"
                    content_type = "text/plain"
                    code = 200
                elif path == "/fleetz":
                    # keep_blank_values: the documented form is the
                    # bare `?rollout=` flag, which parse_qs otherwise
                    # drops.
                    query = parse_qs(url.query, keep_blank_values=True)
                    payload = gateway.fleetz()
                    if "rollout" in query:
                        payload["rollout"] = gateway.stitched_rollout()
                    body = (json.dumps(payload, indent=1) + "\n").encode()
                    code = 200
                else:
                    body = b"not found\n"
                    content_type = "text/plain"
                    code = 404
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, fmt, *fmtargs):  # quiet access logs
                log.debug("fleet http: " + fmt, *fmtargs)

        server = http.server.ThreadingHTTPServer((bind, port), Handler)
        thread = threading.Thread(
            target=server.serve_forever, name="fleet-gateway", daemon=True
        )
        thread.start()
        log.info(
            "fleet gateway listening on %s:%d",
            bind, server.server_address[1],
        )
        return server

    def run(self, stop: threading.Event | None = None) -> None:
        """Sweep loop: scrape, then wait out the interval (stop-aware,
        via the sanctioned retry.wait — a kill between sweeps returns
        immediately)."""
        stop = stop or threading.Event()
        while not stop.is_set():
            try:
                self.scrape_once()
            except Exception:  # noqa: BLE001 - the loop must outlive one bad sweep
                log.exception("fleet sweep failed; continuing")
            if retry_mod.wait(self.interval_s, stop):
                return
