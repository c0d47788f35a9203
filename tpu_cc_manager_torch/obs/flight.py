"""Rollout flight recorder: an append-only JSONL timeline of every
orchestrator decision.

The rolling orchestrator (ccmanager/rolling.py) makes dozens of
decisions per rollout — plan computed, surge picks, wave/window
open+close, per-node desired-patch/converged/failed/retired/adopted,
budget spend and halt, lease takeover and fence, resume — and before
this module the only durable record was the end-of-run summary. When
wave 3 halts at 02:00 the summary says *that* it halted; the flight
recorder says *why*, in order, with the rollout generation, wave id and
trace id stamped on every event, and it survives the orchestrator dying
mid-window: a successor's ``--resume`` appends to the SAME file, so one
timeline spans the crash.

Write discipline: one JSON object per line, flushed per event. A kill
can tear at most the final line; :func:`read_events` tolerates exactly
that (an unparseable tail line is counted, never fatal) and fails no
reader. Like the span journal, recording is best-effort — observability
must never halt a rollout.

Consumers:

- ``tpu-cc-ctl rollout-timeline`` renders the timeline and the
  exactly-once reconstruction (docs/observability.md);
- ``/rolloutz`` (ccmanager/metrics_server.py) serves the live
  recorder's snapshot during a rollout;
- ``hack/chaos_soak.sh`` asserts zero torn lines after seeded kills
  (the OBS_SUMMARY line).
"""

from __future__ import annotations

import collections
import json
import logging
import os
import tempfile
import time

from tpu_cc_manager_torch.labels import label_safe
from tpu_cc_manager_torch.utils import locks as locks_mod

log = logging.getLogger(__name__)

FLIGHT_DIR_ENV = "CC_FLIGHT_DIR"

#: Event names the recorder emits (ccmanager/rolling.py + ctl.py). Kept
#: here as the schema's single source so the timeline renderer and the
#: docs table cannot drift from the writers.
EVENT_LEASE_ACQUIRED = "lease-acquired"
EVENT_RESUME = "resume"
EVENT_PLAN = "plan"
EVENT_QUARANTINE_SKIP = "quarantine-skip"
EVENT_GROUP_SKIPPED = "group-skipped"
EVENT_SURGE_PICK = "surge-pick"
EVENT_WINDOW_OPEN = "window-open"
EVENT_WINDOW_CLOSE = "window-close"
EVENT_NODE_DESIRED = "node-desired-patch"
EVENT_NODE_CONVERGED = "node-converged"
EVENT_NODE_FAILED = "node-failed"
EVENT_NODE_RETIRED = "node-retired-deleted"
EVENT_NODE_ADOPTED = "node-adopted"
EVENT_BUDGET_CHARGE = "budget-charge"
EVENT_HALT = "halt"
EVENT_FENCED = "fenced"
EVENT_COMPLETE = "complete"
#: SLO pacing (ccmanager/rolling.py slo_gate): the gate paused the next
#: wave at a boundary / the window recovered and the wave resumed / the
#: burn outlasted the pause budget and the rollout halted like the
#: failure budget does. Every pacing decision is journaled.
EVENT_SLO_PAUSED = "slo-paused"
EVENT_SLO_RESUMED = "slo-resumed"
EVENT_SLO_HALT = "slo-halt"
#: Zero-bounce spares (ccmanager/rolling.py prestage): one event per
#: surge spare whose agent reported a completed pre-staged flip (the
#: annotation record's seconds ride along) BEFORE its flip window
#: opened — the timeline's explanation of a surge window that converged
#: in ~drain+readmit time.
EVENT_SPARE_PRESTAGED = "spare-prestaged"
#: Federated rollouts (ccmanager/federation.py): one event per
#: wave-boundary exchange with the parent record — region, the global
#: spend size folded back, and the parent status at that instant. The
#: stitched cross-region timeline uses these to show WHEN each region
#: learned of a sibling's budget charges or a global halt.
EVENT_FEDERATION_SYNC = "federation-sync"
#: Parent-plane partition tolerance (ccmanager/federation.py escrow):
#: journaled once per outage edge. ``parent-offline`` fires when a
#: shard's boundary syncs have hit transport errors past
#: CC_FEDERATION_OFFLINE_GRACE_S and it enters degraded mode (waves now
#: charge strictly against the local escrow); ``parent-reconnect`` fires
#: when the next sync lands and the dark spend reconciles exactly-once
#: into the parent. The stitched timeline uses the pair to bracket how
#: long each region ran autonomously.
EVENT_PARENT_OFFLINE = "parent-offline"
EVENT_PARENT_RECONNECT = "parent-reconnect"
#: Continuous prestage (ccmanager/rolling.py continuous_prestage, record
#: v7): the capacity-ledger lifecycle of one REGULAR node prestaged
#: ahead of its flip window. ``reserved`` journals the headroom charge
#: (durable before the node is touched), ``armed`` the PRESTAGE request
#: landing, ``held`` the agent's completed hidden flip adopted at the
#: window, ``invalidated`` a stale/never-held entry downgraded to the
#: full flip path, ``released`` the charge settling (outcome rides
#: along: converged/degraded/aborted), and ``paused`` a maintenance
#: pass that skipped its top-up on SLO burn — prestage pauses, the
#: wave never does.
EVENT_PRESTAGE_RESERVED = "prestage-reserved"
EVENT_PRESTAGE_ARMED = "prestage-armed"
EVENT_PRESTAGE_HELD = "prestage-held"
EVENT_PRESTAGE_INVALIDATED = "prestage-invalidated"
EVENT_PRESTAGE_RELEASED = "prestage-released"
EVENT_PRESTAGE_PAUSED = "prestage-paused"
#: Fail-slow containment (obs/failslow.py + ccmanager/rolling.py):
#: ``failslow-verdict`` journals one concluded peer-relative verdict
#: (node, verdict, deviation ride along) at the boundary where the
#: orchestrator recorded it — BEFORE acting, behind the
#: ``failslow-vetted`` crash point, so a successor resumes the same
#: verdict instead of re-deriving it. ``straggler-skipped`` fires when
#: an await gives up on nodes converging beyond the peer-relative
#: straggler wall: charged to the failure budget and skipped, instead
#: of stretching every window to node_timeout_s.
EVENT_FAILSLOW_VERDICT = "failslow-verdict"
EVENT_STRAGGLER_SKIPPED = "straggler-skipped"

#: Node-terminal events: the exactly-once reconstruction keys on these
#: (a node converges/fails/retires once per rollout, crash+resume
#: included — the record's done map and the idempotency skip guarantee
#: it; a duplicate here is a real double-bounce).
NODE_TERMINAL_EVENTS = (
    EVENT_NODE_CONVERGED,
    EVENT_NODE_FAILED,
    EVENT_NODE_RETIRED,
)


def flight_dir() -> str:
    """Where rollout flight files live: ``CC_FLIGHT_DIR``, defaulting to
    a stable per-host temp subdirectory (the orchestrator is a CLI, not
    a pod — a crash+``--resume`` on the same host must find the same
    file)."""
    return os.environ.get(FLIGHT_DIR_ENV) or os.path.join(
        tempfile.gettempdir(), "tpu-cc-flight"
    )


def flight_path_for(selector: str) -> str:
    """Deterministic flight-file path for a pool selector, so a resumed
    rollout appends to the interrupted one's timeline without any flag
    plumbing."""
    return os.path.join(
        flight_dir(), f"rollout-{label_safe(selector, max_len=120)}.jsonl"
    )


class FlightRecorder:
    """Append-only JSONL event sink for one rollout timeline.

    ``generation`` and ``trace_id`` are stamped on every event once set
    (the lease generation at construction/adoption, the trace id when
    the rollout root span opens). Thread-safe: wave threads record
    concurrently. Every append is flushed so a SIGKILL tears at most
    the in-progress final line.
    """

    def __init__(
        self,
        path: str,
        generation: int | None = None,
        trace_id: str | None = None,
    ) -> None:
        self.path = path
        self.generation = generation
        self.trace_id = trace_id
        self._lock = locks_mod.make_lock("obs.flight")
        self._seq = 0  # cclint: guarded-by(_lock)
        self.events_written = 0  # cclint: guarded-by(_lock)
        self._failed = False  # cclint: guarded-by(_lock)
        # /rolloutz serves from memory: the recorder wrote (or loaded at
        # init) every event itself, so a scrape never re-reads and
        # re-parses the whole file — O(limit) per poll however long the
        # rollout ran. read_events() stays the cross-process reader
        # (ctl rollout-timeline).
        self._recent: collections.deque[dict] = collections.deque(  # cclint: guarded-by(_lock)
            maxlen=256
        )
        self._loaded = 0  # cclint: guarded-by(_lock)
        self._torn_at_load = 0  # cclint: guarded-by(_lock)
        try:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            # Continue a predecessor's sequence so one file stays
            # globally ordered across a crash+resume.
            if os.path.exists(path):
                events, torn = read_events(path)
                if events:
                    self._seq = max(e.get("seq", 0) for e in events)
                self._recent.extend(events)
                self._loaded = len(events)
                self._torn_at_load = torn
        except OSError as e:
            log.warning("flight recorder init failed (non-fatal): %s", e)

    def set_trace(self, trace_id: str) -> None:
        self.trace_id = trace_id

    def set_generation(self, generation: int | None) -> None:
        self.generation = generation

    def record(self, event: str, **fields) -> None:
        """Append one event. Best-effort: a full disk degrades the
        recorder (one warning), never the rollout."""
        entry = {
            "event": event,
            "ts": round(time.time(), 3),
            "gen": self.generation,
            "trace_id": self.trace_id,
        }
        entry.update(fields)
        with self._lock:
            self._seq += 1
            entry["seq"] = self._seq
            try:
                line = json.dumps(entry, sort_keys=True, default=str)
                with open(self.path, "a", encoding="utf-8") as f:
                    f.write(line + "\n")
                    f.flush()
                self.events_written += 1
                self._recent.append(json.loads(line))
                self._failed = False
            except (OSError, TypeError, ValueError) as e:
                if not self._failed:
                    log.warning(
                        "flight recorder write failed (non-fatal, "
                        "degrading): %s", e,
                    )
                self._failed = True

    def snapshot(self, limit: int = 64) -> dict:
        """The live payload ``/rolloutz`` serves — from memory, so a
        poller scraping every few seconds costs O(limit), not a re-read
        of the whole (growing) file."""
        with self._lock:
            written = self.events_written
            seq = self._seq
            loaded = self._loaded
            torn = self._torn_at_load
            recent = list(self._recent)
        return {
            "enabled": True,
            "path": self.path,
            "generation": self.generation,
            "trace_id": self.trace_id,
            "events_written": written,
            "last_seq": seq,
            "events_in_file": loaded + written,
            "torn_lines": torn,
            "recent": recent[-max(0, limit):],
        }


def read_events(path: str) -> tuple[list[dict], int]:
    """Every parseable event in ``path`` (file order) plus the count of
    torn/garbled lines skipped. A missing file is an empty timeline, not
    an error — the readers (ctl, /rolloutz) run before, during and after
    rollouts alike."""
    events: list[dict] = []
    torn = 0
    try:
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    obj = json.loads(line)
                except ValueError:
                    torn += 1
                    continue
                if isinstance(obj, dict) and obj.get("event"):
                    events.append(obj)
                else:
                    torn += 1
    except OSError:
        return [], 0
    return events, torn


def _order_key(value) -> tuple:
    """Type-stable sort key for wave/window ids: numeric ids first in
    numeric order, then string ids ("surge", "adopt") alphabetically,
    then absent — int and str never compare directly."""
    if isinstance(value, (int, float)) and not isinstance(value, bool):
        return (0, value, "")
    if value is None:
        return (2, 0, "")
    return (1, 0, str(value))


def reconstruct(events: list[dict]) -> dict:
    """Collapse a (possibly crash-spanning) event stream into the
    exactly-once view an operator asks for: one outcome per node, one
    row per wave/window, the halts and resumes in order.

    The raw stream is kept honest by the writers (a resumed rollout
    skips done groups on the record's say-so, so terminal node events
    genuinely happen once); this function VERIFIES that — any node with
    two terminal events is surfaced in ``duplicates`` instead of being
    silently merged."""
    nodes: dict[str, dict] = {}
    duplicates: list[dict] = []
    windows: dict[tuple, dict] = {}
    halts: list[dict] = []
    slo_pauses = 0
    resumes: list[dict] = []
    generations: list[int] = []
    plan: dict | None = None
    adopted: list[str] = []
    surged: list[str] = []
    prestaged: list[str] = []
    prestage: dict = {
        "reserved": [], "armed": [], "held": [], "invalidated": [],
        "released": {}, "paused": 0,
    }
    for e in events:
        ev = e.get("event")
        gen = e.get("gen")
        if gen is not None and gen not in generations:
            generations.append(gen)
        if ev == EVENT_PLAN and plan is None:
            plan = e
        elif ev == EVENT_RESUME:
            resumes.append(e)
        elif ev in (EVENT_HALT, EVENT_SLO_HALT):
            halts.append(e)
        elif ev == EVENT_SLO_PAUSED:
            slo_pauses += 1
        elif ev == EVENT_SURGE_PICK:
            surged.extend(e.get("nodes") or [])
        elif ev == EVENT_SPARE_PRESTAGED:
            prestaged.append(e.get("node"))
        elif ev == EVENT_PRESTAGE_RESERVED:
            prestage["reserved"].append(e.get("node"))
        elif ev == EVENT_PRESTAGE_ARMED:
            prestage["armed"].append(e.get("node"))
        elif ev == EVENT_PRESTAGE_HELD:
            prestage["held"].append(e.get("node"))
        elif ev == EVENT_PRESTAGE_INVALIDATED:
            prestage["invalidated"].append(e.get("node"))
        elif ev == EVENT_PRESTAGE_RELEASED:
            outcome = e.get("outcome") or "released"
            prestage["released"][outcome] = (
                prestage["released"].get(outcome, 0) + 1
            )
        elif ev == EVENT_PRESTAGE_PAUSED:
            prestage["paused"] += 1
        elif ev == EVENT_NODE_ADOPTED:
            adopted.append(e.get("node"))
        elif ev in (EVENT_WINDOW_OPEN, EVENT_WINDOW_CLOSE):
            key = (e.get("wave"), e.get("window"))
            w = windows.setdefault(
                key, {"wave": e.get("wave"), "window": e.get("window")}
            )
            if ev == EVENT_WINDOW_OPEN:
                w["opened_ts"] = e.get("ts")
                w["groups"] = e.get("groups")
            else:
                w["closed_ts"] = e.get("ts")
                w["seconds"] = e.get("seconds")
                w["failed"] = e.get("failed")
        elif ev in NODE_TERMINAL_EVENTS:
            name = e.get("node")
            entry = {
                "outcome": ev,
                "state": e.get("state"),
                "wave": e.get("wave"),
                "gen": gen,
                "ts": e.get("ts"),
                "skipped": bool(e.get("skipped")),
            }
            prev = nodes.get(name)
            if prev is None:
                nodes[name] = entry
            elif entry["skipped"] or prev["skipped"]:
                # A crash between the terminal event and its checkpoint
                # makes the successor re-verify the group; its skipped
                # terminal MERGES with the real one (prefer the real
                # drive) — that is a re-observation, not a re-bounce.
                if prev["skipped"] and not entry["skipped"]:
                    nodes[name] = entry
            elif prev["outcome"] != EVENT_NODE_CONVERGED:
                # A re-drive of a FAILED (or retired-then-reappeared)
                # node is the DESIGNED resume path — the operator re-ran
                # the rollout on purpose and rolling.py re-drives
                # not-done groups. The later outcome supersedes;
                # `redriven` keeps the history visible.
                entry["redriven"] = True
                nodes[name] = entry
            else:
                # Two REAL drives of a CONVERGED node: the double bounce
                # the exactly-once guarantee forbids. Surface, never
                # merge.
                duplicates.append(e)
    return {
        "plan": {
            "mode": (plan or {}).get("mode"),
            "groups": (plan or {}).get("groups"),
            "nodes": (plan or {}).get("nodes"),
        } if plan else None,
        "generations": generations,
        "resumes": len(resumes),
        # Wave ids mix ints (shards) and strings ("surge"/"adopt"), so
        # the sort key must never compare across types: rank by kind
        # first, then within it.
        "windows": [windows[k] for k in sorted(
            windows, key=lambda k: (_order_key(k[0]), _order_key(k[1]))
        )],
        "nodes": nodes,
        "adopted": sorted(n for n in adopted if n),
        "surged": sorted(set(surged)),
        "prestaged": sorted({n for n in prestaged if n}),
        # Continuous-prestage ledger accounting, crash-spanning: a
        # resumed rollout's adoption re-journals nothing, so reserved −
        # (invalidated + released) should read the live in-transition
        # count and a COMPLETE timeline balances to zero.
        "prestage": prestage if (
            prestage["reserved"] or prestage["paused"]
            or prestage["released"]
        ) else None,
        "halts": halts,
        "slo_pauses": slo_pauses,
        "duplicate_node_events": duplicates,
    }


def _stitch_identity(event: dict) -> str:
    """Content identity of an event, independent of which stream carried
    it (the ``stream`` tag a stitch adds is excluded). Two streams can
    legitimately carry the SAME event — e.g. a gateway scraping a node's
    /rolloutz and a shard file on disk — and a stitch must not double it."""
    return json.dumps(
        {k: v for k, v in event.items() if k != "stream"},
        sort_keys=True, default=str,
    )


def stitch_timelines(
    streams: list[list[dict]], labels: list[str] | None = None
) -> list[dict]:
    """Merge N shard/region flight-recorder streams into ONE federated
    timeline, seq-consistent across the fleet.

    Within a stream events are already totally ordered by ``seq``
    (continued across crash+resume by the recorder). Across streams
    there is no shared sequence, so the stitch orders by what IS shared:
    the lease generation first (a gen-N event globally precedes gen-N+1
    — the fence guarantees no overlap), then the wall-clock ``ts``
    within a generation, with (stream, seq) as the deterministic
    tiebreak. ``gen`` uses the type-stable :func:`_order_key` so a
    pre-lease ``None`` generation sorts after numbered ones it trails
    in no stream.

    Each stitched event carries a ``stream`` tag (the label or index of
    its source) so the federated timeline stays attributable; exact
    duplicates appearing in multiple streams collapse to one event.
    Torn tails were already dropped per stream by :func:`read_events` —
    this function only ever sees parseable events, however ragged the
    shard files' endings.
    """
    tagged: list[tuple[tuple, dict]] = []
    seen: set[str] = set()
    for idx, stream in enumerate(streams):
        label = labels[idx] if labels and idx < len(labels) else str(idx)
        for event in stream:
            identity = _stitch_identity(event)
            if identity in seen:
                continue
            seen.add(identity)
            merged = dict(event)
            merged["stream"] = label
            tagged.append((
                (
                    _order_key(event.get("gen")),
                    event.get("ts") or 0,
                    idx,
                    event.get("seq") or 0,
                ),
                merged,
            ))
    tagged.sort(key=lambda pair: pair[0])
    return [event for _, event in tagged]


def stitch_files(paths: list[str]) -> tuple[list[dict], int]:
    """Stitch N flight files (``ctl rollout-timeline --stitch``): the
    federated timeline plus the total torn-line count across shards."""
    streams: list[list[dict]] = []
    labels: list[str] = []
    torn_total = 0
    for path in paths:
        events, torn = read_events(path)
        streams.append(events)
        labels.append(os.path.basename(path))
        torn_total += torn
    return stitch_timelines(streams, labels=labels), torn_total


def render_timeline(events: list[dict], torn: int = 0) -> str:
    """Human timeline for ``tpu-cc-ctl rollout-timeline``: one line per
    event in file order, then the reconstruction summary."""
    lines: list[str] = []
    for e in events:
        ts = time.strftime("%H:%M:%S", time.localtime(e.get("ts") or 0))
        wave = e.get("wave")
        where = f" wave={wave}" if wave is not None else ""
        window = e.get("window")
        if window is not None:
            where += f" window={window}"
        detail = {
            k: v for k, v in e.items()
            if k not in (
                "event", "ts", "seq", "gen", "trace_id", "wave", "window",
            ) and v is not None
        }
        lines.append(
            f"{ts} gen={e.get('gen')}{where} {e.get('event'):<22} "
            + (json.dumps(detail, sort_keys=True) if detail else "")
        )
    rec = reconstruct(events)
    lines.append("")
    plan = rec["plan"] or {}
    lines.append(
        f"reconstruction: mode={plan.get('mode')} "
        f"groups={plan.get('groups')} nodes={plan.get('nodes')} "
        f"generations={rec['generations']} resumes={rec['resumes']}"
    )
    for w in rec["windows"]:
        lines.append(
            f"  wave {w.get('wave')} window {w.get('window')}: "
            f"groups={w.get('groups')} seconds={w.get('seconds')} "
            f"failed={w.get('failed') or '-'}"
        )
    for name in sorted(rec["nodes"]):
        n = rec["nodes"][name]
        lines.append(
            f"  node {name}: {n['outcome']} (state={n.get('state')}, "
            f"gen={n.get('gen')})"
        )
    for h in rec["halts"]:
        lines.append(f"  HALT: {h.get('reason')} (gen={h.get('gen')})")
    if rec["duplicate_node_events"]:
        lines.append(
            f"  WARNING: {len(rec['duplicate_node_events'])} duplicate "
            "node event(s) — a node was driven twice"
        )
    if torn:
        lines.append(f"  WARNING: {torn} torn/garbled line(s) skipped")
    return "\n".join(lines)
