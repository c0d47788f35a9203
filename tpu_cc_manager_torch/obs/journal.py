"""Span journal: bounded in-process record of finished spans.

The reference has no instrumentation beyond log lines (SURVEY.md §5); the
north-star metric here is a latency budget (per-node drain→CC-on→ready
< 90 s, BASELINE.md), and when a rollout blows it the flat per-phase gauges
cannot say *which slice, which retry, which handshake* ate the time. The
journal is the other half of the tracing subsystem (obs/trace.py): every
finished span lands in a thread-safe ring buffer (bounded — the agent is a
long-lived DaemonSet pod) and, when ``CC_TRACE_FILE`` is set, is appended
as one JSON line to a size-bounded JSONL file, so a post-mortem has the
span stream even after the ring rolled over.

Consumers:

- ``/tracez`` and ``/statusz`` (ccmanager/metrics_server.py) serve the ring
  and the in-flight set over HTTP;
- bench.py reads the journal to report per-phase histograms instead of
  single-run totals;
- operators tail the JSONL file (same shape as the HTTP payloads).
"""

from __future__ import annotations

import collections
import json
import logging
import os
from typing import TYPE_CHECKING, Iterable

from tpu_cc_manager_torch.utils import locks as locks_mod

if TYPE_CHECKING:  # pragma: no cover - import cycle guard (trace imports us)
    from tpu_cc_manager_torch.obs.trace import Span

log = logging.getLogger(__name__)

TRACE_FILE_ENV = "CC_TRACE_FILE"
TRACE_FILE_MAX_BYTES_ENV = "CC_TRACE_FILE_MAX_BYTES"
DEFAULT_CAPACITY = 2048
# One rotation (file -> file.1) keeps disk usage bounded at ~2x this.
DEFAULT_MAX_FILE_BYTES = 8 * 1024 * 1024


class Journal:
    """Thread-safe bounded record of spans, optionally mirrored to JSONL.

    ``trace_file=None`` (the default) reads :data:`TRACE_FILE_ENV` at
    construction; pass ``trace_file=""`` to force the file sink off
    regardless of the environment.
    """

    def __init__(
        self,
        capacity: int = DEFAULT_CAPACITY,
        trace_file: str | None = None,
        max_file_bytes: int | None = None,
    ) -> None:
        self._lock = locks_mod.make_lock("obs.journal")
        self._finished: collections.deque[dict] = collections.deque(  # cclint: guarded-by(_lock)
            maxlen=max(1, capacity)
        )
        # span_id -> live Span, for the /statusz in-flight tree.
        self._active: dict[str, "Span"] = {}  # cclint: guarded-by(_lock)
        if trace_file is None:
            trace_file = os.environ.get(TRACE_FILE_ENV, "")
        self.trace_file = trace_file or None
        if max_file_bytes is None:
            raw = os.environ.get(TRACE_FILE_MAX_BYTES_ENV, "")
            try:
                max_file_bytes = int(raw) if raw else DEFAULT_MAX_FILE_BYTES
            except ValueError:
                # Observability must never take the agent down: a malformed
                # size (e.g. "8M") degrades to the default, loudly.
                log.warning(
                    "invalid %s=%r; using default %d",
                    TRACE_FILE_MAX_BYTES_ENV, raw, DEFAULT_MAX_FILE_BYTES,
                )
                max_file_bytes = DEFAULT_MAX_FILE_BYTES
        self.max_file_bytes = max_file_bytes
        self._file_bytes = 0  # cclint: guarded-by(_lock)
        if self.trace_file and os.path.exists(self.trace_file):
            try:
                self._file_bytes = os.path.getsize(self.trace_file)
            except OSError:
                self._file_bytes = 0

    # ------------------------------------------------------------------
    # Recording (called by obs/trace.py)
    # ------------------------------------------------------------------

    def span_started(self, span: "Span") -> None:
        with self._lock:
            self._active[span.span_id] = span

    def span_finished(self, span: "Span") -> None:
        entry = span.to_dict()
        with self._lock:
            self._active.pop(span.span_id, None)
            self._finished.append(entry)
        if self.trace_file:
            self._write_jsonl(entry)

    def _write_jsonl(self, entry: dict) -> None:
        """Append one JSON line, rotating file -> file.1 at the size cap.

        Best-effort: the journal is observability, and neither a full disk
        nor an unserializable span attribute may fail a reconcile."""
        try:
            line = json.dumps(entry, sort_keys=True, default=str) + "\n"
            data = line.encode()
            with self._lock:
                if (
                    self.max_file_bytes > 0
                    and self._file_bytes + len(data) > self.max_file_bytes
                    and self._file_bytes > 0
                ):
                    os.replace(self.trace_file, self.trace_file + ".1")
                    self._file_bytes = 0
                with open(self.trace_file, "a", encoding="utf-8") as f:
                    f.write(line)
                self._file_bytes += len(data)
        except (OSError, TypeError, ValueError) as e:
            log.debug("trace journal write failed (non-fatal): %s", e)

    # ------------------------------------------------------------------
    # Reading (metrics_server.py, bench.py, tests)
    # ------------------------------------------------------------------

    def spans(
        self, trace_id: str | None = None, limit: int | None = None
    ) -> list[dict]:
        """Finished spans, oldest first, optionally filtered by trace and
        bounded to the newest ``limit``."""
        with self._lock:
            out = list(self._finished)
        if trace_id is not None:
            out = [s for s in out if s["trace_id"] == trace_id]
        if limit is not None and limit >= 0:
            out = out[-limit:]
        return out

    def active_spans(self) -> list[dict]:
        """In-flight (started, unfinished) spans as dicts."""
        with self._lock:
            live = list(self._active.values())
        return [s.to_dict() for s in live]

    def trace_ids(self) -> list[str]:
        """Distinct trace ids in the ring, oldest first."""
        seen: dict[str, None] = {}
        for s in self.spans():
            seen.setdefault(s["trace_id"], None)
        return list(seen)

    def span_tree(self, spans: Iterable[dict]) -> list[dict]:
        """Nest a flat span list into parent→children trees (roots
        returned; orphans whose parent is outside the list become roots
        too, so a partially-rolled-over trace still renders)."""
        nodes = {s["span_id"]: {**s, "children": []} for s in spans}
        roots: list[dict] = []
        for node in nodes.values():
            parent = nodes.get(node.get("parent_id") or "")
            if parent is not None:
                parent["children"].append(node)
            else:
                roots.append(node)
        return roots

    def phase_durations(
        self, names: Iterable[str] | None = None
    ) -> dict[str, list[float]]:
        """name -> [seconds, ...] across every finished span (bench.py's
        per-phase histogram input). ``names`` filters to the given set."""
        wanted = set(names) if names is not None else None
        out: dict[str, list[float]] = {}
        for s in self.spans():
            if wanted is not None and s["name"] not in wanted:
                continue
            out.setdefault(s["name"], []).append(s["seconds"])
        return out

    def clear(self) -> None:
        with self._lock:
            self._finished.clear()
            self._active.clear()


#: Process-wide default journal (the agent's; bench/tests build their own).
JOURNAL = Journal()
