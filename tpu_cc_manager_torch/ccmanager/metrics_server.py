"""Tiny Prometheus text + debug endpoint server (stdlib, daemon thread).

The reference has no metrics endpoint (SURVEY.md §5 — its only outward state
is node labels and a readiness file). Since this build's north-star is a
latency, the phase timings in utils/metrics.py are exported at
``/metrics``; ``/healthz`` returns 200 for liveness probes; and the tracing
subsystem (obs/) is served at two debug endpoints:

- ``/statusz`` — JSON: mode/result of the last reconcile, its per-phase
  seconds and trace id, cumulative result totals, and the in-flight span
  tree (what the agent is doing *right now*, nested);
- ``/tracez`` — JSON: recent finished spans from the journal ring,
  filterable by ``?trace_id=`` (returns that trace's spans plus their
  nested tree) and boundable by ``?limit=``;
- ``/journalz`` — JSON: the live node-local intent journal
  (ccmanager/intent_journal.py): open intents, deferred label patches,
  last replay outcome — what ``tpu-cc-ctl journal <node>`` reads;
- ``/rolloutz`` — JSON: the rollout flight recorder's live snapshot
  (obs/flight.py): generation, trace id, recent decision events, torn-
  line count — the orchestrator's (``ctl rollout --metrics-port``) and
  the serve harness's mid-rollout observability surface.
"""

from __future__ import annotations

import http.server
import json
import logging
import os
import threading
import time
from urllib.parse import parse_qs, urlparse

from tpu_cc_manager_torch.obs import journal as journal_mod
from tpu_cc_manager_torch.utils.metrics import MetricsRegistry
from tpu_cc_manager_torch.version import __version__

log = logging.getLogger(__name__)

# /tracez default and ceiling for ?limit= (the ring itself bounds memory;
# this bounds one response).
TRACEZ_DEFAULT_LIMIT = 256
TRACEZ_MAX_LIMIT = 4096


def _statusz_payload(
    registry: MetricsRegistry, journal: journal_mod.Journal
) -> dict:
    last = registry.last()
    last_reconcile = None
    if last is not None:
        last_reconcile = {
            "mode": last.mode,
            "result": last.result,
            "trace_id": last.trace_id,
            "total_seconds": round(last.total_seconds, 3),
            "phases": {p.name: round(p.seconds, 3) for p in last.phases},
        }
    active = journal.active_spans()
    finished = journal.spans()
    totals = registry.result_totals()
    return {
        # For the fleet gateway (obs/fleet.py): agent_version identifies
        # mixed-version fleets mid-rollout; snapshot_ts is MONOTONIC and
        # stamped per response, so a scrape whose snapshot_ts fails to
        # advance between sweeps is a cached/replayed body from a dead
        # agent — stale, not live.
        "agent_version": __version__,
        "snapshot_ts": round(time.monotonic(), 6),
        "mode": last.mode if last is not None else None,
        "reconciling": bool(
            last is not None and last.result == "pending"
        ),
        "last_reconcile": last_reconcile,
        "in_flight": journal.span_tree(active),
        "result_totals": {
            r: totals.get(r, 0) for r in ("ok", "failed", "noop")
        },
        "failure_totals": registry.failure_totals(),
        "journal_spans": len(finished),
        "journal_traces": len(
            {s["trace_id"] for s in finished}
        ),
    }


def _tracez_payload(journal: journal_mod.Journal, query: dict) -> dict:
    trace_id = (query.get("trace_id") or [None])[0]
    try:
        limit = int((query.get("limit") or [str(TRACEZ_DEFAULT_LIMIT)])[0])
    except ValueError:
        limit = TRACEZ_DEFAULT_LIMIT
    limit = max(1, min(limit, TRACEZ_MAX_LIMIT))
    spans = journal.spans(trace_id=trace_id, limit=limit)
    payload: dict = {
        "trace_id": trace_id,
        "count": len(spans),
        "spans": spans,
    }
    if trace_id is not None:
        # One trace fits in one response; nest it for human consumption.
        payload["tree"] = journal.span_tree(spans)
    else:
        payload["trace_ids"] = journal.trace_ids()[-limit:]
    return payload


def start_metrics_server(
    port: int,
    registry: MetricsRegistry,
    bind: str | None = None,
    journal: journal_mod.Journal | None = None,
    intent_journal=None,
    flight=None,
) -> http.server.ThreadingHTTPServer:
    """Serve /metrics, /healthz, /statusz, /tracez and /rolloutz on
    ``bind``:``port``.

    The endpoint is unauthenticated (Prometheus-style). The default bind
    IS all-interfaces (0.0.0.0) — inside a pod that is the pod IP, which
    kubelet probes and the scraper must reach. Operators running the
    agent on a host network should restrict it via CC_METRICS_BIND
    (e.g. 127.0.0.1) or the ``bind`` argument."""
    if bind is None:
        bind = os.environ.get("CC_METRICS_BIND", "0.0.0.0")
    if journal is None:
        journal = journal_mod.JOURNAL
    jnl = journal

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 - http.server API
            url = urlparse(self.path)
            path = url.path.rstrip("/")
            content_type = "application/json"
            if path in ("", "/metrics"):
                body = registry.render_prometheus().encode()
                content_type = "text/plain; version=0.0.4"
                code = 200
            elif path == "/healthz":
                body = b"ok\n"
                content_type = "text/plain"
                code = 200
            elif path == "/statusz":
                body = (
                    json.dumps(_statusz_payload(registry, jnl), indent=1)
                    + "\n"
                ).encode()
                code = 200
            elif path == "/tracez":
                body = (
                    json.dumps(
                        _tracez_payload(jnl, parse_qs(url.query)), indent=1
                    )
                    + "\n"
                ).encode()
                code = 200
            elif path == "/journalz":
                payload = (
                    intent_journal.snapshot()
                    if intent_journal is not None
                    else {"enabled": False}
                )
                body = (json.dumps(payload, indent=1) + "\n").encode()
                code = 200
            elif path == "/rolloutz":
                payload = (
                    flight.snapshot()
                    if flight is not None
                    else {"enabled": False}
                )
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
            log.debug("metrics http: " + fmt, *fmtargs)

    server = http.server.ThreadingHTTPServer((bind, port), Handler)
    thread = threading.Thread(target=server.serve_forever, name="metrics", daemon=True)
    thread.start()
    # server_address, not the requested port: port=0 binds an ephemeral
    # one and the log is how it's discovered.
    log.info("metrics server listening on %s:%d", bind, server.server_address[1])
    return server
