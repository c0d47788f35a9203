"""Logging setup.

Reference analogue: main.py:53-58 (stdout logging with asctime/name/level).
Improvement: optional JSON log lines (one object per line) so GKE's logging
agent ingests structured fields without a parser config. Every line emitted
inside a trace (obs/trace.py) carries ``trace_id``/``span_id``, so log
search correlates a drain handshake with the reset/attest it triggered.
"""

from __future__ import annotations

import json
import logging
import sys
import time

from tpu_cc_manager_torch.obs import trace as obs_trace


class JsonFormatter(logging.Formatter):
    """Render each record as a single JSON object on one line."""

    def format(self, record: logging.LogRecord) -> str:
        out = {
            "ts": round(time.time(), 3),
            "severity": record.levelname,
            "logger": record.name,
            "message": record.getMessage(),
        }
        # format() runs on the emitting thread, so the contextvar still
        # names the span the log call happened under.
        span = obs_trace.current_span()
        if span is not None:
            out["trace_id"] = span.trace_id
            out["span_id"] = span.span_id
        if record.exc_info:
            out["exc"] = self.formatException(record.exc_info)
        extra = getattr(record, "fields", None)
        if isinstance(extra, dict):
            out.update(extra)
        return json.dumps(out)


def setup_logging(debug: bool = False, json_lines: bool = False) -> None:
    """Configure root logging to stdout; idempotent."""
    root = logging.getLogger()
    root.setLevel(logging.DEBUG if debug else logging.INFO)
    for h in list(root.handlers):
        root.removeHandler(h)
    handler = logging.StreamHandler(sys.stdout)
    if json_lines:
        handler.setFormatter(JsonFormatter())
    else:
        handler.setFormatter(
            logging.Formatter("%(asctime)s - %(name)s - %(levelname)s - %(message)s")
        )
    root.addHandler(handler)
