"""Observability: reconcile tracing (spans + journal), the rollout
flight recorder, and serving-SLO evaluation.

``obs.trace`` mints trace/span ids and nests spans through a contextvar
(with cross-process parents for orchestrator→agent stitching);
``obs.journal`` records finished spans to a bounded ring and an optional
JSONL file (``CC_TRACE_FILE``); ``obs.flight`` journals every rolling-
orchestrator decision to an append-only JSONL timeline (``tpu-cc-ctl
rollout-timeline`` / ``/rolloutz``); ``obs.slo`` computes rolling-window
p99 and error-budget burn for the serving layer. The metrics endpoint
layer (ccmanager/metrics_server.py) serves traces at ``/tracez`` and
``/statusz`` and the flight recorder at ``/rolloutz``.
"""

from tpu_cc_manager_torch.obs.flight import FlightRecorder
from tpu_cc_manager_torch.obs.journal import JOURNAL, Journal
from tpu_cc_manager_torch.obs.slo import SloEvaluator
from tpu_cc_manager_torch.obs.trace import (
    Span,
    current_span,
    current_span_id,
    current_trace_id,
    in_current_context,
    root_span,
    span,
)

__all__ = [
    "JOURNAL",
    "FlightRecorder",
    "Journal",
    "SloEvaluator",
    "Span",
    "current_span",
    "current_span_id",
    "current_trace_id",
    "in_current_context",
    "root_span",
    "span",
]
