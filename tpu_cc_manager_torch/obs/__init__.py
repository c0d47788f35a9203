"""Observability of the port's agent: reconcile tracing (spans + journal).

Copies of ``tpu_cc_manager/obs/trace.py`` and ``obs/journal.py``.
``obs.trace`` mints trace/span ids and nests spans through a contextvar
(with cross-process parents for orchestrator→agent stitching);
``obs.journal`` records finished spans to a bounded ring and an optional
JSONL file (``CC_TRACE_FILE``). The metrics endpoint layer
(ccmanager/metrics_server.py) serves traces at ``/tracez`` and
``/statusz``. The JAX package's ``obs.flight`` and ``obs.slo`` serve the
fleet rollout, which the port does not have yet.
"""

from tpu_cc_manager_torch.obs.journal import JOURNAL, Journal
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
    "Journal",
    "Span",
    "current_span",
    "current_span_id",
    "current_trace_id",
    "in_current_context",
    "root_span",
    "span",
]
