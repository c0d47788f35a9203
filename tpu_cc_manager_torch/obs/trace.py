"""In-process tracing: spans with trace ids, nesting, and status.

Deliberately tiny — OpenTelemetry is not in this image, and the control
plane needs exactly four things the stdlib gives for free:

- a **trace id** minted once per reconcile (or rollout) and shared by every
  span under it, so a drain handshake in ``drain/`` correlates with the
  reset/attest it triggered in ``ccmanager/manager.py``;
- **parent/child nesting** via a :mod:`contextvars` context variable, so a
  phase span opened in ``utils/metrics.py`` automatically parents the
  barrier/attestation/smoke sub-spans opened layers below it;
- **attributes and status** (ok / error + message) per span;
- a **journal** of finished spans (obs/journal.py) that ``/tracez`` and
  bench.py read.

Context propagation: ``contextvars`` flow through generators and async
code, but NOT into ``threading.Thread`` targets. Code that fans work out
to threads under one trace wraps the target with :func:`in_current_context`
(the rolling orchestrator's wave threads do exactly this, so sharded-wave
spans nest under the rollout root).

Cross-PROCESS propagation: a root span may be opened with an explicit
``parent=(trace_id, span_id)`` — the remote-parent contract the rolling
orchestrator uses to stitch its rollout trace to each node agent's
reconcile trace. The orchestrator stamps
:func:`format_parent`'s ``<trace>.<span>`` value into the desired-mode
patch (labels.ROLLOUT_TRACE_LABEL, dot-separated because label values
cannot carry ``:``), the agent parses it back with :func:`parse_parent`
and opens its reconcile root under it, and ``/tracez?trace_id=`` then
renders ONE causal tree from ``ctl rollout`` down through each node's
drain/reset/smoke.

Compute-path regions: :func:`region` is the span of the model and the
train step, which open a few hundred a step and must cost nothing when no
one looks. While a ``torch.profiler`` records, a region is
``torch.profiler.record_function(name)``: it lands on the profiler's host
timeline, on the clock of the device's kernels, and a backward operator's
device work can be put down to the region open at the forward operator it
differentiates (the profiler links the two by sequence number). Otherwise
it is one shared null context, at the cost of one flag read. A region has
no id, attributes, status or journal entry. Names are ``<layer>.<part>``
(``llama.*`` in ``models/llama.py``, ``train.*`` in ``parallel/train.py``)
and never start with ``bench.``, which a profiling harness may keep for
its own ranges.
"""

from __future__ import annotations

import contextlib
import contextvars
import secrets
import sys
import time
from dataclasses import dataclass, field
from typing import Callable

from tpu_cc_manager_torch.obs import journal as journal_mod

#: Current span for this execution context (None outside any trace).
_CURRENT: contextvars.ContextVar["Span | None"] = contextvars.ContextVar(
    "tpu_cc_current_span", default=None
)

STATUS_IN_PROGRESS = "in_progress"
STATUS_OK = "ok"
STATUS_ERROR = "error"


def new_id() -> str:
    """128-bit trace / 64-bit span ids are overkill for one node agent;
    64 random bits keep the labels and log lines short."""
    return secrets.token_hex(8)


@dataclass
class Span:
    name: str
    trace_id: str
    span_id: str
    parent_id: str | None = None
    start_monotonic: float = 0.0
    end_monotonic: float | None = None
    start_ts: float = 0.0  # wall clock, for cross-process correlation
    attributes: dict = field(default_factory=dict)
    status: str = STATUS_IN_PROGRESS
    error: str | None = None
    # The journal this span reports to; children inherit it from their
    # parent so one reconcile's whole tree lands in one journal.
    journal: "journal_mod.Journal | None" = field(
        default=None, repr=False, compare=False
    )

    @property
    def seconds(self) -> float:
        end = (
            self.end_monotonic
            if self.end_monotonic is not None
            else time.monotonic()
        )
        return max(0.0, end - self.start_monotonic)

    def set_attribute(self, key: str, value) -> None:
        self.attributes[key] = value

    def to_dict(self) -> dict:
        try:
            attributes = dict(self.attributes)
        except RuntimeError:  # live span mutated while /statusz serializes
            attributes = {}
        return {
            "name": self.name,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "start_ts": round(self.start_ts, 3),
            "seconds": round(self.seconds, 6),
            "status": self.status,
            "error": self.error,
            "attributes": attributes,
        }


def current_span() -> Span | None:
    return _CURRENT.get()


def current_trace_id() -> str | None:
    span = _CURRENT.get()
    return span.trace_id if span is not None else None


def current_span_id() -> str | None:
    span = _CURRENT.get()
    return span.span_id if span is not None else None


def format_parent(s: Span) -> str:
    """``<trace_id>.<span_id>``: the label-safe wire form of a span's
    identity (dot, not colon — k8s label values reject ``:``)."""
    return f"{s.trace_id}.{s.span_id}"


def parse_parent(value: str | None) -> tuple[str, str] | None:
    """Parse a :func:`format_parent` value back to (trace_id, span_id);
    None for absent/garbled input — a stitching hint must never fail a
    reconcile."""
    if not value:
        return None
    parts = value.split(".")
    if len(parts) != 2 or not all(parts):
        return None
    return parts[0], parts[1]


@contextlib.contextmanager
def span(
    name: str,
    journal: "journal_mod.Journal | None" = None,
    root: bool = False,
    parent: tuple[str, str] | None = None,
    **attributes,
):
    """Open a span under the current one (or a new root trace).

    - nested under :func:`current_span` unless ``root=True``;
    - ``parent=(trace_id, span_id)`` adopts a REMOTE parent (only
      meaningful with ``root=True``): the span joins that trace instead
      of minting its own — cross-process stitching;
    - ``journal`` defaults to the parent's journal, then the process-wide
      :data:`~tpu_cc_manager_torch.obs.journal.JOURNAL`;
    - an escaping exception marks the span ``error`` (message recorded) and
      propagates.
    """
    ambient = None if root else _CURRENT.get()
    if ambient is not None:
        trace_id = ambient.trace_id
        parent_id = ambient.span_id
        if journal is None:
            journal = ambient.journal
    elif parent is not None:
        trace_id, parent_id = parent
    else:
        trace_id = new_id()
        parent_id = None
    if journal is None:
        journal = journal_mod.JOURNAL
    s = Span(
        name=name,
        trace_id=trace_id,
        span_id=new_id(),
        parent_id=parent_id,
        start_monotonic=time.monotonic(),
        start_ts=time.time(),
        attributes=dict(attributes),
        journal=journal,
    )
    journal.span_started(s)
    token = _CURRENT.set(s)
    try:
        yield s
        if s.status == STATUS_IN_PROGRESS:
            s.status = STATUS_OK
    except BaseException as e:
        s.status = STATUS_ERROR
        s.error = f"{type(e).__name__}: {e}"
        raise
    finally:
        s.end_monotonic = time.monotonic()
        _CURRENT.reset(token)
        journal.span_finished(s)


def root_span(
    name: str,
    journal: "journal_mod.Journal | None" = None,
    parent: tuple[str, str] | None = None,
    **attributes,
):
    """A new root trace, ignoring any ambient span — one reconcile, one
    rollout, one pool verification each get their own trace id. With
    ``parent`` the root joins a REMOTE trace instead (the agent adopting
    the orchestrator's rollout trace)."""
    return span(name, journal=journal, root=True, parent=parent, **attributes)


def in_current_context(fn: Callable, *args, **kwargs) -> Callable[[], object]:
    """Bind ``fn(*args, **kwargs)`` to a snapshot of the caller's context.

    ``threading.Thread`` targets do NOT inherit contextvars; pass the
    returned thunk as the thread target and spans opened inside the thread
    nest under the caller's current span."""
    ctx = contextvars.copy_context()
    return lambda: ctx.run(fn, *args, **kwargs)


_NO_REGION = contextlib.nullcontext()


def region(name: str):
    """``torch.profiler.record_function(name)`` while a profiler records,
    else one shared null context. The flag read is the one the profiler
    sets as it starts recording and clears as it stops; torch is not
    imported here, since no profiler records before something else has
    imported it."""
    profiler = sys.modules.get("torch.autograd.profiler")
    if profiler is None or not profiler._is_profiler_enabled:
        return _NO_REGION
    return profiler.record_function(name)
