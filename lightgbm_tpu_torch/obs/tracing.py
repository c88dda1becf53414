"""Causal trace context: trace_id / span_id / parent_id propagation.

Counterpart of ``lightgbm_tpu/obs/tracing.py``.

Spans recorded while trace context is enabled
(``trace_context_enabled=true`` / ``LGBM_TPU_TRACE_CTX=1`` /
``obs.configure(trace_context=True)``) carry three extra args —
``trace_id`` (the whole causal chain), ``span_id`` (this span) and
``parent_id`` (the enclosing span) — so one JSONL/Perfetto export shows
a serve request's full ancestry back to the pipeline window that
trained the model answering it.

Within one thread the current context lives in a ``contextvars``
variable and nesting is automatic: every ``obs.span`` opened while
another is active becomes its child.  Across thread boundaries the
context must travel explicitly, because worker threads start with an
empty contextvars context:

* ``capture()`` snapshots the sender's current context (``None`` while
  tracing is off — the disabled path allocates nothing);
* the snapshot rides the queue item / model generation / checkpoint
  manifest to the receiver;
* ``set_current(ctx)`` / ``reset(token)`` activate it around the
  receiver's work (both no-ops on ``None``, so call sites need no flag
  checks of their own).

The port's propagation edges: pipeline prep thread -> train -> swap,
micro-batch ``submit`` -> worker flush (``PredictionServer`` and each
``FleetServer`` replica: a ``serve.request`` / ``serve.fleet.request``
span a request), and checkpoint/resume (the resumed pipeline reuses the
originating ``trace_id`` from the manifest).
"""

from __future__ import annotations

import contextvars
import uuid
from typing import Optional

from .state import STATE

__all__ = ["SpanContext", "enabled", "new_id", "current", "capture",
           "set_current", "reset", "new_root", "link_args"]

#: the active span's context on THIS thread (threads start empty —
#: cross-thread handoff is explicit via capture()/set_current())
_CURRENT: "contextvars.ContextVar[Optional[SpanContext]]" = \
    contextvars.ContextVar("lgbm_tpu_torch_trace_ctx", default=None)


class SpanContext:
    """An immutable (trace_id, span_id) position in a trace tree.

    ``span_id`` may be ``None`` for a root context (a trace id restored
    from a checkpoint manifest, or a fresh pipeline root before any
    span opened): children inherit the trace_id and record no
    parent_id."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: str, span_id: Optional[str] = None):
        self.trace_id = trace_id
        self.span_id = span_id

    def __repr__(self) -> str:   # pragma: no cover - debugging aid
        return f"SpanContext({self.trace_id!r}, {self.span_id!r})"


def new_id() -> str:
    """16-hex-char random id (process-unique is all the exports need)."""
    return uuid.uuid4().hex[:16]


def enabled() -> bool:
    """True when spans record/propagate trace context."""
    return STATE.enabled and STATE.trace_context


def current() -> Optional["SpanContext"]:
    """The active context on this thread (None while tracing is off)."""
    if not (STATE.enabled and STATE.trace_context):
        return None
    return _CURRENT.get()


def capture() -> Optional["SpanContext"]:
    """Snapshot the current context for a cross-thread handoff.

    Returns ``None`` while tracing is disabled — the queue tuples and
    model generations that carry the snapshot pay a single flag check
    and allocate no context objects on the disabled path."""
    if not (STATE.enabled and STATE.trace_context):
        return None
    return _CURRENT.get()


def set_current(ctx: Optional["SpanContext"]):
    """Activate ``ctx`` on this thread; returns a reset token (or
    ``None`` when there is nothing to activate — pass it straight to
    :func:`reset`, which ignores ``None``)."""
    if ctx is None or not (STATE.enabled and STATE.trace_context):
        return None
    return _CURRENT.set(ctx)


def reset(token) -> None:
    """Undo a :func:`set_current` (no-op on a ``None`` token)."""
    if token is not None:
        _CURRENT.reset(token)


def new_root(trace_id: Optional[str] = None) -> Optional["SpanContext"]:
    """A root context for a new causal chain (e.g. one pipeline run).

    ``trace_id`` restores an existing chain — the checkpoint/resume
    edge: the resumed pipeline's windows keep the originating trace_id.
    Returns ``None`` while tracing is disabled."""
    if not (STATE.enabled and STATE.trace_context):
        return None
    return SpanContext(trace_id or new_id(), None)


def link_args(ctx: Optional["SpanContext"], prefix: str = "") -> dict:
    """Span args linking to another trace position (empty when no
    context): ``{<prefix>trace_id, <prefix>span_id}``.  Used for
    cross-chain references that are NOT parent/child edges — e.g. a
    serve span linking to the training window whose model answered
    it."""
    if ctx is None:
        return {}
    out = {f"{prefix}trace_id": ctx.trace_id}
    if ctx.span_id is not None:
        out[f"{prefix}span_id"] = ctx.span_id
    return out
