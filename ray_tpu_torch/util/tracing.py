"""Distributed tracing — trace/span propagation across tasks and actors.

Equivalent of the reference's tracing hooks (ref: python/ray/util/
tracing/tracing_helper.py — OTel context injected into task metadata and
re-activated in the worker). Framework-free implementation: a trace
context (trace_id, span_id) lives in a contextvar, rides every TaskSpec
submitted under it, and is re-activated around remote execution; each
task execution emits a span into the GCS task-event stream, so
`timeline()` and the state API can reconstruct cross-process call trees
without an OTel dependency (plug a real exporter in via `span_export`).

    with tracing.trace("ingest") as span:
        ray_tpu_torch.get(process.remote(x))   # child spans link to `span`

    tree = tracing.get_trace(span.trace_id)
"""
from __future__ import annotations

import contextlib
import contextvars
import os
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

_current: "contextvars.ContextVar[Optional[tuple]]" = contextvars.ContextVar(
    "rtpu_trace_ctx", default=None)

# optional exporter hook: called with each finished span dict
span_export: Optional[Callable[[dict], None]] = None

# span-export failures are never allowed to break user code, but they
# must not vanish either: every swallowed failure counts here (shipped
# to the head's /metrics from workers) and the FIRST one per process
# warns with the cause (satellite: _record used to drop silently)
from . import metrics as _metrics  # noqa: E402

SPANS_DROPPED = _metrics.Counter(
    "ray_tpu_spans_dropped_total",
    "trace spans dropped before reaching the task-event stream",
    tag_keys=("reason",))

# head-side: whole traces dropped by the TraceStore — tail-sampled out
# ("sampled"), evicted under the byte budget ("evicted"), or spans
# arriving for an already-dropped trace ("late")
TRACES_DROPPED = _metrics.Counter(
    "ray_tpu_traces_dropped_total",
    "whole traces dropped by the head trace store",
    tag_keys=("reason",))
_warned_reasons: set = set()


def _note_span_drop(reason: str, err: BaseException) -> None:
    SPANS_DROPPED.inc(tags={"reason": reason})
    if reason not in _warned_reasons:
        _warned_reasons.add(reason)
        import warnings

        warnings.warn(
            f"tracing: span {reason} export failed ({err!r}); further "
            f"failures are counted in ray_tpu_spans_dropped_total "
            f"without warning", RuntimeWarning, stacklevel=3)


def _new_id() -> str:
    return os.urandom(8).hex()


def new_trace_id() -> str:
    """Fresh W3C-width (16-byte) trace id for ingress root spans."""
    return os.urandom(16).hex()


def new_span_id() -> str:
    return _new_id()


# reserved kwarg carrying (trace_id, parent_span_id) across the
# handle -> replica actor hop (popped in replica.handle_request*, the
# MUX_KWARG pattern) — contextvars don't cross process boundaries
TRACE_KWARG = "__rtpu_trace__"


# ---- W3C trace-context wire format -----------------------------------------
# traceparent: 00-<32 hex trace-id>-<16 hex parent-id>-<2 hex flags>
# (https://www.w3.org/TR/trace-context/). Internal ids are 8-byte hex;
# format_traceparent left-pads so an internally-rooted trace still
# round-trips through a W3C-conformant proxy or client.

def parse_traceparent(header: Optional[str]) -> Optional[tuple]:
    """traceparent header -> (trace_id, span_id) context, or None when
    absent/malformed (a bad header must not fail the request)."""
    if not header:
        return None
    parts = header.strip().lower().split("-")
    if len(parts) < 4 or parts[0] == "ff":
        return None
    trace_id, span_id = parts[1], parts[2]
    if len(trace_id) != 32 or len(span_id) != 16:
        return None
    try:
        if int(trace_id, 16) == 0 or int(span_id, 16) == 0:
            return None
    except ValueError:
        return None
    return (trace_id, span_id)


def format_traceparent(ctx: tuple, sampled: bool = True) -> str:
    """(trace_id, span_id) -> a version-00 traceparent header value."""
    trace_id = str(ctx[0]).rjust(32, "0")
    span_id = str(ctx[1]).rjust(16, "0")
    return f"00-{trace_id}-{span_id}-{'01' if sampled else '00'}"


def record_span(name: str, ctx: tuple, start: float,
                end: Optional[float] = None,
                span_id: Optional[str] = None, **attributes) -> str:
    """Emit one finished span explicitly, without touching the
    contextvar — for code that crosses threads (router pool, engine
    scheduler loop) where the trace context travels as data, not
    ambient state. ``ctx`` is the PARENT (trace_id, parent_span_id);
    returns the new span's id so callers can parent further children."""
    sid = span_id or _new_id()
    span = Span(trace_id=ctx[0], span_id=sid, parent_span_id=ctx[1],
                name=name, start=start, end=end if end is not None
                else time.time(), attributes=dict(attributes))
    _record(span)
    return sid


@dataclass
class Span:
    trace_id: str
    span_id: str
    parent_span_id: Optional[str]
    name: str
    start: float = field(default_factory=time.time)
    end: Optional[float] = None
    attributes: Dict[str, Any] = field(default_factory=dict)

    def set_attribute(self, key: str, value: Any) -> None:
        self.attributes[str(key)] = value


class trace:
    """Context manager opening a (root or child) span in this process."""

    def __init__(self, name: str, **attributes):
        self._name = name
        self._attrs = attributes
        self.span: Optional[Span] = None
        self._token = None

    def __enter__(self) -> Span:
        parent = _current.get()
        trace_id = parent[0] if parent else _new_id()
        self.span = Span(trace_id=trace_id, span_id=_new_id(),
                         parent_span_id=parent[1] if parent else None,
                         name=self._name, attributes=dict(self._attrs))
        self._token = _current.set((trace_id, self.span.span_id))
        return self.span

    def __exit__(self, *exc) -> None:
        _current.reset(self._token)
        self.span.end = time.time()
        _record(self.span)


def current_context() -> Optional[tuple]:
    """(trace_id, span_id) to stamp onto outgoing TaskSpecs, or None."""
    return _current.get()


def activate(ctx: Optional[tuple]):
    """Worker-side: re-activate the submitter's context around a task
    (returns the reset token)."""
    return _current.set(tuple(ctx) if ctx else None)


def deactivate(token) -> None:
    _current.reset(token)


@contextlib.contextmanager
def task_span(spec):
    """Worker-side wrapper for one task execution: re-activate the
    submitter's context, open the task's span, and ALWAYS reset the
    thread's context afterwards — worker threads are long-lived, and a
    leaked contextvar would stamp every later (even untraced) task on
    this thread into the wrong trace."""
    if not getattr(spec, "trace_ctx", None):
        yield None
        return
    token = activate(spec.trace_ctx)
    try:
        with trace(spec.description, task_id=spec.task_id.hex()) as span:
            yield span
    finally:
        deactivate(token)


def _record(span: Span) -> None:
    """Spans land in the GCS task-event stream (local or via channel)."""
    event = {
        # the task id (when this span wraps a task) joins span events to
        # the task's RUNNING/FINISHED events in the same stream
        "task_id": span.attributes.get("task_id", ""),
        "name": span.name, "state": "SPAN",
        "trace_id": span.trace_id, "span_id": span.span_id,
        "parent_span_id": span.parent_span_id,
        "time": span.start, "end_time": span.end,
        "attributes": span.attributes,
        # provenance: timeline() groups span slices into per-process
        # lanes and draws cross-process flow arrows from these
        "pid": os.getpid(),
    }
    try:
        from ..core import runtime as runtime_mod

        rt = runtime_mod.maybe_runtime()
    except Exception:
        rt = None
    if rt is not None:
        node = getattr(getattr(rt, "worker", None), "node_id_hex", None)
        event["node_id"] = node or ("head" if hasattr(rt, "gcs") else "")
    if span_export is not None:
        try:
            span_export(event)
        except Exception as e:  # noqa: BLE001 — counted, warned once
            _note_span_drop("exporter", e)
    try:
        if rt is None:
            return
        if hasattr(rt, "gcs"):
            rt.gcs.add_task_event(event)
        else:  # worker/client: ship to the head
            rt.channel.notify("log_event", event)
    except Exception as e:  # noqa: BLE001 — counted, warned once
        _note_span_drop("ship", e)


def get_trace(trace_id: str) -> List[dict]:
    """All recorded spans (and traced task events) of one trace, ordered
    by start time — the call tree via parent_span_id links."""
    from ..core import runtime as runtime_mod

    rt = runtime_mod.get_runtime()
    events = (rt.gcs.task_events() if hasattr(rt, "gcs")
              else rt.channel.call("task_events", {}))
    out = [dict(e) for e in events if e.get("trace_id") == trace_id]
    out.sort(key=lambda e: e.get("time", 0.0))
    return out
