"""Tracing — contextvar-propagated spans riding the serving/training paths.

A ``Span`` is one timed operation; spans opened inside another span's scope
become its children and share its ``trace_id``.  The trace id crosses
process/socket boundaries on the ``X-MMLSpark-Trace-Id`` header:
``io/http.py`` clients and ``serving/distributed.RoutingClient`` inject the
ambient span's id into outgoing requests, and ``PipelineServer`` adopts an
incoming header so the worker-side spans of a request join the caller's
trace.

Finished spans are exported twice:

- to a ``MetricsRegistry`` as ``mmlspark_spans_total{name}`` /
  ``mmlspark_span_seconds{name}`` (so latency percentiles per span name come
  for free), and
- to the ``core/logging.py`` event ring as an ``event: "span"`` record, so
  ``recent_events()`` shows per-request/per-fit wall-time decomposition next
  to the BasicLogging verb events.

Spans compose with ``utils.resilience.deadline_scope``: a span opened under
an ambient deadline records ``deadline_remaining_ms`` at start, and
``trace_span(..., deadline_s=...)`` installs a deadline for its block, so
"where did the budget go" is answerable from the trace alone.
"""
from __future__ import annotations

import contextlib
import itertools
import math
import os
import threading
import time
from contextvars import ContextVar
from typing import Any, Dict, Optional

from ..utils.resilience import current_deadline, deadline_scope
from .metrics import MetricsRegistry, get_registry

__all__ = ["Span", "TRACE_HEADER", "TRACEPARENT_HEADER", "current_span",
           "current_trace_id", "new_trace_id", "trace_span", "export_span",
           "parse_traceparent", "format_traceparent", "ambient_phase",
           "thread_phases"]

#: wire header carrying the trace id across HTTP hops
TRACE_HEADER = "X-MMLSpark-Trace-Id"

#: W3C Trace Context header (lowercase per spec); accepted on ingress (its
#: trace id is adopted for spans/exemplars, winning over the legacy header)
#: and injected on egress next to the legacy header, so an external frontend
#: that speaks only W3C still gets end-to-end traces through the fleet
TRACEPARENT_HEADER = "traceparent"

_HEX = frozenset("0123456789abcdef")


def _is_hex(s: str) -> bool:
    return bool(s) and all(c in _HEX for c in s)


def parse_traceparent(value) -> Optional[tuple]:
    """``(trace_id, parent_span_id)`` from a W3C ``traceparent`` header, or
    None when malformed (per spec, a malformed header is ignored and a new
    trace starts).  Future versions (> 00) are accepted as long as the
    00-compatible prefix parses; version ``ff`` is explicitly invalid."""
    if not value:
        return None
    parts = str(value).strip().lower().split("-")
    if len(parts) < 4:
        return None
    version, trace_id, span_id = parts[0], parts[1], parts[2]
    if len(version) != 2 or not _is_hex(version) or version == "ff":
        return None
    if len(trace_id) != 32 or not _is_hex(trace_id) or trace_id == "0" * 32:
        return None
    if len(span_id) != 16 or not _is_hex(span_id) or span_id == "0" * 16:
        return None
    if version == "00" and len(parts) != 4:
        return None
    return trace_id, span_id


def format_traceparent(trace_id: Optional[str] = None,
                       span_id: Optional[str] = None,
                       sampled: bool = True) -> str:
    """A valid ``traceparent`` for this process's ids.  Native trace ids are
    already 32 lowercase hex (process prefix + counter) and span ids 16 —
    they pass through unchanged; a foreign id adopted from the legacy header
    is deterministically re-encoded to hex so the wire value stays valid."""
    tid = (trace_id or new_trace_id()).lower()
    if len(tid) != 32 or not _is_hex(tid):
        tid = tid.encode("utf-8", "replace").hex()[:32].ljust(32, "0")
    if tid == "0" * 32:
        tid = new_trace_id()
    sid = (span_id or "").lower()
    if len(sid) != 16 or not _is_hex(sid) or sid == "0" * 16:
        sid = _new_span_id()
    return f"00-{tid}-{sid}-{'01' if sampled else '00'}"


# id generation sits on the serving hot path INSIDE the serialized scoring
# section, where uuid4's per-call os.urandom syscall (~40 us on this
# container's kernel) measurably cut sustained RPS.  Trace/span ids need
# uniqueness, not entropy: one random per-process prefix + a counter.
# itertools.count.__next__ is a single C call — atomic under the GIL.
_ID_PREFIX = os.urandom(8).hex()
_ID_COUNTER = itertools.count(int.from_bytes(os.urandom(4), "big"))


def new_trace_id() -> str:
    return f"{_ID_PREFIX}{next(_ID_COUNTER) & 0xFFFFFFFFFFFFFFFF:016x}"


def _new_span_id() -> str:
    return f"{next(_ID_COUNTER) & 0xFFFFFFFFFFFFFFFF:016x}"


class Span:
    """One timed operation.  Construct directly (explicit ``start``/
    ``finish`` on an injectable clock — used by the serving scorer, which
    back-dates a request span to its enqueue time) or via ``trace_span``."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "start_s",
                 "end_s", "attributes", "status", "clock")

    def __init__(self, name: str, trace_id: Optional[str] = None,
                 parent_id: Optional[str] = None,
                 attributes: Optional[Dict[str, Any]] = None,
                 clock=time.monotonic, start_s: Optional[float] = None):
        self.name = name
        self.trace_id = trace_id or new_trace_id()
        self.span_id = _new_span_id()
        self.parent_id = parent_id
        self.attributes: Dict[str, Any] = dict(attributes or {})
        self.status = "ok"
        self.clock = clock
        self.start_s = clock() if start_s is None else float(start_s)
        self.end_s: Optional[float] = None

    def set_attribute(self, key: str, value: Any) -> None:
        self.attributes[key] = value

    def finish(self, end_s: Optional[float] = None) -> "Span":
        if self.end_s is None:
            self.end_s = self.clock() if end_s is None else float(end_s)
        return self

    @property
    def duration_s(self) -> float:
        end = self.end_s if self.end_s is not None else self.clock()
        return max(0.0, end - self.start_s)

    def to_event(self) -> Dict[str, Any]:
        """Ring-buffer record.  Carries a ``className`` key so ring
        consumers that filter on it (the BasicLogging tests) never KeyError
        on span records."""
        return {"event": "span", "className": "Span", "name": self.name,
                "traceId": self.trace_id, "spanId": self.span_id,
                "parentId": self.parent_id, "seconds": round(self.duration_s, 6),
                "status": self.status, **{f"attr.{k}": v for k, v
                                          in self.attributes.items()}}

    def __repr__(self):
        return (f"Span({self.name!r}, trace={self.trace_id[:8]}, "
                f"{self.duration_s:.6f}s)")


_current_span: ContextVar[Optional[Span]] = \
    ContextVar("mmlspark_tpu_span", default=None)

#: thread ident -> innermost ambient span/phase NAME.  Contextvars cannot
#: be read across threads, so the sampling profiler
#: (``observability/profiling.py``) attributes each sampled thread through
#: this side table instead: ``trace_span`` and ``ambient_phase`` both
#: maintain it (two dict writes per scope — GIL-atomic, no lock; each
#: thread only ever writes its own key).
_THREAD_PHASE: Dict[int, str] = {}


def thread_phases() -> Dict[int, str]:
    """Snapshot of {thread ident: innermost ambient span/phase name} — the
    profiler's attribution table.  Threads outside any ``trace_span`` /
    ``ambient_phase`` scope are absent (attributed ``unattributed``)."""
    return dict(_THREAD_PHASE)


def _enter_phase(name: str) -> tuple:
    tid = threading.get_ident()
    prev = _THREAD_PHASE.get(tid)
    _THREAD_PHASE[tid] = name
    return tid, prev


def _exit_phase(token: tuple) -> None:
    tid, prev = token
    if prev is None:
        _THREAD_PHASE.pop(tid, None)
    else:
        _THREAD_PHASE[tid] = prev


@contextlib.contextmanager
def ambient_phase(name: str):
    """Mark this thread's work as ``name`` for profiler attribution WITHOUT
    opening a Span — the hot-loop variant (e.g. the continuous decode
    engine's step loop, where a span per token would flood the export
    ring).  Nests: inner scopes shadow outer ones, restored on exit."""
    token = _enter_phase(name)
    try:
        yield
    finally:
        _exit_phase(token)


def current_span() -> Optional[Span]:
    """The innermost active span in this context, or None."""
    return _current_span.get()


def current_trace_id() -> Optional[str]:
    span = _current_span.get()
    return span.trace_id if span is not None else None


def export_span(span: Span, registry: Optional[MetricsRegistry] = None) -> None:
    """Record a finished span into the registry (histogram observation
    carries the span's trace id as an exemplar), the per-registry
    ``SpanCollector`` ring (behind ``/trace/<id>`` + ``/debug/slow`` and
    the OTLP exporter), and the logging event ring."""
    span.finish()
    reg = registry or get_registry()
    # per-registry child cache keyed by span name (low-cardinality: stage
    # class names + a handful of subsystem spans) — exports ride every
    # served request, so label resolution must not repeat per call
    cache = getattr(reg, "_span_children", None)
    if cache is None:
        cache = reg._span_children = {}
    pair = cache.get(span.name)
    if pair is None:
        pair = cache[span.name] = (
            reg.counter("mmlspark_spans_total", "finished spans by name",
                        labels=("name",)).labels(name=span.name),
            reg.histogram("mmlspark_span_seconds", "span durations by name",
                          labels=("name",)).labels(name=span.name))
    pair[0].inc()
    pair[1].observe(span.duration_s, span.trace_id)
    # bounded ring for /trace + /debug/slow + OTLP export; record() is one
    # deque append and never blocks this (often request-serialized) caller
    collector = getattr(reg, "_span_collector", None)
    if collector is None:
        from .collector import get_collector  # lazy: collector imports us
        collector = get_collector(reg)
    collector.record(span)
    from ..core.logging import log_event  # lazy: logging lazily imports us
    log_event(span.to_event())


@contextlib.contextmanager
def trace_span(name: str, trace_id: Optional[str] = None,
               attributes: Optional[Dict[str, Any]] = None,
               registry: Optional[MetricsRegistry] = None,
               clock=time.monotonic, deadline_s: Optional[float] = None):
    """Open a span for the block; child of the ambient span (same trace)
    unless an explicit ``trace_id`` adopts one from the wire.  Exceptions
    mark the span ``error:<Type>`` and propagate.  ``deadline_s`` installs a
    ``deadline_scope`` for the block so trace and budget travel together."""
    parent = _current_span.get()
    span = Span(name,
                trace_id=trace_id or (parent.trace_id if parent else None),
                parent_id=parent.span_id if parent else None,
                attributes=attributes, clock=clock)
    ambient = current_deadline()
    if ambient is not None:
        remaining = ambient.remaining()
        if math.isfinite(remaining):  # inf = "no effective bound": omit
            span.set_attribute("deadline_remaining_ms",
                               int(remaining * 1000))
    token = _current_span.set(span)
    phase_token = _enter_phase(name)  # profiler attribution (side table)
    try:
        if deadline_s is not None:
            with deadline_scope(deadline_s, clock):
                yield span
        else:
            yield span
    except BaseException as e:
        span.status = f"error:{type(e).__name__}"
        raise
    finally:
        _exit_phase(phase_token)
        _current_span.reset(token)
        export_span(span, registry)
