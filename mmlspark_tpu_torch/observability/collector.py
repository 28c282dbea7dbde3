"""SpanCollector — bounded in-process span buffer with OTLP-shaped export.

An own copy of the JAX package's ``observability/collector.py``, verbatim
apart from module paths and the HTTP sink, which needs ``io/http.py``'s
client (not ported yet, ROADMAP.md §1 item 12): an ``http(s)://``
endpoint raises ``NotImplementedError`` at construction instead of
dropping spans.  Spans that only land in the ``core/logging.py`` event
ring cannot be traced from aggregate percentiles on ``/metrics`` back to
the request that caused them.  This module closes the loop:

- every finished span lands in a **bounded, drop-counting ring**
  (``record()`` is one deque append under a short lock — it NEVER blocks
  the caller, and overflow drops the oldest span and counts the drop);
- the ring answers ``trace(trace_id)`` / ``trace_tree(trace_id)`` /
  ``slowest(k)`` — the queries behind ``GET /trace/<id>`` and
  ``GET /debug/slow`` on ``PipelineServer``;
- a background **flusher** (off by default; enabled by the
  ``MMLSPARK_TPU_OTLP_ENDPOINT`` env knob or explicit construction)
  batches spans into OTLP/JSON-shaped payloads and writes them to a file
  sink (``file://<path>`` — one JSON payload per line); failed batches
  are dropped and counted, the scoring path is untouched.

Export telemetry (registered by ``instruments.instrument_collector``):
ring drops, export spans/batches by result, flush latency, live queue
depth — the collector watches the pipeline, and the registry watches the
collector.

Timestamps: spans run on injectable (usually monotonic) clocks; OTLP wants
unix nanos.  ``epoch_offset_s`` (default: ``time.time() - time.monotonic()``
captured once at construction) shifts span times into the unix epoch —
best-effort for payload shape, exact only for spans on the monotonic clock.
"""
from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Any, Callable, Deque, Dict, List, Optional

from .metrics import MetricsRegistry, get_registry
from ..utils.concurrency import make_lock

__all__ = ["SpanCollector", "get_collector", "OTLP_ENDPOINT_ENV",
           "OTLP_SAMPLE_ENV", "OTLP_SLOW_S_ENV"]

#: env knob enabling span export (off when unset/empty).  ``http(s)://``
#: values POST OTLP/JSON; ``file://<path>`` appends one payload per line.
OTLP_ENDPOINT_ENV = "MMLSPARK_TPU_OTLP_ENDPOINT"

#: tail-sampling mode: ``slow_error`` keeps only slow (>= the threshold
#: below) or non-ok spans AT EXPORT TIME — the ring (and with it
#: ``/trace/<id>`` + ``/debug/slow``) always sees everything; only the
#: exporter's egress shrinks.  Unset/empty = export every span.
OTLP_SAMPLE_ENV = "MMLSPARK_TPU_OTLP_SAMPLE"

#: duration (seconds, float) at which a span counts as slow for
#: tail-sampling; default 0.25.
OTLP_SLOW_S_ENV = "MMLSPARK_TPU_OTLP_SLOW_S"


def _otlp_value(v: Any) -> Dict[str, Any]:
    """One OTLP AnyValue."""
    if isinstance(v, bool):
        return {"boolValue": v}
    if isinstance(v, int):
        return {"intValue": str(v)}
    if isinstance(v, float):
        return {"doubleValue": v}
    return {"stringValue": str(v)}


class SpanCollector:
    """Bounded span ring + optional OTLP-shaped exporter.

    ``record(span)`` is the only hot-path entry point: append to the ring
    (and, when exporting, the export queue) under one short lock; counters
    are booked after release.  Everything slow — serialization, file I/O,
    HTTP — happens on the flusher thread or in scrape-time queries.
    """

    def __init__(self, capacity: int = 2048, registry: Optional[MetricsRegistry] = None,
                 clock: Callable[[], float] = time.monotonic,
                 endpoint: Optional[str] = None,
                 batch_size: int = 128, flush_interval_s: float = 2.0,
                 breaker=None, http_timeout_s: float = 5.0,
                 transport=None, epoch_offset_s: Optional[float] = None,
                 service_name: str = "mmlspark_tpu_torch",
                 sample_mode: Optional[str] = None,
                 slow_threshold_s: Optional[float] = None):
        self.registry = registry if registry is not None else get_registry()
        self.clock = clock
        self.capacity = max(1, int(capacity))
        self.batch_size = max(1, int(batch_size))
        self.flush_interval_s = float(flush_interval_s)
        self.service_name = service_name
        self.http_timeout_s = float(http_timeout_s)
        self._transport = transport
        if endpoint is None:
            endpoint = os.environ.get(OTLP_ENDPOINT_ENV, "")
        self.endpoint = endpoint or ""
        self.exporting = bool(self.endpoint)
        if sample_mode is None:
            sample_mode = os.environ.get(OTLP_SAMPLE_ENV, "")
        if sample_mode not in ("", "slow_error"):
            raise ValueError(f"unknown {OTLP_SAMPLE_ENV} mode "
                             f"{sample_mode!r}; expected 'slow_error'")
        self.sample_mode = sample_mode
        if slow_threshold_s is None:
            slow_threshold_s = float(
                os.environ.get(OTLP_SLOW_S_ENV, "") or 0.25)
        self.slow_threshold_s = float(slow_threshold_s)
        self._file_sink = self.endpoint[len("file://"):] \
            if self.endpoint.startswith("file://") else None
        if self.exporting and self._file_sink is None:
            # the HTTP sink rides io/http.py's breaker/deadline-aware
            # client, which the port does not have yet: refuse rather
            # than drop the spans
            raise NotImplementedError(
                f"OTLP export to {self.endpoint!r} needs io/http.py's "
                "client, not ported yet (ROADMAP.md §1 item 12); use a "
                "file:// endpoint")
        if epoch_offset_s is None:
            # one wall-clock anchor per collector (module-level-style
            # amortization): exact when spans ride time.monotonic, a
            # best-effort shape otherwise (FakeClock tests pass 0.0)
            epoch_offset_s = time.time() - time.monotonic() \
                if clock is time.monotonic else 0.0
        self.epoch_offset_s = float(epoch_offset_s)
        self._lock = make_lock("SpanCollector._lock")
        self._ring: Deque = collections.deque(maxlen=self.capacity)
        self._export_q: Deque = collections.deque(maxlen=self.capacity)
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._flusher: Optional[threading.Thread] = None
        self.breaker = breaker
        from .instruments import instrument_collector
        self._m = instrument_collector(self, self.registry)
        # self-register as the registry's collector (last construction
        # wins): export_span() resolves `registry._span_collector`, so an
        # explicitly built exporter must take over from (or preempt) the
        # implicit ring-only collector — otherwise it would silently
        # receive nothing while a hidden second collector ate the spans
        self.registry._span_collector = self
        if self.exporting:
            self.start()

    # ------------------------------------------------------------ hot path
    def record(self, span) -> None:
        """Buffer one finished span.  Never blocks: bounded ring, oldest
        dropped on overflow (counted), export queue likewise."""
        ring_dropped = export_dropped = False
        wake = False
        with self._lock:
            if len(self._ring) >= self.capacity:
                ring_dropped = True      # deque maxlen evicts the oldest
            self._ring.append(span)
            if self.exporting:
                if len(self._export_q) >= self.capacity:
                    export_dropped = True
                self._export_q.append(span)
                wake = len(self._export_q) >= self.batch_size
        # telemetry books OUTSIDE the collector lock (LCK discipline)
        if ring_dropped:
            self._m["ring_dropped"].inc()
        if export_dropped:
            self._m["spans_dropped"].inc()
        if wake:
            self._wake.set()

    def queue_depth(self) -> int:
        with self._lock:
            return len(self._export_q)

    # ------------------------------------------------------------- queries
    def trace(self, trace_id: str) -> List:
        """Finished spans of a trace still in the ring, oldest-finish first."""
        with self._lock:
            spans = list(self._ring)
        return [s for s in spans if s.trace_id == trace_id]

    def trace_tree(self, trace_id: str) -> Optional[Dict[str, Any]]:
        """Assembled span tree for ``GET /trace/<id>``: spans nested under
        their parents (orphans — parent already evicted or in another
        process — surface as roots).  None when the trace is unknown."""
        spans = self.trace(trace_id)
        if not spans:
            return None
        nodes = {s.span_id: self._node(s) for s in spans}
        roots: List[Dict[str, Any]] = []
        for s in spans:
            parent = nodes.get(s.parent_id) if s.parent_id else None
            if parent is not None:
                parent["children"].append(nodes[s.span_id])
            else:
                roots.append(nodes[s.span_id])
        return {"traceId": trace_id, "spanCount": len(spans), "roots": roots}

    @staticmethod
    def _node(s) -> Dict[str, Any]:
        return {"name": s.name, "spanId": s.span_id, "parentId": s.parent_id,
                "startS": s.start_s, "durationS": round(s.duration_s, 6),
                "status": s.status, "attributes": dict(s.attributes),
                "children": []}

    def slowest(self, k: int = 10, name: str = "serving.request",
                server: Optional[str] = None) -> List[Dict[str, Any]]:
        """Top-``k`` slowest ring spans named ``name`` (optionally filtered
        to one server's label), slowest first — the ``/debug/slow`` query."""
        with self._lock:
            spans = list(self._ring)
        picked = [s for s in spans if s.name == name and
                  (server is None or s.attributes.get("server") == server)]
        picked.sort(key=lambda s: s.duration_s, reverse=True)
        # attributes spread last (status/queue_s/score_s/verdict/server for
        # serving.request); the span's own status keeps a distinct key
        return [{"traceId": s.trace_id, "durationS": round(s.duration_s, 6),
                 "spanStatus": s.status, **{k_: v for k_, v in
                                            s.attributes.items()}}
                for s in picked[:max(0, int(k))]]

    # -------------------------------------------------------------- export
    def start(self) -> "SpanCollector":
        if self._flusher is None or not self._flusher.is_alive():
            self._stop.clear()
            self._flusher = threading.Thread(target=self._flush_loop,
                                             daemon=True,
                                             name="mmlspark-otlp-flusher")
            self._flusher.start()
        return self

    def stop(self, drain: bool = True) -> None:
        self._stop.set()
        self._wake.set()
        if self._flusher is not None:
            self._flusher.join(timeout=2.0)
            self._flusher = None
        if drain:
            while self.flush_now():
                pass

    def _flush_loop(self) -> None:
        while not self._stop.is_set():
            self._wake.wait(self.flush_interval_s)
            self._wake.clear()
            while self.flush_now() and not self._stop.is_set():
                pass

    def _sample(self, span) -> bool:
        """Tail-sampling verdict at export time: keep non-ok spans and
        spans at/over the slow threshold; everything else is sampled out
        (counted, never sent).  Ring queries are unaffected."""
        if self.sample_mode != "slow_error":
            return True
        return span.status != "ok" or span.duration_s >= self.slow_threshold_s

    def flush_now(self) -> int:
        """Drain up to ``batch_size`` spans and export one payload.
        Returns the number of spans attempted (0 = queue empty).  A failed
        batch is dropped and counted — a dead sink must never make the
        queue (or anything upstream of it) grow without bound.  With
        tail-sampling on, fast-ok spans drain from the queue but are
        dropped (``mmlspark_otlp_sampled_out_total``) before
        serialization, so a healthy system exports ~nothing."""
        with self._lock:
            batch = [self._export_q.popleft()
                     for _ in range(min(self.batch_size, len(self._export_q)))]
        if not batch:
            return 0
        drained = len(batch)
        kept = [s for s in batch if self._sample(s)]
        if len(kept) < drained:
            self._m["sampled_out"].inc(drained - len(kept))
        if not kept:
            return drained          # queue drained; nothing crossed the wire
        batch = kept
        payload = self.to_otlp(batch)
        t0 = self.clock()
        try:
            ok = self._send(payload)
        except Exception:  # noqa: BLE001 — export must never propagate
            ok = False
        self._m["flush_seconds"].observe(max(0.0, self.clock() - t0))
        result = "ok" if ok else "fail"
        self._m[f"batches_{result}"].inc()
        self._m[f"spans_{result}"].inc(len(batch))
        return drained

    def _send(self, payload: Dict[str, Any]) -> bool:
        # only the file sink exists in the port (the constructor refuses
        # an HTTP endpoint)
        line = json.dumps(payload, default=str)
        with open(self._file_sink, "a", encoding="utf-8") as fh:
            fh.write(line + "\n")
        return True

    def to_otlp(self, spans) -> Dict[str, Any]:
        """OTLP/JSON-shaped ExportTraceServiceRequest for a span batch."""
        off = self.epoch_offset_s
        out = []
        for s in spans:
            end_s = s.end_s if s.end_s is not None else s.start_s
            out.append({
                "traceId": s.trace_id,
                "spanId": s.span_id,
                "parentSpanId": s.parent_id or "",
                "name": s.name,
                "kind": 1,  # SPAN_KIND_INTERNAL
                "startTimeUnixNano": str(int((s.start_s + off) * 1e9)),
                "endTimeUnixNano": str(int((end_s + off) * 1e9)),
                "attributes": [{"key": k, "value": _otlp_value(v)}
                               for k, v in s.attributes.items()],
                "status": ({"code": 1} if s.status == "ok" else
                           {"code": 2, "message": s.status}),
            })
        return {"resourceSpans": [{
            "resource": {"attributes": [
                {"key": "service.name",
                 "value": {"stringValue": self.service_name}}]},
            "scopeSpans": [{
                "scope": {"name": "mmlspark_tpu_torch.observability"},
                "spans": out}]}]}


_collector_lock = make_lock("collector._collector_lock")


def get_collector(registry: Optional[MetricsRegistry] = None) -> SpanCollector:
    """The per-registry collector, created on first use (ring always on;
    export only when ``MMLSPARK_TPU_OTLP_ENDPOINT`` is set at creation).
    An explicitly constructed ``SpanCollector(registry=...)`` registers
    itself and is returned here instead."""
    reg = registry if registry is not None else get_registry()
    coll = getattr(reg, "_span_collector", None)
    if coll is None:
        with _collector_lock:
            coll = getattr(reg, "_span_collector", None)
            if coll is None:
                coll = SpanCollector(registry=reg)  # __init__ registers it
    return coll
