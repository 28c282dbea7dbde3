"""Observability of the port — the metrics registry, spans, the span
collector, SLOs, cost attribution, the host-stack profiler, the flight
recorder and the compute-plane gauges the serving front reads.

Own copies of the JAX package's jax-free modules, verbatim apart from
module paths: ``metrics``, ``tracing``, ``instruments``, ``collector``
(its HTTP sink raises until ``io/http.py`` is ported, ROADMAP.md §1 item
12), ``slo``, ``attribution`` and ``flightrecorder``.  Twins with a
PyTorch body: ``profiling`` (a ``torch.profiler`` capture hatch) and
``compute`` (``compile_report``, ``torch.cuda`` memory gauges and build
info; its jit and transfer wrappers raise, item 13).  Not ported yet:
``federation`` and ``autoscale`` (the fleet plane, item 9(c)) and
``trainwatch`` (item 13).
"""
from .metrics import (Counter, DEFAULT_LATENCY_BUCKETS, Gauge, Histogram,
                      MetricsRegistry, get_registry, set_registry)
from .tracing import (Span, TRACE_HEADER, TRACEPARENT_HEADER, ambient_phase,
                      current_span, current_trace_id, format_traceparent,
                      new_trace_id, parse_traceparent, thread_phases,
                      trace_span)
from .instruments import (BREAKER_STATE_CODES, instrument_breaker,
                          instrument_collector)
from .collector import OTLP_ENDPOINT_ENV, SpanCollector, get_collector
from .slo import SLO, SLOEngine, parse_slo
from .compute import (InstrumentedJit, compile_report, device_put,
                      ensure_build_info, ensure_device_memory_gauges,
                      instrumented_jit, transfer_nbytes)
from .profiling import (SamplingProfiler, ProfilerBusy, profile_window,
                        profiler_instruments)
from .flightrecorder import (FlightRecorder, flightrecorder_instruments,
                             get_flight_recorder)

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "DEFAULT_LATENCY_BUCKETS", "get_registry", "set_registry",
           "Span", "TRACE_HEADER", "TRACEPARENT_HEADER", "current_span",
           "current_trace_id", "new_trace_id", "trace_span",
           "ambient_phase", "thread_phases",
           "parse_traceparent", "format_traceparent", "BREAKER_STATE_CODES",
           "instrument_breaker", "instrument_collector",
           "OTLP_ENDPOINT_ENV", "SpanCollector", "get_collector",
           "InstrumentedJit", "instrumented_jit", "compile_report",
           "device_put", "transfer_nbytes", "ensure_build_info",
           "ensure_device_memory_gauges",
           "SLO", "SLOEngine", "parse_slo",
           "SamplingProfiler", "ProfilerBusy", "profile_window",
           "profiler_instruments", "FlightRecorder",
           "flightrecorder_instruments", "get_flight_recorder"]
