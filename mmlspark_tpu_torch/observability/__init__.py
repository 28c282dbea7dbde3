"""Observability of the port — the metrics registry, spans, the span
collector, SLOs, cost attribution, the host-stack profiler, the flight
recorder and the compute-plane gauges the serving front reads.

Own copies of the JAX package's jax-free modules, verbatim apart from
module paths: ``metrics``, ``tracing``, ``instruments``, ``collector``
(a file sink, or an OTLP POST through ``io/http.py``'s client), ``slo``,
``attribution``, ``flightrecorder``, the fleet plane (``federation``,
``autoscale``) and the training monitor (``trainwatch``).  Twins with a
PyTorch body: ``profiling`` (a ``torch.profiler`` capture hatch) and
``compute`` (``InstrumentedJit``'s signature booking, a captured CUDA
graph per signature on the card, ``compile_report``, ``torch.cuda`` memory
gauges, build info and host -> device transfer booking).
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
from .federation import FleetView, MetricsFederator, parse_prometheus
from .slo import SLO, SLOEngine, parse_slo
from .autoscale import AutoscaleAdvisor
from .compute import (InstrumentedJit, compile_report, device_put,
                      ensure_build_info, ensure_device_memory_gauges,
                      instrumented_jit, transfer_nbytes)
from .profiling import (SamplingProfiler, ProfilerBusy, profile_window,
                        profiler_instruments)
from .flightrecorder import (FlightRecorder, flightrecorder_instruments,
                             get_flight_recorder)
from .trainwatch import (MonitorServer, TrainingRun, active_monitors,
                         active_runs, start_training_monitor,
                         training_instruments)

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
           "FleetView", "MetricsFederator", "parse_prometheus",
           "SLO", "SLOEngine", "parse_slo", "AutoscaleAdvisor",
           "SamplingProfiler", "ProfilerBusy", "profile_window",
           "profiler_instruments", "FlightRecorder",
           "flightrecorder_instruments", "get_flight_recorder",
           "TrainingRun", "MonitorServer", "start_training_monitor",
           "training_instruments", "active_runs", "active_monitors"]
