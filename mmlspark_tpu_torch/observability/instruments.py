"""Instrumentation adapters — wire existing subsystems into the registry.

Kept separate from ``utils/resilience.py`` so the resilience primitives stay
dependency-free: a ``CircuitBreaker`` only exposes a generic listener hook,
and this module turns it into gauges/counters.
"""
from __future__ import annotations

from typing import Optional

from .metrics import MetricsRegistry, get_registry

__all__ = ["BREAKER_STATE_CODES", "instrument_breaker",
           "uninstrument_breaker", "instrument_collector",
           "instrument_federator", "instrument_slo_engine",
           "instrument_autoscaler"]

#: numeric encoding for the breaker-state gauge (alerting rules compare
#: against these: anything > 0 means degraded)
BREAKER_STATE_CODES = {"closed": 0, "half_open": 1, "open": 2}


def instrument_breaker(breaker, registry: Optional[MetricsRegistry] = None,
                       name: Optional[str] = None):
    """Register a ``CircuitBreaker`` with a registry:

    - ``mmlspark_breaker_state{breaker}`` — callback gauge (0 closed /
      1 half-open / 2 open), sampled at scrape time;
    - ``mmlspark_breaker_failure_rate{breaker}`` — callback gauge over the
      breaker's rolling outcome window;
    - ``mmlspark_breaker_transitions_total{breaker,to}`` — counter fed by
      the breaker's transition listener;
    - the breaker lands in ``registry.breakers`` so ``/stats`` endpoints can
      dump ``as_dict()`` per breaker.

    Returns the breaker (chainable at construction sites).
    """
    reg = registry or get_registry()
    bname = name or breaker.name or f"breaker-{id(breaker):x}"
    reg.breakers[bname] = breaker
    reg.gauge("mmlspark_breaker_state",
              "circuit state: 0 closed, 1 half-open, 2 open",
              labels=("breaker",)).set_function(
        lambda b=breaker: BREAKER_STATE_CODES.get(b.state, -1), breaker=bname)
    reg.gauge("mmlspark_breaker_failure_rate",
              "failures / outcomes inside the rolling window",
              labels=("breaker",)).set_function(
        lambda b=breaker: b.failure_rate(), breaker=bname)
    transitions = reg.counter("mmlspark_breaker_transitions_total",
                              "breaker state transitions", labels=("breaker", "to"))

    def on_transition(_breaker, old: str, new: str) -> None:
        transitions.inc(breaker=bname, to=new)

    breaker.add_listener(on_transition)
    # remembered so uninstrument_breaker can detach it — instrument after
    # uninstrument must not leave two listeners double-counting transitions
    _listeners(reg)[bname] = on_transition
    return breaker


def instrument_collector(collector, registry: Optional[MetricsRegistry] = None
                         ) -> dict:
    """Wire a ``SpanCollector``'s public surface into a registry — the
    collector watches the pipeline; these series watch the collector:

    - ``mmlspark_span_ring_dropped_total`` — ring overflow (oldest span
      evicted before any ``/trace`` query could see it);
    - ``mmlspark_otlp_export_spans_total{result}`` — exported (``ok``),
      in failed batches (``fail``), or dropped on export-queue overflow
      (``dropped``);
    - ``mmlspark_otlp_export_batches_total{result}`` — flush outcomes;
    - ``mmlspark_otlp_flush_seconds`` — per-flush latency (serialize +
      sink write, breaker short-circuits included);
    - ``mmlspark_otlp_export_queue_depth`` — callback gauge, sampled at
      scrape time;
    - ``mmlspark_otlp_sampled_out_total`` — spans dropped by tail-sampling
      at export time (``MMLSPARK_TPU_OTLP_SAMPLE=slow_error``): drained
      from the queue but never serialized or sent.

    Returns the bound children keyed by the names the collector's hot and
    flush paths use (children resolved once, never per call).  The
    collector's breaker (HTTP sinks) additionally goes through
    ``instrument_breaker`` so a dead endpoint shows up as an open circuit
    on ``/metrics`` and ``/stats``.
    """
    reg = registry or get_registry()
    spans = reg.counter("mmlspark_otlp_export_spans_total",
                        "spans by export outcome", labels=("result",))
    batches = reg.counter("mmlspark_otlp_export_batches_total",
                          "export flushes by outcome", labels=("result",))
    children = {
        "ring_dropped": reg.counter(
            "mmlspark_span_ring_dropped_total",
            "spans evicted from the collector ring on overflow").labels(),
        "spans_ok": spans.labels(result="ok"),
        "spans_fail": spans.labels(result="fail"),
        "spans_dropped": spans.labels(result="dropped"),
        "batches_ok": batches.labels(result="ok"),
        "batches_fail": batches.labels(result="fail"),
        "flush_seconds": reg.histogram(
            "mmlspark_otlp_flush_seconds",
            "span export flush latency").labels(),
        "sampled_out": reg.counter(
            "mmlspark_otlp_sampled_out_total",
            "spans dropped by slow_error tail-sampling at export "
            "time").labels(),
    }
    reg.gauge("mmlspark_otlp_export_queue_depth",
              "spans buffered for export").set_function(
        lambda c=collector: c.queue_depth())
    if getattr(collector, "breaker", None) is not None:
        instrument_breaker(collector.breaker, reg)
    return children


def instrument_federator(federator, registry: Optional[MetricsRegistry] = None
                         ) -> dict:
    """Wire a ``MetricsFederator`` into a registry — the fleet plane
    watches the workers; these series watch the fleet plane:

    - ``mmlspark_federation_scrape_total{worker,result}`` — per-worker
      scrape outcomes (``ok``/``error``/``parse_error``/
      ``deadline_exhausted``);
    - ``mmlspark_federation_scrape_seconds`` — full-sweep latency;
    - ``mmlspark_federation_stale_workers{federation}`` — callback gauge:
      live workers whose last successful scrape is older than the
      staleness bound (never-scraped counts); labelled by the federator's
      ``name`` so federators sharing a registry neither clobber each
      other's callback nor remove each other's series on close;
    - ``mmlspark_federation_bucket_mismatch_total{family}`` — histogram
      worker-children skipped on mismatched bucket bounds (the
      never-silently-merge rule made visible).

    Returns the bound children/families keyed as the federator's scrape
    path uses them."""
    reg = registry or get_registry()
    children = {
        "scrapes": reg.counter(
            "mmlspark_federation_scrape_total",
            "federation /metrics scrapes by worker and outcome",
            labels=("worker", "result")),
        "scrape_seconds": reg.histogram(
            "mmlspark_federation_scrape_seconds",
            "full federation sweep latency (fan-out + parse + merge)"
            ).labels(),
        "bucket_mismatch": reg.counter(
            "mmlspark_federation_bucket_mismatch_total",
            "histogram children skipped on mismatched bucket bounds "
            "(never silently merged)", labels=("family",)),
    }
    reg.gauge("mmlspark_federation_stale_workers",
              "live workers without a fresh successful scrape",
              labels=("federation",)).set_function(
        lambda f=federator: f.stale_workers(), federation=federator.name)
    return children


def instrument_slo_engine(engine, registry: Optional[MetricsRegistry] = None
                          ) -> dict:
    """Register the SLO engine's verdict gauges:

    - ``mmlspark_slo_burn_rate{slo,window}`` — windowed bad-fraction over
      the error budget (> 1 on both windows = burning);
    - ``mmlspark_slo_budget_remaining{slo}`` — slow-window budget left,
      clamped to [0, 1]."""
    reg = registry or get_registry()
    return {
        "burn_rate": reg.gauge(
            "mmlspark_slo_burn_rate",
            "error-budget burn rate per window (fast/slow)",
            labels=("slo", "window")),
        "budget_remaining": reg.gauge(
            "mmlspark_slo_budget_remaining",
            "fraction of the error budget left over the slow window",
            labels=("slo",)),
    }


def instrument_autoscaler(advisor, registry: Optional[MetricsRegistry] = None
                          ) -> dict:
    """Register the autoscale advisor's recommendation series:

    - ``mmlspark_autoscale_desired_replicas{class}`` — the signal itself;
    - ``mmlspark_autoscale_recommendations_total{class,direction}`` —
      recomputations by direction (``up``/``down``/``hold``) so flapping
      is visible as a rate."""
    reg = registry or get_registry()
    return {
        "desired": reg.gauge(
            "mmlspark_autoscale_desired_replicas",
            "desired replica count per request class", labels=("class",)),
        "recommendations": reg.counter(
            "mmlspark_autoscale_recommendations_total",
            "autoscale recomputations by class and direction",
            labels=("class", "direction")),
    }


def _listeners(reg: MetricsRegistry) -> dict:
    """Per-registry map of breaker name -> transition listener."""
    table = getattr(reg, "_breaker_listeners", None)
    if table is None:
        table = reg._breaker_listeners = {}
    return table


def breaker_registry_name(breaker) -> str:
    """The name a breaker was registered under by ``instrument_breaker``
    (when no explicit ``name=`` override was given)."""
    return breaker.name or f"breaker-{id(breaker):x}"


def uninstrument_breaker(breaker_or_name,
                         registry: Optional[MetricsRegistry] = None) -> None:
    """Reverse of ``instrument_breaker`` for a breaker that is gone for
    good (e.g. its worker was evicted from the topology): drops the
    ``/stats`` entry and the state/failure-rate gauge series, whose
    callback closures would otherwise pin the breaker and scrape frozen
    values forever.  The ``transitions_total`` counter series stays — it
    is history and holds no object references.  No-op if never registered.
    """
    reg = registry or get_registry()
    name = breaker_or_name if isinstance(breaker_or_name, str) \
        else breaker_registry_name(breaker_or_name)
    breaker = reg.breakers.pop(name, None)
    listener = _listeners(reg).pop(name, None)
    if breaker is not None and listener is not None:
        breaker.remove_listener(listener)
    for fam_name in ("mmlspark_breaker_state",
                     "mmlspark_breaker_failure_rate"):
        fam = reg.family(fam_name)  # never CREATE an empty family here
        if fam is not None:
            fam.remove(breaker=name)


def training_instruments(registry: Optional[MetricsRegistry] = None) -> dict:
    """Register (once per registry) the training-plane families that
    :class:`~mmlspark_tpu_torch.observability.trainwatch.TrainingRun` books —
    the twin of ``flightrecorder_instruments``.  Counters and the
    step-time histogram are bound per ``job`` by each run; the
    progress/ETA/throughput gauges are callback series the run installs at
    construction and removes at close (the eviction hygiene the breaker
    gauges established)."""
    reg = registry or get_registry()
    got = getattr(reg, "_training_families", None)
    if got is not None:
        return got
    fams = {
        "steps": reg.counter(
            "mmlspark_training_steps_total",
            "training steps/iterations completed per job", labels=("job",)),
        "rows": reg.counter(
            "mmlspark_training_rows_total",
            "training rows processed per job (steps x dataset rows for the "
            "gbdt drivers, batch rows for the parallel trainer)",
            labels=("job",)),
        "stalls": reg.counter(
            "mmlspark_training_stalls_total",
            "training stall-watchdog trips (no tick within "
            "max(k x EWMA step time, floor)); each trip also writes a "
            "trigger=train_stall flight dump", labels=("job",)),
        "step_seconds": reg.histogram(
            "mmlspark_training_step_seconds",
            "tick-to-tick training step time (host wall clock)",
            labels=("job",)),
        "progress": reg.gauge(
            "mmlspark_training_progress_ratio",
            "completed fraction of the declared total steps (NaN when the "
            "driver declared no total)", labels=("job",)),
        "eta": reg.gauge(
            "mmlspark_training_eta_seconds",
            "EWMA-projected seconds to completion (+Inf until the EWMA "
            "and a total are known)", labels=("job",)),
        "rate": reg.gauge(
            "mmlspark_training_rows_per_second",
            "EWMA training throughput in rows/second", labels=("job",)),
    }
    reg._training_families = fams
    return fams
