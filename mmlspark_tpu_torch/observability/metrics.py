"""MetricsRegistry — counters, gauges, histograms with Prometheus exposition.

The repo grew three disjoint telemetry fragments (the ``core/logging.py``
event ring, ``utils/stopwatch.py``, and the hand-rolled ``ServingStats``
counters); this module is the single sink they now feed.  Reference framing:
MMLSpark treats per-stage structured telemetry as a pipeline contract
(``logging/BasicLogging.scala``), and its serving docs tune against latency
percentiles — both need one coherent registry, not ad-hoc counters.

Design points:

- **Families + labels.**  ``registry.counter(name, help, labels=(...))``
  returns a family; ``family.labels(k=v)`` (or the inc/set/observe
  conveniences taking ``**labels``) resolves a child per label-value tuple,
  exactly the Prometheus client model.
- **Histograms** use fixed log-spaced latency buckets by default
  (100 µs … 100 s, 4 per decade) so percentile error is bounded by the
  bucket ratio (~1.78x) at any traffic volume, and expose
  p50/p95/p99 summaries computed by linear interpolation within the
  winning bucket (the ``histogram_quantile`` estimator).
- **Injectable clock** everywhere a timestamp or duration is taken, so the
  deterministic suites drive time with ``utils.resilience.FakeClock``.
- **Callback gauges** (``set_function``) read live values at scrape time —
  queue depths and breaker states are sampled, never pushed.
- **Exemplars.**  ``observe(value, trace_id=...)`` retains a tiny
  per-bucket reservoir of ``(value, trace_id, ts)`` samples — last write
  per bucket plus one slot biased to the maximum observation — so a
  histogram outlier links straight to the trace that caused it
  (OpenMetrics exemplar syntax on the text exposition, ``exemplars`` on
  the JSON one).  Cost when no trace id is supplied: one ``is None``
  check.
- Thread-safe: one lock per family; children are plain slots updated under
  it.  The hot path (child inc/observe) is a dict hit + float add.
"""
from __future__ import annotations

import bisect
import math
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "DEFAULT_LATENCY_BUCKETS", "get_registry", "set_registry"]


def _log_spaced_buckets(lo: float = 1e-4, hi: float = 100.0,
                        per_decade: int = 4) -> Tuple[float, ...]:
    """Fixed log-spaced bucket upper bounds, ``lo`` … ``hi`` inclusive."""
    n = int(round(math.log10(hi / lo) * per_decade))
    return tuple(lo * 10.0 ** (i / per_decade) for i in range(n + 1))


#: 100 µs .. 100 s, 4 buckets per decade — covers sub-ms serving replies
#: through multi-minute fits with a bounded ~1.78x quantile error.
DEFAULT_LATENCY_BUCKETS = _log_spaced_buckets()


def _escape_label(value: str) -> str:
    return str(value).replace("\\", "\\\\").replace('"', '\\"') \
        .replace("\n", "\\n")


def _fmt_labels(names: Sequence[str], values: Sequence[str],
                extra: Optional[List[Tuple[str, str]]] = None) -> str:
    pairs = [(n, v) for n, v in zip(names, values)] + list(extra or [])
    if not pairs:
        return ""
    return "{" + ",".join(f'{n}="{_escape_label(v)}"' for n, v in pairs) + "}"


def _fmt_value(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    f = float(v)
    return repr(int(f)) if f.is_integer() and abs(f) < 1e15 else repr(f)


class _Family:
    """Shared machinery: named metric + labelled children."""

    kind = "untyped"

    def __init__(self, name: str, help: str, labels: Sequence[str] = ()):
        if not name.replace("_", "").replace(":", "").isalnum():
            raise ValueError(f"invalid metric name {name!r}")
        self.name = name
        self.help = help
        self.label_names = tuple(labels)
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], object] = {}

    def _child_key(self, labels: Dict[str, str]) -> Tuple[str, ...]:
        # hot path (every inc/observe with labels): no set() allocations
        names = self.label_names
        if len(labels) != len(names):
            raise ValueError(
                f"{self.name}: expected labels {names}, got {tuple(labels)}")
        try:
            return tuple(str(labels[n]) for n in names)
        except KeyError:
            raise ValueError(
                f"{self.name}: expected labels {names}, got {tuple(labels)}")

    def labels(self, **labels):
        key = self._child_key(labels)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = self._new_child()
            return child

    def _new_child(self):
        raise NotImplementedError

    def detached_child(self):
        """A child of this family's shape that is NOT registered under any
        label set — a sink for components that must accept writes before
        their identity (e.g. a server's port) is resolved, without leaking
        ghost zero-valued series into every scrape."""
        return self._new_child()

    def remove(self, **labels) -> None:
        """Drop a labelled child from the family (no-op if absent).  Needed
        for callback gauges whose closures pin otherwise-dead objects — a
        stopped server must unhook its samplers or the registry keeps both
        the stale series and the server alive forever."""
        key = self._child_key(labels)
        with self._lock:
            self._children.pop(key, None)

    def _snapshot(self) -> List[Tuple[Tuple[str, ...], object]]:
        with self._lock:
            return sorted(self._children.items())


class _CounterChild:
    __slots__ = ("_value", "_lock")

    def __init__(self):
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Counter(_Family):
    """Monotonic counter family (Prometheus ``counter``)."""

    kind = "counter"

    def _new_child(self):
        return _CounterChild()

    def inc(self, amount: float = 1.0, **labels) -> None:
        self.labels(**labels).inc(amount)

    def value(self, **labels) -> float:
        return self.labels(**labels).value


class _GaugeChild:
    __slots__ = ("_value", "_fn", "_lock")

    def __init__(self):
        self._value = 0.0
        self._fn: Optional[Callable[[], float]] = None
        self._lock = threading.Lock()

    def set(self, value: float) -> None:
        with self._lock:
            self._fn = None
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def set_function(self, fn: Callable[[], float]) -> None:
        with self._lock:
            self._fn = fn

    @property
    def value(self) -> float:
        with self._lock:
            fn = self._fn
            if fn is None:
                return self._value
        try:  # outside the lock: a callback may itself take locks
            return float(fn())
        except Exception:  # noqa: BLE001 — a dead callback scrapes as NaN
            return float("nan")


class Gauge(_Family):
    """Gauge family; ``set_function`` children are sampled at scrape time."""

    kind = "gauge"

    def _new_child(self):
        return _GaugeChild()

    def set(self, value: float, **labels) -> None:
        self.labels(**labels).set(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        self.labels(**labels).inc(amount)

    def set_function(self, fn: Callable[[], float], **labels) -> None:
        self.labels(**labels).set_function(fn)

    def value(self, **labels) -> float:
        return self.labels(**labels).value


class _HistogramChild:
    __slots__ = ("_uppers", "_counts", "_overflow", "_sum", "_count", "_lock",
                 "_clock", "_exemplars", "_max_exemplar")

    def __init__(self, uppers: Tuple[float, ...],
                 clock: Callable[[], float] = time.monotonic):
        self._uppers = uppers
        self._counts = [0] * len(uppers)       # per-bucket, not cumulative
        self._overflow = 0                      # > last finite bound (+Inf)
        self._sum = 0.0
        self._count = 0
        self._lock = threading.Lock()
        self._clock = clock
        # exemplar reservoir: lazily allocated on the first traced
        # observation — one (value, trace_id, ts) slot per bucket (index
        # len(uppers) is the +Inf overflow bucket, last write wins) plus a
        # biased-to-max slot so THE outlier survives any write pattern
        self._exemplars: Optional[List[Optional[Tuple[float, str, float]]]] = None
        self._max_exemplar: Optional[Tuple[float, str, float]] = None

    def observe(self, value: float, trace_id: Optional[str] = None) -> None:
        v = float(value)
        i = bisect.bisect_left(self._uppers, v)
        # clock read + tuple build stay OUTSIDE the lock (LCK discipline)
        ex = None if trace_id is None else (v, str(trace_id), self._clock())
        with self._lock:
            self._sum += v
            self._count += 1
            if i < len(self._uppers):
                self._counts[i] += 1
            else:
                self._overflow += 1
            if ex is not None:
                slots = self._exemplars
                if slots is None:
                    slots = self._exemplars = [None] * (len(self._uppers) + 1)
                slots[min(i, len(self._uppers))] = ex
                if self._max_exemplar is None or v >= self._max_exemplar[0]:
                    self._max_exemplar = ex

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    def cumulative(self) -> List[Tuple[float, int]]:
        """[(upper_bound, cumulative_count)], ending with (+Inf, count)."""
        with self._lock:
            out, cum = [], 0
            for ub, c in zip(self._uppers, self._counts):
                cum += c
                out.append((ub, cum))
            out.append((math.inf, cum + self._overflow))
            return out

    def exemplars(self) -> Optional[Dict[float, Tuple[float, str, float]]]:
        """{bucket_upper_bound: (value, trace_id, ts)} for buckets holding
        an exemplar; key ``math.inf`` is the +Inf bucket, which prefers the
        biased-to-max slot (THE outlier) over its own last write.  None
        when no traced observation was ever recorded."""
        with self._lock:
            slots = self._exemplars
            if slots is None:
                return None
            slots = list(slots)
            max_ex = self._max_exemplar
        out: Dict[float, Tuple[float, str, float]] = {}
        for ub, ex in zip(self._uppers, slots):
            if ex is not None:
                out[ub] = ex
        inf_ex = max_ex or slots[-1]
        if inf_ex is not None:
            out[math.inf] = inf_ex
        return out

    def percentile(self, q: float) -> float:
        """histogram_quantile estimator: linear interpolation inside the
        bucket containing the q-th rank (lower edge of the first bucket is
        0; observations past the last finite bound clamp to it)."""
        with self._lock:
            total = self._count
            counts = list(self._counts)
        if total == 0:
            return float("nan")
        rank = (q / 100.0) * total
        cum, lower = 0.0, 0.0
        for ub, c in zip(self._uppers, counts):
            if c and cum + c >= rank:
                frac = (rank - cum) / c
                return lower + (ub - lower) * frac
            cum += c
            lower = ub
        return self._uppers[-1]


class Histogram(_Family):
    """Histogram family over fixed bucket bounds (default: log-spaced
    latency buckets) with p50/p95/p99 summaries."""

    kind = "histogram"

    def __init__(self, name: str, help: str, labels: Sequence[str] = (),
                 buckets: Optional[Sequence[float]] = None,
                 clock: Callable[[], float] = time.monotonic):
        super().__init__(name, help, labels)
        bs = tuple(sorted(buckets)) if buckets else DEFAULT_LATENCY_BUCKETS
        if not bs:
            raise ValueError("histogram needs at least one bucket")
        self.buckets = bs
        self.clock = clock  # stamps exemplar timestamps

    def _new_child(self):
        return _HistogramChild(self.buckets, self.clock)

    def observe(self, value: float, trace_id: Optional[str] = None,
                **labels) -> None:
        """Record one observation; ``trace_id`` (reserved — cannot be a
        label name) attaches an exemplar linking the sample to a trace."""
        self.labels(**labels).observe(value, trace_id)

    def percentile(self, q: float, **labels) -> float:
        return self.labels(**labels).percentile(q)

    def sum(self, **labels) -> float:
        return self.labels(**labels).sum

    def count(self, **labels) -> int:
        return self.labels(**labels).count


class MetricsRegistry:
    """Named metric families + exposition.

    ``clock`` is only used by helpers that take durations on behalf of the
    caller (``timer``); metric values themselves are caller-supplied, so a
    test can drive everything from a ``FakeClock``.
    """

    def __init__(self, clock: Callable[[], float] = time.monotonic):
        self.clock = clock
        self._lock = threading.Lock()
        self._families: Dict[str, _Family] = {}
        # breakers registered for /stats exposure (observability.instruments)
        self.breakers: Dict[str, object] = {}

    # ------------------------------------------------------------- families
    def family(self, name: str) -> Optional[_Family]:
        """An already-registered family by name, or None — lookups that
        must not create (and thereafter scrape) an empty family."""
        with self._lock:
            return self._families.get(name)

    def _get_or_make(self, cls, name, help, labels, **kw) -> _Family:
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = self._families[name] = cls(name, help, labels, **kw)
                return fam
        if not isinstance(fam, cls) or fam.label_names != tuple(labels):
            raise ValueError(
                f"metric {name!r} re-registered with a different "
                f"type/labels ({fam.kind}{fam.label_names})")
        buckets = kw.get("buckets")
        if buckets and tuple(sorted(buckets)) != fam.buckets:
            # silent acceptance would hand the caller bounds sized for a
            # different value range — every observation lands in overflow
            raise ValueError(
                f"histogram {name!r} re-registered with different buckets")
        return fam

    def counter(self, name: str, help: str = "", labels: Sequence[str] = ()
                ) -> Counter:
        return self._get_or_make(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "", labels: Sequence[str] = ()
              ) -> Gauge:
        return self._get_or_make(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "", labels: Sequence[str] = (),
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        return self._get_or_make(Histogram, name, help, labels,
                                 buckets=buckets, clock=self.clock)

    def timer(self, hist: Histogram, **labels):
        """Context manager observing the block's duration on ``clock``."""
        registry = self

        class _Timer:
            def __enter__(self):
                self.t0 = registry.clock()
                return self

            def __exit__(self, *exc):
                hist.observe(registry.clock() - self.t0, **labels)
                return False

        return _Timer()

    # ----------------------------------------------------------- exposition
    def families(self) -> List[_Family]:
        with self._lock:
            return [self._families[k] for k in sorted(self._families)]

    def to_prometheus(self, openmetrics: bool = False) -> str:
        """Prometheus text exposition format 0.0.4; ``openmetrics=True``
        renders the OpenMetrics dialect instead: histogram bucket lines
        carry exemplar suffixes, and counter metadata drops the ``_total``
        suffix from the family name (the spec puts ``_total`` on the
        sample, not the family — a conformant parser rejects both a
        suffixed family and an exemplar in 0.0.4, so the two dialects must
        never mix).

        Callers gate on the scraper's Accept header (``PipelineServer``
        /metrics does) and, for full OpenMetrics compliance, append the
        ``# EOF`` terminator themselves.
        """
        lines: List[str] = []
        for fam in self.families():
            meta_name = fam.name
            if openmetrics and fam.kind == "counter" and \
                    meta_name.endswith("_total"):
                meta_name = meta_name[:-len("_total")]
            if fam.help:
                lines.append(f"# HELP {meta_name} {fam.help}")
            lines.append(f"# TYPE {meta_name} {fam.kind}")
            for key, child in fam._snapshot():
                if isinstance(fam, Histogram):
                    ex_by_ub = (child.exemplars() or {}) if openmetrics \
                        else {}
                    for ub, cum in child.cumulative():
                        lbl = _fmt_labels(fam.label_names, key,
                                          [("le", _fmt_value(ub))])
                        line = f"{fam.name}_bucket{lbl} {cum}"
                        ex = ex_by_ub.get(ub)
                        if ex is not None:
                            # OpenMetrics exemplar syntax (timestamp
                            # omitted: registry clocks are monotonic)
                            line += (' # {trace_id="'
                                     f'{_escape_label(ex[1])}"}} '
                                     f"{_fmt_value(ex[0])}")
                        lines.append(line)
                    base = _fmt_labels(fam.label_names, key)
                    lines.append(f"{fam.name}_sum{base} "
                                 f"{_fmt_value(child.sum)}")
                    lines.append(f"{fam.name}_count{base} {child.count}")
                else:
                    lbl = _fmt_labels(fam.label_names, key)
                    lines.append(f"{fam.name}{lbl} {_fmt_value(child.value)}")
        return "\n".join(lines) + "\n"

    def to_dict(self) -> Dict:
        """JSON-safe snapshot: {name: {type, help, samples: [...]}}; histogram
        samples carry sum/count and interpolated p50/p95/p99."""
        out: Dict = {}
        for fam in self.families():
            samples = []
            for key, child in fam._snapshot():
                labels = dict(zip(fam.label_names, key))
                if isinstance(fam, Histogram):
                    sample = {
                        "labels": labels, "sum": child.sum,
                        "count": child.count,
                        "p50": child.percentile(50.0),
                        "p95": child.percentile(95.0),
                        "p99": child.percentile(99.0)}
                    exemplars = child.exemplars()
                    if exemplars:
                        sample["exemplars"] = [
                            {"le": _fmt_value(ub), "value": v,
                             "trace_id": tid, "ts": ts}
                            for ub, (v, tid, ts) in sorted(exemplars.items())]
                    samples.append(sample)
                else:
                    samples.append({"labels": labels, "value": child.value})
            out[fam.name] = {"type": fam.kind, "help": fam.help,
                             "samples": samples}
        return out

    def breaker_stats(self) -> Dict[str, Dict]:
        """as_dict() of every breaker registered via instrument_breaker."""
        with self._lock:
            breakers = dict(self.breakers)
        return {name: b.as_dict() for name, b in breakers.items()}


# ---------------------------------------------------------------------------
# process-global default registry (servers/trainers take registry= overrides)
# ---------------------------------------------------------------------------

_global_registry = MetricsRegistry()
_global_lock = threading.Lock()


def get_registry() -> MetricsRegistry:
    """The process-global default registry."""
    return _global_registry


def set_registry(registry: MetricsRegistry) -> MetricsRegistry:
    """Swap the global registry (tests); returns the previous one."""
    global _global_registry
    with _global_lock:
        prev, _global_registry = _global_registry, registry
    return prev
