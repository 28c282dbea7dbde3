"""StopWatch — nested wall-time decomposition, now a facade over spans.

Reference: ``core/utils/StopWatch.scala`` as used by VW diagnostics
(``VowpalWabbitBase.scala:294-329``) to split training time into
ingest/learn/multipass percentages.

Each ``measure(name)`` block opens a ``stopwatch.<name>`` span on the
observability layer, so the same timings that feed ``percentages()`` also
land in the metrics registry (``mmlspark_span_seconds{name=...}``) and the
logging event ring — the three telemetry fragments share one clock path.
The public API is unchanged; ``emit_spans=False`` opts out for callers that
only want the local totals.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict


class StopWatch:
    def __init__(self, emit_spans: bool = True):
        self._totals: Dict[str, float] = {}
        self._t0 = time.perf_counter()
        self._emit_spans = emit_spans

    @contextlib.contextmanager
    def measure(self, name: str):
        start = time.perf_counter()
        try:
            if self._emit_spans:
                from ..observability.tracing import trace_span
                with trace_span(f"stopwatch.{name}"):
                    yield
            else:
                yield
        finally:
            self._totals[name] = self._totals.get(name, 0.0) + (time.perf_counter() - start)

    def elapsed(self, name: str) -> float:
        return self._totals.get(name, 0.0)

    def total_elapsed(self) -> float:
        return time.perf_counter() - self._t0

    def percentages(self) -> Dict[str, float]:
        total = self.total_elapsed()
        return {k: 100.0 * v / total for k, v in self._totals.items()} if total > 0 else {}

    def as_dict(self) -> Dict[str, float]:
        return dict(self._totals)
