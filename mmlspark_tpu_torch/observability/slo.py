"""Declarative SLOs + multi-window burn-rate engine.

The Gemma-on-TPU serving study (PAPERS.md) gates its fleet comparisons on
per-class p99/SLO verdicts; this module computes them against the
federated fleet view.  An :class:`SLO` names an objective over one metric
family:

- **latency quantile** — ``p99(mmlspark_serving_request_latency_seconds
  {class=decode}) <= 0.15``: at most ``(100-q)%`` of observations may
  exceed the threshold (that fraction IS the error budget);
- **error-rate budget** — ``error_rate(mmlspark_serving_requests_total
  {status=shed} / mmlspark_serving_requests_total{status=received})
  <= 0.1%``: bad events over total events, both counter selections.

The :class:`SLOEngine` evaluates every SLO against successive
:class:`~.federation.FleetView` snapshots with Google-SRE-style
**multi-window burn rates**: each evaluation appends the cumulative
(bad, total) pair to a history ring, the fast (~5 m) and slow (~1 h)
windows difference that history at their edges, and the burn rate is the
windowed bad-fraction over the budget.  The objective is *burning* only
when BOTH windows burn past ``alert_burn_rate`` — the fast window gives
the page its speed, the slow window keeps a single spike from paging.
Everything runs on an injectable clock; verdicts land on
``GET /fleet/slo``, gauges on ``mmlspark_slo_{burn_rate,budget_remaining}``,
and burning transitions book ``slo_burn``/``slo_recovered`` ring events.
"""
from __future__ import annotations

import collections
import re
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

from .metrics import MetricsRegistry, get_registry

__all__ = ["SLO", "SLOEngine", "parse_slo"]


_FAMILY = r"[A-Za-z_:][\w:]*"
_LATENCY_RE = re.compile(
    rf"^\s*p(?P<q>\d+(?:\.\d+)?)\s*\(\s*(?P<family>{_FAMILY})\s*"
    r"(?P<labels>\{[^}]*\})?\s*\)\s*<=\s*(?P<bound>[0-9.eE+-]+)\s*"
    r"(?P<unit>ms|s)?\s*$")
_ERROR_RATE_RE = re.compile(
    rf"^\s*error_rate\s*\(\s*(?P<bad>{_FAMILY})\s*"
    rf"(?P<bad_labels>\{{[^}}]*\}})?\s*/\s*(?P<total>{_FAMILY})\s*"
    r"(?P<total_labels>\{[^}]*\})?\s*\)\s*<=\s*"
    r"(?P<bound>[0-9.eE+-]+)\s*(?P<pct>%)?\s*$")


def _parse_label_block(block: Optional[str]) -> Dict[str, str]:
    if not block:
        return {}
    inner = block.strip()[1:-1].strip()
    if not inner:
        return {}
    out: Dict[str, str] = {}
    for pair in inner.split(","):
        k, sep, v = pair.partition("=")
        if not sep or not k.strip():
            raise ValueError(f"bad label selector {pair!r} in {block!r}")
        out[k.strip()] = v.strip().strip('"')
    return out


@dataclass
class SLO:
    """One objective.  ``kind`` is ``"latency"`` (quantile ``q`` of
    histogram ``family`` must stay <= ``threshold`` seconds) or
    ``"error_rate"`` (counter selection ``family``+``labels`` over
    ``total_family``+``total_labels`` must stay <= ``threshold``).
    ``budget`` is the allowed bad fraction the burn rate divides by."""

    name: str
    kind: str                      # "latency" | "error_rate"
    family: str
    threshold: float               # seconds (latency) / fraction (error)
    q: float = 99.0
    labels: Dict[str, str] = field(default_factory=dict)
    total_family: str = ""
    total_labels: Dict[str, str] = field(default_factory=dict)
    spec: str = ""

    def __post_init__(self):
        if self.kind not in ("latency", "error_rate"):
            raise ValueError(f"unknown SLO kind {self.kind!r}")
        if self.kind == "latency" and not 0.0 < self.q < 100.0:
            raise ValueError(f"latency quantile must be in (0, 100): {self.q}")
        if self.threshold <= 0:
            raise ValueError(f"SLO threshold must be > 0: {self.threshold}")
        if self.kind == "error_rate" and not self.total_family:
            self.total_family = self.family

    @property
    def budget(self) -> float:
        """Allowed bad-event fraction: the tail the quantile leaves open,
        or the error-rate bound itself."""
        if self.kind == "latency":
            return (100.0 - self.q) / 100.0
        return self.threshold

    def describe(self) -> str:
        if self.spec:
            return self.spec
        if self.kind == "latency":
            return f"p{self.q:g}({self.family}) <= {self.threshold:g}"
        return (f"error_rate({self.family} / {self.total_family}) "
                f"<= {self.threshold:g}")


def parse_slo(spec: str, name: Optional[str] = None) -> SLO:
    """Parse the declarative grammar into an :class:`SLO`:

    - ``p<q>(family{k=v,...}) <= <seconds>[ms]``
    - ``error_rate(family{bad...} / family{total...}) <= <bound>[%]``

    Raises ``ValueError`` on anything else — a typo'd objective must fail
    construction, not silently never fire."""
    m = _LATENCY_RE.match(spec)
    if m is not None:
        bound = float(m.group("bound"))
        if m.group("unit") == "ms":
            bound /= 1000.0
        return SLO(name=name or spec.strip(), kind="latency",
                   family=m.group("family"), threshold=bound,
                   q=float(m.group("q")),
                   labels=_parse_label_block(m.group("labels")), spec=spec)
    m = _ERROR_RATE_RE.match(spec)
    if m is not None:
        bound = float(m.group("bound"))
        if m.group("pct"):
            bound /= 100.0
        return SLO(name=name or spec.strip(), kind="error_rate",
                   family=m.group("bad"), threshold=bound,
                   labels=_parse_label_block(m.group("bad_labels")),
                   total_family=m.group("total"),
                   total_labels=_parse_label_block(m.group("total_labels")),
                   spec=spec)
    raise ValueError(
        f"unparseable SLO spec {spec!r}; expected "
        "'p<q>(family{...}) <= <seconds>' or "
        "'error_rate(family{...} / family{...}) <= <fraction|%>'")


def window_fraction(samples: List[Tuple[float, float, float]], now: float,
                    window_s: float) -> float:
    """Windowed bad-fraction from cumulative (t, bad, total) samples:
    difference the newest sample against the newest sample at/older than
    the window edge (the whole history when shorter than the window).
    No traffic in the window — or a single sample — reads as 0.0: an
    idle fleet is in compliance, not in an undefined state.  Callers own
    monotonicity: difference only histories whose cumulative totals never
    regress (``SLOEngine``/``AutoscaleAdvisor`` clear history on a
    detected counter reset and hold verdicts on shrunken scrape coverage
    — see their docstrings)."""
    if len(samples) < 2:
        return 0.0
    newest = samples[-1]
    cutoff = now - window_s
    base = samples[0]
    for sample in reversed(samples[:-1]):
        if sample[0] <= cutoff:
            base = sample
            break
    if base is newest:
        return 0.0
    d_total = newest[2] - base[2]
    if d_total <= 0:
        return 0.0
    d_bad = max(0.0, newest[1] - base[1])
    return min(1.0, d_bad / d_total)


def coalesce_append(hist, sample: Tuple[float, float, float],
                    min_spacing_s: float) -> None:
    """Append a cumulative sample to a bounded history ring, coalescing
    into the newest slot while it sits within ``min_spacing_s`` of the
    last RETAINED sample (``hist[-2]``).  Retained samples therefore stay
    >= ``min_spacing_s`` apart, so the bounded ring always SPANS at least
    ``min_spacing_s * (maxlen - 2)`` of time regardless of caller cadence.
    Comparing against the newest slot itself would refresh its timestamp
    on every pass and collapse the ring to [oldest, latest] forever —
    silently turning every window lifetime-wide.  The newest slot is
    committed once it has matured ``min_spacing_s`` past its predecessor;
    until then fresh samples coalesce into it."""
    if len(hist) > 1 and hist[-1][0] - hist[-2][0] < min_spacing_s:
        hist[-1] = sample
    else:
        hist.append(sample)


class SLOEngine:
    """Evaluate a set of SLOs against successive fleet views.

    ``slos`` accepts :class:`SLO` objects or grammar strings.  Each
    :meth:`evaluate` appends one cumulative sample per SLO and recomputes
    both windows, so history accumulates at whatever cadence the
    federation poll (or the on-demand endpoints) run — the windows
    difference by *time*, not by sample count.

    Degraded-telemetry discipline: fleet-cumulative counts are only
    comparable across views with the same worker coverage.  When a worker
    that scraped ok last pass drops out (scrape failure or departure),
    this pass HOLDS the previous verdicts instead of differencing a
    shrunken total — a telemetry outage must never fire a false
    ``slo_recovered`` mid-incident.  Coverage GROWTH is the symmetric
    hazard: a worker rejoining after a multi-poll outage injects its
    process-lifetime counts, which did not happen inside any window — so
    any coverage change rebuilds every SLO's history from the new
    baseline (a brief blind window beats a false ``slo_burn`` page).  A
    cumulative total that regresses with stable coverage (worker restart
    resetting its counters) is treated as a counter reset the same way."""

    def __init__(self, slos: Sequence[Union[SLO, str]] = (),
                 registry: Optional[MetricsRegistry] = None,
                 clock: Callable[[], float] = time.monotonic,
                 fast_window_s: float = 300.0, slow_window_s: float = 3600.0,
                 alert_burn_rate: float = 1.0, history_cap: int = 4096):
        self.registry = registry if registry is not None else get_registry()
        self.clock = clock
        self.fast_window_s = float(fast_window_s)
        self.slow_window_s = float(slow_window_s)
        self.alert_burn_rate = float(alert_burn_rate)
        self.slos: List[SLO] = [s if isinstance(s, SLO) else parse_slo(s)
                                for s in slos]
        names = [s.name for s in self.slos]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate SLO names: {sorted(names)}")
        self._lock = threading.Lock()
        self._history: Dict[str, collections.deque] = {
            s.name: collections.deque(maxlen=max(2, int(history_cap)))
            for s in self.slos}
        # coalescing bound: evaluates arriving faster than this replace
        # the newest sample instead of appending, so a high-cadence
        # on-demand caller can never age the slow-window edge out of the
        # bounded ring (the ring must always SPAN >= slow_window_s)
        self._min_spacing_s = 2.0 * self.slow_window_s / max(2, int(history_cap))
        self._burning: Dict[str, bool] = {s.name: False for s in self.slos}
        self._last_ok_workers: frozenset = frozenset()
        self._last_result: Optional[Dict] = None
        self._pending_rebaseline = False
        from .instruments import instrument_slo_engine
        self._m = instrument_slo_engine(self, self.registry)

    def _cumulative(self, slo: SLO, view) -> Tuple[float, float]:
        """(bad, total) cumulative event counts for one SLO from a view."""
        if slo.kind == "latency":
            return view.fraction_over(slo.family, slo.threshold, slo.labels)
        bad = view.counter_sum(slo.family, slo.labels)
        total = view.counter_sum(slo.total_family, slo.total_labels)
        return bad, total

    def evaluate(self, view, now: Optional[float] = None) -> Dict:
        """One evaluation pass: sample every SLO from ``view``, recompute
        both burn windows, book gauges, and edge-trigger ring events on
        burning transitions.  Returns the ``GET /fleet/slo`` payload.

        A view whose scrape coverage SHRANK since the previous pass holds
        the previous verdicts (``telemetry: held_partial_view``) — see the
        class docstring; a cumulative total that regressed anyway clears
        that SLO's history (counter-reset semantics)."""
        now = self.clock() if now is None else float(now)
        ok_now = frozenset(sid for sid, info in view.workers.items()
                           if info.get("ok", False))
        with self._lock:
            prev_ok = self._last_ok_workers
            self._last_ok_workers = ok_now
            lost = prev_ok - ok_now
            gained = ok_now - prev_ok
            if lost and self._last_result is not None:
                held = dict(self._last_result)
                # whatever coverage the fleet settles on, the NEXT
                # differencing pass must rebuild from a fresh baseline
                self._pending_rebaseline = True
            else:
                held = None
                if gained or self._pending_rebaseline:
                    # coverage CHANGED (a worker rejoined after an outage,
                    # or we are resuming after a held pass): the new view's
                    # cumulative totals include counts that did not happen
                    # inside any window — symmetric twin of the hold rule;
                    # a rejoining worker's lifetime sheds must not fire a
                    # false slo_burn any more than a vanishing worker's
                    # missing counts may fire a false slo_recovered.  No
                    # prev-coverage guard: a pending rebaseline from a
                    # TOTAL outage must survive even though the previous
                    # ok-set was empty (clearing an already-empty history
                    # on the first-ever pass is a no-op anyway).
                    for hist in self._history.values():
                        hist.clear()
                self._pending_rebaseline = False
        if held is not None:
            held["telemetry"] = "held_partial_view"
            held["lost_workers"] = sorted(lost)
            return held
        verdicts: List[Dict] = []
        transitions: List[Dict] = []
        for slo in self.slos:
            bad, total = self._cumulative(slo, view)
            with self._lock:
                hist = self._history[slo.name]
                if hist and total < hist[-1][2]:
                    # cumulative total went backwards with stable coverage:
                    # a worker restarted (fresh counters) or left for good —
                    # counter-reset semantics, rebuild from the new baseline
                    hist.clear()
                coalesce_append(hist, (now, bad, total),
                                self._min_spacing_s)
                samples = list(hist)
            frac_fast = window_fraction(samples, now, self.fast_window_s)
            frac_slow = window_fraction(samples, now, self.slow_window_s)
            budget = slo.budget
            burn_fast = frac_fast / budget
            burn_slow = frac_slow / budget
            rebuilding = len(samples) < 2
            if rebuilding:
                # the windows were just rebaselined (coverage change /
                # counter reset): one sample proves nothing, so the
                # burning state HOLDS — computing "not burning" from an
                # empty window would fire the false slo_recovered the
                # held_partial_view rule exists to prevent; the next pass
                # with real differenced data settles it
                burning = self._burning[slo.name]
            else:
                burning = burn_fast > self.alert_burn_rate \
                    and burn_slow > self.alert_burn_rate
            remaining = max(0.0, 1.0 - burn_slow)
            if not rebuilding:
                # a rebuilding pass computes 0.0 from a <2-sample window —
                # writing that would clear a firing burn-rate alert mid-
                # incident while the verdict deliberately holds burning;
                # the gauges hold their previous values like the verdict
                self._m["burn_rate"].set(burn_fast, slo=slo.name,
                                         window="fast")
                self._m["burn_rate"].set(burn_slow, slo=slo.name,
                                         window="slow")
                self._m["budget_remaining"].set(remaining, slo=slo.name)
            with self._lock:
                flipped = burning != self._burning[slo.name]
                if flipped:
                    self._burning[slo.name] = burning
            if flipped:
                transitions.append(
                    {"event": "slo_burn" if burning else "slo_recovered",
                     "slo": slo.name, "spec": slo.describe(),
                     "burn_fast": round(burn_fast, 4),
                     "burn_slow": round(burn_slow, 4)})
            verdicts.append({
                "slo": slo.name, "spec": slo.describe(), "kind": slo.kind,
                "ok": not burning, "burning": burning,
                "window_rebuilding": rebuilding,
                "burn_rate": {"fast": burn_fast, "slow": burn_slow},
                "bad_fraction": {"fast": frac_fast, "slow": frac_slow},
                "budget": budget, "budget_remaining": remaining,
                "events_total": total,
                "windows_s": {"fast": self.fast_window_s,
                              "slow": self.slow_window_s}})
        # ring events book outside the lock (LCK discipline) — the burn is
        # the page, the ring is where chaos tests and operators read it
        for payload in transitions:
            from ..core.logging import log_event
            log_event(payload)
            if payload["event"] == "slo_burn":
                # flight-recorder dump on the burning EDGE:
                # edge-triggered like the ring event, so a sustained burn
                # costs one dump, not one per evaluate pass.  Only an
                # ALREADY-constructed recorder dumps — the engine must not
                # grow process-global crash hooks as a side effect of an
                # SLO evaluation
                rec = getattr(self.registry, "_flight_recorder", None)
                if rec is not None:
                    try:
                        rec.dump(trigger="slo_burn")
                    except Exception:  # noqa: BLE001 — the page still fires
                        pass
        result = {"evaluated_at": now,
                  "alert_burn_rate": self.alert_burn_rate,
                  "slos": verdicts}
        with self._lock:
            self._last_result = result
        return result

    def burning(self) -> Dict[str, bool]:
        with self._lock:
            return dict(self._burning)
