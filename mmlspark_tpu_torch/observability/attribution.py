"""Goodput & cost attribution — the useful-vs-wasted decode ledger.

The serving stack can say it is slow, burning or
recompiling, but not **what each request cost or how much device
work was useful**.  This module is the accounting plane the next decode
optimisations (speculative decoding, prefix caching — both bets on
converting wasted device work into goodput) will be judged on:

- :class:`RequestCost` — the per-request host-side ledger.  Maintained by
  ``ContinuousDecoder`` / one-shot ``decode()`` entirely OFF the compiled
  path: queue wait, prefill vs decode tokens, device-step seconds
  amortized over the step's *live* slots (riding the
  ``device_time_every`` dispatch/device split), and page-seconds
  integrated at the page alloc/extend/free edges.  Zero new compile keys
  by construction — nothing here touches an executable signature.
- **token outcome ledger** — every decode-step cell lands in exactly one
  ``mmlspark_decode_tokens_outcome_total{outcome}`` bucket
  (:data:`OUTCOMES`), so ``useful + wasted == steps x slots`` is a
  conservation law, not a dashboard approximation.  ``hedge_loser`` is
  booked client-side by ``RoutingClient`` when a hedge leg loses the race
  (the whole reply was device work the caller discarded).
- :class:`RequestRecordRing` — the bounded per-server ring of canonical
  wide-event records (trace id, class, cost stanza, verdict) behind
  ``GET /debug/requests?k=&class=&verdict=`` and the flight recorder's
  ``source.requests`` section.
- :class:`CapacityModel` — the fleet half: folds the federated ledgers
  into fleet goodput%, per-class ``device_seconds_per_1k_tokens`` and a
  per-class headroom report (arrival rate x measured cost vs the fleet's
  device-seconds budget) behind ``GET /fleet/capacity``.
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from .metrics import MetricsRegistry, get_registry
from .slo import coalesce_append

__all__ = ["OUTCOMES", "attribution_instruments", "RequestCost",
           "RequestRecordRing", "CapacityModel"]

#: every bucket a decode-step cell (or a discarded hedge reply's token) can
#: land in — the ledger's whole vocabulary, closed so conservation is
#: checkable:
#:
#: - ``useful``                     — tokens a caller received in a 2xx reply
#: - ``pad_row``                    — batch cells dispatched with no live
#:                                    request behind them (padding / finished
#:                                    rows still riding the fused step)
#: - ``denied_row``                 — tokens of rows frozen by page-pool
#:                                    exhaustion mid-flight
#: - ``deadline_expired_midflight`` — tokens of requests whose deadline
#:                                    expired after decode work started
#: - ``shed_after_work``            — tokens of requests cancelled/errored
#:                                    after decode work started (engine
#:                                    abort, drain teardown, caller gone)
#: - ``hedge_loser``                — tokens of a completed reply the
#:                                    routing client discarded because the
#:                                    other hedge leg won
OUTCOMES = ("useful", "pad_row", "denied_row", "deadline_expired_midflight",
            "shed_after_work", "hedge_loser")

#: ContinuousDecoder/decode() terminal outcome -> ledger bucket
ENGINE_OUTCOME_MAP = {
    "ok": "useful",
    "expired": "deadline_expired_midflight",
    "denied": "denied_row",
    "cancelled": "shed_after_work",
    "error": "shed_after_work",
}


def attribution_instruments(registry: Optional[MetricsRegistry] = None
                            ) -> Dict[str, Any]:
    """Register (idempotently) and return the attribution families.
    ``ModelRunner`` construction calls this so the ledger exists before the
    first decode; ``PipelineServer`` calls it for the class-labelled cost
    rollups it books at record emission; ``RoutingClient`` for the
    hedge-loser bucket (coverage-gated, like every family)."""
    reg = registry if registry is not None else get_registry()
    return {
        "tokens": reg.counter(
            "mmlspark_decode_tokens_outcome_total",
            "decode-step cells by terminal outcome — useful vs each wasted-"
            "work cause; sums to decode steps x batch width",
            labels=("outcome",)),
        "device": reg.counter(
            "mmlspark_decode_device_seconds_total",
            "estimated device-seconds attributed to decode requests (the "
            "per-step amount amortized over live slots)"),
        "class_tokens": reg.counter(
            "mmlspark_request_class_decode_tokens_total",
            "decode tokens delivered, by request class (booked at request-"
            "record emission from the cost ledger)", labels=("class",)),
        "class_device": reg.counter(
            "mmlspark_request_class_device_seconds_total",
            "estimated device-seconds consumed, by request class (booked "
            "at request-record emission from the cost ledger)",
            labels=("class",)),
    }


class RequestCost:
    """Host-side per-request cost ledger (one per ``StreamHandle`` /
    decode row).  Mutated only by the engine that owns the request — no
    locking: every writer runs on the decode loop's thread (or the
    submitting thread before the handle is visible to it)."""

    __slots__ = ("queue_s", "prefill_tokens", "prefill_cached",
                 "decode_tokens", "device_s", "page_seconds", "pages_held",
                 "pages_peak", "_page_t")

    def __init__(self, queue_s: float = 0.0, prefill_tokens: int = 0):
        self.queue_s = float(queue_s)
        self.prefill_tokens = int(prefill_tokens)
        # prefix-cache lane: of prefill_tokens, how many were
        # served from resident shared pages — device work SKIPPED, not
        # spent, so goodput accounting books them as saved rather than
        # silently dropping them from the conservation story
        self.prefill_cached = 0
        self.decode_tokens = 0
        self.device_s = 0.0
        self.page_seconds = 0.0
        self.pages_held = 0
        self.pages_peak = 0
        self._page_t: Optional[float] = None

    def page_edge(self, now: float, delta_pages: int) -> None:
        """Integrate page-seconds up to ``now`` and apply a page-count
        edge (+n at alloc/extend, -held at free).  Called at exactly the
        pool-op edges, so the integral is exact for piecewise-constant
        holdings — no sampling error."""
        if self._page_t is not None and self.pages_held > 0:
            self.page_seconds += self.pages_held * max(0.0, now - self._page_t)
        self._page_t = now
        self.pages_held = max(0, self.pages_held + int(delta_pages))
        self.pages_peak = max(self.pages_peak, self.pages_held)

    def close_pages(self, now: float) -> None:
        """Final page edge: integrate and drop every held page."""
        self.page_edge(now, -self.pages_held)

    def as_dict(self) -> Dict[str, float]:
        """The record's cost stanza — JSON-safe, bounded, rounded to keep
        the ring and the dump compact."""
        return {
            "queue_s": round(self.queue_s, 6),
            "prefill_tokens": int(self.prefill_tokens),
            "prefill_cached": int(self.prefill_cached),
            "decode_tokens": int(self.decode_tokens),
            "device_s": round(self.device_s, 6),
            "page_seconds": round(self.page_seconds, 6),
            "pages_peak": int(self.pages_peak),
        }


class RequestRecordRing:
    """Bounded, thread-safe ring of canonical request records — one dict
    per terminal request (trace id, class, verdict, status, cost stanza).
    Newest-first queries serve ``GET /debug/requests``; :meth:`tail`
    feeds the flight recorder's ``source.requests`` section so a
    stall/crash dump shows what the engine was serving when it died."""

    def __init__(self, maxlen: int = 256):
        self._ring: "collections.deque" = collections.deque(
            maxlen=max(1, int(maxlen)))
        self._lock = threading.Lock()
        self.appended = 0

    def append(self, record: Dict[str, Any]) -> None:
        with self._lock:
            self._ring.append(record)
            self.appended += 1

    def query(self, k: int = 50, klass: Optional[str] = None,
              verdict: Optional[str] = None) -> List[Dict[str, Any]]:
        """Newest-first records matching the optional class/verdict
        filters, capped at ``k``."""
        with self._lock:
            records = list(self._ring)
        out: List[Dict[str, Any]] = []
        for rec in reversed(records):
            if klass is not None and rec.get("class") != klass:
                continue
            if verdict is not None and rec.get("verdict") != verdict:
                continue
            out.append(rec)
            if len(out) >= max(0, int(k)):
                break
        return out

    def tail(self, k: int = 32) -> List[Dict[str, Any]]:
        """The newest ``k`` records, oldest-first (dump-section order)."""
        with self._lock:
            records = list(self._ring)
        return records[-max(0, int(k)):]


def _window_delta(samples, now: float, window_s: float):
    """Difference the newest cumulative sample against the newest sample
    at/older than the window edge (``window_fraction``'s base-pick rule,
    generalized to n-field tuples).  Returns ``(elapsed_s, deltas)`` or
    ``None`` with fewer than two samples / no elapsed time.  Negative
    deltas clamp to 0 — callers clear history on detected counter resets,
    this is only the residual-race guard."""
    if len(samples) < 2:
        return None
    newest = samples[-1]
    cutoff = now - window_s
    base = samples[0]
    for sample in reversed(samples[:-1]):
        if sample[0] <= cutoff:
            base = sample
            break
    if base is newest:
        return None
    dt = newest[0] - base[0]
    if dt <= 0:
        return None
    return dt, tuple(max(0.0, n - b) for n, b in zip(newest[1:], base[1:]))


class CapacityModel:
    """Fleet capacity from the federated cost ledgers (``GET
    /fleet/capacity``).

    Per request class it keeps a bounded cumulative history of
    ``(t, device_seconds, decode_tokens, received_requests)`` — fed from
    each :class:`FleetView` the federation poll produces — and reports
    windowed rates: measured ``device_seconds_per_1k_tokens``, arrival
    rate, device utilization against the class's device-seconds budget
    (one device-second per wall-second per live replica), and the
    remaining headroom.  The SLO/autoscale window discipline applies
    verbatim: bounded per-class rings maintained with
    :func:`slo.coalesce_append`, cleared on counter reset or scrape-
    coverage change, and a class with too little history reports ``null``
    rates instead of confidently-wrong ones."""

    TOKENS_FAMILY = "mmlspark_decode_tokens_outcome_total"
    CLASS_TOKENS_FAMILY = "mmlspark_request_class_decode_tokens_total"
    CLASS_DEVICE_FAMILY = "mmlspark_request_class_device_seconds_total"
    REQUESTS_FAMILY = "mmlspark_serving_requests_total"
    PREFIX_TOKENS_FAMILY = "mmlspark_prefix_hit_tokens_total"

    def __init__(self, clock: Callable[[], float] = time.monotonic,
                 window_s: float = 300.0):
        self.clock = clock
        self.window_s = float(window_s)
        self._min_spacing_s = 2.0 * self.window_s / 4096
        self._lock = threading.Lock()
        self._state: Dict[str, Dict] = {}

    # ------------------------------------------------------------- signals
    def _class_sample(self, view, klass: str, workers: List[Dict]):
        """One cumulative (device_s, tokens, received) triple for a class
        from the fleet view.  Device/token rollups carry the ``class``
        label directly; arrivals come from the class workers' serving
        counters (the autoscale addr-matching rule)."""
        addrs = {f"{w['host']}:{w['port']}" for w in workers}
        dev = view.counter_sum(self.CLASS_DEVICE_FAMILY, {"class": klass})
        tok = view.counter_sum(self.CLASS_TOKENS_FAMILY, {"class": klass})
        recv = sum(
            v for labels, v in view.counters.get(
                self.REQUESTS_FAMILY, {}).items()
            if dict(labels).get("status") == "received"
            and dict(labels).get("server") in addrs)
        return dev, tok, recv

    def report(self, view, workers_by_class: Dict[str, List[Dict]],
               now: Optional[float] = None) -> Dict[str, Any]:
        """Fold one fleet view into the per-class histories and return the
        ``GET /fleet/capacity`` payload."""
        now = self.clock() if now is None else float(now)
        classes: Dict[str, Dict] = {}
        with self._lock:
            for klass in sorted(workers_by_class):
                workers = workers_by_class[klass]
                n = len(workers)
                st = self._state.setdefault(klass, {
                    "hist": collections.deque(maxlen=4096),
                    "coverage": None})
                coverage = frozenset(
                    sid for w in workers
                    if (sid := w.get("server_id")) is not None
                    and view.workers.get(sid, {}).get("ok", False))
                hist = st["hist"]
                if coverage != st["coverage"]:
                    # scrape coverage changed: cumulative counts are not
                    # comparable across the change (the autoscale /
                    # SLO re-baselining rule)
                    hist.clear()
                    st["coverage"] = coverage
                dev, tok, recv = self._class_sample(view, klass, workers)
                if hist and (dev < hist[-1][1] or tok < hist[-1][2]
                             or recv < hist[-1][3]):
                    hist.clear()  # counter reset: a replica restarted
                coalesce_append(hist, (now, dev, tok, recv),
                                self._min_spacing_s)
                delta = _window_delta(list(hist), now, self.window_s)
                row: Dict[str, Any] = {
                    "replicas": n,
                    "device_seconds_per_1k_tokens": None,
                    "decode_tokens_per_s": None, "arrival_rps": None,
                    "device_utilization": None, "headroom_pct": None,
                    "samples": len(hist),
                }
                if delta is not None:
                    dt, (d_dev, d_tok, d_recv) = delta
                    row["decode_tokens_per_s"] = round(d_tok / dt, 4)
                    row["arrival_rps"] = round(d_recv / dt, 4)
                    if d_tok > 0:
                        row["device_seconds_per_1k_tokens"] = round(
                            1000.0 * d_dev / d_tok, 6)
                    # budget: one device-second per wall-second per replica
                    util = (d_dev / dt) / max(1, n)
                    row["device_utilization"] = round(util, 4)
                    row["headroom_pct"] = round(100.0 * (1.0 - util), 2)
                classes[klass] = row
            dead = [k for k in self._state if k not in workers_by_class]
            for k in dead:
                self._state.pop(k)
        by_outcome = {
            o: view.counter_sum(self.TOKENS_FAMILY, {"outcome": o})
            for o in OUTCOMES}
        total = sum(by_outcome.values())
        goodput = 100.0 * by_outcome["useful"] / total if total > 0 else None
        return {
            "goodput_pct": round(goodput, 4) if goodput is not None else None,
            "tokens_by_outcome": by_outcome,
            "token_samples": total,
            # prefix-cache savings: prefill tokens served from
            # resident pages fleet-wide — device work the cache SKIPPED,
            # reported beside goodput so capacity math sees the win
            "prefill_cached_tokens": view.counter_sum(
                self.PREFIX_TOKENS_FAMILY, {}),
            "classes": classes,
            "window_s": self.window_s,
            "evaluated_at": view.scraped_at,
        }
