"""MetricsFederator — fleet-wide ``/metrics`` scrape + merge.

An own copy of the JAX package's ``observability/federation.py``, verbatim apart from module
paths.

The serving stack makes every *worker* deeply observable; this module gives the
*fleet* one registry-shaped view of all of them.  A ``MetricsFederator``
scrapes each live worker's ``/metrics`` (concurrently, under one overall
deadline — the ``/fleet/slow`` fan-out discipline: a dead worker costs its
own timeout, never the whole sweep, and partial results always serve),
parses the exposition with :func:`parse_prometheus` (promoted here from the
test suite so the production scraper and the round-trip tests share one
parser), and merges families across workers into a :class:`FleetView`:

- **counters are summed** per label-set — the fleet total (per-worker
  attribution survives through the ``server`` label serving families
  already carry);
- **gauges are labelled per worker** — a ``worker="<server_id>"`` label is
  added so ``GET /fleet/metrics`` serves the Prometheus-federation shape;
- **histograms merge bucket-by-bucket only when bucket bounds match** — a
  worker child with mismatched bounds is skipped and counted
  (``mmlspark_federation_bucket_mismatch_total``), never silently merged
  into numbers that look right and are not.

Scrape bookkeeping (``mmlspark_federation_scrape_{total,seconds}``, the
``mmlspark_federation_stale_workers`` callback gauge) rides the same
registry, so the fleet plane watches itself the way the collector does.
Scrape failures book per-worker failure counters ONLY — federation never
feeds the serving-path breakers (``RoutingClient``/``fleet_slow``): a
telemetry outage must not shed traffic.
"""
from __future__ import annotations

import math
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from .metrics import MetricsRegistry, _escape_label, _fmt_value, get_registry
from ..utils.concurrency import make_lock
from ..utils.resilience import Deadline

__all__ = ["parse_prometheus", "FleetView", "MetricsFederator",
           "merge_snapshots"]


# ---------------------------------------------------------------------------
# exposition parsing (shared by the federator and the round-trip tests)
# ---------------------------------------------------------------------------

def _parse_label_pairs(rest: str, line: str) -> List[Tuple[str, str]]:
    """Split ``k="v",k2="v2"`` into pairs, honoring the escapes the
    registry's own ``_escape_label`` emits (``\\\\``, ``\\"``, ``\\n``):
    a comma or quote INSIDE a quoted value must not split the pair, and
    the value is unescaped so label identity survives the round trip."""
    pairs: List[Tuple[str, str]] = []
    i, n = 0, len(rest)
    while i < n:
        eq = rest.find("=", i)
        if eq < 0 or eq + 1 >= n or rest[eq + 1] != '"':
            raise ValueError(f"malformed label block in line {line!r}")
        key = rest[i:eq]
        j, out = eq + 2, []
        while j < n:
            ch = rest[j]
            if ch == "\\":
                if j + 1 >= n:
                    raise ValueError(f"dangling escape in line {line!r}")
                out.append({"n": "\n"}.get(rest[j + 1], rest[j + 1]))
                j += 2
                continue
            if ch == '"':
                break
            out.append(ch)
            j += 1
        else:
            raise ValueError(f"unterminated label value in line {line!r}")
        pairs.append((key, "".join(out)))
        i = j + 1
        if i < n:
            if rest[i] != ",":
                raise ValueError(f"malformed label block in line {line!r}")
            i += 1
    return pairs


def parse_prometheus(text):
    """Tiny exposition-format parser: returns ({(name, frozenset(labels)):
    value}, {name: type}, {key: (exemplar_labels, exemplar_value)}).
    Raises ``ValueError`` on malformed lines — including malformed
    OpenMetrics exemplar suffixes (``... # {trace_id="x"} 0.042``) — so
    the round-trip tests also validate the format itself.  Promoted from
    ``tests/test_observability.py``: the federation scraper and the
    exposition tests must never drift onto different grammars.  Explicit
    raises (not asserts): this is production input validation now, and a
    proxy's HTML error page behind a 200 must become a ``parse_error``
    verdict even under ``python -O``."""
    values, types, exemplars = {}, {}, {}
    for line in text.splitlines():
        if not line:
            continue
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split(" ", 3)
            if kind not in ("counter", "gauge", "histogram"):
                raise ValueError(f"unknown TYPE in line {line!r}")
            types[name] = kind
            continue
        if line.startswith("#"):
            if not line.startswith("# HELP ") and line != "# EOF":
                raise ValueError(f"unknown comment line {line!r}")
            continue
        exemplar = None
        if " # " in line:  # OpenMetrics exemplar suffix on a bucket line
            line, _, ex = line.partition(" # ")
            if not ex.startswith("{"):
                raise ValueError(f"malformed exemplar suffix {ex!r}")
            ex_labels, _, ex_val = ex[1:].partition("} ")
            exemplar = (dict(_parse_label_pairs(ex_labels, ex)),
                        float(ex_val))
        body, sval = line.rsplit(" ", 1)
        if "{" in body:
            name, rest = body.split("{", 1)
            if not rest.endswith("}"):
                raise ValueError(f"unterminated label block in {line!r}")
            key = (name, frozenset(_parse_label_pairs(rest[:-1], line)))
        else:
            key = (body, frozenset())
        values[key] = float(sval)
        if exemplar is not None:
            exemplars[key] = exemplar
    return values, types, exemplars


# ---------------------------------------------------------------------------
# fleet view: the merged registry shape
# ---------------------------------------------------------------------------

def _labels_text(labels: frozenset) -> str:
    pairs = sorted(labels)
    if not pairs:
        return ""
    return "{" + ",".join(f'{k}="{_escape_label(v)}"'
                          for k, v in pairs) + "}"


def _label_sort_key(labels: frozenset) -> Tuple:
    return tuple(sorted(labels))


class FleetView:
    """The merged, JSON/exposition-servable fleet registry view.

    ``workers`` records per-worker scrape outcomes (``ok``/``error`` plus
    ``age_s`` since the last successful scrape) so a partial merge is
    visibly partial; ``skipped_histograms`` counts worker histogram
    children whose bucket bounds did not match the merge base.
    """

    def __init__(self):
        self.workers: Dict[str, Dict] = {}
        self.types: Dict[str, str] = {}
        # counter/gauge families: {name: {frozenset(labels): value}}
        self.counters: Dict[str, Dict[frozenset, float]] = {}
        self.gauges: Dict[str, Dict[frozenset, float]] = {}
        # histogram families: {name: {frozenset(base_labels): {"bounds":
        # (..., inf), "cum": {bound: cumulative_count}, "sum", "count"}}}
        self.histograms: Dict[str, Dict[frozenset, Dict]] = {}
        self.skipped_histograms: Dict[str, int] = {}
        self.scraped_at: Optional[float] = None

    # ------------------------------------------------------------- builders
    @classmethod
    def from_texts(cls, texts: Dict[str, str],
                   on_mismatch: Optional[Callable[[str, str], None]] = None
                   ) -> "FleetView":
        """Merge raw exposition texts keyed by worker id (tests, replays)."""
        snapshots = {}
        for sid, text in texts.items():
            values, types, _ = parse_prometheus(text)
            snapshots[sid] = (values, types)
        return merge_snapshots(snapshots, on_mismatch=on_mismatch)

    # -------------------------------------------------------------- queries
    def counter_sum(self, family: str,
                    labels: Optional[Dict[str, str]] = None) -> float:
        """Sum of every counter sample in ``family`` whose label set
        contains ``labels`` (subset match)."""
        sel = set((labels or {}).items())
        return sum(v for ls, v in self.counters.get(family, {}).items()
                   if sel <= set(ls))

    def gauge_values(self, family: str,
                     labels: Optional[Dict[str, str]] = None
                     ) -> List[Tuple[Dict[str, str], float]]:
        """[(labels_dict, value)] for gauge samples matching the subset
        filter (the ``worker`` label added by the merge is included)."""
        sel = set((labels or {}).items())
        return [(dict(ls), v)
                for ls, v in sorted(self.gauges.get(family, {}).items(),
                                    key=lambda kv: _label_sort_key(kv[0]))
                if sel <= set(ls)]

    def histogram_aggregate(self, family: str,
                            labels: Optional[Dict[str, str]] = None
                            ) -> Optional[Dict]:
        """One combined cumulative histogram over every child of ``family``
        matching the subset filter.  Children whose bucket bounds differ
        from the combine base are EXCLUDED — the same never-silently-merge
        rule as the cross-worker merge.  This is a pure read: the
        merge-time ``skipped_histograms`` bookkeeping is the mismatch
        signal (a query must not inflate it on every call)."""
        fam = self.histograms.get(family)
        if not fam:
            return None
        total: Optional[Dict] = None
        sel = set((labels or {}).items())
        for base_labels, acc in sorted(fam.items(),
                                       key=lambda kv: _label_sort_key(kv[0])):
            if not sel <= set(base_labels):
                continue
            if total is None:
                total = {"bounds": acc["bounds"], "cum": dict(acc["cum"]),
                         "sum": acc["sum"], "count": acc["count"]}
            elif total["bounds"] == acc["bounds"]:
                for b in total["bounds"]:
                    total["cum"][b] += acc["cum"][b]
                total["sum"] += acc["sum"]
                total["count"] += acc["count"]
        return total

    def quantile(self, family: str, q: float,
                 labels: Optional[Dict[str, str]] = None) -> float:
        """histogram_quantile estimator over the combined fleet histogram
        (same interpolation as the per-process registry); NaN with no
        data."""
        agg = self.histogram_aggregate(family, labels)
        if not agg or agg["count"] <= 0:
            return float("nan")
        rank = (q / 100.0) * agg["count"]
        prev, lower = 0.0, 0.0
        for b in agg["bounds"]:
            c = agg["cum"][b]
            if c >= rank and c > prev:
                if math.isinf(b):
                    return lower  # clamp to the last finite bound
                return lower + (b - lower) * ((rank - prev) / (c - prev))
            prev = c
            if not math.isinf(b):
                lower = b
        return lower

    def fraction_over(self, family: str, threshold: float,
                      labels: Optional[Dict[str, str]] = None
                      ) -> Tuple[float, float]:
        """(observations over ``threshold``, total observations) for the
        combined fleet histogram — the cumulative "bad events" pair the SLO
        burn-rate windows difference.  Linear interpolation inside the
        bucket containing the threshold; past the last finite bound, the
        whole overflow bucket counts as over."""
        agg = self.histogram_aggregate(family, labels)
        if not agg or agg["count"] <= 0:
            return 0.0, 0.0
        total = agg["count"]
        prev, lower = 0.0, 0.0
        for b in agg["bounds"]:
            c = agg["cum"][b]
            if math.isinf(b) or threshold <= b:
                if math.isinf(b):
                    under = prev
                else:
                    span = b - lower
                    frac = 1.0 if span <= 0 else (threshold - lower) / span
                    under = prev + (c - prev) * min(1.0, max(0.0, frac))
                return max(0.0, total - under), total
            prev, lower = c, b
        return 0.0, total

    # ----------------------------------------------------------- exposition
    def to_prometheus(self, extra_registry: Optional[MetricsRegistry] = None
                      ) -> str:
        """Prometheus 0.0.4 text for the merged view: counters summed,
        gauges carrying the ``worker`` label, histograms with cumulative
        ``le`` buckets.  ``extra_registry`` (the TopologyService's own
        registry — scrape/staleness bookkeeping, SLO and autoscale gauges)
        is appended so one endpoint serves the fleet AND its federation."""
        lines: List[str] = []
        for name in sorted(self.types):
            kind = self.types[name]
            if kind == "histogram":
                lines.append(f"# TYPE {name} histogram")
                fam = self.histograms.get(name, {})
                for base_labels, acc in sorted(
                        fam.items(), key=lambda kv: _label_sort_key(kv[0])):
                    for b in acc["bounds"]:
                        le = "+Inf" if math.isinf(b) else _fmt_value(b)
                        lbl = frozenset(set(base_labels) | {("le", le)})
                        lines.append(f"{name}_bucket{_labels_text(lbl)} "
                                     f"{_fmt_value(acc['cum'][b])}")
                    base = _labels_text(base_labels)
                    lines.append(f"{name}_sum{base} "
                                 f"{_fmt_value(acc['sum'])}")
                    lines.append(f"{name}_count{base} "
                                 f"{_fmt_value(acc['count'])}")
                continue
            if kind != "untyped":
                lines.append(f"# TYPE {name} {kind}")
            series = self.counters.get(name) if kind == "counter" \
                else self.gauges.get(name)
            for labels, v in sorted((series or {}).items(),
                                    key=lambda kv: _label_sort_key(kv[0])):
                lines.append(f"{name}{_labels_text(labels)} {_fmt_value(v)}")
        text = "\n".join(lines) + "\n" if lines else ""
        if extra_registry is not None:
            text += extra_registry.to_prometheus()
        return text

    def to_dict(self) -> Dict:
        """JSON-safe summary (worker verdicts + family inventory), used by
        the fleet endpoints' JSON envelopes."""
        return {
            "workers": {sid: dict(v) for sid, v in sorted(self.workers.items())},
            "families": {name: self.types[name] for name in sorted(self.types)},
            "skipped_histograms": dict(self.skipped_histograms),
            "scraped_at": self.scraped_at,
        }


def _classify(name: str, types: Dict[str, str], hist_names) -> Tuple[str, Optional[str]]:
    kind = types.get(name)
    if kind in ("counter", "gauge"):
        return kind, None
    for base in hist_names:
        if name == base + "_bucket":
            return "hist_bucket", base
        if name == base + "_sum":
            return "hist_sum", base
        if name == base + "_count":
            return "hist_count", base
    # no TYPE line: pass through per worker like a gauge, typed "untyped"
    return "untyped", None


def merge_snapshots(snapshots: Dict[str, Tuple[Dict, Dict]],
                    on_mismatch: Optional[Callable[[str, str], None]] = None
                    ) -> FleetView:
    """Merge parsed per-worker snapshots (``{sid: (values, types)}`` from
    :func:`parse_prometheus`) into one :class:`FleetView`.  Counters sum,
    gauges gain a ``worker`` label, histograms merge bucket-by-bucket only
    on exactly matching bounds — a mismatched worker child is skipped,
    counted into ``skipped_histograms``, and reported via ``on_mismatch``.
    Workers merge in sorted-id order so the merge base is deterministic."""
    view = FleetView()
    for sid in sorted(snapshots):
        values, types = snapshots[sid]
        view.workers[sid] = {"ok": True}
        hist_names = {n for n, k in types.items() if k == "histogram"}
        # this worker's histogram children, grouped before the fleet fold
        hist_acc: Dict[str, Dict[frozenset, Dict]] = {}
        for (name, labels), value in values.items():
            kind, base = _classify(name, types, hist_names)
            if kind == "counter":
                view.types[name] = "counter"
                fam = view.counters.setdefault(name, {})
                fam[labels] = fam.get(labels, 0.0) + value
            elif kind in ("gauge", "untyped"):
                view.types.setdefault(name, kind)
                if kind == "gauge":
                    view.types[name] = "gauge"
                fam = view.gauges.setdefault(name, {})
                fam[frozenset(set(labels) | {("worker", sid)})] = value
            elif kind == "hist_bucket":
                base_labels = frozenset(p for p in labels if p[0] != "le")
                le = dict(labels).get("le", "+Inf")
                bound = math.inf if le in ("+Inf", "inf") else float(le)
                acc = hist_acc.setdefault(base, {}).setdefault(
                    base_labels, {"cum": {}, "sum": 0.0, "count": 0.0})
                acc["cum"][bound] = value
            elif kind == "hist_sum":
                acc = hist_acc.setdefault(base, {}).setdefault(
                    labels, {"cum": {}, "sum": 0.0, "count": 0.0})
                acc["sum"] = value
            elif kind == "hist_count":
                acc = hist_acc.setdefault(base, {}).setdefault(
                    labels, {"cum": {}, "sum": 0.0, "count": 0.0})
                acc["count"] = value
        for fname, by_labels in hist_acc.items():
            view.types[fname] = "histogram"
            dest = view.histograms.setdefault(fname, {})
            for base_labels, acc in by_labels.items():
                bounds = tuple(sorted(acc["cum"]))
                cur = dest.get(base_labels)
                if cur is None:
                    dest[base_labels] = {"bounds": bounds,
                                         "cum": dict(acc["cum"]),
                                         "sum": acc["sum"],
                                         "count": acc["count"]}
                elif cur["bounds"] == bounds:
                    for b in bounds:
                        cur["cum"][b] += acc["cum"][b]
                    cur["sum"] += acc["sum"]
                    cur["count"] += acc["count"]
                else:
                    # NEVER silently merged: mismatched bounds would add
                    # cumulative counts at different edges and produce
                    # quantiles that are confidently wrong
                    view.skipped_histograms[fname] = \
                        view.skipped_histograms.get(fname, 0) + 1
                    if on_mismatch is not None:
                        on_mismatch(fname, sid)
    return view


# ---------------------------------------------------------------------------
# the federator
# ---------------------------------------------------------------------------

class MetricsFederator:
    """Scrape every live worker's ``/metrics`` and serve the merged view.

    ``workers_fn`` returns the routing table (``{server_id: {host, port,
    ...}}`` — ``TopologyService.routing_table`` on the driver).  Scrapes
    fan out concurrently under one overall deadline (``deadline_s``), each
    exchange through the resilient ``io/http`` client with a per-worker
    timeout; a dead worker is a failure row and a counter, never a stall
    of the sweep and never a feed into any serving-path breaker.

    Staleness: ``stale_workers()`` (exported as the
    ``mmlspark_federation_stale_workers`` callback gauge) counts live
    workers whose last successful scrape is older than ``stale_after_s``
    — a worker registered but never scraped is stale by definition.

    Everything time-shaped rides the injectable ``clock``; ``fetcher`` is
    injectable so the deterministic suites scrape canned texts with no
    sockets.
    """

    def __init__(self, workers_fn: Callable[[], Dict[str, Dict]],
                 registry: Optional[MetricsRegistry] = None,
                 timeout_s: float = 2.0, deadline_s: float = 3.0,
                 stale_after_s: float = 15.0,
                 clock: Callable[[], float] = time.monotonic,
                 fetcher: Optional[Callable] = None,
                 name: str = "default"):
        self.workers_fn = workers_fn
        self.registry = registry if registry is not None else get_registry()
        self.timeout_s = float(timeout_s)
        self.deadline_s = float(deadline_s)
        self.stale_after_s = float(stale_after_s)
        self.clock = clock
        self.fetcher = fetcher or self._http_fetch
        # the staleness gauge's label: federators sharing one registry
        # need distinct names or the later one owns the shared series
        self.name = str(name)
        self._client = None  # lazily built io/http client
        self._lock = make_lock("MetricsFederator._lock")
        self._last_ok: Dict[str, float] = {}
        self._view: Optional[FleetView] = None
        self.reopen()

    # ------------------------------------------------------------ transport
    def _http_fetch(self, url: str, timeout_s: float,
                    deadline: Optional[Deadline]) -> str:
        """One scrape exchange through the resilient client (no retries —
        the poll interval IS the retry; no breaker — federation failures
        must never shed anything)."""
        from ..io.http import HTTPClient, HTTPRequestData
        client = self._client
        if client is None:
            client = self._client = HTTPClient(retries=0,
                                               timeout_s=timeout_s)
        resp = client.send(HTTPRequestData(url=url), deadline=deadline)
        if resp is None or resp.status_code != 200:
            raise ConnectionError(
                f"scrape {url} -> {getattr(resp, 'status_code', None)} "
                f"{getattr(resp, 'reason', '')}")
        return (resp.entity or b"").decode("utf-8", "replace")

    # -------------------------------------------------------------- scraping
    def scrape_once(self, deadline_s: Optional[float] = None) -> FleetView:
        """One concurrent sweep over the live workers; returns the merged
        :class:`FleetView` (partial on failures — one dead worker must
        never blind the fleet view).  Books per-worker scrape outcomes and
        the sweep latency."""
        t0 = self.clock()
        workers = dict(self.workers_fn())
        deadline = Deadline.after(
            self.deadline_s if deadline_s is None else float(deadline_s),
            self.clock)
        results: Dict[str, Tuple[str, object]] = {}
        results_lock = make_lock("MetricsFederator._results_lock")

        def fetch(sid: str, w: Dict) -> None:
            url = f"http://{w['host']}:{w['port']}/metrics"
            try:
                text = self.fetcher(url, self.timeout_s, deadline)
            except Exception as e:  # noqa: BLE001 — a dead worker is a row
                verdict = "deadline_exhausted" if deadline.expired() \
                    else "error"
                with results_lock:
                    results[sid] = (verdict, str(e))
                return
            try:
                values, types, _ = parse_prometheus(text)
            except Exception as e:  # noqa: BLE001 — garbage is a verdict
                with results_lock:
                    results[sid] = ("parse_error", str(e))
                return
            with results_lock:
                results[sid] = ("ok", (values, types))

        threads = []
        for sid, w in sorted(workers.items()):
            t = threading.Thread(target=fetch, args=(sid, w), daemon=True,
                                 name=f"federate-{sid}")
            t.start()
            threads.append((sid, t))
        for _sid, t in threads:
            t.join(timeout=max(0.0, deadline.remaining()))
        with results_lock:
            done = dict(results)
        now = self.clock()
        snapshots: Dict[str, Tuple[Dict, Dict]] = {}
        failures: Dict[str, Dict] = {}
        for sid, _t in threads:
            verdict, payload = done.get(
                sid, ("deadline_exhausted", "scrape still in flight"))
            self._m["scrapes"].inc(worker=sid, result=verdict)
            if verdict == "ok":
                snapshots[sid] = payload
            else:
                failures[sid] = {"ok": False, "error": f"{verdict}: {payload}"}
        view = merge_snapshots(
            snapshots,
            on_mismatch=lambda fam, _sid: self._m["bucket_mismatch"].inc(
                family=fam))
        view.workers.update(failures)
        with self._lock:
            for sid in snapshots:
                self._last_ok[sid] = now
            for sid in list(self._last_ok):  # departed workers drop out
                if sid not in workers:
                    self._last_ok.pop(sid)
            last_ok = dict(self._last_ok)
            self._view = view
        for sid, info in view.workers.items():
            seen = last_ok.get(sid)
            # None (not inf) for never-scraped: these rows ride JSON
            # endpoints, and json.dumps renders inf as the non-RFC
            # ``Infinity`` literal that strict parsers reject outright
            info["age_s"] = (now - seen) if seen is not None else None
        view.scraped_at = now
        self._m["scrape_seconds"].observe(max(0.0, self.clock() - t0))
        return view

    def last_view(self) -> Optional[FleetView]:
        with self._lock:
            return self._view

    def reopen(self) -> None:
        """(Re-)register this federator's instruments — called at
        construction and by ``TopologyService.start()`` so a stopped-then-
        restarted service gets its staleness series back (the
        ``CheckpointManager`` re-open convention)."""
        from .instruments import instrument_federator
        self._m = instrument_federator(self, self.registry)

    def close(self) -> None:
        """Unhook THIS federator's stale-workers gauge series (scoped by
        the ``federation`` label — a shared registry's other federators
        keep theirs): the callback closure pins this federator (and,
        through ``workers_fn``, the owning topology service), so a stopped
        service must detach it or the registry keeps both the stale series
        and the dead fleet alive for process lifetime — same hygiene as
        ``PipelineServer.stop()``'s queue gauges."""
        fam = self.registry.family("mmlspark_federation_stale_workers")
        if fam is not None:
            fam.remove(federation=self.name)

    def stale_workers(self) -> int:
        """Live workers whose last successful scrape is older than
        ``stale_after_s`` (never-scraped counts as stale) — the
        ``mmlspark_federation_stale_workers`` gauge callback."""
        try:
            workers = self.workers_fn()
        except Exception:  # noqa: BLE001 — a dying table scrapes as 0
            return 0
        now = self.clock()
        with self._lock:
            last = dict(self._last_ok)
        return sum(1 for sid in workers
                   if now - last.get(sid, -math.inf) > self.stale_after_s)
