"""Distributed serving topology — driver registry + worker servers + routing.

Reference: Spark Serving v2's driver-side routing service
(``continuous/HTTPSourceV2.scala:190-196`` ``DriverServiceUtils
.createDriverService`` announces which executor hosts which partition's
server so a load balancer can route) and its server/client registries
(``HTTPSourceStateHolder`` ``:337-371``); the v1 distributed variant shards
buffered requests across partitions (``DistributedHTTPSource.scala:27-88``
``MultiChannelMap``).

An own copy of the JAX package's ``serving/distributed.py``, verbatim apart
from module paths.  Mapping: one ``WorkerServer`` per executor host (each
wrapping a pipeline on that host's card; on one card, N local workers), a ``TopologyService`` on the
driver holding the ``server_id -> host:port`` routing table plus aggregated
stats, and a ``RoutingClient`` that routes by partition key (hash) or round
robin — the ``MultiChannelMap`` analogue, client-side where the reference
put it behind an LB.  Workers reply directly on their own sockets
(continuous-mode semantics: no reply forwarding hop, ``HTTPSinkV2``).
"""
from __future__ import annotations

import itertools
import json
import os
import queue
import threading
import time
import urllib.parse
import urllib.request
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Iterable, List, Optional, Tuple

from .server import PipelineServer
from ..observability import get_registry, instrument_breaker
from ..observability.attribution import CapacityModel, attribution_instruments
from ..observability.autoscale import AutoscaleAdvisor
from ..observability.federation import MetricsFederator
from ..observability.instruments import uninstrument_breaker
from ..observability.slo import SLOEngine
from ..observability.tracing import (TRACE_HEADER, TRACEPARENT_HEADER,
                                     current_span, current_trace_id,
                                     format_traceparent)
from ..utils.concurrency import make_lock
from ..utils.resilience import (CircuitBreaker, Deadline, RetryBudget,
                                current_deadline)


def _http_json(url: str, payload: Optional[dict] = None, timeout: float = 10.0,
               deadline: Optional[Deadline] = None):
    deadline = deadline or current_deadline()
    if deadline is not None:
        if deadline.expired():
            raise TimeoutError("deadline exceeded before request")
        timeout = deadline.clip(timeout)
    data = json.dumps(payload).encode() if payload is not None else None
    headers = {"Content-Type": "application/json"}
    if deadline is not None:
        # forward the remaining budget so the server admits/sheds/scores
        # under the caller's deadline, not its own default
        headers[Deadline.HEADER] = deadline.to_header()
    trace_id = current_trace_id()
    if trace_id is not None:
        # the ambient span's trace id rides the wire so worker-side spans
        # join the caller's trace — legacy header plus W3C traceparent
        headers[TRACE_HEADER] = trace_id
        span = current_span()
        headers[TRACEPARENT_HEADER] = format_traceparent(
            trace_id, span.span_id if span is not None else None)
    req = urllib.request.Request(url, data=data, headers=headers)
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read().decode() or "null")


#: every HTTP endpoint TopologyService serves, by verb — the telemetry
#: coverage sweep (tests/test_telemetry_coverage.py) diffs this table
#: against the handler source, so a new endpoint cannot land unlisted
#: (and therefore undocumented/unswept).  ``/flag/<key>`` is the
#: prefix-matched flag read.
TOPOLOGY_ENDPOINTS = {
    "GET": ("/routing", "/flag/<key>", "/stats", "/fleet/slow",
            "/fleet/metrics", "/fleet/slo", "/fleet/autoscale",
            "/fleet/capacity", "/fleet/trace/<id>",
            "/fleet/membership", "/fleet/dump", "/health"),
    "POST": ("/register", "/deregister", "/flag"),
}

#: per-process instance counter for the membership-epoch gauge label: a
#: registry shared by several services (tests, embedded drivers) must not
#: have one service's epoch stomp another's series, and port 0 is not
#: known until start() so host:port cannot label at construction
_SERVICE_IDS = itertools.count()


def _nonneg_int(raw: str) -> int:
    v = int(raw)
    if v < 0:
        raise ValueError("must be >= 0")
    return v


def _pos_float(raw: str) -> float:
    v = float(raw)
    if not v > 0:
        raise ValueError("must be > 0")
    return v


def _flag01(raw: str) -> bool:
    if raw in ("1", "true"):
        return True
    if raw in ("", "0", "false"):
        return False
    raise ValueError("expected 0|1")


def _parse_query(query: str, spec: Dict[str, Callable[[str], object]]):
    """Validate a query string against ``spec`` (param name -> parser
    raising ValueError).  Returns ``(params, None)`` or ``(None, error)``
    — the shared validation for every fleet endpoint: a malformed value
    is a 400 verdict on the REQUEST, never a silent default and never an
    unhandled exception turning into a 500.  Unknown
    params are ignored (forward compatibility); percent-encoding is
    decoded by the stdlib parser; a repeated param's LAST value wins."""
    params: Dict[str, object] = {}
    if not query:
        return params, None
    for key, values in urllib.parse.parse_qs(
            query, keep_blank_values=True).items():
        parser = spec.get(key)
        if parser is None:
            continue
        raw = values[-1]
        try:
            params[key] = parser(raw)
        except ValueError as e:
            return None, f"bad query param {key}={raw!r}: {e}"
    return params, None


def _default_prober(worker: Dict, timeout: float) -> bool:
    """One /health probe against a worker's own socket (PipelineServer and
    TopologyService both serve GET /health)."""
    try:
        url = f"http://{worker['host']}:{worker['port']}/health"
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status == 200
    except Exception:  # noqa: BLE001 — any failure is "unhealthy"
        return False


class TopologyService:
    """Driver-side registry: workers announce ``server_id -> host:port``;
    clients fetch the routing table; ``/stats`` aggregates every worker's
    counters (reference: driver service ``HTTPSourceV2.scala:190`` +
    state-holder registries ``:337-371``).

    Health-checked failover: the driver actively probes each worker's
    ``/health`` every ``probe_interval_s``; ``evict_after`` consecutive
    probe failures evict the worker from the routing table (it reappears
    if it re-registers).  ``probe_once()`` runs a single sweep — tests
    drive eviction deterministically through it instead of sleeping.
    ``prober`` is injectable for the chaos harness.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 probe_interval_s: Optional[float] = 5.0,
                 probe_timeout_s: float = 2.0, evict_after: int = 3,
                 prober: Optional[Callable[[Dict, float], bool]] = None,
                 registry=None, fleet_slow_deadline_s: float = 2.0,
                 fleet_slow_k: int = 10,
                 fleet_breaker_factory: Optional[
                     Callable[[str], CircuitBreaker]] = None,
                 slos=(), federation_poll_s: Optional[float] = None,
                 federation_timeout_s: float = 2.0,
                 federation_deadline_s: float = 3.0,
                 telemetry_clock: Callable[[], float] = time.monotonic,
                 federator: Optional[MetricsFederator] = None,
                 slo_engine: Optional[SLOEngine] = None,
                 autoscaler: Optional[AutoscaleAdvisor] = None):
        self.host, self.port = host, port
        self.probe_interval_s = probe_interval_s
        self.probe_timeout_s = probe_timeout_s
        self.evict_after = max(1, evict_after)
        self.prober = prober or _default_prober
        self.registry = registry if registry is not None else get_registry()
        # /fleet/slow fan-out: overall budget, default depth, per-worker
        # breakers (a dead worker costs one probe per cooldown, never the
        # whole fan-out's latency on every query)
        self.fleet_slow_deadline_s = float(fleet_slow_deadline_s)
        self.fleet_slow_k = int(fleet_slow_k)
        self.fleet_breaker_factory = fleet_breaker_factory or (
            lambda sid: CircuitBreaker(failure_threshold=3, window_s=30.0,
                                       cooldown_s=10.0,
                                       name=f"fleet-slow:{sid}"))
        self._fleet_breakers: Dict[str, CircuitBreaker] = {}
        self._m_probes = self.registry.counter(
            "mmlspark_topology_probes_total",
            "health probes by worker and outcome",
            labels=("worker", "result"))
        self._m_evictions = self.registry.counter(
            "mmlspark_topology_evictions_total",
            "workers evicted after consecutive probe failures",
            labels=("worker",))
        # training-fleet membership plane: a monotonically
        # increasing epoch that bumps EXACTLY once per join / evict /
        # leave — the signal an elastic training loop (MembershipWatcher)
        # observes to checkpoint-and-exit instead of riding a dead
        # collective.  Registered at construction (coverage-gated).
        self._membership_epoch = 0
        _sid = next(_SERVICE_IDS)
        self._membership_label = f"topology-{_sid}"
        # served in /fleet/membership as "instance": a restarted driver
        # is a DIFFERENT membership plane even when its fresh epoch has
        # already caught up past a watcher's last-seen value — pid makes
        # it unique across processes, the counter within one
        self._boot_id = f"{os.getpid():x}-{_sid}"
        self._m_membership = self.registry.gauge(
            "mmlspark_fleet_membership_epoch",
            "monotonic fleet-membership epoch (bumps once per worker "
            "join/evict/leave)", labels=("service",))
        self._m_membership.set(0.0, service=self._membership_label)
        self._m_membership_changes = self.registry.counter(
            "mmlspark_fleet_membership_changes_total",
            "membership transitions by kind", labels=("change",))
        # postmortem plane: recorder families on the driver's
        # registry (fleet_dump books per-worker outcomes into them), the
        # driver's own recorder with crash/preemption hooks, and roster
        # enrolment so any recorder dumping THIS registry captures the
        # membership epoch
        from ..observability.flightrecorder import (_roster,
                                                    flightrecorder_instruments,
                                                    get_flight_recorder)
        self._m_fr = flightrecorder_instruments(self.registry)
        get_flight_recorder(self.registry)
        _roster(self.registry, "_topology_services").add(self)
        self._lock = make_lock("TopologyService._lock")
        self._workers: Dict[str, Dict] = {}
        self._fail_counts: Dict[str, int] = {}
        self._evicted: Dict[str, Dict] = {}
        self._flags: Dict[str, str] = {}
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._httpd_thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._probe_thread: Optional[threading.Thread] = None
        # fleet telemetry plane: federated /metrics, SLO
        # burn-rate verdicts, autoscale recommendations — all driven off
        # ONE injectable clock so the deterministic suites step windows
        # and cooldowns with FakeClock.  Components are injectable whole
        # for custom thresholds; the defaults share this service's
        # registry so every instrument lands in one scrape.
        self.federation_poll_s = federation_poll_s
        self.federator = federator if federator is not None else \
            MetricsFederator(workers_fn=self.routing_table,
                             registry=self.registry,
                             timeout_s=federation_timeout_s,
                             deadline_s=federation_deadline_s,
                             clock=telemetry_clock)
        self.slo_engine = slo_engine if slo_engine is not None else \
            SLOEngine(slos, registry=self.registry, clock=telemetry_clock)
        self.autoscaler = autoscaler if autoscaler is not None else \
            AutoscaleAdvisor(registry=self.registry, clock=telemetry_clock)
        # fleet capacity model: folds the federated cost
        # ledgers into goodput% + per-class device-seconds/1k-tokens and
        # headroom — fed once per federation tick, served at
        # GET /fleet/capacity
        self.capacity = CapacityModel(clock=telemetry_clock)
        self._fleet_lock = make_lock("TopologyService._fleet_lock")
        self._last_view = None
        self._last_slo: Optional[Dict] = None
        self._last_autoscale: Optional[Dict] = None
        self._last_capacity: Optional[Dict] = None
        self._federation_thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------ http
    def _make_handler(self):
        svc = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _json(self, status, obj):
                self._raw(status, json.dumps(obj).encode(),
                          "application/json")

            def _raw(self, status, body, ctype):
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_POST(self):
                length = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(length).decode() or "{}")
                if self.path == "/register":
                    payload.setdefault("role", "worker")
                    payload.setdefault("generation", 0)
                    bump = None
                    with svc._lock:
                        sid = payload["server_id"]
                        prev = svc._workers.get(sid)
                        # a JOIN is a sid the table does not route to, or
                        # a returning worker announcing a NEW generation
                        # (a crashed box back before the prober noticed);
                        # a same-generation re-register is a heartbeat
                        # and must NOT bump the epoch
                        if prev is None or \
                                prev.get("generation") != payload["generation"]:
                            bump = svc._bump_epoch_locked("joined", sid,
                                                          payload)
                        svc._workers[sid] = payload
                        # (re-)registration wipes any stale health verdict
                        svc._fail_counts.pop(sid, None)
                        svc._evicted.pop(sid, None)
                        num, epoch = len(svc._workers), svc._membership_epoch
                    if bump is not None:
                        svc._book_membership(*bump)
                    self._json(200, {"ok": True, "num_workers": num,
                                     "membership_epoch": epoch})
                elif self.path == "/deregister":
                    bump = None
                    with svc._lock:
                        sid = payload.get("server_id")
                        gone = svc._workers.pop(sid, None)
                        if gone is not None:
                            bump = svc._bump_epoch_locked("left", sid, gone)
                    if bump is not None:
                        svc._book_membership(*bump)
                    self._json(200, {"ok": True})
                elif self.path == "/flag":
                    with svc._lock:
                        svc._flags[payload["key"]] = payload["value"]
                    self._json(200, {"ok": True})
                else:
                    self._json(404, {"error": "not found"})

            def do_GET(self):
                path, _, query = self.path.partition("?")
                if path == "/routing":
                    # trainers register so /fleet/metrics
                    # federates their telemetry, but they serve /progress,
                    # not scores — keep them out of the routing table so
                    # RoutingClient never hashes score traffic onto one
                    with svc._lock:
                        table = {sid: w for sid, w in svc._workers.items()
                                 if w.get("role") != "trainer"}
                    self._json(200, table)
                elif path.startswith("/flag/"):
                    with svc._lock:
                        self._json(200, {"value": svc._flags.get(path[6:])})
                elif path == "/stats":
                    self._json(200, svc.aggregate_stats())
                elif path == "/fleet/slow":
                    # shared validation: a malformed or
                    # negative ?k= is a 400 verdict on the request — it
                    # used to be swallowed into the default (or blow up in
                    # the handler), both of which hide the caller's bug
                    params, err = _parse_query(query, {
                        "k": _nonneg_int, "deadline_ms": _pos_float})
                    if err is not None:
                        self._json(400, {"error": err})
                        return
                    dl = params.get("deadline_ms")
                    self._json(200, svc.fleet_slow(
                        k=params.get("k"),
                        deadline_s=dl / 1000.0 if dl is not None else None))
                elif path == "/fleet/metrics":
                    params, err = _parse_query(query, {
                        "refresh": _flag01, "deadline_ms": _pos_float})
                    if err is not None:
                        self._json(400, {"error": err})
                        return
                    dl = params.get("deadline_ms")
                    view, _slo, _auto = svc._fleet_state(
                        refresh=params.get("refresh"),
                        deadline_s=dl / 1000.0 if dl is not None else None)
                    body = view.to_prometheus(extra_registry=svc.registry)
                    self._raw(200, body.encode(),
                              "text/plain; version=0.0.4; charset=utf-8")
                elif path == "/fleet/slo":
                    params, err = _parse_query(query, {"refresh": _flag01})
                    if err is not None:
                        self._json(400, {"error": err})
                        return
                    view, verdicts, _auto = svc._fleet_state(
                        refresh=params.get("refresh"))
                    self._json(200, {**verdicts, "workers": view.to_dict()["workers"]})
                elif path == "/fleet/autoscale":
                    params, err = _parse_query(query, {"refresh": _flag01})
                    if err is not None:
                        self._json(400, {"error": err})
                        return
                    view, _slo, recs = svc._fleet_state(
                        refresh=params.get("refresh"))
                    self._json(200, {"classes": recs,
                                     "workers": view.to_dict()["workers"],
                                     "evaluated_at": view.scraped_at})
                elif path == "/fleet/capacity":
                    params, err = _parse_query(query, {
                        "refresh": _flag01, "deadline_ms": _pos_float})
                    if err is not None:
                        self._json(400, {"error": err})
                        return
                    dl = params.get("deadline_ms")
                    self._json(200, svc.fleet_capacity(
                        refresh=params.get("refresh"),
                        deadline_s=dl / 1000.0 if dl is not None else None))
                elif path.startswith("/fleet/trace/"):
                    params, err = _parse_query(query,
                                               {"deadline_ms": _pos_float})
                    if err is not None:
                        self._json(400, {"error": err})
                        return
                    dl = params.get("deadline_ms")
                    body = svc.fleet_trace(
                        path[len("/fleet/trace/"):],
                        deadline_s=dl / 1000.0 if dl is not None else None)
                    # 404 ONLY when no worker (and not the driver) holds
                    # the id — a partial assembly past dead workers is 200
                    self._json(200 if body["found"] else 404, body)
                elif path == "/fleet/dump":
                    params, err = _parse_query(query,
                                               {"deadline_ms": _pos_float})
                    if err is not None:
                        self._json(400, {"error": err})
                        return
                    dl = params.get("deadline_ms")
                    self._json(200, svc.fleet_dump(
                        deadline_s=dl / 1000.0 if dl is not None else None))
                elif path == "/fleet/membership":
                    self._json(200, svc.membership())
                elif path == "/health":
                    self._json(200, {"ok": True})
                else:
                    self._json(404, {"error": "not found"})

        return Handler

    # ---------------------------------------------------------------- health
    def _bump_epoch_locked(self, change: str, sid: str,
                           worker: Optional[Dict]) -> tuple:
        """Advance the membership epoch — caller MUST hold ``self._lock``
        — and return the transition tuple for :meth:`_book_membership`
        (booked OUTSIDE the lock: the ring event does I/O).  Every
        mutation site rides this one helper so the exactly-once
        bump-per-change contract is structural, not copy-pasted."""
        self._membership_epoch += 1
        return (self._membership_epoch, change, sid, worker)

    def _book_membership(self, epoch: int, change: str, sid: str,
                         worker: Optional[Dict]) -> None:
        """Book one membership transition: epoch gauge, per-kind counter,
        and the ``fleet_membership_changed`` ring event a training loop's
        watcher (or an operator tailing events) observes.  The gauge is
        written from the CURRENT epoch while holding the lock, not this
        transition's value outside it: two transitions booking out of
        lock order must never regress a gauge documented as monotonic —
        the ring event keeps the per-transition epoch."""
        with self._lock:
            # set while HOLDING the lock: a re-read-then-set outside it
            # still lets an older transition's write land last
            self._m_membership.set(float(self._membership_epoch),
                                   service=self._membership_label)
        self._m_membership_changes.inc(change=change)
        from ..core.logging import log_event
        log_event({"event": "fleet_membership_changed", "epoch": int(epoch),
                   "change": change, "worker": sid,
                   "role": (worker or {}).get("role"),
                   "generation": (worker or {}).get("generation")})

    def membership(self) -> Dict:
        """The ``GET /fleet/membership`` body: current epoch plus every
        live worker's role/generation/address — what an elastic training
        loop polls to notice the fleet changed under it."""
        with self._lock:
            workers = {sid: {"role": w.get("role", "worker"),
                             "generation": int(w.get("generation", 0)),
                             "host": w.get("host"), "port": w.get("port"),
                             "request_class": w.get("request_class"),
                             # "up" | "draining" — a draining worker is
                             # still a member (its in-flight slots are
                             # finishing) but routing excludes it at pick
                             # time; published by a same-generation
                             # re-register so it never bumps the epoch
                             "state": w.get("state", "up")}
                       for sid, w in self._workers.items()}
            return {"epoch": int(self._membership_epoch), "workers": workers,
                    "evicted": sorted(self._evicted),
                    "instance": self._boot_id}

    def probe_once(self) -> List[str]:
        """One health sweep over the registered workers; returns the ids
        evicted by this sweep.  Also the unit the background prober loops."""
        with self._lock:
            snapshot = list(self._workers.items())
        evicted: List[str] = []
        bumps = []
        for sid, w in snapshot:
            healthy = self.prober(w, self.probe_timeout_s)
            self._m_probes.inc(worker=sid,
                               result="ok" if healthy else "fail")
            with self._lock:
                if sid not in self._workers:
                    continue  # deregistered mid-sweep
                if healthy:
                    self._fail_counts.pop(sid, None)
                    continue
                fails = self._fail_counts.get(sid, 0) + 1
                self._fail_counts[sid] = fails
                if fails >= self.evict_after:
                    gone = self._workers.pop(sid)
                    self._evicted[sid] = gone
                    self._fail_counts.pop(sid, None)
                    evicted.append(sid)
                    bumps.append(self._bump_epoch_locked("evicted", sid,
                                                         gone))
        for sid in evicted:
            self._m_evictions.inc(worker=sid)
        for bump in bumps:
            self._book_membership(*bump)
        return evicted

    def _probe_loop(self) -> None:
        while not self._stop.wait(self.probe_interval_s):
            try:
                self.probe_once()
            except Exception:  # noqa: BLE001 — prober must never die
                pass

    # ------------------------------------------------------ fleet telemetry
    def workers_by_class(self) -> Dict[str, List[Dict]]:
        """Live workers grouped by the ``request_class`` they registered
        under (``"default"`` when unset) — the autoscale signal's unit."""
        out: Dict[str, List[Dict]] = {}
        for w in self.routing_table().values():
            out.setdefault(str(w.get("request_class") or "default"),
                           []).append(w)
        return out

    def federation_tick(self, deadline_s: Optional[float] = None) -> Dict:
        """One federation poll: scrape every live worker's ``/metrics``,
        evaluate the SLOs against the merged view, recompute the autoscale
        recommendation — the unit the background poll loops and the
        on-demand fleet endpoints call.  Always completes with whatever
        partial view the scrape produced: a dead worker is a failure row,
        never a blind endpoint."""
        view = self.federator.scrape_once(deadline_s=deadline_s)
        verdicts = self.slo_engine.evaluate(view)
        by_class = self.workers_by_class()
        recs = self.autoscaler.recommend(view, by_class)
        capacity = self.capacity.report(view, by_class)
        with self._fleet_lock:
            self._last_view = view
            self._last_slo = verdicts
            self._last_autoscale = recs
            self._last_capacity = capacity
        return {"view": view, "slo": verdicts, "autoscale": recs,
                "capacity": capacity}

    def _fleet_state(self, refresh: Optional[bool] = None,
                     deadline_s: Optional[float] = None):
        """(view, slo_verdicts, autoscale_recs) for the fleet endpoints.
        With a background poll running the cached poll result serves
        (``?refresh=1`` forces a sweep); without one every GET scrapes on
        demand — the "poll interval or on demand" contract."""
        if refresh is None:
            refresh = self.federation_poll_s is None
        with self._fleet_lock:
            have = self._last_view is not None
        if refresh or not have:
            self.federation_tick(deadline_s=deadline_s)
        with self._fleet_lock:
            return self._last_view, self._last_slo, self._last_autoscale

    def _federation_loop(self) -> None:
        while not self._stop.wait(self.federation_poll_s):
            try:
                self.federation_tick()
            except Exception:  # noqa: BLE001 — the poll must never die
                pass

    # ------------------------------------------------------------------ api
    def start(self) -> "TopologyService":
        # a restart after stop() must re-arm the loops: the stop event
        # left set would kill the fresh probe/federation threads on entry
        self._stop.clear()
        self._httpd = ThreadingHTTPServer((self.host, self.port),
                                          self._make_handler())
        self.port = self._httpd.server_port
        self._httpd_thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True)
        self._httpd_thread.start()
        if self.probe_interval_s is not None:
            self._probe_thread = threading.Thread(target=self._probe_loop,
                                                  daemon=True)
            self._probe_thread.start()
        # restore the staleness series after a previous stop() (no-op on
        # first start — construction already registered it)
        self.federator.reopen()
        if self.federation_poll_s is not None:
            self._federation_thread = threading.Thread(
                target=self._federation_loop, daemon=True,
                name="mmlspark-federation-poll")
            self._federation_thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._httpd:
            self._httpd.shutdown()
            self._httpd.server_close()
        # join the loops before returning: start() clears the stop event,
        # and an old loop still mid-probe when it is cleared would revive
        # and run ALONGSIDE the restart's fresh threads (double-counted
        # probes evict healthy workers at half the intended threshold)
        for t in (self._probe_thread, self._federation_thread,
                  self._httpd_thread):
            if t is not None and t.is_alive():
                t.join(timeout=10.0)
        self._probe_thread = self._federation_thread = None
        self._httpd_thread = None
        # the federator's stale-workers callback gauge closes over this
        # service's routing table — a stopped driver must not scrape on
        self.federator.close()

    @property
    def address(self) -> str:
        return f"http://{self.host}:{self.port}"

    def routing_table(self) -> Dict[str, Dict]:
        with self._lock:
            return dict(self._workers)

    def aggregate_stats(self) -> Dict:
        """Pull and sum every registered worker's counters."""
        with self._lock:
            workers = list(self._workers.values())
            evicted = sorted(self._evicted)
        total = {"received": 0, "replied": 0, "errors": 0, "shed": 0,
                 "workers": {}, "evicted": evicted}
        lat_sum_ms, lat_count = 0.0, 0
        ckpt_ages: Dict[str, float] = {}
        for w in workers:
            try:
                s = _http_json(f"http://{w['host']}:{w['port']}/stats")
            except Exception as e:  # noqa: BLE001 — a dead worker is a stat
                total["workers"][w["server_id"]] = {"error": str(e)}
                continue
            total["workers"][w["server_id"]] = s
            total["received"] += s.get("received", 0)
            total["replied"] += s.get("replied", 0)
            total["errors"] += s.get("errors", 0)
            total["shed"] += s.get("shed", 0)
            # checkpointing workers report their last-success age:
            # "checkpoints stopped landing" is a FLEET page, so the
            # worst age surfaces here, not just per box
            age = s.get("checkpoint_last_success_age_seconds")
            if isinstance(age, (int, float)) and age == age:  # NaN out
                ckpt_ages[w["server_id"]] = age
            # (sum, count)-paired latency when the worker reports it; the
            # pre-pairing fallback weights by replied
            n = s.get("latency_count", s.get("replied", 0))
            lat_count += n
            lat_sum_ms += s.get("mean_latency_ms", 0.0) * n
        if lat_count:
            total["latency_count"] = lat_count
            total["latency_avg_ms"] = lat_sum_ms / lat_count
            total["mean_latency_ms"] = total["latency_avg_ms"]
        if ckpt_ages:
            total["checkpoint_last_success_age_seconds"] = ckpt_ages
            total["checkpoint_max_last_success_age_seconds"] = \
                max(ckpt_ages.values())
        return total

    # ------------------------------------------------------------ /fleet/slow
    def _fleet_breaker(self, sid: str) -> CircuitBreaker:
        with self._lock:
            b = self._fleet_breakers.get(sid)
        if b is None:
            fresh = self.fleet_breaker_factory(sid)
            with self._lock:
                b = self._fleet_breakers.setdefault(sid, fresh)
            if b is fresh:
                # only the setdefault WINNER is instrumented (outside our
                # lock — it registers gauges): instrumenting a losing
                # duplicate would rebind the shared gauge callbacks and
                # listener record to a breaker nobody uses
                instrument_breaker(b, self.registry)
        return b

    def _prune_fleet_breakers(self, live_ids) -> None:
        """A worker gone from the routing table takes its fan-out breaker
        and gauge series with it (same hygiene as RoutingClient's
        per-worker breakers — fresh-id churn must not grow state)."""
        with self._lock:
            dead = [(sid, self._fleet_breakers.pop(sid))
                    for sid in list(self._fleet_breakers)
                    if sid not in live_ids]
        for _sid, breaker in dead:
            uninstrument_breaker(breaker, self.registry)

    def _fanout_debug(self, path: str, deadline: Deadline,
                      not_found_ok: bool = False) -> Tuple[Dict, Dict]:
        """Concurrent deadline-bounded GET of ``path`` against every live
        worker with the per-worker breaker discipline (factored
        this out of :meth:`fleet_slow` so ``/fleet/dump`` shares it
        verbatim).  Returns ``(per_worker, payloads)``: a verdict row per
        worker (``{"ok": True}`` / ``{"skipped": ...}`` / ``{"error":
        ...}``) and the successful workers' JSON payloads.

        Rules carried over: an open breaker costs one skip, not a timeout;
        a client-side deadline expiry mid-exchange is NEVER fed to the
        breaker; partial results always serve.

        ``not_found_ok`` (``/fleet/trace/<id>``): a worker's 404
        is a healthy "I don't hold it" verdict — ``{"not_found": True}``
        row, no payload, and NO breaker feed (a trace fanned out across a
        fleet misses on most workers by design; charging their breakers
        would open every breaker under normal trace lookups)."""
        with self._lock:
            workers = list(self._workers.items())
        self._prune_fleet_breakers({sid for sid, _ in workers})
        per_worker: Dict[str, Dict] = {}
        results: Dict[str, tuple] = {}
        results_lock = make_lock("TopologyService._stats_results_lock")

        def fetch(sid: str, w: Dict, breaker: CircuitBreaker) -> None:
            try:
                got = _http_json(
                    f"http://{w['host']}:{w['port']}{path}",
                    timeout=self.probe_timeout_s, deadline=deadline)
            except Exception as e:  # noqa: BLE001 — a dead worker is a row
                if not_found_ok and isinstance(e, urllib.error.HTTPError) \
                        and e.code == 404:
                    breaker.record_success()
                    with results_lock:
                        results[sid] = ({"not_found": True}, None)
                    return
                if deadline.expired():
                    # the budget ran out mid-exchange — that is the
                    # caller's deadline, not the worker's health: no
                    # breaker feed (rule: client-side expiry must
                    # never trip a healthy worker's breaker)
                    with results_lock:
                        results[sid] = (
                            {"skipped": "deadline_exhausted"}, None)
                    return
                breaker.record_failure()
                with results_lock:
                    results[sid] = ({"error": str(e)}, None)
                return
            breaker.record_success()
            with results_lock:
                results[sid] = ({"ok": True}, got)

        # genuinely concurrent fan-out: one slow worker costs the query its
        # OWN latency, never every later worker's slice of the budget (the
        # sequential version starved the tail of the worker list)
        threads = []
        for sid, w in workers:
            breaker = self._fleet_breaker(sid)
            if not breaker.allow():
                per_worker[sid] = {"skipped": "circuit_open"}
                continue
            if deadline.expired():
                per_worker[sid] = {"skipped": "deadline_exhausted"}
                continue
            t = threading.Thread(target=fetch, args=(sid, w, breaker),
                                 daemon=True, name=f"fleet-debug-{sid}")
            t.start()
            threads.append((sid, t))
        for sid, t in threads:
            t.join(timeout=max(0.0, deadline.remaining()))
        with results_lock:
            done = dict(results)
        payloads: Dict[str, Dict] = {}
        for sid, _t in threads:
            outcome = done.get(sid)
            if outcome is None:
                # still in flight when the budget ran out; its thread will
                # finish the breaker bookkeeping in the background
                per_worker[sid] = {"skipped": "deadline_exhausted"}
                continue
            verdict, payload = outcome
            per_worker[sid] = verdict
            if payload is not None:
                payloads[sid] = payload
        return per_worker, payloads

    def fleet_slow(self, k: Optional[int] = None,
                   deadline_s: Optional[float] = None) -> Dict:
        """Fleet-wide slowest requests (``GET /fleet/slow?k=N``):
        fan out to every live worker's ``/debug/slow`` under one
        overall deadline, merge to a global top-K with worker attribution.

        Per-worker circuit breakers isolate dead workers: a worker that
        keeps failing costs one probe per cooldown instead of a timeout per
        query, and partial results are always served — one dead worker must
        never blind the fleet view.  Skipped/failed workers are reported in
        ``workers`` so a partial merge is visibly partial."""
        k = self.fleet_slow_k if k is None else max(0, int(k))
        deadline = Deadline.after(deadline_s if deadline_s is not None
                                  else self.fleet_slow_deadline_s)
        per_worker, payloads = self._fanout_debug(f"/debug/slow?k={k}",
                                                  deadline)
        merged: List[Dict] = []
        for sid, got in payloads.items():
            rows = got.get("slowest", []) if isinstance(got, dict) else []
            for row in rows:
                row["worker"] = sid
            per_worker[sid] = {"count": len(rows)}
            merged.extend(rows)
        merged.sort(key=lambda r: r.get("durationS", 0.0), reverse=True)
        return {"k": k, "workers": per_worker, "slowest": merged[:k]}

    def fleet_dump(self, deadline_s: Optional[float] = None) -> Dict:
        """Fleet-wide flight-recorder snapshots (``GET /fleet/dump``):
        fan out to every live worker's ``/debug/dump`` under
        one overall deadline with the :meth:`fleet_slow` breaker
        discipline, and serve PARTIAL results — a dead worker is exactly
        when an operator pulls the fleet's black boxes, so one dead worker
        blinding the endpoint would defeat it.  Per-worker outcomes book
        ``mmlspark_flightrecorder_dumps_total{trigger="fleet"}`` on the
        driver's registry."""
        deadline = Deadline.after(deadline_s if deadline_s is not None
                                  else self.fleet_slow_deadline_s)
        per_worker, payloads = self._fanout_debug("/debug/dump", deadline)
        dumps_c = self._m_fr["dumps"]
        for sid, verdict in per_worker.items():
            result = "ok" if sid in payloads else (
                "skipped" if "skipped" in verdict else "error")
            dumps_c.inc(trigger="fleet", result=result)
        return {"workers": per_worker, "dumps": payloads}

    def fleet_trace(self, trace_id: str,
                    deadline_s: Optional[float] = None) -> Dict:
        """Assemble ONE trace's span trees across the driver and every
        live worker (``GET /fleet/trace/<id>``, the cross-worker
        trace): fan ``/trace/<id>`` out under one overall deadline
        with the breaker discipline, treating a worker's 404 as a healthy
        "not here" verdict.  Partial results serve past dead workers;
        ``found`` is False only when NO reachable holder (driver
        included) had the id — the endpoint's 404 signal."""
        deadline = Deadline.after(deadline_s if deadline_s is not None
                                  else self.fleet_slow_deadline_s)
        per_worker, payloads = self._fanout_debug(
            f"/trace/{urllib.parse.quote(trace_id, safe='')}", deadline,
            not_found_ok=True)
        trees = dict(payloads)
        from ..observability.collector import get_collector
        own = get_collector(self.registry).trace_tree(trace_id)
        if own is not None:
            trees["driver"] = own
        return {"trace_id": trace_id, "found": bool(trees),
                "workers": per_worker, "trees": trees}

    def fleet_capacity(self, refresh: Optional[bool] = None,
                       deadline_s: Optional[float] = None) -> Dict:
        """Per-class capacity/headroom report (``GET /fleet/capacity``):
        goodput%, measured device-seconds per 1k decode tokens,
        arrival rate vs the class's device-seconds budget.  Rides the
        federation cache exactly like the other fleet endpoints —
        ``?refresh=1`` forces a sweep; the background poll keeps the
        windowed rate history warm in between."""
        self._fleet_state(refresh=refresh, deadline_s=deadline_s)
        with self._fleet_lock:
            return dict(self._last_capacity or {})


class WorkerServer:
    """Executor-side server: a ``PipelineServer`` that registers its
    ``host:port`` (and owned partition ids) with the driver's topology
    service at start and deregisters at stop — the worker half of
    ``HTTPSourceStateHolder`` registration."""

    def __init__(self, model, server_id: str, driver_address: str,
                 partition_ids: Optional[List[int]] = None,
                 request_class: str = "default", role: str = "serving",
                 generation: int = 0, **kw):
        self.server_id = server_id
        self.driver_address = driver_address.rstrip("/")
        self.partition_ids = partition_ids or []
        # the traffic class this replica serves (e.g. "score" / "decode"):
        # the autoscale signal groups workers by it
        self.request_class = request_class
        # membership plane: the role this worker plays in the
        # fleet ("serving" / "trainer" / ...) and its restart generation —
        # a returning worker announces generation+1 so the driver books a
        # join even if the prober never noticed the crash
        self.role = role
        self.generation = int(generation)
        # the class rides into the wrapped server too: its
        # request records and per-class cost rollups must agree with what
        # this worker registered as — an explicit kw still wins
        kw.setdefault("request_class", request_class)
        self.server = PipelineServer(model, **kw)

    def _registration(self, state: Optional[str] = None) -> Dict:
        body = {"server_id": self.server_id, "host": self.server.host,
                "port": self.server.port,
                "api_path": self.server.api_path,
                "partition_ids": self.partition_ids,
                "request_class": self.request_class,
                "role": self.role, "generation": self.generation}
        if state is not None:
            body["state"] = state
        return body

    def start(self) -> "WorkerServer":
        self.server.start()
        _http_json(f"{self.driver_address}/register", self._registration())
        return self

    def drain(self, timeout_s: Optional[float] = None) -> bool:
        """Zero-drop rolling-restart unit: publish the
        ``draining`` membership state FIRST (a same-generation re-register
        — a heartbeat row replacement, so ``RoutingClient`` stops picking
        this worker without a membership-epoch bump), then drain the
        wrapped :class:`PipelineServer` (shed new admissions, let
        in-flight work finish, stop), then deregister.  Stragglers that
        raced the state publication are shed with ``Retry-After`` and fail
        over client-side.  Returns the server drain's verdict."""
        try:
            _http_json(f"{self.driver_address}/register",
                       self._registration(state="draining"))
        except Exception:  # noqa: BLE001 — a blind driver must not block
            pass           # the drain; probes will evict us anyway
        ok = self.server.drain(timeout_s=timeout_s)
        try:
            _http_json(f"{self.driver_address}/deregister",
                       {"server_id": self.server_id})
        except Exception:  # noqa: BLE001 — driver may already be gone
            pass
        return ok

    def stop(self) -> None:
        try:
            _http_json(f"{self.driver_address}/deregister",
                       {"server_id": self.server_id})
        except Exception:  # noqa: BLE001 — driver may already be gone
            pass
        self.server.stop()

    @property
    def address(self) -> str:
        return self.server.address


class MembershipWatcher:
    """Watches ``GET /fleet/membership`` for a fleet SHRINK.

    The elastic-training half of the membership plane: a training loop
    hands this to :func:`utils.resilience.preemption_scope` (``watcher=``)
    — or starts it standalone around the whole run — and when the epoch
    advances with FEWER workers than before, the watcher requests
    preemption, so the loop writes its final checkpoint and exits instead
    of riding a collective whose peer just died.  Growth (a join) is
    observed but never preempts: new capacity joins at the next restart's
    re-shard, it does not invalidate the running step.

    ``poll_once()`` is the deterministic unit tests drive; ``start()``
    loops it on a daemon thread every ``poll_s``.  A dead or slow driver
    is swallowed — losing the membership view must degrade to signal-only
    preemption, never kill the training it protects."""

    def __init__(self, driver_address: str, poll_s: float = 2.0,
                 timeout_s: float = 2.0,
                 on_shrink: Optional[Callable[[Dict], None]] = None,
                 roles: Optional[Iterable[str]] = None):
        self.driver_address = driver_address.rstrip("/")
        self.poll_s = float(poll_s)
        self.timeout_s = float(timeout_s)
        self.on_shrink = on_shrink
        # on a TopologyService shared with serving replicas, a scaled-down
        # or evicted SERVING worker must not preempt training — pass
        # roles={"trainer"} to watch only the collective's own peers.
        # None keeps every worker in view (single-purpose fleets).
        self.roles = None if roles is None else frozenset(roles)
        self.last_epoch: Optional[int] = None
        self.last_workers: Optional[Dict[str, int]] = None  # sid -> generation
        self.last_instance: Optional[str] = None
        self.shrinks = 0
        # guards the view compare-and-update: poll_once runs on the
        # watcher thread AND as a public probe (tests, manual ticks) — an
        # unlocked interleaving can diff against a half-updated view and
        # preempt a healthy collective (CCY002)
        self._state_lock = make_lock("MembershipWatcher._state_lock")
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def poll_once(self) -> Optional[Dict]:
        """One membership read; returns the shrink info dict when this
        poll observed a shrink (and fired the preemption), else None."""
        try:
            m = _http_json(f"{self.driver_address}/fleet/membership",
                           timeout=self.timeout_s)
        except Exception:  # noqa: BLE001 — a blind watcher must not kill
            return None    # the training loop it guards
        epoch = int(m.get("epoch", 0))
        workers = {sid: int((w or {}).get("generation", 0))
                   for sid, w in dict(m.get("workers", {})).items()
                   if self.roles is None
                   or (w or {}).get("role") in self.roles}
        inst = m.get("instance")
        # compare-and-update under the state lock (the HTTP fetch above
        # and the on_shrink callback below stay outside it); the callback
        # fires AFTER the view commits, so a reentrant poll_once from
        # inside on_shrink diffs against the new baseline, not a torn one
        with self._state_lock:
            first = self.last_epoch is None
            restarted = not first and (
                (inst is not None and self.last_instance is not None
                 and inst != self.last_instance)
                or epoch < self.last_epoch)
            if restarted:
                # a NEW instance token (or, pre-upgrade, an epoch that went
                # backwards): a restarted (fresh, in-memory) membership
                # plane, not a transition — the old view is incomparable.
                # The token matters because a restart whose re-registrations
                # already pushed the fresh epoch PAST our last-seen value
                # looks like a plain advance.  Rebaseline instead of diffing
                # across service instances: a restarted driver's half-empty
                # registry would read as "every peer lost" and preempt a
                # healthy collective, and a lost membership view must
                # degrade to signal-only preemption, never kill the run it
                # guards.
                self.last_epoch, self.last_workers = epoch, workers
                self.last_instance = inst
                return None
            # a shrink is a worker the last view HAD that this one lost —
            # keyed by id AND generation, not a count compare: an eviction
            # masked by an unrelated join keeps the count flat, and a crash
            # whose supervisor re-registers the same id with generation+1
            # inside one poll interval keeps even the ID SET flat — in both
            # cases the collective's original peer process is dead
            lost = set() if first else {
                sid for sid, gen in self.last_workers.items()
                if workers.get(sid, -1) != gen}
            shrunk = not first and epoch > self.last_epoch and bool(lost)
            self.last_epoch, self.last_workers = epoch, workers
            self.last_instance = inst
            if not shrunk:
                return None
            self.shrinks += 1
        info = {"epoch": epoch, "workers": len(workers),
                "lost": sorted(lost)}
        if self.on_shrink is not None:
            self.on_shrink(info)
        else:
            from ..utils.resilience import request_preemption
            request_preemption("fleet_membership_shrink")
        return info

    def _loop(self, stop: threading.Event) -> None:
        # the event is captured per thread: a loop orphaned by a
        # timed-out stop() keeps its own SET event and dies at the next
        # wake even after start() arms a fresh one — never two pollers
        while not stop.wait(self.poll_s):
            try:
                self.poll_once()
            except Exception:  # noqa: BLE001 — the watcher must never
                # die: a malformed /fleet/membership body (proxy error
                # page behind a 200) or a user on_shrink callback that
                # raises would otherwise silently kill the thread, and
                # every later shrink would go unobserved — the exact
                # dead-collective hang this watcher exists to prevent
                pass

    def start(self) -> "MembershipWatcher":
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, args=(self._stop,), daemon=True,
            name="mmlspark-membership-watcher")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout=self.poll_s + self.timeout_s + 1.0)
        self._thread = None


class RoutingClient:
    """Client-side router over the driver's table: round robin by default,
    or deterministic key-hash routing (``MultiChannelMap.nextList``'s
    request sharding, client-side).  Refreshes the table on demand.

    Failover: a failed exchange refreshes the table and retries ONCE per
    remaining healthy worker candidate (``failover_retries``, default 1 —
    exactly one failover hop), always excluding workers that already failed
    this request so a retry can never land back on the dead socket.

    Per-worker circuit breakers (ROADMAP follow-up): every routed exchange
    feeds that worker's breaker; a worker whose breaker is OPEN is skipped
    at pick time — repeated failures stop costing a failed primary attempt
    per request during the eviction window.  If every candidate's breaker
    is open the pick falls back to ignoring breaker state (shedding 100% of
    traffic client-side is worse than probing).  ``breaker_factory=None``
    keeps the default breaker; pass a factory for custom thresholds, or
    ``per_worker_breakers=False`` to disable.  Request/failover counters
    land per worker in the registry.

    Tail tolerance:

    - **Retry budget** — failover retries (and hedges) draw from a shared
      token-bucket :class:`RetryBudget` that deposits per first-try
      request: under a full outage, attempted exchanges stay within
      ``(1 + ratio) x`` offered load instead of amplifying into a retry
      storm.  ``retry_budget_ratio=None`` disables the budget; pass
      ``retry_budget=`` to inject one (e.g. ``initial=0.0`` for the exact
      asymptotic bound).  Bookings:
      ``mmlspark_retry_budget_{granted,denied}_total``.
    - **Hedged requests** (``hedge=True``, off by default: a hedge is a
      deliberate traffic duplicate) — once the first exchange outlives
      the rolling-p95 hedge delay (over the last ``hedge_window``
      successful exchange latencies; no hedging until
      ``hedge_min_samples`` exist), ONE speculative duplicate goes to a
      *different* worker and the first response wins.  Bookings:
      ``mmlspark_hedges_total{outcome}``.
    - **Retry-After cooldown** — a 503 shed carrying ``Retry-After`` puts
      that worker on a pick-time cooldown instead of charging its breaker
      (a shed is backpressure by design, not a fault) — the very next
      request routes elsewhere instead of re-picking the shedding worker.
    - **Draining exclusion** — workers whose membership row carries
      ``state="draining"`` are skipped at pick time (falling back to them
      only when nobody else is left).
    """

    def __init__(self, driver_address: str, refresh_s: float = 5.0,
                 failover_retries: int = 1, registry=None,
                 per_worker_breakers: bool = True,
                 breaker_factory: Optional[Callable[[str], CircuitBreaker]] = None,
                 clock: Callable[[], float] = time.monotonic,
                 retry_budget: Optional[RetryBudget] = None,
                 retry_budget_ratio: Optional[float] = 0.1,
                 hedge: bool = False, hedge_window: int = 64,
                 hedge_min_samples: int = 8,
                 hedge_min_delay_s: float = 0.05):
        self.driver_address = driver_address.rstrip("/")
        self.refresh_s = refresh_s
        self.failover_retries = max(0, failover_retries)
        self.clock = clock
        self.registry = registry if registry is not None else get_registry()
        self.per_worker_breakers = per_worker_breakers
        self.breaker_factory = breaker_factory or (
            lambda sid: CircuitBreaker(failure_threshold=5, window_s=30.0,
                                       cooldown_s=5.0, clock=self.clock,
                                       name=f"worker:{sid}"))
        self.breakers: Dict[str, CircuitBreaker] = {}
        if retry_budget is not None:
            self.retry_budget: Optional[RetryBudget] = retry_budget
        elif retry_budget_ratio is not None:
            self.retry_budget = RetryBudget(ratio=retry_budget_ratio)
        else:
            self.retry_budget = None
        self.hedge = hedge
        self.hedge_min_samples = max(1, int(hedge_min_samples))
        self.hedge_min_delay_s = float(hedge_min_delay_s)
        self._lat_window: "deque" = deque(maxlen=max(1, int(hedge_window)))
        # per-worker Retry-After cooldown: sid -> clock() time the shed
        # verdict expires (consulted at pick time, like breakers)
        self._cooldown: Dict[str, float] = {}
        self._m_requests = self.registry.counter(
            "mmlspark_routing_requests_total",
            "routed exchanges by worker and outcome",
            labels=("worker", "result"))
        self._m_failovers = self.registry.counter(
            "mmlspark_routing_failovers_total",
            "failover hops away from a failed worker", labels=("worker",))
        self._m_hedges = self.registry.counter(
            "mmlspark_hedges_total",
            "speculative duplicate exchanges by outcome",
            labels=("outcome",))
        self._m_budget_granted = self.registry.counter(
            "mmlspark_retry_budget_granted_total",
            "retry/hedge attempts the token-bucket budget allowed")
        self._m_budget_denied = self.registry.counter(
            "mmlspark_retry_budget_denied_total",
            "retry/hedge attempts suppressed by an exhausted budget")
        # attribution: a hedge leg that completes 200 after the
        # race was lost produced a whole reply the caller discards — its
        # decode tokens book as hedge_loser waste, client-side (only the
        # client knows which leg lost)
        self._c_tok_outcome = attribution_instruments(self.registry)["tokens"]
        self._table: List[Dict] = []
        self._fetched = 0.0
        self._rr = 0
        self._lock = make_lock("RoutingClient._lock")

    def _breaker_for(self, sid: str) -> Optional[CircuitBreaker]:
        if not self.per_worker_breakers:
            return None
        with self._lock:
            b = self.breakers.get(sid)
            if b is None:
                b = self.breakers[sid] = instrument_breaker(
                    self.breaker_factory(sid), self.registry)
            return b

    def _refresh(self, force: bool = False):
        now = time.monotonic()
        if force or not self._table or now - self._fetched > self.refresh_s:
            table = _http_json(f"{self.driver_address}/routing")
            with self._lock:
                self._table = sorted(table.values(),
                                     key=lambda w: w["server_id"])
                self._fetched = now
                # a worker id the topology no longer routes to (evicted or
                # deregistered) takes its breaker with it: the breaker dict
                # entry AND its state/failure-rate gauge series would
                # otherwise grow without bound under fresh-id churn and
                # scrape frozen values forever.
                # A re-registered id simply gets a fresh breaker.
                live = {w["server_id"] for w in self._table}
                dead = [(sid, self.breakers.pop(sid))
                        for sid in list(self.breakers) if sid not in live]
                # cooldown hygiene rides the same sweep: a departed
                # worker's Retry-After verdict must not outlive its row
                for sid in list(self._cooldown):
                    if sid not in live:
                        del self._cooldown[sid]
            for _sid, breaker in dead:  # registry ops outside our lock
                uninstrument_breaker(breaker, self.registry)

    def _pick(self, key: Optional[str], exclude=()) -> Dict:
        self._refresh()
        with self._lock:
            candidates = [w for w in self._table
                          if w["server_id"] not in exclude]
            if not candidates:
                raise RuntimeError(
                    "no serving workers registered" if not self._table
                    else "no healthy serving workers left to fail over to")
            # a draining worker sheds everything it is sent: skip it at
            # pick time, falling back only when nobody else is left (its
            # fast 503 still beats "no workers" for the caller)
            up = [w for w in candidates if w.get("state") != "draining"]
            if up:
                candidates = up
            # Retry-After cooldown: a worker that shed with an explicit
            # back-off verdict is skipped until it expires — same
            # last-resort fall-back as breakers
            now = self.clock()
            cool = [w for w in candidates
                    if self._cooldown.get(w["server_id"], 0.0) <= now]
            if cool:
                candidates = cool
            if self.per_worker_breakers:
                # skip workers whose breaker is open; keep them as a last
                # resort when every candidate is open
                closed = [w for w in candidates
                          if (b := self.breakers.get(w["server_id"])) is None
                          or b.state != "open"]
                if closed:
                    candidates = closed
            if key is not None:
                # stable across processes/restarts (builtin hash is salted),
                # so partition affinity survives like MultiChannelMap's
                import zlib
                return candidates[zlib.crc32(key.encode()) % len(candidates)]
            w = candidates[self._rr % len(candidates)]
            self._rr += 1
            return w

    @staticmethod
    def _shed_retry_after(e) -> Optional[float]:
        """The cooldown a 503 shed's ``Retry-After`` header asks for, or
        None when ``e`` is not a shed (or carries no parseable header)."""
        if not (isinstance(e, urllib.error.HTTPError) and e.code == 503):
            return None
        try:
            ra = e.headers.get("Retry-After") if e.headers is not None \
                else None
            return float(ra) if ra is not None else None
        except (TypeError, ValueError):
            return None

    def _attempt(self, w: Dict, payload, timeout: float,
                 deadline: Optional[Deadline]):
        """One exchange against one worker with ALL per-worker bookkeeping
        — breaker feed, Retry-After shed cooldown, request counter, hedge
        latency window.  Never raises; returns a verdict pair:

        - ``("ok", out)`` — success;
        - ``("raise", e)`` — 4xx: a verdict on the REQUEST, not the worker
          (the caller re-raises; retrying elsewhere wastes a hop and five
          bad payloads must never trip a healthy worker's breaker);
        - ``("deadline", e)`` — the budget ran out mid-exchange: ambiguous
          evidence, so nothing is booked against the worker;
        - ``("err", e)`` — a failure the caller may fail over from.
        """
        sid = w["server_id"]
        url = f"http://{w['host']}:{w['port']}{w.get('api_path', '/score')}"
        breaker = self._breaker_for(sid)
        t0 = self.clock()
        try:
            out = _http_json(url, payload, timeout=timeout,
                             deadline=deadline)
        except Exception as e:  # noqa: BLE001 — verdict, not propagation
            if isinstance(e, urllib.error.HTTPError) and e.code < 500:
                return ("raise", e)
            if deadline is not None and deadline.expired():
                return ("deadline", e)
            cooldown_s = self._shed_retry_after(e)
            if cooldown_s is not None:
                # a shed is backpressure by design, not a fault: honor the
                # worker's Retry-After with a pick-time cooldown instead
                # of charging its breaker — and stop re-picking it on the
                # very next request
                with self._lock:
                    self._cooldown[sid] = self.clock() + cooldown_s
                self._m_requests.inc(worker=sid, result="shed")
            else:
                if breaker is not None:
                    breaker.record_failure()
                self._m_requests.inc(worker=sid, result="fail")
            return ("err", e)
        if breaker is not None:
            if breaker.state == "half_open":
                # the routing path filters on state at pick time rather
                # than calling allow() (probe-slot leaks on the bail-out
                # paths would pin the breaker), so a successful exchange
                # against a half-open worker is accounted as the probe it
                # de-facto was: take a slot, then record — the success
                # closes it
                breaker.allow()
            breaker.record_success()
        self._m_requests.inc(worker=sid, result="ok")
        with self._lock:
            # successful exchange latencies drive the rolling-p95 hedge
            # delay; failures stay out (a hung worker must not teach the
            # hedger that "slow is normal")
            self._lat_window.append(max(0.0, self.clock() - t0))
        return ("ok", out)

    def _hedge_delay_s(self) -> Optional[float]:
        """Rolling p95 of recent successful exchange latencies (floored at
        ``hedge_min_delay_s``), or None while the window is too thin to
        trust — no hedging during cold start."""
        with self._lock:
            n = len(self._lat_window)
            if n < self.hedge_min_samples:
                return None
            lats = sorted(self._lat_window)
        return max(self.hedge_min_delay_s, lats[min(n - 1, int(0.95 * n))])

    def _hedged_exchange(self, w: Dict, payload, key: Optional[str],
                         timeout: float, deadline: Optional[Deadline],
                         tried: set):
        """The first attempt with latency hedging: run the primary
        exchange; once it outlives the hedge delay, issue ONE speculative
        duplicate to a *different* worker and return whichever response
        lands first.  The losing leg finishes its own (per-worker)
        bookkeeping on its daemon thread.  Failed legs land in ``tried``
        so a later failover never re-picks them."""
        delay = self._hedge_delay_s()
        if delay is None:
            return self._attempt(w, payload, timeout, deadline)
        results: "queue.Queue" = queue.Queue()
        race = {"winner": None}
        race_lock = make_lock("RoutingClient._race_lock")

        def leg(name: str, wk: Dict) -> None:
            res = self._attempt(wk, payload, timeout, deadline)
            lost = False
            with race_lock:
                if res[0] == "ok":
                    if race["winner"] is None:
                        race["winner"] = name
                    else:
                        lost = True
            if lost:
                # the race already had a winner when this 200 landed: the
                # whole reply is discarded device work
                self._book_hedge_loser(res[1])
            results.put((name, wk["server_id"], res))

        threading.Thread(target=leg, args=("primary", w), daemon=True,
                         name="mmlspark-hedge-primary").start()
        try:
            _name, _sid, res = results.get(timeout=delay)
            return res  # primary beat the hedge delay: no duplicate issued
        except queue.Empty:
            pass
        # the primary outlived the p95 delay — speculate, to a different
        # worker; a hedge is a retry in disguise, so it draws from the
        # same budget (a storm of hedges is still a retry storm)
        hw = None
        try:
            hw = self._pick(key, exclude=tried | {w["server_id"]})
        except RuntimeError:
            pass
        if hw is None:
            self._m_hedges.inc(outcome="no_candidate")
        elif self.retry_budget is not None \
                and not self.retry_budget.try_withdraw():
            self._m_budget_denied.inc()
            self._m_hedges.inc(outcome="budget_denied")
            hw = None
        else:
            if self.retry_budget is not None:
                self._m_budget_granted.inc()
            threading.Thread(target=leg, args=("hedge", hw), daemon=True,
                             name="mmlspark-hedge-dup").start()
        # collect until the first success (or every launched leg failed);
        # each leg's exchange is bounded by `timeout`, so the collection
        # loop is too — no unbounded wait
        legs = 1 if hw is None else 2
        t_end = time.monotonic() + timeout + 1.0
        raise_res = deadline_res = err_res = None
        for _ in range(legs):
            try:
                name, sid, res = results.get(
                    timeout=max(0.05, t_end - time.monotonic()))
            except queue.Empty:
                break
            if res[0] == "ok":
                if hw is not None:
                    self._m_hedges.inc(
                        outcome="hedge_won" if name == "hedge"
                        else "primary_won")
                return res
            tried.add(sid)
            if res[0] == "raise":
                raise_res = res
            elif res[0] == "deadline":
                deadline_res = deadline_res or res
            else:
                err_res = err_res or res
        if hw is not None:
            self._m_hedges.inc(outcome="both_failed")
        return raise_res or err_res or deadline_res or \
            ("err", TimeoutError("hedged exchange produced no result"))

    def _book_hedge_loser(self, reply) -> None:
        """Book a discarded-but-completed hedge reply's decode tokens as
        ``hedge_loser`` waste.  The reply shape is the decode scorer's: a
        token list, possibly wrapped in ``{"tokens": ...}`` (report_ttft)
        and possibly one-row nested; an unparseable reply books nothing —
        attribution must never fail a request path."""
        body = reply.get("tokens") if isinstance(reply, dict) else reply
        if isinstance(body, (list, tuple)):
            if len(body) == 1 and isinstance(body[0], (list, tuple)):
                body = body[0]
            n = len(body)
        else:
            n = 0
        if n > 0:
            self._c_tok_outcome.inc(n, outcome="hedge_loser")

    def request(self, payload, key: Optional[str] = None,
                timeout: float = 30.0, retries: Optional[int] = None,
                deadline: Optional[Deadline] = None):
        """POST to the routed worker; on failure, refresh the table and fail
        over to the next healthy worker — exactly once per extra attempt
        (the LB behavior the reference delegates to Azure LB,
        ``docs/mmlspark-serving.md:87``).  The ambient/explicit deadline
        clips every attempt's timeout.  Failover retries draw from the
        retry budget; with ``hedge=True`` the first attempt may issue one
        speculative duplicate (see the class docstring)."""
        deadline = deadline or current_deadline()
        failovers = self.failover_retries if retries is None else max(0, retries)
        if self.retry_budget is not None:
            # one deposit per OFFERED request: first tries fund retries
            self.retry_budget.deposit()
        tried: set = set()
        last = None
        failed_over_from: Optional[str] = None
        first_attempt = True
        for _ in range(failovers + 1):
            if deadline is not None and deadline.expired():
                # the CALLER's budget is gone — a client-side condition, not
                # a worker failure: raise without feeding any breaker or
                # failover counter (five tight-deadline requests must never
                # trip a healthy worker's breaker)
                raise last or TimeoutError("deadline exceeded before request")
            try:
                w = self._pick(key, exclude=tried)
            except RuntimeError:
                if last is None:
                    raise  # empty table and nothing attempted yet
                break  # nobody left to fail over to
            sid = w["server_id"]
            if not first_attempt and self.retry_budget is not None:
                # a failover retry spends a token; an exhausted budget ends
                # the request instead of amplifying the outage
                if not self.retry_budget.try_withdraw():
                    self._m_budget_denied.inc()
                    break
                self._m_budget_granted.inc()
            if failed_over_from is not None:
                # a HOP is real only once a next candidate is attempted —
                # a terminal failure with nobody left must not count one
                self._m_failovers.inc(worker=failed_over_from)
                failed_over_from = None
            if first_attempt and self.hedge:
                verdict, out = self._hedged_exchange(
                    w, payload, key, timeout, deadline, tried)
            else:
                verdict, out = self._attempt(w, payload, timeout, deadline)
            first_attempt = False
            if verdict == "ok":
                return out
            if verdict == "raise":
                raise out
            if verdict == "deadline":
                raise last or out
            last = out
            tried.add(sid)
            failed_over_from = sid
            try:  # a briefly-unreachable driver must not abort the
                self._refresh(force=True)  # retry; stale table still works
            except Exception:  # noqa: BLE001
                pass
            key = None  # reroute away from the dead worker
        raise RuntimeError(f"all serving workers failed: {last}")

    def stats(self) -> Dict:
        return _http_json(f"{self.driver_address}/stats")
