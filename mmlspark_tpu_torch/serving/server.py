"""Serving — low-latency model web service over pipeline transforms.

Reference: Spark Serving (``core/src/main/scala/org/apache/spark/sql/
execution/streaming/``, SURVEY.md §2.7):
- v1 head-node ``HTTPSource``/``HTTPSink`` (requests buffered as micro-batch
  offsets, replies matched by uuid);
- ``DistributedHTTPSource`` (per-executor ``JVMSharedServer`` +
  ``MultiChannelMap`` request sharding);
- v2 continuous mode (sub-ms replies; worker servers reply directly via
  ``HTTPSourceStateHolder.replyTo``).

An own copy of the JAX package's ``serving/server.py``, verbatim apart
from module paths; its lazy imports reach the port's twins of
``observability.compute`` and ``observability.profiling``.  The server is
host-side Python (threaded HTTP, as the reference's is JVM HttpServer);
scoring goes through a pipeline whose runner pads to power-of-two buckets,
so the device sees a few steady batch shapes.  ``continuous`` mode drains
whatever is queued into one dynamic micro-batch per transform (the latency/
throughput trick the reference gets from continuous processing);
``micro_batch`` mode flushes on a trigger interval.
"""
from __future__ import annotations

import itertools
import json
import math
import queue
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ..core import DataFrame, Transformer
from ..observability import get_registry
from ..observability.collector import get_collector
from ..observability.tracing import (Span, TRACE_HEADER, TRACEPARENT_HEADER,
                                     export_span, format_traceparent,
                                     new_trace_id, parse_traceparent,
                                     trace_span)
from ..utils.concurrency import make_lock
from ..utils.resilience import (Deadline, deadline_scope,
                                register_preemption_hook,
                                unregister_preemption_hook)

# entry ids need uniqueness within the process, not entropy: uuid4's
# per-call os.urandom syscall (~40 us on this kernel) sat inside the
# serialized admission path — same counter pattern as span ids in
# observability/tracing.py.  itertools.count.__next__ is atomic under
# the GIL, so handler threads share it without a lock.
_ENTRY_IDS = itertools.count()


@dataclass
class _Entry:
    uid: str
    payload: Any
    headers: Dict[str, str]
    done: threading.Event = field(default_factory=threading.Event)
    reply: Any = None
    status: int = 200
    # absolute expiry on the server clock; a plain float (not a Deadline
    # object) keeps the per-request hot path allocation-free
    t_deadline: float = float("inf")
    t_enq: float = 0.0
    retry_after_s: Optional[float] = None
    trace_id: str = ""
    # set when the request carried a W3C traceparent: the reply echoes one
    # back with the server-side request span's id
    echo_traceparent: bool = False
    span_id: str = ""  # serving.request span id, filled by the scorer
    # stable prompt identity: set at continuous admission when
    # the front accepts prompt_hash=; lands on the request record so
    # /debug/requests correlates hits with their prefill_cached lane
    prompt_hash: Optional[str] = None


class ServingStats:
    """Request counters (reference DistributedHTTPSource.scala:99-110).

    Each request is counted EXACTLY once by its handler thread:
    ``replied`` (200 written), ``errors`` (500/504/failed write), or
    ``shed`` (503 load shed).  At quiescence
    ``received == replied + errors + shed``; mid-flight, admitted-but-
    unresolved requests make up the difference.

    ``latency_sum`` is paired with ``latency_count`` (both fed only by 200s,
    under one lock) so consumers always compute a correct average — dividing
    by ``replied`` raced the reply-before-latency window and broke down once
    shed/error replies existed.
    """

    def __init__(self):
        self.lock = make_lock("ServingStats.lock")
        self.received = 0
        self.replied = 0
        self.errors = 0
        self.shed = 0
        self.latency_sum = 0.0
        self.latency_count = 0

    def as_dict(self):
        with self.lock:
            avg_ms = 1000.0 * self.latency_sum / max(1, self.latency_count)
            return {"received": self.received, "replied": self.replied,
                    "errors": self.errors, "shed": self.shed,
                    "latency_sum_s": self.latency_sum,
                    "latency_count": self.latency_count,
                    "latency_avg_ms": avg_ms,
                    # legacy name kept for aggregators; same correct value
                    "mean_latency_ms": avg_ms}


class PipelineServer:
    """Serve a fitted pipeline as a JSON web service.

    POST <api_path> with a JSON object (one row) -> JSON reply from
    ``reply_col``.  GET /stats -> counters; GET /health -> ok;
    GET /metrics -> Prometheus exposition (with exemplars);
    GET /trace/<id> -> assembled span tree for a recent trace;
    GET /debug/slow[?k=N] -> top-K slowest recent requests with phase
    breakdown and shed/deadline verdict (see docs/OBSERVABILITY.md,
    "Debugging a slow request");
    GET /debug/compile -> compute-plane compile state (per-function compile
    counts, abstract signatures, last cost analysis, recompile-storm trips);
    GET /debug/requests[?k=&class=&verdict=] -> newest-first canonical
    request records with per-request cost stanzas.

    Graceful degradation: admission is bounded — once ``max_queue_depth``
    requests are in flight, further POSTs are shed immediately with 503 +
    ``Retry-After`` instead of queueing toward certain timeout (the
    reference's LB would do this upstream; in-process we must).  Each
    request carries a deadline (``X-MMLSpark-Deadline-Ms`` header if the
    client sent one, else ``request_timeout_s``); the scorer drops entries
    whose budget expired in the queue (504) or whose queue age exceeds
    ``max_queue_age_s`` (503) without wasting device time on them.
    """

    def __init__(self, model: Transformer, input_col: str = "request",
                 reply_col: str = "reply", host: str = "127.0.0.1",
                 port: int = 8899, api_path: str = "/score",
                 mode: str = "continuous", max_batch: int = 64,
                 micro_batch_interval_ms: int = 10,
                 input_parser: Optional[Callable[[bytes], Any]] = None,
                 reply_encoder: Optional[Callable[[Any], Any]] = None,
                 request_timeout_s: float = 30.0,
                 max_queue_depth: int = 256,
                 max_queue_age_s: Optional[float] = None,
                 shed_retry_after_s: float = 1.0,
                 clock: Callable[[], float] = time.monotonic,
                 registry=None,
                 shed_queue_delay_ewma_s: Optional[float] = None,
                 ewma_alpha: float = 0.2,
                 micro_batch_deadline_margin_s: float = 0.0,
                 micro_batch_ewma_flush_s: Optional[float] = None,
                 slow_k: int = 10,
                 drain_timeout_s: Optional[float] = 30.0,
                 request_class: str = "default",
                 request_record_k: int = 256):
        if mode not in ("continuous", "micro_batch"):
            raise ValueError("mode must be continuous|micro_batch")
        self.model = model
        # continuous admission protocol: a model exposing
        # `continuous_submit(payload, resolve, queue_age_s=,
        # deadline_budget_s=)` (the runner's continuous decode scorer)
        # gets each drained entry
        # handed to it the moment the drain sees it — the entry resolves
        # per request from the model's own engine instead of with the
        # batch, so a finished sequence replies while the rest keep
        # decoding.  Duck-typed so serving never imports the models
        # package (a pure-python pipeline must not pay a torch import).
        self._continuous_submit = getattr(model, "continuous_submit", None)
        # `trace_id=` (the TTFT exemplar rides it to the engine thread)
        # is forwarded only to fronts that declare it — the continuous
        # protocol is duck-typed, and an existing front must not start
        # throwing TypeError because the server learned a new kwarg
        self._submit_takes_trace = False
        # `prompt_hash=` (the prefix-cache admission seam — a
        # stable identity for the request's prompt, recorded on the
        # stream handle and the request record) rides the same duck-typed
        # introspection as trace_id
        self._submit_takes_hash = False
        if self._continuous_submit is not None:
            try:
                import inspect as _inspect
                params = _inspect.signature(
                    self._continuous_submit).parameters
                var_kw = any(p.kind is _inspect.Parameter.VAR_KEYWORD
                             for p in params.values())
                self._submit_takes_trace = "trace_id" in params or var_kw
                self._submit_takes_hash = "prompt_hash" in params or var_kw
            except (TypeError, ValueError):
                pass
        self.input_col, self.reply_col = input_col, reply_col
        self.host, self.port, self.api_path = host, port, api_path
        self.mode = mode
        self.max_batch = max_batch
        self.interval_ms = micro_batch_interval_ms
        self.input_parser = input_parser or (lambda b: json.loads(b.decode() or "null"))
        self.reply_encoder = reply_encoder or _default_encode
        self.request_timeout_s = request_timeout_s
        self.max_queue_depth = max_queue_depth
        self.max_queue_age_s = max_queue_age_s
        self.shed_retry_after_s = shed_retry_after_s
        self.clock = clock
        self.stats = ServingStats()
        self._pending = 0  # admitted, not yet resolved (guarded by stats.lock)
        # adaptive shedding signal: EWMA of per-entry queue delay, updated by
        # the scorer, read at admission (guarded by stats.lock).  Shedding on
        # it only engages while a backlog exists (_pending > 0), so a drained
        # server always admits again — no lockout after a latency spike.
        self.shed_queue_delay_ewma_s = shed_queue_delay_ewma_s
        self.ewma_alpha = float(ewma_alpha)
        self._queue_ewma = 0.0
        # micro-batch early flush: never wait out the trigger interval past
        # the point where the tightest drained entry's deadline (minus this
        # reserved scoring margin) would expire in the batch buffer
        self.micro_batch_deadline_margin_s = float(micro_batch_deadline_margin_s)
        # EWMA-predicted early flush: once the
        # scorer-maintained queue-delay EWMA says entries are already
        # paying this much delay, waiting out the rest of the trigger
        # interval costs more latency than the batch amortization gains —
        # take what is queued and flush now.  None = off.
        self.micro_batch_ewma_flush_s = micro_batch_ewma_flush_s
        # /debug/slow default depth
        self.slow_k = int(slow_k)
        # graceful drain: once draining, admission sheds with
        # 503 "draining" + Connection: close, the continuous engine stops
        # accepting joins while existing slots run to eos/budget, and the
        # server stops only after everything admitted resolved — a rolling
        # restart drops zero in-flight requests.  The SIGTERM/preemption
        # hook drains with this default budget.
        self.drain_timeout_s = drain_timeout_s
        self._draining = threading.Event()
        self._drained = threading.Event()
        self._drain_lock = make_lock("PipelineServer._drain_lock")
        self._preemption_hook = None
        # metrics: families on the (shared, injectable) registry; children
        # are labelled per server instance once the port is resolved so many
        # servers coexist in one registry/process
        self.registry = registry if registry is not None else get_registry()
        self._server_label = f"{host}:{port}"
        reg = self.registry
        self._m_requests = reg.counter(
            "mmlspark_serving_requests_total",
            "requests by terminal status (received counts admissions+sheds)",
            labels=("server", "status"))
        self._m_latency = reg.histogram(
            "mmlspark_serving_request_latency_seconds",
            "end-to-end latency of 200 replies", labels=("server",))
        self._m_phase = reg.histogram(
            "mmlspark_serving_phase_seconds",
            "per-request time split: queue wait vs batch score",
            labels=("server", "phase"))
        self._m_queue_depth = reg.gauge(
            "mmlspark_serving_queue_depth",
            "admitted-but-unresolved requests", labels=("server",))
        self._m_queue_age = reg.gauge(
            "mmlspark_serving_queue_oldest_age_seconds",
            "age of the oldest queued entry (0 when empty)",
            labels=("server",))
        self._m_ewma = reg.gauge(
            "mmlspark_serving_queue_delay_ewma_seconds",
            "EWMA of per-entry queue delay (adaptive shed signal)",
            labels=("server",))
        self._m_drain = reg.histogram(
            "mmlspark_serving_drain_seconds",
            "graceful-drain duration: draining flag set -> server stopped",
            labels=("server",))
        # profiling + postmortem plane: families registered at
        # construction (coverage-gated), and the per-registry flight
        # recorder created with its crash/preemption hooks installed so
        # every serving process records — /debug/profile and /debug/dump
        # serve from these
        from ..observability.flightrecorder import get_flight_recorder
        from ..observability.profiling import profiler_instruments
        profiler_instruments(reg)
        self._recorder = get_flight_recorder(reg)
        # goodput & cost attribution: this server's request
        # class labels the fleet cost rollups, and every terminal request
        # emits one bounded canonical record (trace id, class, verdict,
        # cost stanza) into the ring behind GET /debug/requests — also the
        # flight recorder's `source.requests:<addr>` postmortem section
        from ..observability.attribution import (RequestRecordRing,
                                                 attribution_instruments)
        self.request_class = str(request_class)
        self._records = RequestRecordRing(request_record_k)
        _att = attribution_instruments(reg)
        self._c_class_tokens = _att["class_tokens"].labels(
            **{"class": self.request_class})
        self._c_class_device = _att["class_device"].labels(
            **{"class": self.request_class})
        self._record_source: Optional[str] = None
        # pre-start sinks: port=0 is unresolved, and registering children
        # under "host:0" would leave a ghost zero series in the (usually
        # shared) registry for every constructed-but-restarted server.
        # start() re-binds to real labelled children.
        self._c_status = {s: self._m_requests.detached_child()
                          for s in self._STATUSES}
        self._h_latency = self._m_latency.detached_child()
        self._h_phase_queue = self._m_phase.detached_child()
        self._h_phase_score = self._m_phase.detached_child()
        self._h_drain = self._m_drain.detached_child()
        self._q: "queue.Queue[_Entry]" = queue.Queue()
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._threads: List[threading.Thread] = []
        self._stop = threading.Event()
        # continuous-mode fast path: an idle handler thread scores its own
        # request inline instead of paying two thread hand-offs through the
        # queue (reference continuous mode reaches ~1 ms,
        # docs/mmlspark-serving.md:10-11; the hand-off alone costs ~0.5 ms)
        self._inline_lock = make_lock("PipelineServer._inline_lock")

    _STATUSES = ("received", "replied", "shed", "error", "write_error")

    def _bind_metric_children(self) -> None:
        """Resolve this server's labelled children ONCE (per-call label
        resolution costs a dict+tuple build inside the serialized scoring
        section); called by start() with the resolved port.  Also pre-creates
        the known status series at 0 so scrapers always see shed/error
        counters (a rate() over a series born mid-incident would miss its
        first increment)."""
        label = self._server_label
        self._c_status = {
            s: self._m_requests.labels(server=label, status=s)
            for s in self._STATUSES}
        self._h_latency = self._m_latency.labels(server=label)
        self._h_phase_queue = self._m_phase.labels(server=label, phase="queue")
        self._h_phase_score = self._m_phase.labels(server=label, phase="score")
        self._h_drain = self._m_drain.labels(server=label)

    # ------------------------------------------------------------------ http
    def _make_handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            # HTTP/1.1: persistent connections.  Every reply carries an
            # explicit Content-Length, so keep-alive is safe and a client
            # scoring a stream of rows pays TCP/handshake setup once, not
            # per request (the reference's continuous-mode latency claim
            # assumes exactly this client pattern).
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):  # quiet
                pass

            def do_GET(self):
                if self.path == "/health":
                    # health is the eviction signal: TopologyService probes
                    # GET this and treat non-200 as unhealthy.  Draining
                    # (about to stop) and an unhealthy model (duck-typed
                    # `serving_healthy` — a quarantined decode engine flips
                    # it) must both fail the probe so routing stops sending
                    # work here.
                    if server.draining:
                        self._write_raw(503, b"draining", b"text/plain")
                    elif not getattr(server.model, "serving_healthy", True):
                        self._write_raw(503, b"unhealthy", b"text/plain")
                    else:
                        self._write_raw(200, b"ok", b"text/plain")
                elif self.path == "/stats":
                    d = server.stats.as_dict()
                    with server.stats.lock:
                        d["pending"] = server._pending
                        d["queue_delay_ewma_ms"] = 1000.0 * server._queue_ewma
                    d["draining"] = server.draining
                    # every breaker instrumented into this registry, with
                    # state / consecutive failures / rolling failure rate
                    d["breakers"] = server.registry.breaker_stats()
                    # a checkpointing worker reports its worst last-success
                    # age so the fleet aggregator can page on "checkpoints
                    # stopped landing" fleet-wide; absent when
                    # nothing in this process checkpoints
                    age = server._checkpoint_age_s()
                    if age is not None:
                        d["checkpoint_last_success_age_seconds"] = age
                    self._write_raw(200, json.dumps(d).encode())
                elif self.path == "/metrics":
                    # content negotiation: exemplars are only legal under
                    # the OpenMetrics content type — a 0.0.4 parser reads
                    # the ` # {...}` suffix as a malformed timestamp and
                    # fails the ENTIRE scrape.  Prometheus asks for
                    # OpenMetrics explicitly when it wants exemplars.
                    accept = self.headers.get("Accept", "")
                    if "application/openmetrics-text" in accept:
                        body = (server.registry.to_prometheus(openmetrics=True)
                                + "# EOF\n").encode()
                        ctype = (b"application/openmetrics-text; "
                                 b"version=1.0.0; charset=utf-8")
                    else:
                        body = server.registry.to_prometheus().encode()
                        ctype = b"text/plain; version=0.0.4; charset=utf-8"
                    self._write_raw(200, body, ctype)
                elif self.path.startswith("/trace/"):
                    # slow-request diagnostics: a /metrics exemplar's trace
                    # id resolves here to the assembled span tree while the
                    # trace is still in the collector ring
                    trace_id = self.path[len("/trace/"):]
                    tree = get_collector(server.registry).trace_tree(trace_id)
                    if tree is None:
                        self._respond(404, {"error": "unknown or evicted "
                                                     "trace", "traceId": trace_id})
                    else:
                        self._respond(200, tree)
                elif self.path == "/debug/compile":
                    # compute-plane diagnostics: per-instrumented-function
                    # compile counts, abstract signatures, last cost
                    # analysis — the first stop when "score got slow" is
                    # actually a recompile storm below the host timings
                    from ..observability.compute import compile_report
                    self._respond(200, compile_report(server.registry))
                elif self.path.split("?", 1)[0] == "/debug/slow":
                    k = server.slow_k
                    query = self.path.partition("?")[2]
                    for part in query.split("&"):
                        if part.startswith("k="):
                            try:
                                k = int(part[2:])
                            except ValueError:
                                pass
                    slow = get_collector(server.registry).slowest(
                        k=k, name="serving.request",
                        server=server._server_label)
                    self._respond(200, {"server": server._server_label,
                                        "slowest": slow})
                elif self.path.split("?", 1)[0] == "/debug/profile":
                    # on-demand host-stack sampling window:
                    # blocks THIS handler thread for the window (other
                    # requests keep flowing — threaded server), attributes
                    # samples to ambient span names, 409 when a window is
                    # already running
                    from ..observability.profiling import (ProfilerBusy,
                                                           profile_window)
                    seconds, hz, idle = 2.0, None, False
                    query = self.path.partition("?")[2]
                    try:
                        for part in query.split("&"):
                            if part.startswith("seconds="):
                                seconds = float(part[len("seconds="):])
                            elif part.startswith("hz="):
                                hz = float(part[len("hz="):])
                            elif part.startswith("idle="):
                                idle = bool(int(part[len("idle="):]))
                    except ValueError:
                        self._respond(400, {"error": "seconds/hz/idle must "
                                                     "be numeric"})
                        return
                    try:
                        kw = {} if hz is None else {"hz": hz}
                        report = profile_window(seconds=seconds,
                                                registry=server.registry,
                                                include_idle=idle,
                                                **kw)
                    except ProfilerBusy as e:
                        self._write_raw(409, json.dumps(
                            {"error": str(e)}).encode())
                        return
                    self._respond(200, report)
                elif self.path.split("?", 1)[0] == "/debug/requests":
                    # canonical request records: newest-first,
                    # filterable by class/verdict — the wide-event ring a
                    # wasted-work investigation starts from (each record
                    # carries the request's full cost stanza)
                    k, klass, verdict = 50, None, None
                    query = self.path.partition("?")[2]
                    try:
                        for part in query.split("&"):
                            if part.startswith("k="):
                                k = int(part[len("k="):])
                            elif part.startswith("class="):
                                klass = part[len("class="):]
                            elif part.startswith("verdict="):
                                verdict = part[len("verdict="):]
                    except ValueError:
                        self._respond(400, {"error": "k must be an integer"})
                        return
                    self._respond(200, {
                        "server": server._server_label,
                        "class": server.request_class,
                        "appended": server._records.appended,
                        "records": server._records.query(
                            k=k, klass=klass, verdict=verdict)})
                elif self.path == "/debug/dump":
                    # on-demand flight-recorder snapshot: books the dump
                    # (and writes the file when a dump dir is configured),
                    # then serves the snapshot itself
                    from ..observability.flightrecorder import \
                        get_flight_recorder
                    rec = get_flight_recorder(server.registry)
                    path = rec.dump(trigger="http")
                    snap = dict(rec.last_snapshot or {})
                    snap["dump_path"] = path
                    self._respond(200, snap)
                else:
                    self._respond(404, {"error": "not found"})

            def do_POST(self):
                # ALWAYS drain the body first: on keep-alive connections an
                # unread body would be parsed as the next request line,
                # desynchronizing the stream after any error reply
                t0 = time.perf_counter()
                length = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(length)
                if self.path == "/admin/drain":
                    # kick the drain off-thread and ack immediately: drain
                    # blocks until in-flight slots finish, and the admin
                    # caller (an orchestrator mid rolling-restart) polls
                    # /stats or just watches the port close.  Idempotent —
                    # a second POST reports the drain already running.
                    timeout_s = server.drain_timeout_s
                    try:
                        req = json.loads(body.decode() or "{}")
                        if isinstance(req, dict) and "timeout_s" in req:
                            timeout_s = float(req["timeout_s"])
                    except (ValueError, TypeError):
                        self._respond(400, {"error": "timeout_s must be "
                                                     "numeric"})
                        return
                    already = server.draining
                    if not already:
                        threading.Thread(
                            target=server.drain,
                            kwargs={"timeout_s": timeout_s},
                            daemon=True, name="mmlspark-drain").start()
                    with server.stats.lock:
                        pending = server._pending
                    self._respond(200, {"draining": True,
                                        "already_draining": already,
                                        "pending": pending})
                    return
                if self.path != server.api_path:
                    self._respond(404, {"error": "not found"})
                    return
                try:
                    payload = server.input_parser(body)
                except Exception as e:  # noqa: BLE001
                    self._respond(400, {"error": f"bad request: {e}"})
                    return
                # the caller's remaining budget rides the deadline header;
                # without one the server default bounds the request
                t_enq = server.clock()
                budget_s = server.request_timeout_s
                hdr = self.headers.get(Deadline.HEADER)
                if hdr:
                    parsed = Deadline.parse_budget_s(hdr)
                    if parsed is not None:
                        budget_s = min(budget_s, parsed)
                # adopt the caller's trace id so the worker-side spans of
                # this request join the caller's trace: a W3C `traceparent`
                # wins (external frontends speak Trace
                # Context), else the legacy X-MMLSpark-Trace-Id, else fresh
                tp_in = self.headers.get(TRACEPARENT_HEADER)
                parsed_tp = parse_traceparent(tp_in) if tp_in else None
                if parsed_tp is not None:
                    trace_id = parsed_tp[0]
                else:
                    trace_id = self.headers.get(TRACE_HEADER) or new_trace_id()
                entry = _Entry(uid=f"e{next(_ENTRY_IDS):x}", payload=payload,
                               headers=dict(self.headers), t_enq=t_enq,
                               t_deadline=t_enq + budget_s,
                               trace_id=trace_id,
                               echo_traceparent=parsed_tp is not None)
                # bounded admission: shedding beats queueing toward a
                # certain timeout (503 tells the client to back off; 504
                # would have cost it request_timeout_s of waiting first)
                shed_reason = server._try_admit()
                trace_hdr = {TRACE_HEADER: trace_id}
                if entry.echo_traceparent:
                    # echoed next to the legacy header; the request span's
                    # id rides it once the scorer resolved the entry (the
                    # pre-score shed/timeout replies carry a fresh span id)
                    trace_hdr[TRACEPARENT_HEADER] = format_traceparent(
                        trace_id, entry.span_id or None)
                if shed_reason is not None:
                    extra = {"Retry-After":
                             _retry_after(server.shed_retry_after_s),
                             **trace_hdr}
                    if shed_reason == "draining":
                        # the server is going away: tell the client to tear
                        # the keep-alive connection down and re-resolve (a
                        # pooled connection to a draining server would just
                        # shed again until the port closes)
                        extra["Connection"] = "close"
                        self.close_connection = True
                    self._respond(503, {"error": f"overloaded: {shed_reason}"},
                                  extra_headers=extra)
                    return
                if server.mode == "continuous" and \
                        server._inline_lock.acquire(blocking=False):
                    try:  # idle scorer: skip the queue hand-off entirely
                        server._score_batch([entry])
                    finally:
                        server._inline_lock.release()
                else:
                    server._q.put(entry)
                # wait no longer than the caller still cares about
                if not entry.done.wait(budget_s):
                    self._respond(504, {"error": "timeout"},
                                  extra_headers=trace_hdr)
                    with server.stats.lock:
                        server.stats.errors += 1
                    server._c_status["error"].inc()
                    return
                # count BEFORE the socket write: a client that already holds
                # the reply must never observe its counter lagging (stats
                # aggregation raced the last in-flight write otherwise).  A
                # failed write rolls the count back as an error; latency is
                # sampled after the write so the metric's window is unchanged
                status = entry.status
                stats = server.stats
                extra = dict(trace_hdr)
                if entry.echo_traceparent and entry.span_id:
                    # the scorer resolved the request span: the echo now
                    # names the exact server-side span of this request
                    extra[TRACEPARENT_HEADER] = format_traceparent(
                        trace_id, entry.span_id)
                if status == 503:
                    extra["Retry-After"] = _retry_after(
                        entry.retry_after_s or server.shed_retry_after_s)
                try:
                    if status == 200:
                        with stats.lock:
                            stats.replied += 1
                        self._respond(200, entry.reply, extra_headers=extra)
                        # latency is a SUCCESS metric: only 200s may feed
                        # the (sum, count) pair — latency_avg divides by it
                        latency_s = time.perf_counter() - t0
                        with stats.lock:
                            stats.latency_sum += latency_s
                            stats.latency_count += 1
                        server._c_status["replied"].inc()
                        # exemplar: the bucket this latency lands in keeps
                        # this request's trace id — a p99 outlier on
                        # /metrics resolves to /trace/<id>
                        server._h_latency.observe(latency_s, trace_id)
                    elif status == 503:
                        with stats.lock:
                            stats.shed += 1
                        self._respond(503, entry.reply, extra_headers=extra)
                        server._c_status["shed"].inc()
                    else:
                        with stats.lock:
                            stats.errors += 1
                        self._respond(status, entry.reply, extra_headers=extra)
                        server._c_status["error"].inc()
                except Exception:  # any failed write: invariant must hold
                    # (the stats invariant rolls back exactly; monotonic
                    # registry counters book the write failure as an error
                    # instead — documented divergence in docs/OBSERVABILITY.md)
                    with stats.lock:
                        if status == 200:
                            stats.replied -= 1
                        elif status == 503:
                            stats.shed -= 1
                        else:
                            stats.errors -= 1
                        stats.errors += 1
                    server._c_status["write_error"].inc()
                    raise

            _STATUS = {200: b"200 OK", 400: b"400 Bad Request",
                       404: b"404 Not Found", 409: b"409 Conflict",
                       500: b"500 Internal Server Error",
                       503: b"503 Service Unavailable",
                       504: b"504 Gateway Timeout"}

            def _write_raw(self, status, body, ctype=b"application/json",
                           extra_headers=None):
                # one buffered write per reply: status line + headers + body
                # in a single syscall/TCP segment (the default handler path
                # issues one write per header, which interacts badly with
                # delayed ACKs on loopback)
                hdrs = b""
                for k, v in (extra_headers or {}).items():
                    hdrs += k.encode() + b": " + str(v).encode() + b"\r\n"
                self.wfile.write(
                    b"HTTP/1.1 " + self._STATUS.get(status, b"500 ISE")
                    + b"\r\nContent-Type: " + ctype
                    + b"\r\n" + hdrs
                    + b"Content-Length: " + str(len(body)).encode()
                    + b"\r\n\r\n" + body)

            def _respond(self, status, obj, extra_headers=None):
                self._write_raw(status, json.dumps(obj, default=str).encode(),
                                extra_headers=extra_headers)

        return Handler

    # ------------------------------------------------------------------ work
    def _try_admit(self) -> Optional[str]:
        """Count the request and decide admission; returns None when
        admitted (pending slot taken) or the shed reason.  Three signals
        shed:

        - ``draining`` — the server is emptying itself to stop (graceful
          drain); takes precedence over the load signals;
        - ``queue_full`` — fixed bound: ``_pending >= max_queue_depth``;
        - ``queue_delay_ewma`` — adaptive bound: the scorer-maintained EWMA
          of queue delay exceeds ``shed_queue_delay_ewma_s`` AND a backlog
          exists.  The backlog condition makes recovery automatic: once the
          queue drains, admission resumes regardless of the stale EWMA.
        """
        with self.stats.lock:
            self.stats.received += 1
            shed = None
            if self._draining.is_set():
                # draining beats every other signal: nothing new may join a
                # server that is emptying itself to stop
                shed = "draining"
            elif self._pending >= self.max_queue_depth:
                shed = "queue_full"
            elif self.shed_queue_delay_ewma_s is not None \
                    and self._pending > 0 \
                    and self._queue_ewma > self.shed_queue_delay_ewma_s:
                shed = "queue_delay_ewma"
            if shed is None:
                self._pending += 1
            else:
                self.stats.shed += 1
        self._c_status["received"].inc()
        if shed is not None:
            self._c_status["shed"].inc()
        return shed

    def _checkpoint_age_s(self) -> Optional[float]:
        """Max ``mmlspark_checkpoint_last_success_age_seconds`` across the
        registry's checkpoint sites, or None when nothing checkpoints here.
        The MAX is the pageable number: one stalled site is an outage even
        when the others keep landing.  Finite values only: ``inf`` (armed
        but never saved) would serialize as the non-RFC ``Infinity`` JSON
        literal strict clients reject — the never-saved state stays
        visible as ``+Inf`` on the ``/metrics`` text exposition."""
        fam = self.registry.family(
            "mmlspark_checkpoint_last_success_age_seconds")
        if fam is None:
            return None
        vals = [child.value for _key, child in fam._snapshot()]
        vals = [v for v in vals if math.isfinite(v)]
        return max(vals) if vals else None

    def _oldest_queue_age_s(self) -> float:
        """Age of the oldest queued (not yet drained) entry; gauge callback."""
        with self._q.mutex:
            head = self._q.queue[0] if self._q.queue else None
        return 0.0 if head is None else max(0.0, self.clock() - head.t_enq)

    def _drain(self) -> List[_Entry]:
        try:
            first = self._q.get(timeout=0.1)
        except queue.Empty:
            return []
        batch = [first]
        if self.mode == "micro_batch":
            flush_at = time.monotonic() + self.interval_ms / 1000.0
            if self.micro_batch_ewma_flush_s is not None:
                # EWMA-predicted trigger: the scorer's
                # queue-delay EWMA predicts what further waiting costs the
                # entries in hand.  Once the prediction eats the bound,
                # the batch gains cannot pay for the wait — take whatever
                # is queued and flush now; below the bound, pull the flush
                # point forward so total predicted delay stays bounded.
                # The EWMA only moves in _score_batch (this same worker
                # thread), so one read per drain is exact.
                with self.stats.lock:
                    predicted = self._queue_ewma
                ewma_slack_s = self.micro_batch_ewma_flush_s - predicted
                if ewma_slack_s <= 0:
                    while len(batch) < self.max_batch:
                        try:
                            batch.append(self._q.get_nowait())
                        except queue.Empty:
                            break
                    return batch
                flush_at = min(flush_at,
                               time.monotonic() + ewma_slack_s)
            while len(batch) < self.max_batch:
                wait_s = flush_at - time.monotonic()
                if wait_s <= 0:
                    break
                # deadline-aware trigger: waiting out the
                # full interval past the tightest admitted deadline would
                # turn a scoreable request into a certain 504 — flush as
                # soon as the most impatient entry's slack (minus the
                # margin reserved for scoring itself) runs out.  Entry
                # deadlines live on the injectable server clock; the
                # trigger interval stays on the wall clock.
                slack_s = min(e.t_deadline for e in batch) - self.clock() \
                    - self.micro_batch_deadline_margin_s
                if slack_s <= 0:
                    break
                try:
                    batch.append(self._q.get(timeout=min(wait_s, slack_s)))
                except queue.Empty:
                    break
        else:  # continuous: take whatever is already waiting
            while len(batch) < self.max_batch:
                try:
                    batch.append(self._q.get_nowait())
                except queue.Empty:
                    break
        return batch

    def _score_batch(self, batch: List[_Entry]) -> None:
        """Run the pipeline over a batch of entries and resolve each one.
        Called from the worker thread and, in continuous mode, inline from
        an idle handler thread (guarded by ``_inline_lock``).

        Entries that expired in the queue are resolved without scoring:
        504 when the caller's deadline is gone (it stopped listening), 503
        shed when queue age exceeds ``max_queue_age_s`` (overload — tell
        the caller to back off rather than burn device time on stale work).
        Counting happens in the handler threads (exactly once per request),
        never here; this thread only frees admission slots and wakes them.
        """
        now = self.clock()
        live: List[_Entry] = []
        # per-entry queue delay feeds the phase histogram and the adaptive
        # shed EWMA (in arrival order, so tests on FakeClock are exact)
        alpha = self.ewma_alpha
        with self.stats.lock:
            for e in batch:
                self._queue_ewma = (alpha * max(0.0, now - e.t_enq)
                                    + (1.0 - alpha) * self._queue_ewma)
        verdicts: Dict[str, str] = {}
        for e in batch:
            self._h_phase_queue.observe(max(0.0, now - e.t_enq), e.trace_id)
            if now > e.t_deadline:
                e.status, e.reply = 504, {"error": "deadline expired in queue"}
                verdicts[e.uid] = "deadline_expired_in_queue"
            elif self.max_queue_age_s is not None and \
                    now - e.t_enq > self.max_queue_age_s:
                e.status, e.reply = 503, {"error": "shed: queue age exceeded"}
                e.retry_after_s = self.shed_retry_after_s
                verdicts[e.uid] = "shed_queue_age"
            else:
                live.append(e)
        # continuous admission: entries go to the model's own
        # in-flight engine one by one and resolve from it per request —
        # admission failures (no free slot / page pool exhausted) shed THIS
        # entry with 503 + Retry-After and ride the normal resolution loop
        deferred: set = set()
        if live and self.mode == "continuous" and \
                self._continuous_submit is not None:
            for e in live:
                if self._submit_continuous(e, max(0.0, now - e.t_enq)):
                    deferred.add(e.uid)
                elif e.status == 503:
                    verdicts[e.uid] = "shed_decode_admission"
            live = []
        score_s = 0.0
        if live:
            col = np.empty(len(live), dtype=object)
            for i, e in enumerate(live):
                col[i] = e.payload
            ids = np.asarray([e.uid for e in live], dtype=object)
            # `_enq_age_s` (queue age at drain — a RELATIVE duration, so
            # the server's injectable clock never leaks its domain into
            # the scorer) rides along so a TTFT-reporting scorer can
            # anchor first-token latency at admission (extra columns pass
            # through any transformer untouched)
            df = DataFrame([{self.input_col: col, "id": ids,
                             "_enq_age_s": np.asarray(
                                 [max(0.0, now - e.t_enq) for e in live])}])
            # scoring runs under the TIGHTEST deadline in the batch so any
            # HTTP fan-out inside the pipeline (io/http, cognitive) clips
            # its own timeouts/retries to what the most impatient caller
            # still allows.  The batch span adopts the FIRST live entry's
            # trace id (one device pass serves many traces; per-entry
            # serving.request spans below carry each request's own id), and
            # installs it in this thread's context so io/http fan-out inside
            # the pipeline propagates it downstream.
            t_score0 = self.clock()
            try:
                with deadline_scope(Deadline(
                        min(e.t_deadline for e in live), self.clock)):
                    with trace_span("serving.score",
                                    trace_id=live[0].trace_id,
                                    attributes={"batch": len(live)},
                                    registry=self.registry, clock=self.clock):
                        out = self.model.transform(df).collect()
                replies = out[self.reply_col]
                for e, r in zip(live, replies):
                    # per-row shed sentinel (duck-typed `shed_reason`): a
                    # scorer refusing ONE row — mid-decode page denial —
                    # sheds that request without failing its batchmates
                    reason = getattr(r, "shed_reason", None)
                    if reason is not None:
                        e.status = 503
                        e.reply = {"error": f"shed: {reason}"}
                        e.retry_after_s = getattr(r, "retry_after_s", None) \
                            or self.shed_retry_after_s
                        verdicts[e.uid] = "shed_row"
                    else:
                        e.reply = self.reply_encoder(r)
            except Exception as ex:  # noqa: BLE001 — reply errors per-request
                if getattr(ex, "shed", False):
                    # backpressure raised out of the scorer (pool/slot
                    # exhaustion at admission): tell callers to back off
                    # instead of reporting a server fault
                    for e in live:
                        e.status = 503
                        e.reply = {"error": f"shed: {ex}"}
                        e.retry_after_s = self.shed_retry_after_s
                        verdicts[e.uid] = "shed_backpressure"
                else:
                    for e in live:
                        e.status, e.reply = 500, {"error": str(ex)}
            score_s = max(0.0, self.clock() - t_score0)
            for e in live:
                self._h_phase_score.observe(score_s, e.trace_id)
        with self.stats.lock:
            self._pending -= (len(batch) - len(deferred))
        for e in batch:
            if e.uid in deferred:
                continue
            # one serving.request span per entry, back-dated to its enqueue
            # time on the server clock: queue wait + score in one record,
            # joined to the caller's trace.  `server` scopes /debug/slow to
            # one instance in a shared registry; `verdict` names the
            # shed/deadline decision the slow-request view reports.
            verdict = verdicts.get(e.uid,
                                   "ok" if e.status == 200 else "error")
            span = Span("serving.request", trace_id=e.trace_id,
                        clock=self.clock, start_s=e.t_enq,
                        attributes={"status": e.status,
                                    "queue_s": round(max(0.0, now - e.t_enq), 6),
                                    "score_s": round(score_s, 6),
                                    "server": self._server_label,
                                    "verdict": verdict})
            if e.status != 200:
                span.status = f"http:{e.status}"
            span.finish()
            e.span_id = span.span_id  # before done.set(): the handler may
            export_span(span, self.registry)  # echo it in `traceparent`
            self._emit_record(e, verdict, max(0.0, now - e.t_enq), score_s)
            e.done.set()

    def _emit_record(self, e: _Entry, verdict: str, queue_s: float,
                     score_s: float, ttft_s: Optional[float] = None,
                     cost=None) -> None:
        """Append one canonical wide-event record for a terminal request
        and, when it carried a decode cost ledger, book the
        per-class fleet rollups: tokens delivered only on 200s (the
        goodput numerator), device-seconds always — waste is exactly the
        cost the capacity model must keep seeing."""
        rec: Dict[str, Any] = {
            "trace_id": e.trace_id, "class": self.request_class,
            "verdict": verdict, "status": int(e.status),
            "queue_s": round(queue_s, 6), "score_s": round(score_s, 6)}
        if ttft_s is not None:
            rec["ttft_s"] = round(ttft_s, 6)
        if e.prompt_hash is not None:
            rec["prompt_hash"] = e.prompt_hash
        if cost is not None:
            rec["cost"] = cost.as_dict()
            if e.status == 200 and cost.decode_tokens > 0:
                self._c_class_tokens.inc(cost.decode_tokens)
            if cost.device_s > 0:
                self._c_class_device.inc(cost.device_s)
        self._records.append(rec)

    def _submit_continuous(self, e: _Entry, queue_s: float) -> bool:
        """Hand one admitted entry to the model's continuous engine.

        Returns True when the engine owns resolution (the entry's span,
        pending slot and done event are settled by the ``resolve`` callback
        on the engine thread, per request); False when admission failed —
        the entry's status is set here (503 for shed-typed failures, 500
        otherwise) and it rides the caller's normal resolution loop.

        Timing crosses the seam as RELATIVE durations (queue age, deadline
        budget) — the model's engine runs on its own clock and must never
        compare this server's (injectable) clock values."""
        t_submit = self.clock()

        def resolve(reply=None, status=200, verdict="ok",
                    retry_after_s=None, ttft_s=None, cost=None):
            # 200 replies ride the server's reply_encoder exactly like the
            # batch path — a custom encoder applies to both drains
            e.status = status
            e.reply = self.reply_encoder(reply) if status == 200 else reply
            if retry_after_s is not None:
                e.retry_after_s = retry_after_s
            score_s = max(0.0, self.clock() - t_submit)
            self._h_phase_score.observe(score_s, e.trace_id)
            with self.stats.lock:
                self._pending -= 1
            attrs = {"status": status,
                     "queue_s": round(queue_s, 6),
                     "score_s": round(score_s, 6),
                     "server": self._server_label,
                     "verdict": verdict}
            if ttft_s is not None:
                attrs["ttft_s"] = round(ttft_s, 6)
            span = Span("serving.request", trace_id=e.trace_id,
                        clock=self.clock, start_s=e.t_enq, attributes=attrs)
            if status != 200:
                span.status = f"http:{status}"
            span.finish()
            e.span_id = span.span_id  # before done.set(): traceparent echo
            export_span(span, self.registry)
            self._emit_record(e, verdict, queue_s, score_s,
                              ttft_s=ttft_s, cost=cost)
            e.done.set()

        try:
            kw = {"trace_id": e.trace_id} if self._submit_takes_trace else {}
            if self._submit_takes_hash:
                e.prompt_hash = _prompt_hash(e.payload)
                kw["prompt_hash"] = e.prompt_hash
            self._continuous_submit(
                e.payload, resolve=resolve,
                queue_age_s=max(0.0, t_submit - e.t_enq),
                deadline_budget_s=max(0.0, e.t_deadline - t_submit), **kw)
            return True
        except Exception as ex:  # noqa: BLE001 — admission failure shapes
            if getattr(ex, "shed", False):
                e.status = 503
                e.reply = {"error": f"shed: {ex}"}
                e.retry_after_s = self.shed_retry_after_s
            else:
                e.status, e.reply = 500, {"error": str(ex)}
            return False

    def _worker(self):
        while not self._stop.is_set():
            batch = self._drain()
            if not batch:
                continue
            # same lock as the inline fast path: scoring stays serialized
            # end-to-end, so pipeline stages may keep per-call scratch state
            with self._inline_lock:
                self._score_batch(batch)

    # ------------------------------------------------------------------ api
    def start(self) -> "PipelineServer":
        # environment pivot + device-memory series for this registry (both
        # idempotent; no-ops where torch or memory introspection is absent).
        # Registered from a daemon thread: ensure_* may initialize the CUDA
        # runtime, and against a wedged device that can block — serving
        # startup must never ride that, and a
        # pure-python pipeline should pay no backend init at all on the
        # start path (the registry is thread-safe by contract).
        def _register_env_gauges():
            from ..observability.compute import (ensure_build_info,
                                                 ensure_device_memory_gauges)
            ensure_build_info(self.registry)
            ensure_device_memory_gauges(self.registry)
        threading.Thread(target=_register_env_gauges, daemon=True,
                         name="mmlspark-env-gauges").start()
        self._httpd = ThreadingHTTPServer((self.host, self.port), self._make_handler())
        self.port = self._httpd.server_port  # resolve port=0
        # label children per resolved address; callback gauges sample live
        # state at scrape time (no push on the hot path)
        self._server_label = f"{self.host}:{self.port}"
        self._bind_metric_children()
        self._m_queue_depth.set_function(lambda: self._pending,
                                         server=self._server_label)
        self._m_queue_age.set_function(self._oldest_queue_age_s,
                                       server=self._server_label)
        self._m_ewma.set_function(lambda: self._queue_ewma,
                                  server=self._server_label)
        # postmortem source: a stall/crash/preemption
        # dump shows the last-K requests this server resolved before it
        # died, cost stanzas included
        self._record_source = f"requests:{self._server_label}"
        self._recorder.add_source(self._record_source, self._records.tail)
        t = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        t.start()
        self._threads.append(t)
        w = threading.Thread(target=self._worker, daemon=True)
        w.start()
        self._threads.append(w)
        # SIGTERM/preemption -> graceful drain: any preemption
        # event (a signal landing in a preemption_scope, or a programmatic
        # request_preemption from a membership watcher) drains this server.
        # The hook only spawns the drain thread — hooks must never block
        # the checkpoint-and-exit path they observe.
        def _drain_on_preemption(reason, _self=self):
            threading.Thread(target=_self.drain,
                             kwargs={"timeout_s": _self.drain_timeout_s},
                             daemon=True, name="mmlspark-drain").start()
        self._preemption_hook = _drain_on_preemption
        register_preemption_hook(_drain_on_preemption)
        return self

    @property
    def draining(self) -> bool:
        return self._draining.is_set()

    def drain(self, timeout_s: Optional[float] = None,
              poll_s: float = 0.02) -> bool:
        """Gracefully drain and stop: shed new admissions (503 ``draining``
        + ``Connection: close``), let the continuous engine's in-flight
        slots run to eos/budget (no new joins), wait for every admitted
        entry to resolve, then :meth:`stop`.

        Returns True when everything in flight resolved before the budget
        ran out; False means the drain timed out and ``stop()`` cancelled
        the stragglers (they resolve as cancelled — still counted, so the
        exactly-once stats invariant holds either way).  Idempotent:
        concurrent callers ride the first drain and share its verdict.
        """
        with self._drain_lock:
            first = not self._draining.is_set()
            if first:
                self._draining.set()
        if not first:
            self._drained.wait(timeout_s)
            return self._drained.is_set()
        t0 = self.clock()
        deadline = None if timeout_s is None else t0 + timeout_s
        ok = True
        # continuous engine first: existing slots run to eos/budget with no
        # new joins (duck-typed like continuous_submit — a pure-python
        # pipeline has nothing to drain)
        drainer = getattr(self.model, "continuous_drain", None)
        if drainer is not None:
            budget = None if deadline is None \
                else max(0.0, deadline - self.clock())
            ok = bool(drainer(budget)) and ok
        # then the admission ledger: every admitted entry must resolve
        # (micro-batch queue drained, handler threads replied) before the
        # listener goes away
        while True:
            with self.stats.lock:
                pending = self._pending
            if pending <= 0:
                break
            if deadline is not None and self.clock() >= deadline:
                ok = False
                break
            time.sleep(poll_s)
        self.stop()
        self._h_drain.observe(max(0.0, self.clock() - t0))
        self._drained.set()
        return ok

    def stop(self) -> None:
        self._stop.set()
        if self._preemption_hook is not None:
            unregister_preemption_hook(self._preemption_hook)
            self._preemption_hook = None
        if self._record_source is not None:
            self._recorder.remove_source(self._record_source)
            self._record_source = None
        if self._httpd:
            self._httpd.shutdown()
            self._httpd.server_close()
        # a continuous-decode scorer owns a live engine thread + borrowed
        # pool slabs: close it with the server (in-flight entries resolve
        # as cancelled; a restarted scorer lazily reopens the stream)
        closer = getattr(self.model, "continuous_close", None)
        if closer is not None:
            closer()
        # retire the accept/worker threads before returning: a stop() that
        # leaves the worker mid-drain races a restart's fresh worker into
        # the same scorer, and chaos drills cannot tell a leaked thread
        # from a hang.  Both loops observe _stop within one 0.1s poll, so
        # the join bound is slack, not a grace period.
        for t in self._threads:
            if t.is_alive() and t is not threading.current_thread():
                t.join(timeout=5.0)
        self._threads = []
        # unhook the callback gauges: their closures capture this server,
        # so leaving them registered would pin a stopped server (and emit
        # frozen queue/EWMA series) for process lifetime.  Counter and
        # histogram series stay — they are history, and hold no objects.
        for g in (self._m_queue_depth, self._m_queue_age, self._m_ewma):
            g.remove(server=self._server_label)

    @property
    def address(self) -> str:
        return f"http://{self.host}:{self.port}{self.api_path}"


def _retry_after(seconds: float) -> str:
    """HTTP Retry-After is integer seconds; never advertise 0 (thundering
    herd of immediate retries)."""
    return str(max(1, int(round(seconds))))


def _default_encode(cell):
    if isinstance(cell, np.ndarray):
        return cell.tolist()
    if isinstance(cell, (np.floating, np.integer)):
        return cell.item()
    return cell


def _prompt_hash(payload) -> str:
    """Stable, content-derived identity for a prompt payload:
    equal prompts hash equal across requests and processes, so the record
    ring and the prefix-cache hit stats correlate.  Identity only — the
    index matches on token content, so a collision can never corrupt
    decode."""
    import hashlib
    try:
        canon = json.dumps(payload, sort_keys=True, default=str)
    except (TypeError, ValueError):
        canon = repr(payload)
    return hashlib.sha1(canon.encode()).hexdigest()[:16]


class DistributedPipelineServer:
    """Distributed variant: one PipelineServer per worker (the reference runs
    one ``JVMSharedServer`` per executor, ``DistributedHTTPSource.scala:90``,
    with a load balancer in front).  In-process this shards across N worker
    servers on consecutive ports; multi-host deployments run one per host
    behind an external LB, exactly like the reference's deployment doc
    (``docs/mmlspark-serving.md:87-120``)."""

    def __init__(self, model, num_servers: int = 2, base_port: int = 0, **kw):
        self.servers = [PipelineServer(model, port=base_port and base_port + i, **kw)
                        for i in range(num_servers)]

    def start(self):
        for s in self.servers:
            s.start()
        return self

    def stop(self):
        for s in self.servers:
            s.stop()

    @property
    def addresses(self):
        return [s.address for s in self.servers]
