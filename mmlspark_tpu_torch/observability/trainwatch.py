"""Training observability plane: live job monitor + stall watchdog.

An own copy of the JAX package's ``observability/trainwatch.py``, verbatim
apart from module paths.

The serving half answers "where did the time go" from one registry and one
trace; a multi-hour ``train_streamed`` / ``Trainer.train_stream`` job was a
black box while it ran.  This module gives the training loops the same
surface the fleet already has, in three pieces:

- :class:`TrainingRun` — the heartbeat.  Drivers call ``tick(step, rows,
  loss)`` from their existing ``callbacks`` seam once per boosting
  iteration / train step.  The run maintains an EWMA step time (→ rows/sec
  and a finite ETA when ``total_steps`` is known), a bounded loss tail,
  and books ``mmlspark_training_{steps,rows}_total`` /
  ``mmlspark_training_step_seconds`` plus callback gauges for progress,
  ETA and throughput (families created once per registry by
  ``instruments.training_instruments``).

- the **stall watchdog** — a :class:`~mmlspark_tpu_torch.utils.resilience.Watchdog`
  whose timeout tracks the run: each tick re-``arm``\\ s it (resetting the
  once-per-section trip latch, so recovery re-enables detection) and
  rescales ``stall_timeout_s`` to ``max(stall_factor × EWMA step time,
  floor)``.  A trip books ``mmlspark_training_stalls_total{job}``, fires a
  flight-recorder dump with ``trigger="train_stall"`` (the run
  ``add_source``\\ s its own progress snapshot, so the dump shows
  step/phase/prefetch state), and — opt-in — requests graceful preemption
  so a checkpointing job exits cleanly instead of hanging a pod.
  Deterministic suites construct the run on a FakeClock and call
  :meth:`TrainingRun.check` directly; drivers call :meth:`TrainingRun.start`
  for the real daemon poll thread.

- :class:`MonitorServer` — an opt-in (``monitor_port=`` on all three train
  drivers) HTTP sidecar serving ``GET /progress`` (the JSON snapshot),
  ``GET /metrics`` (Prometheus text, OpenMetrics-negotiated like
  ``PipelineServer``), ``GET /stats`` (the fleet-aggregation shape —
  carries ``checkpoint_last_success_age_seconds`` so "checkpoints stopped
  landing" pages fleet-wide for trainers too), ``GET /health``,
  ``GET /debug/dump`` and ``GET /debug/profile``.  It can register with a
  :class:`~mmlspark_tpu_torch.serving.distributed.TopologyService` under
  ``role="trainer"`` — the federator scrapes it into ``/fleet/metrics``,
  while ``GET /routing`` excludes trainer rows so score traffic never
  lands here.

Every lock routes through ``utils.concurrency.make_lock`` (the
lock-order sanitizer covers this plane).  The tick path is deliberately
cheap — a clock read, a few float folds, two counter incs and one
histogram observation; the measured overhead on the streamed driver is
recorded in docs/OBSERVABILITY.md ("Training plane").
"""
from __future__ import annotations

import json
import math
import time
import threading
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional

from .instruments import training_instruments
from .metrics import MetricsRegistry, get_registry
from ..utils.concurrency import make_lock
from ..utils.resilience import Watchdog, request_preemption

#: no-tick floor when the caller gives no ``monitor_stall_timeout_s`` —
#: generous on purpose: before the first two ticks there is no EWMA, and a
#: cold first iteration (trace + compile) legitimately dwarfs the steady
#: state.
DEFAULT_STALL_FLOOR_S = 30.0
#: stall threshold = max(factor × EWMA step time, floor) — the "k" of the
#: detection contract.  4× absorbs normal step-time jitter (checkpoint
#: boundaries, eval iterations) without masking a real hang.
DEFAULT_STALL_FACTOR = 4.0
#: EWMA fold weight for step time / throughput: ~2/(N+1) for an effective
#: window of a handful of steps — fast enough to follow a phase change,
#: smooth enough that one slow iteration does not whipsaw the ETA.
DEFAULT_EWMA_ALPHA = 0.3
DEFAULT_LOSS_WINDOW = 64


def _roster(registry: MetricsRegistry, attr: str) -> list:
    """Per-registry enrolment list (the flightrecorder pattern): tests and
    the E2E suite discover live runs/monitors through the registry they
    passed to the driver, without a process-global."""
    got = getattr(registry, attr, None)
    if got is None:
        got = []
        setattr(registry, attr, got)
    return got


def active_runs(registry: Optional[MetricsRegistry] = None) -> List["TrainingRun"]:
    """Live (un-closed) :class:`TrainingRun`\\ s enrolled on ``registry``."""
    reg = registry if registry is not None else get_registry()
    return list(_roster(reg, "_training_runs"))


def active_monitors(registry: Optional[MetricsRegistry] = None
                    ) -> List["MonitorServer"]:
    """Live (started, un-stopped) :class:`MonitorServer`\\ s on ``registry``."""
    reg = registry if registry is not None else get_registry()
    return list(_roster(reg, "_training_monitors"))


class TrainingRun:
    """One training job's heartbeat state + stall watchdog.

    Drivers construct it when monitoring is requested, call :meth:`tick`
    from their ``callbacks`` seam, and :meth:`close` in a ``finally``.
    ``loss`` is optional by contract: ``Trainer.train_stream`` fetches
    losses AFTER its loop (a per-step ``float()`` would serialize the
    pipeline the prefetcher exists to overlap), so its ticks carry
    ``loss=None`` and the tail stays empty for that driver.
    """

    def __init__(self, job: str, *, total_steps: Optional[int] = None,
                 rows_per_step: int = 0,
                 registry: Optional[MetricsRegistry] = None,
                 clock: Callable[[], float] = time.monotonic,
                 stall_timeout_s: Optional[float] = None,
                 stall_factor: float = DEFAULT_STALL_FACTOR,
                 ewma_alpha: float = DEFAULT_EWMA_ALPHA,
                 loss_window: int = DEFAULT_LOSS_WINDOW,
                 preempt_on_stall: bool = False,
                 flight_dump: bool = True,
                 driver: str = ""):
        self.job = str(job)
        self.driver = driver or self.job
        self.total_steps = int(total_steps) if total_steps else None
        self.rows_per_step = int(rows_per_step)
        self.registry = registry if registry is not None else get_registry()
        self.clock = clock
        self.stall_floor_s = float(stall_timeout_s) if stall_timeout_s \
            else DEFAULT_STALL_FLOOR_S
        self.stall_factor = float(stall_factor)
        self.ewma_alpha = float(ewma_alpha)
        self.preempt_on_stall = bool(preempt_on_stall)

        self._lock = make_lock("TrainingRun._lock")
        self._step = 0
        self._rows = 0
        self._losses: deque = deque(maxlen=max(1, int(loss_window)))
        self._ewma_step_s: Optional[float] = None
        self._ewma_rows_rate: Optional[float] = None
        self._last_tick_s: Optional[float] = None
        self._started_s = clock()
        self._stalls = 0
        self._phase = ""
        self._closed = False
        self._prefetch_fn: Optional[Callable[[], Dict]] = None
        self._token = None  # PreemptionToken, when the driver shares one

        fams = training_instruments(self.registry)
        self._c_steps = fams["steps"].labels(job=self.job)
        self._c_rows = fams["rows"].labels(job=self.job)
        self._c_stalls = fams["stalls"].labels(job=self.job)
        self._h_step = fams["step_seconds"].labels(job=self.job)
        # sampled at scrape, never pushed on the tick path
        fams["progress"].set_function(self._progress_ratio, job=self.job)
        fams["eta"].set_function(self._eta_value, job=self.job)
        fams["rate"].set_function(self._rate_value, job=self.job)
        self._fams = fams

        # armed from birth: the hang class this plane exists for includes
        # "the FIRST tile load never returned" — a watchdog armed only
        # after the first tick would sleep through it
        self._watchdog = Watchdog(self.stall_floor_s, clock=clock,
                                  on_stall=self._on_stall,
                                  name=f"trainwatch.{self.job}")
        self._watchdog.arm(self.job)

        self._recorder = None
        if flight_dump:
            from .flightrecorder import get_flight_recorder
            self._recorder = get_flight_recorder(self.registry)
            self._recorder.add_source(f"training.{self.job}", self.progress)

        _roster(self.registry, "_training_runs").append(self)

    # ------------------------------------------------------------ heartbeat
    def tick(self, step: Optional[int] = None, rows: Optional[int] = None,
             loss: Optional[float] = None) -> None:
        """One unit of progress.  ``step`` is the driver's absolute step
        counter (the chunked lightgbm path advances several iterations per
        callback — the delta books them all); ``rows`` overrides the
        ``rows_per_step × delta`` default; ``loss`` (or an eval-metric
        value) feeds the bounded tail when the driver has one host-side."""
        now = self.clock()
        with self._lock:
            if self._closed:
                return
            prev_step = self._step
            self._step = int(step) if step is not None else prev_step + 1
            d_step = max(self._step - prev_step, 1)
            d_rows = int(rows) if rows is not None \
                else self.rows_per_step * d_step
            self._rows += d_rows
            prev_tick, self._last_tick_s = self._last_tick_s, now
            dt = None
            if prev_tick is not None:
                dt = max(now - prev_tick, 1e-9)
                per_step = dt / d_step
                a = self.ewma_alpha
                self._ewma_step_s = per_step if self._ewma_step_s is None \
                    else a * per_step + (1.0 - a) * self._ewma_step_s
                if d_rows > 0:
                    rate = d_rows / dt
                    self._ewma_rows_rate = rate \
                        if self._ewma_rows_rate is None \
                        else a * rate + (1.0 - a) * self._ewma_rows_rate
            if loss is not None:
                self._losses.append(float(loss))
            ewma = self._ewma_step_s
        # booking outside the lock (registry children lock internally)
        self._c_steps.inc(d_step)
        if d_rows:
            self._c_rows.inc(d_rows)
        if dt is not None:
            self._h_step.observe(dt / d_step)
        if ewma is not None:
            self._watchdog.stall_timeout_s = max(
                self.stall_factor * ewma, self.stall_floor_s)
        # re-arm (not heartbeat): arm() bumps the generation and resets the
        # once-per-section trip latch, so a run that recovered from one
        # stall is watched for the next
        self._watchdog.arm(self.job)

    def set_phase(self, name: str) -> None:
        """Coarse driver phase for ``/progress`` (the profiler's
        ``ambient_phase`` is per-thread; this is the job-level headline)."""
        with self._lock:
            self._phase = str(name)

    def set_prefetch_fn(self, fn: Optional[Callable[[], Dict]]) -> None:
        """Install the driver's prefetch-state snapshot (overlap totals +
        the live :meth:`TilePrefetcher.snapshot`); read at ``/progress``
        and flight-dump time, never on the tick path."""
        with self._lock:
            self._prefetch_fn = fn

    def set_preemption_token(self, token) -> None:
        """Share the driver's :class:`PreemptionToken` so ``/progress``
        reports whether a graceful shutdown is already in flight."""
        with self._lock:
            self._token = token

    # --------------------------------------------------------- monitor side
    def check(self) -> bool:
        """One watchdog poll (FakeClock suites call this directly;
        :meth:`start` runs it on a daemon thread)."""
        return self._watchdog.check()

    def start(self, poll_interval_s: Optional[float] = None) -> "TrainingRun":
        """Start the real-clock watchdog poll thread (idempotent)."""
        self._watchdog.start(poll_interval_s)
        return self

    def _on_stall(self, label: str, elapsed: float) -> None:
        # runs on the monitor thread, outside the watchdog lock; a raise
        # is swallowed by the watchdog, so each step is individually safe
        with self._lock:
            self._stalls += 1
        self._c_stalls.inc()
        if self._recorder is not None:
            # the dump carries source.training.<job> (this run's progress
            # snapshot, prefetch state included) + the thread-phase table
            self._recorder.dump(trigger="train_stall")
        if self.preempt_on_stall:
            request_preemption(
                f"trainwatch: {self.job} made no progress for "
                f"{elapsed:.1f}s (timeout "
                f"{self._watchdog.stall_timeout_s:.1f}s)")

    # ------------------------------------------------------------- snapshot
    def _progress_ratio(self) -> float:
        with self._lock:
            if not self.total_steps:
                return float("nan")
            return min(1.0, self._step / float(self.total_steps))

    def _eta_value(self) -> float:
        with self._lock:
            ewma, step = self._ewma_step_s, self._step
        if not ewma or not self.total_steps:
            # armed-but-unknowable stays +Inf on /metrics (the checkpoint
            # age gauge convention); /progress serializes it as null
            return float("inf")
        return max(self.total_steps - step, 0) * ewma

    def _rate_value(self) -> float:
        with self._lock:
            return self._ewma_rows_rate if self._ewma_rows_rate is not None \
                else float("nan")

    def _checkpoint_age_s(self) -> Optional[float]:
        # max finite last-success age across this registry's checkpoint
        # sites — the PipelineServer /stats convention, so the fleet
        # aggregator pages on the same number for trainers
        fam = self.registry.family(
            "mmlspark_checkpoint_last_success_age_seconds")
        if fam is None:
            return None
        vals = [child.value for _k, child in fam._snapshot()]
        vals = [v for v in vals if math.isfinite(v)]
        return max(vals) if vals else None

    def progress(self) -> Dict[str, Any]:
        """The ``/progress`` JSON body (also the flight-dump source): every
        value JSON-safe, unknowns ``null`` rather than non-finite."""
        with self._lock:
            now = self.clock()
            ewma = self._ewma_step_s
            step = self._step
            snap: Dict[str, Any] = {
                "job": self.job,
                "driver": self.driver,
                "step": step,
                "total_steps": self.total_steps,
                "rows": self._rows,
                "rows_per_second": round(self._ewma_rows_rate, 3)
                if self._ewma_rows_rate is not None else None,
                "ewma_step_seconds": round(ewma, 6)
                if ewma is not None else None,
                "elapsed_seconds": round(max(0.0, now - self._started_s), 6),
                "loss_tail": list(self._losses),
                "phase": self._phase,
                "stalls": self._stalls,
            }
            token = self._token
            pf_fn = self._prefetch_fn
        eta = None
        if ewma and self.total_steps:
            eta = max(self.total_steps - step, 0) * ewma
        snap["eta_seconds"] = round(eta, 3) if eta is not None else None
        snap["preemption_requested"] = bool(getattr(token, "requested", False))
        wd = self._watchdog
        snap["watchdog"] = {
            "stalled_for_seconds": round(wd.stalled_for(), 3),
            "stall_timeout_seconds": round(wd.stall_timeout_s, 3),
            "trips": wd.trips,
        }
        if pf_fn is not None:
            try:
                snap["prefetch"] = pf_fn()
            except Exception as e:  # noqa: BLE001 — snapshot must not die
                snap["prefetch"] = {"error": f"{type(e).__name__}: {e}"}
        age = self._checkpoint_age_s()
        if age is not None:
            snap["checkpoint_age_seconds"] = round(age, 3)
        return snap

    # -------------------------------------------------------------- closing
    def close(self) -> None:
        """End of run: stop the watchdog, unhook the flight source, remove
        the per-job gauge series (counters stay — they are history)."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self._watchdog.disarm()
        self._watchdog.stop()
        if self._recorder is not None:
            self._recorder.remove_source(f"training.{self.job}")
        for key in ("progress", "eta", "rate"):
            try:
                self._fams[key].remove(job=self.job)
            except Exception:  # noqa: BLE001 — a shared-label twin may have
                pass           # removed the series first
        runs = _roster(self.registry, "_training_runs")
        if self in runs:
            runs.remove(self)


def _post_json(url: str, payload: Dict, timeout_s: float = 2.0) -> Dict:
    # lazy: observability must stay importable without the serving layer,
    # and the serving layer imports observability at module scope.  The
    # shared helper clips to the ambient deadline and rides the trace id.
    from ..serving.distributed import _http_json
    return _http_json(url, payload, timeout=timeout_s)


class MonitorServer:
    """Opt-in HTTP sidecar for one :class:`TrainingRun`.

    Deliberately tiny: read-only GETs off the run's snapshot and the shared
    registry, on a ``ThreadingHTTPServer`` daemon thread — no admission
    control, no queue, because the only clients are an operator's curl,
    a Prometheus scrape, and the fleet federator.
    """

    def __init__(self, run: TrainingRun, port: int = 0,
                 host: str = "127.0.0.1",
                 topology_address: Optional[str] = None,
                 server_id: Optional[str] = None):
        self.run = run
        self.registry = run.registry
        self.host, self.port = host, int(port)
        self.topology_address = topology_address
        self.server_id = server_id or f"train-{run.job}"
        self.registered = False
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    # ---------------------------------------------------------------- http
    def _make_handler(self):
        mon = self

        class Handler(BaseHTTPRequestHandler):
            # HTTP/1.1 + explicit Content-Length: keep-alive-safe, same
            # contract as PipelineServer so scrapers share client code
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):  # quiet
                pass

            def _write_raw(self, status: int, body: bytes,
                           ctype: bytes = b"application/json") -> None:
                self.send_response(status)
                self.send_header("Content-Type", ctype.decode())
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                try:
                    self.wfile.write(body)
                except (BrokenPipeError, ConnectionResetError):
                    pass

            def _respond(self, status: int, obj) -> None:
                self._write_raw(status, json.dumps(obj, default=str).encode())

            def do_GET(self):
                path = self.path.split("?", 1)[0]
                if path == "/health":
                    # the TopologyService probe target: a live monitor IS
                    # healthy (training liveness is the watchdog's job —
                    # a stalled run must keep serving its diagnosis)
                    self._write_raw(200, b"ok", b"text/plain")
                elif path == "/progress":
                    self._respond(200, mon.run.progress())
                elif path == "/stats":
                    self._respond(200, mon._stats())
                elif path == "/metrics":
                    # OpenMetrics negotiation, verbatim PipelineServer
                    # semantics: exemplars only under the content type
                    # whose parsers accept them
                    accept = self.headers.get("Accept", "")
                    if "application/openmetrics-text" in accept:
                        body = (mon.registry.to_prometheus(openmetrics=True)
                                + "# EOF\n").encode()
                        ctype = (b"application/openmetrics-text; "
                                 b"version=1.0.0; charset=utf-8")
                    else:
                        body = mon.registry.to_prometheus().encode()
                        ctype = b"text/plain; version=0.0.4; charset=utf-8"
                    self._write_raw(200, body, ctype)
                elif path == "/debug/dump":
                    from .flightrecorder import get_flight_recorder
                    rec = get_flight_recorder(mon.registry)
                    dump_path = rec.dump(trigger="http")
                    snap = dict(rec.last_snapshot or {})
                    snap["dump_path"] = dump_path
                    self._respond(200, snap)
                elif path == "/debug/profile":
                    from .profiling import ProfilerBusy, profile_window
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
                                                registry=mon.registry,
                                                include_idle=idle, **kw)
                    except ProfilerBusy as e:
                        self._respond(409, {"error": str(e)})
                        return
                    self._respond(200, report)
                else:
                    self._respond(404, {"error": "not found"})

        return Handler

    def _stats(self) -> Dict[str, Any]:
        """The shape ``TopologyService.aggregate_stats`` folds: trainers
        contribute no request counters, but their checkpoint age must page
        fleet-wide exactly like a serving worker's."""
        p = self.run.progress()
        d: Dict[str, Any] = {"role": "trainer", "job": self.run.job,
                             "step": p["step"], "stalls": p["stalls"],
                             "preemption_requested":
                                 p["preemption_requested"]}
        age = p.get("checkpoint_age_seconds")
        if age is not None:
            d["checkpoint_last_success_age_seconds"] = age
        return d

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "MonitorServer":
        if self._httpd is not None:
            return self
        httpd = ThreadingHTTPServer((self.host, self.port),
                                    self._make_handler())
        httpd.daemon_threads = True
        self._httpd = httpd
        self.port = httpd.server_address[1]
        thread = threading.Thread(
            target=httpd.serve_forever,
            name=f"mmlspark-trainwatch:{self.run.job}", daemon=True)
        self._thread = thread
        thread.start()
        _roster(self.registry, "_training_monitors").append(self)
        if self.topology_address:
            # best-effort enrolment: a down driver must not kill training.
            # role="trainer" keeps this box out of GET /routing (score
            # traffic) while the federator still scrapes its /metrics.
            try:
                _post_json(f"{self.topology_address}/register",
                           self._registration())
                self.registered = True
            except Exception:  # noqa: BLE001
                self.registered = False
        return self

    def _registration(self) -> Dict[str, Any]:
        return {"server_id": self.server_id, "host": self.host,
                "port": self.port, "api_path": "/progress",
                "request_class": "training", "role": "trainer",
                "generation": 0, "partition_ids": []}

    @property
    def address(self) -> str:
        return f"http://{self.host}:{self.port}"

    def stop(self) -> None:
        httpd, self._httpd = self._httpd, None
        if httpd is None:
            return
        if self.registered and self.topology_address:
            try:
                _post_json(f"{self.topology_address}/deregister",
                           {"server_id": self.server_id})
            except Exception:  # noqa: BLE001
                pass
            self.registered = False
        httpd.shutdown()
        httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        monitors = _roster(self.registry, "_training_monitors")
        if self in monitors:
            monitors.remove(self)


def start_training_monitor(job: str, *, total_steps: Optional[int] = None,
                           rows_per_step: int = 0,
                           registry: Optional[MetricsRegistry] = None,
                           monitor_port: Optional[int] = None,
                           stall_timeout_s: Optional[float] = None,
                           stall_factor: float = DEFAULT_STALL_FACTOR,
                           topology_address: Optional[str] = None,
                           preempt_on_stall: bool = False,
                           clock: Callable[[], float] = time.monotonic,
                           driver: str = ""):
    """Driver-side one-call wiring: build the :class:`TrainingRun`, start
    its watchdog thread, and (when ``monitor_port`` is given — 0 binds an
    ephemeral port) serve it.  Returns ``(run, server_or_None)``; the
    driver owns cleanup (``server.stop()`` then ``run.close()``)."""
    run = TrainingRun(job, total_steps=total_steps,
                      rows_per_step=rows_per_step, registry=registry,
                      clock=clock, stall_timeout_s=stall_timeout_s,
                      stall_factor=stall_factor,
                      preempt_on_stall=preempt_on_stall, driver=driver)
    run.start()
    server = None
    if monitor_port is not None:
        server = MonitorServer(run, port=int(monitor_port),
                               topology_address=topology_address)
        server.start()
    return run, server
