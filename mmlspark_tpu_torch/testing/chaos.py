"""Deterministic fault injection — seeded chaos for the resilience layer.

Every injector owns a ``random.Random(seed)``: the fault sequence is a pure
function of the seed and the call sequence, so chaos tests replay exactly
(no real network flakes, no wall-clock races).  Injectors wrap the
``transport`` callable that ``io/http.HTTPClient`` exposes (monkeypatch an
instance's ``.transport`` or pass ``transport=`` at construction) and
compose by nesting::

    t = LatencyInjector(seed=1, rate=0.3, latency_s=0.2, sleep=clk.sleep).wrap(
        ConnectionErrorInjector(seed=2, rate=0.5).wrap(base_transport))
    client = HTTPClient(transport=t, clock=clk, sleep=clk.sleep)

Server-side chaos: ``WorkerKiller`` kills a ``WorkerServer``'s socket
without deregistering (a crash, as the topology service sees it) and can
restart it on a fresh port, re-registering with the driver — driving the
health-probe eviction and failover paths end to end.

An own copy of the JAX package's ``testing/chaos.py``, verbatim apart from
module paths and issue numbers, but for ``ElasticTopologyDrill``'s legs:
the reference's are ``jax`` programs on a mesh of virtual CPU devices; the
port's are worlds of CPU ranks over gloo (``parallel.world``).
"""
from __future__ import annotations

import random
import signal as _signal
import threading
import time
from typing import Callable, Optional

from ..io.http import HTTPRequestData, HTTPResponseData
from ..utils.resilience import FakeClock  # re-export for chaos suites

__all__ = ["ChaosInjector", "LatencyInjector", "ConnectionErrorInjector",
           "StatusStormInjector", "WorkerKiller", "FakeClock",
           "FlakyLoadInjector", "HungLoadInjector", "PreemptionSimulator",
           "ElasticTopologyDrill", "HungWorkerInjector"]

Transport = Callable[[HTTPRequestData, float], HTTPResponseData]


class ChaosInjector:
    """Base: a seeded coin decides per call whether to inject.  ``injected``
    and ``calls`` counters make assertions about the schedule cheap."""

    def __init__(self, seed: int = 0, rate: float = 1.0):
        self.rng = random.Random(seed)
        self.rate = float(rate)
        self.calls = 0
        self.injected = 0
        self._lock = threading.Lock()

    def _fire(self) -> bool:
        with self._lock:
            self.calls += 1
            fire = self.rng.random() < self.rate
            if fire:
                self.injected += 1
            return fire

    def _inject(self, req: HTTPRequestData, timeout_s: float,
                inner: Transport) -> HTTPResponseData:
        raise NotImplementedError

    def wrap(self, inner: Transport) -> Transport:
        def transport(req: HTTPRequestData, timeout_s: float) -> HTTPResponseData:
            if self._fire():
                return self._inject(req, timeout_s, inner)
            return inner(req, timeout_s)
        return transport


class LatencyInjector(ChaosInjector):
    """Latency spike before the real exchange.  ``sleep`` is injectable —
    pass a FakeClock's ``sleep`` so spikes advance virtual time only."""

    def __init__(self, seed: int = 0, rate: float = 1.0,
                 latency_s: float = 0.2,
                 sleep: Optional[Callable[[float], None]] = None):
        super().__init__(seed, rate)
        self.latency_s = latency_s
        self.sleep = sleep or time.sleep

    def _inject(self, req, timeout_s, inner):
        self.sleep(self.latency_s)
        if self.latency_s > timeout_s:
            raise TimeoutError(
                f"injected latency {self.latency_s}s > timeout {timeout_s}s")
        return inner(req, timeout_s)


class ConnectionErrorInjector(ChaosInjector):
    """Transport-level failure (refused/reset), as urllib would raise it."""

    def _inject(self, req, timeout_s, inner):
        raise ConnectionError(f"injected connection failure -> {req.url}")


class StatusStormInjector(ChaosInjector):
    """HTTP error storm: 429/503 replies with an optional Retry-After, the
    shape a throttling or overloaded service produces."""

    def __init__(self, seed: int = 0, rate: float = 1.0, status: int = 503,
                 retry_after_s: Optional[float] = None):
        super().__init__(seed, rate)
        self.status = status
        self.retry_after_s = retry_after_s

    def _inject(self, req, timeout_s, inner):
        headers = {}
        if self.retry_after_s is not None:
            headers["Retry-After"] = str(self.retry_after_s)
        return HTTPResponseData(status_code=self.status,
                                reason="injected storm", headers=headers,
                                entity=b'{"error": "injected"}')


class FlakyLoadInjector(ChaosInjector):
    """Compute-plane twin of the HTTP injectors: wraps a prefetcher
    ``load_fn`` and makes it raise a transient error on a seeded coin —
    the tile-load failure class (flaky storage, wedged device relay) the
    ``TilePrefetcher`` retry exists for.  ``max_injections`` bounds the
    total faults so a high rate cannot exhaust a bounded retry budget by
    pure bad luck; ``exc_factory`` picks the failure shape (default: a
    transient ``ConnectionError``)."""

    def __init__(self, seed: int = 0, rate: float = 1.0,
                 max_injections: Optional[int] = None,
                 exc_factory: Callable[[int], BaseException] = None):
        super().__init__(seed, rate)
        self.max_injections = max_injections
        self.exc_factory = exc_factory or (
            lambda k: ConnectionError(f"injected tile-load failure #{k}"))

    def _fire(self) -> bool:
        with self._lock:
            self.calls += 1
            if self.max_injections is not None \
                    and self.injected >= self.max_injections:
                return False
            fire = self.rng.random() < self.rate
            if fire:
                self.injected += 1
            return fire

    def wrap(self, load_fn: Callable) -> Callable:
        def flaky(item):
            if self._fire():
                raise self.exc_factory(self.injected)
            return load_fn(item)
        return flaky


class HungLoadInjector:
    """The failure the retry CANNOT see: a tile load that never returns
    (NFS server gone away mid-read, wedged device relay holding the
    transfer lock).  No exception is raised, so ``FlakyLoadInjector``'s
    retry path never engages — the prefetch worker just blocks, the
    consumer's tick stream freezes, and only the stall watchdog
    notices.  Deterministic by construction: hangs at the ``hang_at``-th
    load call (0-based), not on a coin.

    ``hanging`` is set when the worker is actually blocked (tests wait on
    it instead of sleeping); ``release()`` unblocks the load so the
    stream — and the test — can finish cleanly."""

    def __init__(self, hang_at: int = 0):
        self.hang_at = int(hang_at)
        self.calls = 0
        self.hanging = threading.Event()   # worker is blocked NOW
        self._gate = threading.Event()     # release() opens it
        self._lock = threading.Lock()

    def release(self) -> None:
        self._gate.set()

    def wrap(self, load_fn: Callable) -> Callable:
        def hung(item):
            with self._lock:
                k = self.calls
                self.calls += 1
            if k == self.hang_at and not self._gate.is_set():
                self.hanging.set()
                self._gate.wait()
                self.hanging.clear()
            return load_fn(item)
        return hung


class PreemptionSimulator:
    """Fires SIGTERM at a seeded boosting-iteration boundary — the
    scheduled-preemption drill for checkpoint-aware training loops.

    Shaped as a ``callbacks`` entry (``cb(iteration, eval)``, the contract
    ``train``/``train_streamed`` already expose): install it and the
    process receives SIGTERM at the END of the chosen iteration, exactly
    where a cloud scheduler's grace window would land mid-run.  The
    iteration is drawn from ``random.Random(seed)`` over [lo, hi), so the
    kill point replays exactly.  ``fired`` makes schedule assertions
    cheap; ``signum`` defaults to SIGTERM (``preemption_scope`` handles
    SIGINT identically)."""

    def __init__(self, seed: int = 0, lo: int = 0, hi: int = 1,
                 signum: int = _signal.SIGTERM):
        if hi <= lo:
            raise ValueError(f"need hi > lo, got [{lo}, {hi})")
        self.rng = random.Random(seed)
        self.at_iteration = self.rng.randrange(lo, hi)
        self.signum = signum
        self.fired = False

    def __call__(self, iteration: int, evals=None) -> None:
        if not self.fired and iteration >= self.at_iteration:
            self.fired = True
            _signal.raise_signal(self.signum)


class ElasticTopologyDrill:
    """SIGKILL a sharded training world mid-run, resume it at a DIFFERENT
    width, grow back — the crash drill generalized across topology
    (elastic resume).

    Each leg runs ``lightgbm.train(shard_rows=True)`` on the CPU in a
    world of ``width`` ranks over gloo (``parallel.world.World``: spawned
    processes, one process group) against one shared checkpoint
    directory, which rank 0 writes.  Rank 0 appends each completed
    iteration to a marker file; :meth:`run_child` SIGKILLs the leg's whole
    process group — launcher and ranks, no grace, no handler, the crash
    class atomic publication exists for — once enough NEW iterations
    landed.  :meth:`train_inline` runs a leg (or the uninterrupted
    baseline) in a world started from this process and returns rank 0's
    TrainResult after checking every rank grew the same booster, so the
    final assertion — resumed-across-widths booster == uninterrupted
    booster, bit for bit — stays a plain array compare.  Quantized
    histograms are forced ON: integer accumulation plus global-row-keyed
    rounding noise is what makes the cross-width replay exact."""

    def __init__(self, ckpt_dir: str, marker_path: str, *, rows: int = 801,
                 features: int = 6, num_iterations: int = 8,
                 max_depth: int = 3, seed: int = 3, data_seed: int = 0):
        self.ckpt_dir = str(ckpt_dir)
        self.marker_path = str(marker_path)
        self.rows, self.features = int(rows), int(features)
        self.num_iterations = int(num_iterations)
        self.max_depth, self.seed = int(max_depth), int(seed)
        self.data_seed = int(data_seed)

    # ---- one data/params recipe, shared by children and inline legs
    def make_data(self):
        import numpy as np
        rng = np.random.default_rng(self.data_seed)
        X = rng.normal(size=(self.rows, self.features)).astype(np.float32)
        y = (X[:, 0] + 0.5 * X[:, 1]
             + rng.normal(scale=0.3, size=self.rows) > 0).astype(np.float32)
        return X, y

    def make_params(self):
        from ..lightgbm import GBDTParams
        return GBDTParams(num_iterations=self.num_iterations,
                          objective="binary", max_depth=self.max_depth,
                          growth="level", seed=self.seed,
                          use_quantized_grad=True, bagging_fraction=0.7,
                          bagging_freq=2, feature_fraction=0.8)

    def _spec(self) -> dict:
        return dict(ckpt_dir=self.ckpt_dir, marker_path=self.marker_path,
                    rows=self.rows, features=self.features,
                    num_iterations=self.num_iterations,
                    max_depth=self.max_depth, seed=self.seed,
                    data_seed=self.data_seed)

    def child_program(self, width: int) -> str:
        """Source of one training leg: a world of ``width`` CPU ranks, each
        resuming from (and rank 0 checkpointing into) the shared
        directory, a marker line per iteration."""
        return (
            "from mmlspark_tpu_torch.parallel.world import World\n"
            "from mmlspark_tpu_torch.testing.chaos import _drill_leg\n"
            f"spec = {self._spec()!r}\n"
            f"with World({int(width)}, threads=1) as w:\n"
            "    w.run(_drill_leg, spec, True, 'auto', True)\n")

    def _marker_lines(self) -> int:
        import os
        if not os.path.exists(self.marker_path):
            return 0
        with open(self.marker_path) as f:
            return len(f.read().splitlines())

    def run_child(self, width: int, min_new_iterations: int = 2,
                  timeout_s: float = 240.0, env: Optional[dict] = None):
        """Spawn one leg at ``width`` and SIGKILL its process group after
        it has logged ``min_new_iterations`` NEW iterations (legs that
        finish first are left finished).  Returns the iteration count
        observed at the kill."""
        import os
        import signal
        import subprocess
        import sys
        base = self._marker_lines()
        run_env = dict(os.environ)
        if env:
            run_env.update(env)
        repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        run_env["PYTHONPATH"] = os.pathsep.join(
            [repo_root] + [p for p in [run_env.get("PYTHONPATH")] if p])
        proc = subprocess.Popen([sys.executable, "-c",
                                 self.child_program(width)],
                                env=run_env, cwd=repo_root,
                                start_new_session=True)

        def kill():
            try:                         # the launcher and its ranks
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass

        try:
            deadline = time.time() + timeout_s
            while time.time() < deadline:
                if self._marker_lines() >= base + min_new_iterations:
                    break
                if proc.poll() is not None:
                    break
                time.sleep(0.05)
            if proc.poll() is None:
                kill()                   # SIGKILL: no cleanup, no handler
            proc.wait(timeout=60)
        finally:
            if proc.poll() is None:
                kill()
        return self._marker_lines()

    def train_inline(self, width: int, checkpoint: bool = True,
                     resume: str = "auto", stop_at: Optional[int] = None):
        """Run one leg (or, with ``checkpoint=False``, the uninterrupted
        baseline) in a world of ``width`` CPU ranks started from this
        process; returns rank 0's TrainResult, raising unless every rank
        grew the same booster.  ``stop_at`` preempts the leg once that
        iteration completed (``utils.resilience.request_preemption``, the
        SIGTERM path without the signal): the leg writes its last snapshot
        and returns, as a preempted fleet would."""
        import numpy as np
        from ..parallel.world import World
        with World(int(width), threads=1) as w:
            results = w.run(_drill_leg, self._spec(), checkpoint, resume,
                            False, stop_at)
        first = results[0].booster
        for r in results[1:]:
            for k in _BOOSTER_ARRAYS:
                if not np.array_equal(getattr(first, k),
                                      getattr(r.booster, k)):
                    raise AssertionError(f"ranks grew different boosters "
                                         f"({k}) at width {width}")
        return results[0]


_BOOSTER_ARRAYS = ("split_feature", "threshold", "threshold_bin",
                   "split_gain", "internal_value", "internal_count",
                   "leaf_value", "leaf_count", "tree_weight", "left_child",
                   "right_child")


def _drill_leg(spec: dict, checkpoint: bool, resume: str, mark: bool,
               stop_at: Optional[int] = None):
    """One rank of an :class:`ElasticTopologyDrill` leg (a world's task)."""
    from ..lightgbm import core as gbdt_core
    from ..parallel.mesh import world_rank
    from ..utils.resilience import request_preemption
    drill = ElasticTopologyDrill(**spec)
    X, y = drill.make_data()
    kw, cbs = {}, []
    if checkpoint:
        kw = dict(checkpoint_dir=drill.ckpt_dir, checkpoint_every=1,
                  resume=resume)
    if mark and world_rank() == 0:
        def mark_cb(it, ev):
            with open(drill.marker_path, "a") as f:
                f.write(str(it) + chr(10))
        cbs.append(mark_cb)
    if stop_at is not None:
        def stop_cb(it, ev):
            if it >= stop_at:
                request_preemption("drill")
        cbs.append(stop_cb)
    return gbdt_core.train(X, y, drill.make_params(), shard_rows=True,
                           device="cpu", callbacks=cbs or None, **kw)


class HungWorkerInjector:
    """A worker that accepts connections and never replies — the SLOW
    failure class (hung device dispatch, wedged device runtime) the tail-tolerance
    layer exists for.  Unlike :class:`WorkerKiller`'s crash, a
    hung worker keeps its socket OPEN: a connect succeeds, the request is
    swallowed, and without hedging/timeouts the client slot is tied up
    forever.

    Binds a real listening socket; :meth:`register` announces it to a
    ``TopologyService`` as a routable worker so real traffic lands on it.
    ``mode``:

    - ``"black_hole"`` — accept, read the request, write nothing;
    - ``"mid_body"`` — write the status line + headers and a partial body
      (``Content-Length`` promises more), then stall forever.

    ``/health`` probes hang identically, so the driver's prober fails
    them by timeout and eviction proceeds.  Held connections close only
    at :meth:`stop`.  ``accepted`` counts hung exchanges for assertions.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 mode: str = "black_hole"):
        if mode not in ("black_hole", "mid_body"):
            raise ValueError("mode must be black_hole|mid_body")
        self.host, self.port = host, port
        self.mode = mode
        self.accepted = 0
        self._sock = None
        self._conns: list = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()

    def start(self) -> "HungWorkerInjector":
        import socket
        self._stop.clear()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((self.host, self.port))
        self.port = self._sock.getsockname()[1]
        self._sock.listen(64)
        self._sock.settimeout(0.2)  # bounded accept: stop() can join
        self._thread = threading.Thread(target=self._accept_loop,
                                        daemon=True, name="hung-worker")
        self._thread.start()
        return self

    def _accept_loop(self) -> None:
        import socket
        while not self._stop.is_set():
            try:
                conn, _addr = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return  # listener closed under us
            with self._lock:
                self.accepted += 1
                self._conns.append(conn)
            if self.mode == "mid_body":
                try:
                    # promise a body that never arrives: the client is
                    # left blocked mid-read, not mid-connect
                    conn.sendall(b"HTTP/1.1 200 OK\r\n"
                                 b"Content-Type: application/json\r\n"
                                 b"Content-Length: 1000\r\n\r\n"
                                 b'{"partial": ')
                except OSError:
                    pass
            # never reply, never close: the connection hangs until stop()

    def register(self, driver_address: str, server_id: str = "hung-worker",
                 api_path: str = "/score", request_class: str = "default",
                 role: str = "serving", generation: int = 0) -> None:
        """Announce this socket to the driver as a routable worker."""
        from ..serving.distributed import _http_json
        _http_json(f"{driver_address.rstrip('/')}/register",
                   {"server_id": server_id, "host": self.host,
                    "port": self.port, "api_path": api_path,
                    "request_class": request_class, "role": role,
                    "generation": generation, "partition_ids": []})

    def stop(self) -> None:
        self._stop.set()
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout=5.0)
        self._thread = None
        with self._lock:
            conns, self._conns = self._conns, []
        for c in conns:
            try:
                c.close()
            except OSError:
                pass

    @property
    def address(self) -> str:
        return f"http://{self.host}:{self.port}"


class WorkerKiller:
    """Kill/restart chaos for distributed serving.

    ``kill`` stops the worker's HTTP socket WITHOUT deregistering — exactly
    what a crashed executor looks like to the driver: still in the routing
    table until the health prober evicts it.  ``restart`` brings the worker
    back on a fresh ``PipelineServer`` (same model/config, port 0) and
    re-registers it.
    """

    def __init__(self, seed: int = 0):
        self.rng = random.Random(seed)
        self.killed: list = []

    def kill(self, worker) -> None:
        """worker: serving.distributed.WorkerServer"""
        worker.server.stop()
        self.killed.append(worker.server_id)

    def kill_one(self, workers) -> object:
        """Seeded pick — deterministic victim selection."""
        victim = workers[self.rng.randrange(len(workers))]
        self.kill(victim)
        return victim

    def restart(self, worker) -> None:
        from ..serving.server import PipelineServer
        old = worker.server
        worker.server = PipelineServer(
            old.model, input_col=old.input_col, reply_col=old.reply_col,
            host=old.host, port=0, api_path=old.api_path, mode=old.mode,
            max_batch=old.max_batch,
            micro_batch_interval_ms=old.interval_ms,
            input_parser=old.input_parser, reply_encoder=old.reply_encoder,
            request_timeout_s=old.request_timeout_s,
            max_queue_depth=old.max_queue_depth,
            max_queue_age_s=old.max_queue_age_s,
            shed_retry_after_s=old.shed_retry_after_s, clock=old.clock)
        worker.start()
