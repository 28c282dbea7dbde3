"""Host-stack sampling profiler with span attribution.

The twin of the JAX package's ``observability/profiling.py``: the host
sampler and ``profile_window`` are its own copy, verbatim apart from
module paths; the optional device capture is a ``torch.profiler`` hatch
in place of ``jax.profiler.trace``, with the reference's semantics (opt-in
by an environment variable, ``MMLSPARK_TPU_TORCH_TRACE_DIR``; every
failure reported in the window's verdict, ``report["torch_trace"]``).  Its
one public name that differs is ``TORCH_TRACE_DIR_ENV`` (the reference's
``JAX_TRACE_DIR_ENV``).

The telemetry stack can say *that* a path is slow (spans + exemplars,
compile plane, fleet SLO burn) but not *where the host time goes* — the
continuous-batching bench notes call the CPU proxy "dispatch-bound" with
no tool to prove which frames eat the step loop.  This module closes that
gap with a production-shaped sampling profiler:

- a daemon thread samples ``sys._current_frames()`` at a configurable hz
  (no tracing hooks, no per-call overhead on the profiled code — the cost
  is one stack walk per thread per sample, paid by the sampler thread);
- every sample is attributed to the sampled thread's **ambient span/phase
  name** (``tracing.thread_phases()`` — maintained by ``trace_span`` and
  the hot-loop ``ambient_phase``), so "dispatch-bound" decomposes into
  named serving/decode/train phases;
- **idle threads are excluded by default** (py-spy's ``--idle`` default
  brought to pure Python): a thread whose top frame sits in a stdlib wait
  wrapper (``threading.py``, ``queue.py``, ``socket.py``, ...) is blocked
  in a C-level wait with the GIL released — counting it would dilute the
  by-span rollup with parked handler/worker threads until no busy phase
  could ever dominate.  Idle thread-samples are still counted
  (``idle_samples`` in the report — never a silent drop), and
  ``include_idle=True`` / ``?idle=1`` restores wall-clock attribution;
- aggregation is **bounded**: stacks fold into ``span;frame;frame;...``
  keys capped at ``max_stacks`` distinct entries (overflow counted, never
  grown), so a long window cannot OOM the process it profiles;
- ``profile_window()`` is the blocking convenience behind
  ``GET /debug/profile?seconds=&hz=`` on ``PipelineServer``; one window at
  a time per process (a second concurrent request gets ``busy`` — two
  samplers would double the overhead both are trying to measure);
- an optional ``torch.profiler`` capture rides the same window behind
  the ``MMLSPARK_TPU_TORCH_TRACE_DIR`` env knob, written as a Chrome trace
  into that directory, with a clean fallback when the profiler fails —
  the host sampler always works.

Output is folded-stack JSON (flamegraph-ready: each entry is one
root-first ``;``-joined stack with a count), plus a ``by_span`` rollup —
the number the decode acceptance gate reads.

Metric families (registered by :func:`profiler_instruments`; the
telemetry-coverage sweep gates on the booking sites):
``mmlspark_profiler_runs_total{result}`` (started/completed/error/busy),
``mmlspark_profiler_samples_total{span}``,
``mmlspark_profiler_stacks_dropped_total``.
"""
from __future__ import annotations

import os
import sys
import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple

from .metrics import MetricsRegistry, get_registry
from ..utils.concurrency import make_lock
from .tracing import thread_phases

__all__ = ["SamplingProfiler", "ProfilerBusy", "profile_window",
           "profiler_instruments", "DEFAULT_HZ", "MAX_SECONDS", "MAX_HZ",
           "TORCH_TRACE_DIR_ENV", "UNATTRIBUTED"]

#: default sampling rate — high enough to resolve ms-scale phases over a
#: few-second window (a 2 s window still lands ~60 samples), low enough
#: that the echo-serving overhead A/B stays within its 3% gate (bench
#: ``SERVING_PROFILER`` arm: on a contended 1-core host each sampler wake
#: also preempts the serving thread, so the felt per-request cost is GIL
#: hand-offs, not just stack-walk CPU); prime, so the sampler never
#: phase-locks to common 100/50/25 Hz timers
DEFAULT_HZ = 29

#: clamps for the HTTP endpoint: a typo'd ?seconds= must not pin a handler
#: thread for an hour, a huge ?hz= must not melt the host
MAX_SECONDS = 60.0
MAX_HZ = 1000

#: env knob: when set to a directory, profile windows ALSO capture a
#: ``torch.profiler`` trace into it (the CPU and, with a card, the CUDA
#: timeline, as a Chrome trace); absent/empty = host sampler only.
#: Failures fall back cleanly — the report records the error and the host
#: samples still serve.
TORCH_TRACE_DIR_ENV = "MMLSPARK_TPU_TORCH_TRACE_DIR"

#: span label for threads sampled outside any trace_span/ambient_phase
UNATTRIBUTED = "unattributed"

#: top-frame module basenames that mark a thread as BLOCKED: the C-level
#: waits these wrappers issue (lock/condition waits, selector polls,
#: socket reads, queue gets) release the GIL and leave the wrapper as the
#: newest Python frame — the only evidence of idleness visible from pure
#: Python.  A thread genuinely executing Python inside one of these
#: modules misclassifies; acceptable for a sampling profiler's default.
_IDLE_FILES = frozenset({"threading.py", "selectors.py", "socket.py",
                         "socketserver.py", "queue.py", "ssl.py"})


def _is_idle(frame) -> bool:
    code = frame.f_code
    if code.co_filename.rsplit(os.sep, 1)[-1] in _IDLE_FILES:
        return True
    # the profile window's own blocking sleep (time.sleep is C, so the
    # newest Python frame is profile_window itself) parks a handler thread
    # for the whole window — the one guaranteed-idle frame we control
    return code.co_name == "profile_window"


class ProfilerBusy(RuntimeError):
    """A profile window is already running in this process."""


def profiler_instruments(registry: Optional[MetricsRegistry] = None
                         ) -> Dict[str, Any]:
    """Register (idempotently) and return the profiler metric families —
    called at PipelineServer construction so the families exist before the
    first ``/debug/profile`` request (coverage-gated)."""
    reg = registry if registry is not None else get_registry()
    return {
        "runs": reg.counter(
            "mmlspark_profiler_runs_total",
            "profile windows by result (started/completed/error/busy)",
            labels=("result",)),
        "samples": reg.counter(
            "mmlspark_profiler_samples_total",
            "profiler samples attributed per ambient span name",
            labels=("span",)),
        "dropped": reg.counter(
            "mmlspark_profiler_stacks_dropped_total",
            "samples whose distinct folded stack exceeded the aggregation "
            "bound (counted into by_span, dropped from stacks)"),
    }


#: per-code-object frame label memo: the label is FUNCTION-granular
#: (``co_firstlineno``, not ``f_lineno``) so every hit of the same function
#: is one dict lookup instead of an f-string + path split — the fold is on
#: the sampler's per-wake path and its cost is serving-thread preemption
#: time on a busy host.  Bounded: cleared if it ever grows past 8192
#: distinct code objects (churning test processes; a server's steady state
#: is a few hundred).
_LABELS: Dict[Any, str] = {}


def _frame_label(code) -> str:
    label = _LABELS.get(code)
    if label is None:
        if len(_LABELS) > 8192:
            _LABELS.clear()
        fname = code.co_filename.rsplit(os.sep, 1)[-1]
        label = _LABELS[code] = \
            f"{code.co_name} ({fname}:{code.co_firstlineno})"
    return label


def _fold_frame(frame, max_depth: int = 64) -> str:
    """Root-first ``;``-joined fold of one thread's stack:
    ``func (module.py:42);func2 (...)`` — the flamegraph convention, at
    function granularity."""
    parts = []
    f = frame
    while f is not None and len(parts) < max_depth:
        parts.append(_frame_label(f.f_code))
        f = f.f_back
    parts.reverse()
    return ";".join(parts)


class SamplingProfiler:
    """Bounded host-thread sampling profiler.

    ``start()`` launches the daemon sampler; ``stop()`` joins it and books
    the per-span sample counters; ``report()`` returns the folded-stack
    JSON.  ``sample_once(frames=)`` is the deterministic unit-test entry
    point (inject frames, skip the thread machinery entirely).
    """

    def __init__(self, hz: float = DEFAULT_HZ,
                 registry: Optional[MetricsRegistry] = None,
                 max_stacks: int = 2048, max_depth: int = 64,
                 include_idle: bool = False,
                 clock: Callable[[], float] = time.monotonic):
        if hz <= 0:
            raise ValueError("hz must be > 0")
        self.hz = min(float(hz), float(MAX_HZ))
        self.registry = registry if registry is not None else get_registry()
        self.max_stacks = max(1, int(max_stacks))
        self.max_depth = max(1, int(max_depth))
        self.include_idle = bool(include_idle)
        self.clock = clock
        self._m = profiler_instruments(self.registry)
        self._lock = make_lock("SamplingProfiler._lock")
        #: (span, folded_stack) -> count, bounded at max_stacks entries
        self._stacks: Dict[Tuple[str, str], int] = {}
        self._by_span: Dict[str, int] = {}
        self._samples = 0
        self._idle = 0
        self._dropped = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._t_start: Optional[float] = None
        self._t_stop: Optional[float] = None

    # ------------------------------------------------------------- sampling
    def sample_once(self, frames: Optional[Dict[int, Any]] = None,
                    phases: Optional[Dict[int, str]] = None) -> int:
        """Take one sample of every live thread (or the injected
        ``frames``/``phases`` in tests), excluding the sampler's own
        thread.  Returns the number of threads sampled."""
        own = threading.get_ident()
        if frames is None:
            frames = sys._current_frames()
        if phases is None:
            phases = thread_phases()
        # fold OUTSIDE the lock: the stack walk is the expensive part
        folded = []
        idle = 0
        for tid, frame in frames.items():
            if tid == own:
                continue
            if not self.include_idle and _is_idle(frame):
                idle += 1
                continue
            folded.append((phases.get(tid, UNATTRIBUTED),
                           _fold_frame(frame, self.max_depth)))
        del frames  # frames pin every sampled thread's locals — drop early
        dropped = 0
        with self._lock:
            self._idle += idle
            for span, stack in folded:
                self._samples += 1
                self._by_span[span] = self._by_span.get(span, 0) + 1
                key = (span, stack)
                n = self._stacks.get(key)
                if n is not None:
                    self._stacks[key] = n + 1
                elif len(self._stacks) < self.max_stacks:
                    self._stacks[key] = 1
                else:
                    # bounded aggregation: the sample still counts toward
                    # its span, only the distinct-stack detail is dropped
                    self._dropped += 1
                    dropped += 1
        if dropped:
            self._m["dropped"].inc(dropped)
        return len(folded)

    def _run(self) -> None:
        interval = 1.0 / self.hz
        while not self._stop.wait(interval):
            try:
                self.sample_once()
            except Exception:  # noqa: BLE001 — the sampler must never kill
                pass           # the process it observes

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "SamplingProfiler":
        if self._thread is not None and self._thread.is_alive():
            return self
        self._t_start = self.clock()
        self._t_stop = None
        self._stop.clear()
        self._m["runs"].inc(result="started")
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="mmlspark-profiler")
        self._thread.start()
        return self

    def stop(self) -> "SamplingProfiler":
        self._stop.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=5.0)
        self._t_stop = self.clock()
        with self._lock:
            by_span = dict(self._by_span)
        for span, n in by_span.items():
            self._m["samples"].inc(n, span=span)
        self._m["runs"].inc(result="completed")
        return self

    # --------------------------------------------------------------- report
    def report(self, top: int = 200) -> Dict[str, Any]:
        """Folded-stack JSON: ``stacks`` (top-``top`` by count, flamegraph
        fold format), ``by_span`` rollup, sample/drop accounting."""
        with self._lock:
            stacks = sorted(self._stacks.items(), key=lambda kv: -kv[1])
            by_span = dict(self._by_span)
            samples, dropped = self._samples, self._dropped
            idle = self._idle
        end = self._t_stop if self._t_stop is not None else self.clock()
        duration = max(0.0, end - (self._t_start or end))
        return {
            "hz": self.hz,
            "duration_s": round(duration, 6),
            "samples": samples,
            "idle_samples": idle,
            "include_idle": self.include_idle,
            "by_span": dict(sorted(by_span.items(), key=lambda kv: -kv[1])),
            "stacks": [{"span": span, "stack": stack, "count": count}
                       for (span, stack), count in stacks[:max(0, int(top))]],
            "distinct_stacks": len(stacks),
            "stacks_dropped": dropped,
        }


# one window at a time per process: two concurrent samplers would double
# the very overhead each is trying to measure (and race the trace dir)
_WINDOW_LOCK = make_lock("profiling._WINDOW_LOCK")


class _TorchTraceHatch:
    """The optional device-capture hatch: wraps the window in a
    ``torch.profiler.profile`` (CPU, plus CUDA when a card is present)
    when ``MMLSPARK_TPU_TORCH_TRACE_DIR`` is set, and writes its Chrome
    trace into that directory on exit.  EVERY failure (profiler
    unavailable, unwritable dir, enter/exit/export raising) degrades to
    host-only sampling with the error recorded in the report — hosts
    without a card keep a working ``/debug/profile`` no matter what the
    device plane does."""

    def __init__(self):
        self.verdict: Optional[Dict[str, Any]] = None
        self._scope = None
        self._dir = os.environ.get(TORCH_TRACE_DIR_ENV, "")

    def _fail(self, e: BaseException) -> None:
        self.verdict = {"dir": self._dir, "ok": False,
                        "error": f"{type(e).__name__}: {e}"}
        self._scope = None

    def enter(self) -> None:
        if not self._dir:
            return
        try:
            import torch
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            os.makedirs(self._dir, exist_ok=True)
            scope = profile(activities=acts)
            scope.__enter__()
            self._scope = scope
            self.verdict = {"dir": self._dir, "ok": True}
        except Exception as e:  # noqa: BLE001 — capture is best-effort
            self._fail(e)

    def exit(self) -> None:
        scope, self._scope = self._scope, None
        if scope is None:
            return
        try:
            scope.__exit__(None, None, None)
            path = os.path.join(
                self._dir, f"trace-{os.getpid()}-{time.time_ns()}.json")
            scope.export_chrome_trace(path)
            self.verdict["file"] = path
        except Exception as e:  # noqa: BLE001 — capture is best-effort
            self._fail(e)


def profile_window(seconds: float = 2.0, hz: float = DEFAULT_HZ,
                   registry: Optional[MetricsRegistry] = None,
                   include_idle: bool = False,
                   sleep: Callable[[float], None] = time.sleep
                   ) -> Dict[str, Any]:
    """Run one blocking profile window and return the report — the
    ``GET /debug/profile`` implementation.  Inputs are clamped
    (``seconds`` to (0, 60], ``hz`` to [1, 1000]); a concurrent window
    raises :class:`ProfilerBusy` (the endpoint replies 409)."""
    reg = registry if registry is not None else get_registry()
    seconds = min(max(0.01, float(seconds)), MAX_SECONDS)
    hz = min(max(1.0, float(hz)), float(MAX_HZ))
    if not _WINDOW_LOCK.acquire(blocking=False):
        profiler_instruments(reg)["runs"].inc(result="busy")
        raise ProfilerBusy("a profile window is already running; "
                           "retry when it finishes")
    try:
        profiler = SamplingProfiler(hz=hz, registry=reg,
                                    include_idle=include_idle)
        hatch = _TorchTraceHatch()
        try:
            hatch.enter()
            profiler.start()
            sleep(seconds)
            profiler.stop()
            hatch.exit()
        except Exception:
            profiler_instruments(reg)["runs"].inc(result="error")
            raise
        report = profiler.report()
        report["requested_seconds"] = seconds
        if hatch.verdict is not None:
            report["torch_trace"] = hatch.verdict
        return report
    finally:
        _WINDOW_LOCK.release()
