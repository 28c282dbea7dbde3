"""Flight recorder — atomic postmortem dumps on crash/preemption/SLO burn.

When a chaos drill SIGKILLs a worker, a fleet shrink preempts training, or
a scorer thread dies on an uncaught exception, the diagnostic state that
explains the incident — the event ring, the slow-span ring, the decode
slot tables, the page-pool occupancy, the compile report — dies with the
process.  The flight recorder is the black box: a bounded snapshot of all
of it, assembled on demand and **dumped atomically** (via
``io/checkpoint.atomic_write`` — a dump racing the crash publishes whole
or not at all, never torn) on:

- **crash** — ``sys.excepthook`` + ``threading.excepthook`` (chained to
  the previous hooks, never replacing them);
- **preemption** — ``utils.resilience`` preemption hooks: both a signal
  landing in a ``preemption_scope`` and a programmatic
  ``request_preemption`` (the membership-shrink path) fire a dump before
  the final checkpoint-and-exit;
- **slo_burn** — the ``SLOEngine`` burning edge (driver-side);
- **demand** — ``GET /debug/dump`` on ``PipelineServer`` (and the
  deadline-bounded ``GET /fleet/dump`` fan-out on ``TopologyService``).

Snapshot sources that cannot be pulled from the registry ride per-registry
``WeakSet`` rosters: ``ContinuousDecoder`` (slot table + pool occupancy),
``ModelRunner`` (last decode geometry) and ``TopologyService`` (membership
epoch) enrol themselves at construction, so the recorder needs no wiring
order and holds no strong references.  ``add_source(name, fn)`` registers
arbitrary extra state.

Metric families (the telemetry-coverage sweep gates on the booking
sites): ``mmlspark_flightrecorder_dumps_total{trigger,result}`` and the
``mmlspark_flightrecorder_last_dump_age_seconds`` callback gauge.

Disk layout: ``<dump_dir>/flightdump_<seq>_<trigger>.json``, keep-last-K
pruned.  With no ``dump_dir`` (parameter or ``MMLSPARK_TPU_FLIGHT_DUMP_DIR``
env), on-demand snapshots still serve over HTTP; trigger dumps book
``result="no_dir"`` and write nothing — a test process must opt in before
its crashes litter the working directory.
"""
from __future__ import annotations

import itertools
import json
import os
import sys
import threading
import time
import weakref
from typing import Any, Callable, Dict, List, Optional

from .metrics import MetricsRegistry, get_registry
from ..utils.concurrency import make_lock

__all__ = ["FlightRecorder", "get_flight_recorder",
           "flightrecorder_instruments", "DUMP_DIR_ENV"]

#: env knob: directory for postmortem dump files (empty/unset = no files;
#: on-demand ``/debug/dump`` snapshots are unaffected)
DUMP_DIR_ENV = "MMLSPARK_TPU_FLIGHT_DUMP_DIR"

_RECORDER_IDS = itertools.count()


def flightrecorder_instruments(registry: Optional[MetricsRegistry] = None
                               ) -> Dict[str, Any]:
    """Register (idempotently) and return the recorder metric families —
    PipelineServer/TopologyService construction calls this so the families
    exist before the first trigger (coverage-gated)."""
    reg = registry if registry is not None else get_registry()
    return {
        "dumps": reg.counter(
            "mmlspark_flightrecorder_dumps_total",
            "flight-recorder dumps by trigger and result",
            labels=("trigger", "result")),
        "age": reg.gauge(
            "mmlspark_flightrecorder_last_dump_age_seconds",
            "seconds since the last successful dump (+Inf before the "
            "first)", labels=("recorder",)),
    }


def _roster(registry, attr: str):
    """The per-registry WeakSet roster named ``attr`` (created on first
    use) — ContinuousDecoder/ModelRunner/TopologyService enrol, the
    recorder iterates live members."""
    ws = getattr(registry, attr, None)
    if ws is None:
        ws = weakref.WeakSet()
        setattr(registry, attr, ws)
    return ws


class FlightRecorder:
    """Bounded black-box snapshot + atomic dump-on-trigger.

    One per registry via :func:`get_flight_recorder` (which also installs
    the crash/preemption hooks); construct explicitly with
    ``install=False`` for hook-free tests.
    """

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 dump_dir: Optional[str] = None, ring_n: int = 128,
                 slow_k: int = 10, keep_last: int = 8,
                 max_metric_entries: int = 400,
                 clock: Callable[[], float] = time.monotonic,
                 install: bool = False):
        self.registry = registry if registry is not None else get_registry()
        if dump_dir is None:
            dump_dir = os.environ.get(DUMP_DIR_ENV, "") or None
        self.dump_dir = dump_dir
        self.ring_n = max(1, int(ring_n))
        self.slow_k = max(0, int(slow_k))
        self.keep_last = max(1, int(keep_last))
        self.max_metric_entries = max(1, int(max_metric_entries))
        self.clock = clock
        self._label = f"r{next(_RECORDER_IDS)}"
        self._m = flightrecorder_instruments(self.registry)
        self._lock = make_lock("FlightRecorder._lock")
        self._seq = itertools.count()
        self._last_dump_s: Optional[float] = None
        #: counter-family baseline from the previous snapshot: the dump
        #: reports DELTAS so "what moved since the last dump" is one read
        self._counter_baseline: Dict[str, float] = {}
        self._sources: Dict[str, Callable[[], Any]] = {}
        self._prev_sys_hook = None
        self._prev_threading_hook = None
        self._installed = False
        self.last_snapshot: Optional[Dict[str, Any]] = None
        self._m["age"].set_function(self._age_s, recorder=self._label)
        if install:
            self.install()

    # ------------------------------------------------------------- sources
    def add_source(self, name: str, fn: Callable[[], Any]) -> None:
        """Register an extra snapshot source; ``fn()`` must return a
        JSON-able value.  A raising source becomes an error row, never a
        failed dump."""
        with self._lock:
            self._sources[str(name)] = fn

    def remove_source(self, name: str) -> None:
        with self._lock:
            self._sources.pop(str(name), None)

    def _age_s(self) -> float:
        last = self._last_dump_s
        return float("inf") if last is None \
            else max(0.0, self.clock() - last)

    # ------------------------------------------------------------ snapshot
    def _metric_section(self) -> Dict[str, Any]:
        """Counter deltas since the previous snapshot + current gauge
        values, bounded to ``max_metric_entries`` rows each (largest
        absolute movers kept; the cut is counted, never silent)."""
        from .metrics import Counter, Gauge, _fmt_labels
        deltas: List = []
        gauges: List = []
        baseline: Dict[str, float] = {}
        for fam in self.registry.families():
            if isinstance(fam, Counter):
                for key, child in fam._snapshot():
                    series = fam.name + _fmt_labels(fam.label_names, key)
                    val = child.value
                    baseline[series] = val
                    prev = self._counter_baseline.get(series, 0.0)
                    if val != prev:
                        deltas.append((series, val - prev, val))
            elif isinstance(fam, Gauge):
                for key, child in fam._snapshot():
                    series = fam.name + _fmt_labels(fam.label_names, key)
                    v = child.value
                    gauges.append((series, v if v == v and abs(v) != float(
                        "inf") else repr(v)))
        self._counter_baseline = baseline
        deltas.sort(key=lambda row: -abs(row[1]))
        cut_d = max(0, len(deltas) - self.max_metric_entries)
        cut_g = max(0, len(gauges) - self.max_metric_entries)
        return {
            "counter_deltas": {s: {"delta": d, "total": t}
                               for s, d, t in
                               deltas[:self.max_metric_entries]},
            "gauges": dict(gauges[:self.max_metric_entries]),
            "truncated": {"counters": cut_d, "gauges": cut_g},
        }

    def _decode_section(self) -> List[Dict[str, Any]]:
        out = []
        for dec in list(_roster(self.registry, "_decode_streams")):
            try:
                out.append(dec.debug_state())
            except Exception as e:  # noqa: BLE001 — a torn decoder is a row
                out.append({"error": f"{type(e).__name__}: {e}"})
        return out

    def _runner_section(self) -> List[Dict[str, Any]]:
        out = []
        for runner in list(_roster(self.registry, "_model_runners")):
            try:
                out.append({"runner": runner.name,
                            "bucket_calls": dict(runner.bucket_calls),
                            "last_decode_extras": runner.last_decode_extras})
            except Exception as e:  # noqa: BLE001
                out.append({"error": f"{type(e).__name__}: {e}"})
        return out

    def _membership_section(self) -> List[Dict[str, Any]]:
        out = []
        for svc in list(_roster(self.registry, "_topology_services")):
            try:
                m = svc.membership()
                out.append({"epoch": m.get("epoch"),
                            "instance": m.get("instance"),
                            "workers": sorted(m.get("workers", {}))})
            except Exception as e:  # noqa: BLE001
                out.append({"error": f"{type(e).__name__}: {e}"})
        return out

    def snapshot(self, trigger: str = "demand") -> Dict[str, Any]:
        """Assemble the bounded black-box snapshot.  Every section is
        individually guarded: one failing source costs its row, never the
        dump — a recorder that throws while the process is already dying
        would be worse than useless."""
        from ..core.logging import recent_events
        from .collector import get_collector
        from .compute import compile_report
        from .tracing import thread_phases

        snap: Dict[str, Any] = {
            "trigger": trigger,
            "pid": os.getpid(),
            "dumped_at_unix": time.time(),
            "recorder": self._label,
        }
        sections: List = [
            ("ring_events", lambda: recent_events()[-self.ring_n:]),
            ("slow_spans", lambda: get_collector(self.registry).slowest(
                k=self.slow_k)),
            ("compile", lambda: compile_report(self.registry)),
            ("metrics", self._metric_section),
            # thread ident -> innermost ambient phase at dump time: a
            # train_stall dump names WHICH phase every worker was stuck in
            # (tile_load vs histogram vs train_step), not just that the
            # loop went quiet
            ("phases", lambda: {str(tid): name
                                for tid, name in thread_phases().items()}),
            ("decode_streams", self._decode_section),
            ("runners", self._runner_section),
            ("membership", self._membership_section),
        ]
        with self._lock:
            extra = list(self._sources.items())
        for name, fn in extra:
            sections.append((f"source.{name}", fn))
        for name, fn in sections:
            try:
                snap[name] = fn()
            except Exception as e:  # noqa: BLE001 — see docstring
                snap[name] = {"error": f"{type(e).__name__}: {e}"}
        return snap

    # ---------------------------------------------------------------- dump
    def dump(self, trigger: str = "demand") -> Optional[str]:
        """Assemble and (when a ``dump_dir`` is configured) atomically
        publish one dump file; returns its path, or None when no directory
        is configured (``result="no_dir"``) or the write failed
        (``result="error"`` — the snapshot still lands on
        ``last_snapshot``).  Books every outcome."""
        snap = self.snapshot(trigger)
        self.last_snapshot = snap
        if self.dump_dir is None:
            self._m["dumps"].inc(trigger=trigger, result="no_dir")
            return None
        seq = next(self._seq)
        path = os.path.join(self.dump_dir,
                            f"flightdump_{seq:06d}_{trigger}.json")
        try:
            from ..io.checkpoint import atomic_write
            with atomic_write(path, "w") as fh:
                json.dump(snap, fh, default=str)
            self._last_dump_s = self.clock()
            self._m["dumps"].inc(trigger=trigger, result="ok")
            self._prune()
            return path
        except Exception:  # noqa: BLE001 — a failed dump must never
            self._m["dumps"].inc(trigger=trigger, result="error")
            return None   # cascade into the crash path that asked for it

    def _prune(self) -> None:
        """Keep the newest ``keep_last`` dump files (by sequence in the
        name; best-effort — a prune failure never fails the dump)."""
        try:
            names = sorted(n for n in os.listdir(self.dump_dir)
                           if n.startswith("flightdump_")
                           and n.endswith(".json"))
            for stale in names[:-self.keep_last]:
                try:
                    os.unlink(os.path.join(self.dump_dir, stale))
                except OSError:
                    pass
        except OSError:
            pass

    # ----------------------------------------------------------- triggers
    def _on_preemption(self, reason) -> None:
        try:
            self.dump(trigger="preemption")
        except Exception:  # noqa: BLE001 — never block the shutdown path
            pass

    def _sys_hook(self, exc_type, exc, tb) -> None:
        try:
            self.dump(trigger="crash")
        except Exception:  # noqa: BLE001 — the original traceback wins
            pass
        prev = self._prev_sys_hook or sys.__excepthook__
        prev(exc_type, exc, tb)

    def _threading_hook(self, args) -> None:
        try:
            self.dump(trigger="crash")
        except Exception:  # noqa: BLE001
            pass
        prev = self._prev_threading_hook or threading.__excepthook__
        prev(args)

    def install(self) -> "FlightRecorder":
        """Chain the crash hooks and register the preemption hook.
        Idempotent; :meth:`uninstall` restores only what this recorder
        installed (and only if still in place)."""
        if self._installed:
            return self
        self._installed = True
        self._prev_sys_hook = sys.excepthook
        sys.excepthook = self._sys_hook
        self._prev_threading_hook = threading.excepthook
        threading.excepthook = self._threading_hook
        from ..utils.resilience import register_preemption_hook
        register_preemption_hook(self._on_preemption)
        return self

    def uninstall(self) -> None:
        if not self._installed:
            return
        self._installed = False
        # bound-method EQUALITY, not identity: each `self._sys_hook` access
        # builds a fresh bound-method object, so `is` would never match and
        # the hooks would leak past close()
        if sys.excepthook == self._sys_hook:
            sys.excepthook = self._prev_sys_hook or sys.__excepthook__
        if threading.excepthook == self._threading_hook:
            threading.excepthook = self._prev_threading_hook \
                or threading.__excepthook__
        from ..utils.resilience import unregister_preemption_hook
        unregister_preemption_hook(self._on_preemption)

    def close(self) -> None:
        """Uninstall hooks and unhook the age gauge (its closure pins this
        recorder; a discarded test recorder must not scrape forever)."""
        self.uninstall()
        self._m["age"].remove(recorder=self._label)
        if getattr(self.registry, "_flight_recorder", None) is self:
            self.registry._flight_recorder = None


_recorder_lock = make_lock("flightrecorder._recorder_lock")


def get_flight_recorder(registry: Optional[MetricsRegistry] = None,
                        **kwargs) -> FlightRecorder:
    """The per-registry recorder, created (with crash/preemption hooks
    installed) on first use — ``PipelineServer``/``TopologyService``
    construction goes through here so every serving process records."""
    reg = registry if registry is not None else get_registry()
    rec = getattr(reg, "_flight_recorder", None)
    if rec is None:
        with _recorder_lock:
            rec = getattr(reg, "_flight_recorder", None)
            if rec is None:
                rec = FlightRecorder(registry=reg, install=True, **kwargs)
                reg._flight_recorder = rec
    return rec
