"""Compute-plane telemetry — the twin of the JAX package's
``observability/compute.py``, under the reference's metric names.

- :func:`compile_report` — the JSON behind ``GET /debug/compile`` on
  ``PipelineServer``: per-function compile counts and signatures of the
  registered :class:`InstrumentedJit` wrappers.
- :func:`ensure_device_memory_gauges` —
  ``mmlspark_device_bytes_in_use{device}`` and
  ``mmlspark_device_peak_bytes_in_use{device}``, callback gauges sampled
  from ``torch.cuda.memory_stats`` at scrape time (``allocated_bytes.all
  .current`` / ``.peak``).  Without a card nothing registers: a dashboard
  should see no series, not a wall of NaN.
- :func:`ensure_build_info` — ``mmlspark_build_info``, constant 1,
  labelled with the torch version, the CUDA version, the device kind and
  the local device count.
- :func:`transfer_nbytes` and :func:`device_put` — host -> device
  transfer accounting: ``mmlspark_device_transfer_bytes_total{site}``,
  booked on the host before the copy, with no sync.

- :class:`InstrumentedJit` / :func:`instrumented_jit` — the reference's
  compile-boundary telemetry around an eager callable.  Every call keys
  its arguments' signature (the nest's structure and each leaf's shape and
  dtype; static arguments by value); the first call of a new signature is
  booked as that signature's "compile" (``mmlspark_jit_compile_total{fn}``,
  its wall time in ``mmlspark_jit_compile_seconds{fn}``, the recompile-
  storm trip at ``MMLSPARK_TPU_JIT_STORM_SIGS`` distinct signatures), and
  the wrapper registers in the registry's ``_jit_wrappers`` table, so
  :func:`compile_report` lists it in the reference's shape.  Nothing is
  compiled or captured: the first call of a signature is where the port
  builds its kernels, picks its cuDNN algorithms and allocates its caches,
  which is what the count is for.  CUDA-graph capture is ROADMAP.md §2
  (items 6, 11, 12 and 14).

``torch`` is imported lazily inside functions, as the reference imports
jax.
"""
from __future__ import annotations

import dataclasses
import functools
import inspect
import os
import threading
import time
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple

from .metrics import MetricsRegistry, get_registry

__all__ = ["InstrumentedJit", "instrumented_jit", "device_put",
           "transfer_nbytes", "compile_report",
           "ensure_device_memory_gauges", "ensure_build_info",
           "STORM_SIGNATURES_ENV", "DEFAULT_STORM_SIGNATURES"]

#: env override for the recompile-storm threshold (the reference's knob;
#: reported by :func:`compile_report`)
STORM_SIGNATURES_ENV = "MMLSPARK_TPU_JIT_STORM_SIGS"
DEFAULT_STORM_SIGNATURES = 8



def _storm_threshold() -> int:
    raw = os.environ.get(STORM_SIGNATURES_ENV, "")
    try:
        return max(2, int(raw)) if raw.strip() else DEFAULT_STORM_SIGNATURES
    except ValueError:
        return DEFAULT_STORM_SIGNATURES


# ---------------------------------------------------------------------------
# signatures
# ---------------------------------------------------------------------------

_DTYPE_SHORT = {"float32": "f32", "float64": "f64", "float16": "f16",
                "bfloat16": "bf16", "int32": "i32", "int64": "i64",
                "int16": "i16", "int8": "i8", "uint8": "u8",
                "uint16": "u16", "uint32": "u32", "bool": "b1"}


def _leaf_sig(leaf) -> Tuple:
    """One leaf's identity: a tensor or array keys on its shape, dtype and
    device; a Python scalar on its type only (a new value is not a new
    signature, as under ``jax.jit``)."""
    if hasattr(leaf, "shape") and hasattr(leaf, "dtype"):
        return ("a", tuple(int(d) for d in leaf.shape),
                str(leaf.dtype).replace("torch.", ""),
                str(getattr(leaf, "device", "cpu")))
    return ("py", type(leaf).__name__)


def _flat(tree, leaves: List) -> Tuple:
    """The structure of a nest of dicts (keys sorted), lists, tuples,
    named tuples and dataclasses, appending its leaves in order."""
    if tree is None:
        return ("none",)
    if isinstance(tree, dict):
        keys = sorted(tree)
        return ("dict", tuple((k, _flat(tree[k], leaves)) for k in keys))
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__, tuple(_flat(v, leaves) for v in tree))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return (type(tree).__name__, tuple(
            (f.name, _flat(getattr(tree, f.name), leaves))
            for f in dataclasses.fields(tree)))
    leaves.append(tree)
    return ("*",)


def _render_leaf(sig: Tuple) -> str:
    if sig[0] == "a":
        dt = _DTYPE_SHORT.get(sig[2], sig[2])
        return f"{dt}[{','.join(str(d) for d in sig[1])}]"
    return f"py:{sig[1]}"


class _SigEntry:
    __slots__ = ("rendered", "compile_s")

    def __init__(self, rendered: str, compile_s: float):
        self.rendered, self.compile_s = rendered, compile_s


class InstrumentedJit:
    """``fn`` with the reference's compile-boundary telemetry (see the
    module doc).  The steady state is one signature build and a dict hit
    before the call; a new signature books its first call's wall time as
    its compile, then checks the storm threshold.

    ``static_argnums`` / ``static_argnames`` key those arguments by value.
    ``in_shardings``, ``out_shardings``, ``donate_argnums`` and
    ``donate_argnames`` (and any other ``jax.jit`` keyword) are accepted
    for the reference's signature and kept on the wrapper
    (``jit_kwargs``): placement is the caller's (a rank already holds its
    blocks, ``parallel.sharding``) and donation has no eager meaning (a
    torch step updates its tensors in place).  ``last_cost_analysis`` is
    always ``None``: nothing is lowered, so there is no cost analysis to
    read."""

    def __init__(self, fn: Callable, *, name: Optional[str] = None,
                 registry: Optional[MetricsRegistry] = None,
                 storm_signatures: Optional[int] = None,
                 static_argnums=(), static_argnames=(), **jit_kwargs):
        self._fn = fn
        self.name = name or getattr(fn, "__name__", None) or "anonymous"
        self.registry = registry if registry is not None else get_registry()
        self.storm_signatures = storm_signatures or _storm_threshold()
        self.jit_kwargs = dict(jit_kwargs)
        self._static_nums = set(int(i) for i in (
            (static_argnums,) if isinstance(static_argnums, int)
            else static_argnums or ()))
        self._static_names = set((static_argnames,) if isinstance(
            static_argnames, str) else static_argnames or ())
        if self._static_names:
            try:
                params = list(inspect.signature(fn).parameters)
                self._static_nums |= {params.index(n)
                                      for n in self._static_names
                                      if n in params}
            except (TypeError, ValueError):
                pass
        self._entries: Dict[Tuple, _SigEntry] = {}
        self._lock = threading.Lock()
        self._storm_tripped = False
        self.last_compile_s = 0.0
        reg = self.registry
        self._c_compile = reg.counter(
            "mmlspark_jit_compile_total",
            "XLA compilations by instrumented function",
            labels=("fn",)).labels(fn=self.name)
        self._h_compile = reg.histogram(
            "mmlspark_jit_compile_seconds",
            "lower+compile wall time per new abstract signature",
            labels=("fn",)).labels(fn=self.name)
        self._c_storm = reg.counter(
            "mmlspark_jit_recompile_storm_total",
            "signatures compiled at/over the recompile-storm threshold",
            labels=("fn",)).labels(fn=self.name)
        table = getattr(reg, "_jit_wrappers", None)
        if table is None:
            table = reg._jit_wrappers = {}
        table.setdefault(self.name, weakref.WeakSet()).add(self)

    def _signature(self, args, kwargs) -> Tuple[Tuple, List]:
        sig: List = []
        rendered: List[str] = []
        for i, a in enumerate(args):
            if i in self._static_nums:
                sig.append(("static", a))
                rendered.append(f"static:{a!r}")
                continue
            leaves: List = []
            struct = _flat(a, leaves)
            ls = tuple(_leaf_sig(l) for l in leaves)
            sig.append((struct, ls))
            rendered.append("/".join(map(_render_leaf, ls)) or "()")
        for k in sorted(kwargs):
            if k in self._static_names:
                sig.append((k, ("static", kwargs[k])))
                rendered.append(f"{k}=static:{kwargs[k]!r}")
                continue
            leaves = []
            struct = _flat(kwargs[k], leaves)
            ls = tuple(_leaf_sig(l) for l in leaves)
            sig.append((k, struct, ls))
            rendered.append(f"{k}=" + ("/".join(map(_render_leaf, ls))
                                       or "()"))
        return tuple(sig), rendered

    def __call__(self, *args, **kwargs):
        sig, rendered = self._signature(args, kwargs)
        if sig in self._entries:             # GIL-atomic read; hot path
            return self._fn(*args, **kwargs)
        t0 = time.perf_counter()
        out = self._fn(*args, **kwargs)
        dt = time.perf_counter() - t0
        with self._lock:
            if sig not in self._entries:
                self._entries[sig] = _SigEntry(", ".join(rendered), dt)
                self.last_compile_s = dt
                self._book_compile(self._entries[sig], len(self._entries))
        return out

    def _book_compile(self, entry: _SigEntry, n_sigs: int) -> None:
        self._c_compile.inc()
        self._h_compile.observe(entry.compile_s)
        if n_sigs >= self.storm_signatures:
            self._c_storm.inc()
            if not self._storm_tripped:
                self._storm_tripped = True
                from ..core.logging import log_event  # lazy: import cycle
                log_event({"event": "recompile_storm",
                           "className": "InstrumentedJit", "fn": self.name,
                           "distinct_signatures": n_sigs,
                           "threshold": self.storm_signatures,
                           "last_signature": entry.rendered})

    @property
    def compiles(self) -> int:
        return len(self._entries)

    def snapshot(self) -> Dict[str, Any]:
        """JSON-able state for ``/debug/compile``."""
        with self._lock:
            entries = list(self._entries.values())
            tripped = self._storm_tripped
        return {"fn": self.name, "compiles": len(entries),
                "storm_threshold": self.storm_signatures,
                "storm_tripped": tripped,
                "signatures": [{"signature": e.rendered,
                                "compile_seconds": round(e.compile_s, 6),
                                "cost_analysis": None, "aot": False}
                               for e in entries],
                "last_cost_analysis": None}

    def __repr__(self):
        return (f"InstrumentedJit({self.name!r}, "
                f"signatures={len(self._entries)})")


def instrumented_jit(fn: Optional[Callable] = None, *,
                     name: Optional[str] = None,
                     registry: Optional[MetricsRegistry] = None,
                     storm_signatures: Optional[int] = None,
                     static_argnums=(), static_argnames=(), **jit_kwargs):
    """The reference's ``instrumented_jit``: ``instrumented_jit(fn,
    name=...)`` or ``@instrumented_jit(name=...)``.  See
    :class:`InstrumentedJit`."""
    if fn is None:
        return functools.partial(
            instrumented_jit, name=name, registry=registry,
            storm_signatures=storm_signatures, static_argnums=static_argnums,
            static_argnames=static_argnames, **jit_kwargs)
    return InstrumentedJit(fn, name=name, registry=registry,
                           storm_signatures=storm_signatures,
                           static_argnums=static_argnums,
                           static_argnames=static_argnames, **jit_kwargs)


def compile_report(registry: Optional[MetricsRegistry] = None
                   ) -> Dict[str, Any]:
    """Aggregated per-function compile state — ``GET /debug/compile``, in
    the reference's shape.  Entries come from the :class:`InstrumentedJit`
    wrappers registered in the registry's ``_jit_wrappers`` table; wrappers
    sharing a ``name`` merge into one entry."""
    reg = registry if registry is not None else get_registry()
    table: Dict[str, Any] = getattr(reg, "_jit_wrappers", {})
    functions: Dict[str, Any] = {}
    for name in sorted(table):
        snaps = [w.snapshot() for w in list(table[name])]
        if not snaps:
            continue
        functions[name] = {
            "compiles": sum(s["compiles"] for s in snaps),
            "storm_threshold": min(s["storm_threshold"] for s in snaps),
            "storm_tripped": any(s["storm_tripped"] for s in snaps),
            "signatures": [sig for s in snaps for sig in s["signatures"]],
            "last_cost_analysis": next(
                (s["last_cost_analysis"] for s in reversed(snaps)
                 if s["last_cost_analysis"] is not None), None),
        }
    return {"functions": functions,
            "storm_threshold_default": _storm_threshold()}


# ---------------------------------------------------------------------------
# device-memory gauges
# ---------------------------------------------------------------------------

def _mem_stat(index: int, key: str) -> float:
    import torch
    stats = torch.cuda.memory_stats(index)
    return float(stats.get(key, float("nan")))


def ensure_device_memory_gauges(registry: Optional[MetricsRegistry] = None,
                                devices=None) -> bool:
    """Register per-card callback gauges sampled from
    ``torch.cuda.memory_stats`` at scrape time:

    - ``mmlspark_device_bytes_in_use{device}``
    - ``mmlspark_device_peak_bytes_in_use{device}``

    ``devices`` is an iterable of CUDA device indices (default: every
    visible card).  Idempotent per registry.  Without a card nothing
    registers.  Returns True when the gauges are live."""
    reg = registry if registry is not None else get_registry()
    state = getattr(reg, "_device_mem_gauges", None)
    if state:
        return True
    if state is False and devices is None:
        return False
    if devices is None:
        try:
            import torch
            if not torch.cuda.is_available():
                reg._device_mem_gauges = False
                return False
            devices = range(torch.cuda.device_count())
        except Exception:  # noqa: BLE001 — runtime unreachable: no
            return False   # verdict cached, retried next call
    live = [int(d) for d in devices]
    if not live:
        reg._device_mem_gauges = False
        return False
    g_use = reg.gauge("mmlspark_device_bytes_in_use",
                      "live allocated bytes per local device (sampled from "
                      "memory_stats at scrape time)", labels=("device",))
    g_peak = reg.gauge("mmlspark_device_peak_bytes_in_use",
                       "high-water allocated bytes per local device",
                       labels=("device",))
    for d in live:
        label = f"cuda:{d}"
        g_use.set_function(functools.partial(
            _mem_stat, d, "allocated_bytes.all.current"), device=label)
        g_peak.set_function(functools.partial(
            _mem_stat, d, "allocated_bytes.all.peak"), device=label)
    reg._device_mem_gauges = True
    return True


# ---------------------------------------------------------------------------
# host->device transfer accounting
# ---------------------------------------------------------------------------

def _leaves(x):
    """The leaves of a nest of dicts, lists and tuples, in the order
    ``jax.tree_util`` flattens them (dict keys sorted); ``None`` is an
    empty nest."""
    if x is None:
        return
    if isinstance(x, dict):
        for k in sorted(x):
            yield from _leaves(x[k])
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _leaves(v)
    else:
        yield x


def transfer_nbytes(x) -> int:
    """Total buffer bytes in a nest of tensors and numpy arrays (what a
    device_put will move or, for already-resident tensors, re-place)."""
    return sum(int(getattr(leaf, "nbytes", 0)) for leaf in _leaves(x))


def _transfer_child(site: str, reg: MetricsRegistry):
    cache = getattr(reg, "_transfer_children", None)
    if cache is None:
        cache = reg._transfer_children = {}
    child = cache.get(site)
    if child is None:
        child = cache[site] = reg.counter(
            "mmlspark_device_transfer_bytes_total",
            "bytes offered to device_put by call site (host->device feed; "
            "already-resident arrays count as placement)",
            labels=("site",)).labels(site=site)
    return child


def _place(x, device, non_blocking: bool):
    import torch
    if x is None:
        return None
    if isinstance(x, dict):
        return {k: _place(v, device, non_blocking) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_place(v, device, non_blocking) for v in x)
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(x)
    return x.to(device, non_blocking=non_blocking)


def device_put(x, device=None, *, site: str = "unlabeled",
               registry: Optional[MetricsRegistry] = None,
               non_blocking: bool = False):
    """The port's ``jax.device_put``: books
    ``mmlspark_device_transfer_bytes_total{site}`` before the transfer,
    then moves every leaf of the nest to ``device`` (``None``: the card)
    with ``.to(device, non_blocking=...)``; numpy leaves become tensors.
    The byte count is computed on the host from the input leaves, so the
    booking adds no device sync."""
    from .._device import resolve_device
    dev = resolve_device(device)
    reg = registry if registry is not None else get_registry()
    _transfer_child(site, reg).inc(transfer_nbytes(x))
    return _place(x, dev, non_blocking)


# ---------------------------------------------------------------------------
# build info
# ---------------------------------------------------------------------------

def ensure_build_info(registry: Optional[MetricsRegistry] = None) -> bool:
    """Register the ``mmlspark_build_info`` gauge (constant 1) labelled with
    the torch version, the CUDA version torch was built with (``"none"``
    on a CPU build), the backend, the device kind and the local device
    count.  Idempotent per registry."""
    reg = registry if registry is not None else get_registry()
    state = getattr(reg, "_build_info_done", None)
    if state is not None:
        return state
    try:
        import torch
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        kind = torch.cuda.get_device_name(0) if n else "cpu"
        reg.gauge("mmlspark_build_info",
                  "constant 1; labels identify the compute environment",
                  labels=("torch", "cuda", "backend", "device_kind",
                          "device_count")
                  ).set(1.0, torch=torch.__version__,
                        cuda=str(torch.version.cuda or "none"),
                        backend="cuda" if n else "cpu", device_kind=kind,
                        device_count=str(n))
    except Exception:  # noqa: BLE001 — runtime unreachable: skip quietly
        reg._build_info_done = False
        return False
    reg._build_info_done = True
    return True
