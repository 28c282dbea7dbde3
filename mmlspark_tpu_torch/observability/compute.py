"""Compute-plane telemetry — the partial twin of the JAX package's
``observability/compute.py``: the three functions the serving front calls,
under the reference's metric names.

- :func:`compile_report` — the JSON behind ``GET /debug/compile`` on
  ``PipelineServer``: per-function compile counts and signatures.  The
  port runs eagerly and compiles nothing through a jit, so the registry's
  compile table stays empty (``{"functions": {}}``) until the decode step
  is captured as a CUDA graph (ROADMAP.md §2 item 6), which will book
  there.
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

``InstrumentedJit`` and ``instrumented_jit`` describe ``jax.jit``; they
raise ``NotImplementedError`` naming ROADMAP.md §1 item 13 (their torch
meaning is CUDA-graph capture, ROADMAP.md §2 item 6).  ``torch`` is
imported lazily inside functions, as the reference imports jax.
"""
from __future__ import annotations

import functools
import os
from typing import Any, Dict, Optional

from .metrics import MetricsRegistry, get_registry

__all__ = ["InstrumentedJit", "instrumented_jit", "device_put",
           "transfer_nbytes", "compile_report",
           "ensure_device_memory_gauges", "ensure_build_info",
           "STORM_SIGNATURES_ENV", "DEFAULT_STORM_SIGNATURES"]

#: env override for the recompile-storm threshold (the reference's knob;
#: reported by :func:`compile_report`)
STORM_SIGNATURES_ENV = "MMLSPARK_TPU_JIT_STORM_SIGS"
DEFAULT_STORM_SIGNATURES = 8

_NOT_PORTED = ("{} instruments jax.jit, which the port does not use; "
               "the compute plane's compile booking is not ported yet "
               "(ROADMAP.md §1 item 13)")


def _storm_threshold() -> int:
    try:
        return max(1, int(os.environ.get(STORM_SIGNATURES_ENV, "")
                          or DEFAULT_STORM_SIGNATURES))
    except ValueError:
        return DEFAULT_STORM_SIGNATURES


class InstrumentedJit:
    """Not ported: raises (ROADMAP.md §1 item 13)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(_NOT_PORTED.format("InstrumentedJit"))


def instrumented_jit(*args, **kwargs):
    """Not ported: raises (ROADMAP.md §1 item 13)."""
    raise NotImplementedError(_NOT_PORTED.format("instrumented_jit"))


def compile_report(registry: Optional[MetricsRegistry] = None
                   ) -> Dict[str, Any]:
    """Aggregated per-function compile state — ``GET /debug/compile``, in
    the reference's shape.  Entries come from wrappers registered in the
    registry's ``_jit_wrappers`` table; the port registers none yet."""
    reg = registry if registry is not None else get_registry()
    table: Dict[str, Any] = getattr(reg, "_jit_wrappers", {})
    functions: Dict[str, Any] = {}
    for name in sorted(table):
        snaps = [w.snapshot() for w in table[name]]
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
