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

``InstrumentedJit``, ``instrumented_jit``, ``device_put`` and
``transfer_nbytes`` describe ``jax.jit`` and ``jax.device_put``; they
raise ``NotImplementedError`` naming ROADMAP.md §1 item 13.  ``torch`` is
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

_NOT_PORTED = ("{} instruments jax.jit / jax.device_put, which the port "
               "does not use; the compute plane's compile and transfer "
               "booking is not ported yet (ROADMAP.md §1 item 13)")


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


def device_put(*args, **kwargs):
    """Not ported: raises (ROADMAP.md §1 item 13)."""
    raise NotImplementedError(_NOT_PORTED.format("device_put"))


def transfer_nbytes(*args, **kwargs):
    """Not ported: raises (ROADMAP.md §1 item 13)."""
    raise NotImplementedError(_NOT_PORTED.format("transfer_nbytes"))


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
