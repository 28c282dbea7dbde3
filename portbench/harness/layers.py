"""What the per-layer readers share: the traced items' spans and the
device time inside them."""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from . import trace

COPY_PREFIXES = ("Memcpy", "Memset")


def spans(run) -> List[Tuple[float, float]]:
    return [t["span"] for t in run.traced]


def range_in(run, name: str, span) -> Optional[Tuple[float, float]]:
    """The first host range ``name`` that starts inside ``span``."""
    lo, hi = span
    for s, e in run.tracer.ranges(name):
        if lo <= s <= hi:
            return s, e
    return None


def kernel_us(run, span, names: Optional[Sequence[str]] = None) -> float:
    """Device time of kernels (not copies or fills) inside ``span``,
    those whose name holds one of ``names`` when given."""
    ivs = [iv for iv in trace.clip(run.tracer.device, *span)
           if not iv[2].startswith(COPY_PREFIXES)
           and (names is None or any(k in iv[2] for k in names))]
    return sum(e - s for s, e in trace.merged(ivs))


def idle_pct(run) -> Optional[float]:
    if not run.traced:
        return None
    sp = spans(run)
    wall = sum(e - s for s, e in sp)
    return 100.0 * (1.0 - trace.busy_us(run.tracer, sp) / wall)


def roofline_pct(run, least_s_of, kernel: str) -> Optional[float]:
    """The traced items' least time over their device time in
    ``kernel``, as a percentage; nothing when the kernel never ran."""
    if not run.traced:
        return None
    least = sum(least_s_of(t) for t in run.traced)
    took = sum(kernel_us(run, t["span"], [kernel]) for t in run.traced)
    return 100.0 * least / (took / 1e6) if took > 0 else None
