"""The device trace of a traced run: ``torch.profiler`` over a stretch of
the window, reduced to device intervals and host ranges.

Times are microseconds on the profiler's clock.  A device interval is a
kernel, copy or fill on the card; the ranges that ``record_function``
mirrors onto the device are annotations, not work, and are left out.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch

Interval = Tuple[float, float, str]


class Trace:
    """Profile the block; afterwards ``device`` and ``host`` hold the
    intervals, sorted by start."""

    def __init__(self, device: torch.device):
        self.device_type = device.type
        self.device: List[Interval] = []
        self.host: List[Interval] = []
        self._prof = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device_type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self.device_type == "cuda":
            torch.cuda.synchronize()
        self._prof.__exit__(*exc)
        host_names = set()
        dev, host = [], []
        for e in self._prof.events():
            iv = (float(e.time_range.start), float(e.time_range.end), e.name)
            if e.device_type == torch.autograd.DeviceType.CUDA:
                dev.append((iv, bool(getattr(e, "is_user_annotation",
                                             False))))
            else:
                host.append(iv)
                host_names.add(e.name)
        self.host = sorted(host)
        # a range mirrored onto the device carries a host range's name
        self.device = sorted(iv for iv, note in dev
                             if not note and iv[2] not in host_names)
        self._prof = None
        return False

    def ranges(self, name: str) -> List[Tuple[float, float]]:
        return [(s, e) for s, e, n in self.host if n == name]


def clip(intervals: Iterable[Interval], lo: float, hi: float
         ) -> List[Interval]:
    return [(max(s, lo), min(e, hi), n) for s, e, n in intervals
            if e > lo and s < hi]


def merged(intervals: Iterable[Interval]) -> List[Tuple[float, float]]:
    """The union of the intervals, as disjoint sorted pairs."""
    out: List[List[float]] = []
    for s, e, _ in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_us(trace: Trace, spans: Sequence[Tuple[float, float]],
            names: Optional[Sequence[str]] = None) -> float:
    """Microseconds inside ``spans`` in which the device ran something
    (only kernels whose name holds one of ``names``, when given)."""
    total = 0.0
    for lo, hi in spans:
        ivs = clip(trace.device, lo, hi)
        if names is not None:
            ivs = [iv for iv in ivs if any(k in iv[2] for k in names)]
        total += sum(e - s for s, e in merged(ivs))
    return total


def kernel_count(trace: Trace, spans, name: str) -> int:
    return sum(1 for lo, hi in spans
               for s, e, n in clip(trace.device, lo, hi) if name in n)


def top_device_ops(trace: Trace, spans, k: int = 10) -> List[list]:
    """The ``k`` device operations that took most time, in seconds."""
    by: Dict[str, float] = {}
    for lo, hi in spans:
        for s, e, n in clip(trace.device, lo, hi):
            by[n[:160]] = by.get(n[:160], 0.0) + (e - s)
    top = sorted(by.items(), key=lambda kv: -kv[1])[:k]
    return [[n, us / 1e6] for n, us in top]


def idle_gaps(trace: Trace, spans, k: int = 10) -> List[list]:
    """The device's idle time inside ``spans``, summed by the innermost
    host range open at each gap's midpoint (one sweep over the ranges,
    which nest on the launching thread); the ``k`` largest, in seconds."""
    by: Dict[str, float] = {}
    for lo, hi in spans:
        busy = merged(clip(trace.device, lo, hi))
        cuts = [lo] + [x for s, e in busy for x in (s, e)] + [hi]
        host = clip(trace.host, lo, hi)
        stack: List[Interval] = []
        nxt = 0
        for a, b in zip(cuts[0::2], cuts[1::2]):
            if b <= a:
                continue
            mid = 0.5 * (a + b)
            while nxt < len(host) and host[nxt][0] <= mid:
                while stack and stack[-1][1] < host[nxt][0]:
                    stack.pop()
                stack.append(host[nxt])
                nxt += 1
            while stack and stack[-1][1] < mid:
                stack.pop()
            label = stack[-1][2] if stack else "host outside any range"
            by[label] = by.get(label, 0.0) + (b - a)
    top = sorted(by.items(), key=lambda kv: -kv[1])[:k]
    return [[n[:160], us / 1e6] for n, us in top]
