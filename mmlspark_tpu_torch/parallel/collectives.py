"""Collectives over the mesh's process groups — the allreduce backend (port
of ``mmlspark_tpu/parallel/collectives.py``).

The reference's ``jax.lax`` collectives run inside ``shard_map``; here each
rank is a process and a collective is a ``torch.distributed`` call on the
group of the named mesh axis (``mesh.Mesh.group``).  An axis of size one is
the identity and needs no process group.  Every function takes the mesh
(default: the active one) and returns a new tensor; none copies a device
tensor to the host on its own: a backend that refuses a collective on a
tensor's device (``gloo`` takes CUDA tensors in ``all_reduce`` only)
raises.

Every ``all_reduce`` that crosses ranks is booked in this process
(``collective_stats``: calls and bytes; with ``timed`` set by
``reset_collective_stats``, also the seconds between a device sync before
it and one after it — off by default, since the syncs cost the overlap).
"""
from __future__ import annotations

import functools
import threading
import time
from typing import Callable

import torch

from .mesh import AXIS_DATA, get_active_mesh
from .sharding import NamedSharding, PartitionSpec


def _axis(mesh, axis: str):
    """``(mesh, size, group)`` of ``axis`` on ``mesh`` (default: active)."""
    mesh = mesh or get_active_mesh()
    size = mesh.shape[axis]
    if size > 1:
        from .mesh import _dist
        if _dist() is None:
            raise RuntimeError(
                f"a collective over the {axis!r} axis of {size} positions "
                "needs an initialized process group "
                "(parallel.initialize_distributed)")
    return mesh, size, mesh.group(axis)


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(x)


_STATS_LOCK = threading.Lock()
_STATS = {"all_reduce_calls": 0, "all_reduce_bytes": 0,
          "all_reduce_s": 0.0}
_TIMED = False


def reset_collective_stats(timed: bool = False) -> None:
    """Zero the book; ``timed`` also clocks each all_reduce between device
    syncs."""
    global _TIMED
    with _STATS_LOCK:
        _STATS.update(all_reduce_calls=0, all_reduce_bytes=0,
                      all_reduce_s=0.0)
        _TIMED = bool(timed)


def collective_stats() -> dict:
    """This process's all_reduce calls, bytes and (timed) seconds since the
    last reset."""
    with _STATS_LOCK:
        return dict(_STATS, timed=_TIMED)


def _sync(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def _all_reduce(x, axis: str, op: str, mesh=None) -> torch.Tensor:
    import torch.distributed as dist
    mesh, size, group = _axis(mesh, axis)
    out = _as_tensor(x).clone().contiguous()
    if size > 1:
        timed = _TIMED
        if timed:
            _sync(out)
        t0 = time.perf_counter()
        dist.all_reduce(out, op=getattr(dist.ReduceOp, op), group=group)
        if timed:
            _sync(out)
        with _STATS_LOCK:
            _STATS["all_reduce_calls"] += 1
            _STATS["all_reduce_bytes"] += out.numel() * out.element_size()
            if timed:
                _STATS["all_reduce_s"] += time.perf_counter() - t0
    return out


def psum(x, axis: str = AXIS_DATA, mesh=None) -> torch.Tensor:
    """Sum over the axis (integer sums wrap as int32/int64 adds do)."""
    return _all_reduce(x, axis, "SUM", mesh)


def pmean(x, axis: str = AXIS_DATA, mesh=None) -> torch.Tensor:
    """Mean over the axis: a sum, then a divide (``gloo`` has no AVG)."""
    mesh = mesh or get_active_mesh()
    return psum(x, axis, mesh) / mesh.shape[axis]


def pmax(x, axis: str = AXIS_DATA, mesh=None) -> torch.Tensor:
    return _all_reduce(x, axis, "MAX", mesh)


def histogram_psum(hist_i32, axis: str = AXIS_DATA, row_bound: int = None,
                   quant_bins: int = None, num_tiles: int = 1, mesh=None):
    """Allreduce for quantized GBDT histograms — ``(..., 3)`` int32
    ``[sum_qg, sum_qh, count]`` tensors (``ops.histogram`` quantized
    builders).

    When the global row bound keeps both integer lanes under 14 bits
    (``row_bound * num_tiles * max(quant level) < 2**14`` — signed 16/16
    lanes with carry margin), the grad and hess sums pack into ONE int32
    channel for the transfer: the allreduce moves 2 channels instead of 3,
    a third off the bytes on top of the exactness the integer sum already
    buys (f32 sums of large histograms are reduction-order dependent; int32
    sums are not).  Above the bound the tensor is summed as it is, still
    exact.

    ``row_bound`` is a caller contract like ``max_rows`` in
    ``ops.histogram``: the TOTAL row count across ranks (the padded global
    n), never a guess.  ``num_tiles`` extends it to a rank that accumulates
    per-tile int32 partials: a cell is then bounded by ``row_bound *
    num_tiles``.  The lanes decode with floor ``%`` and ``//``, whose
    semantics torch's integer ops share."""
    h = _as_tensor(hist_i32)
    if (h.dtype != torch.int32 or row_bound is None
            or quant_bins is None):
        return psum(h, axis, mesh)
    qcap = max(1, quant_bins - 1)              # worst lane magnitude
    if int(row_bound) * max(1, int(num_tiles)) * qcap >= (1 << 14):
        return psum(h, axis, mesh)
    packed = h[..., 0] * 65536 + h[..., 1]
    two = psum(torch.stack([packed, h[..., 2]], dim=-1), axis, mesh)
    qh = two[..., 0] % 65536                   # hess lane is non-negative,
    qg = (two[..., 0] - qh) // 65536           # so floor mod/div decode
    return torch.stack([qg, qh, two[..., 1]], dim=-1)


def all_gather(x, axis: str = AXIS_DATA, tiled: bool = True, mesh=None):
    """Every rank's ``x`` along the axis, in axis order: concatenated on
    dim 0 (``tiled``) or stacked on a new leading dim."""
    import torch.distributed as dist
    mesh, size, group = _axis(mesh, axis)
    x = _as_tensor(x).contiguous()
    if size == 1:
        parts = [x]
    else:
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=0) if tiled else torch.stack(parts)


def ppermute(x, perm, axis: str = AXIS_DATA, mesh=None):
    """Send ``x`` along ``perm`` (``(source, destination)`` pairs of axis
    coordinates); a rank no pair sends to receives zeros, as in
    ``jax.lax.ppermute``."""
    import torch.distributed as dist
    mesh, size, group = _axis(mesh, axis)
    x = _as_tensor(x).contiguous()
    me = mesh.axis_index(axis)
    out = torch.zeros_like(x)
    if size == 1:
        return x.clone() if (me, me) in set(map(tuple, perm)) else out
    ranks = mesh.axis_ranks(axis)
    ops = []
    for src, dst in perm:
        if src == me and dst == me:
            out.copy_(x)
        elif src == me:
            ops.append(dist.P2POp(dist.isend, x, ranks[dst], group=group))
        elif dst == me:
            ops.append(dist.P2POp(dist.irecv, out, ranks[src], group=group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


def ring_perm(n: int, shift: int = 1):
    """Neighbour permutation for ring pipelines (ring attention etc.)."""
    return [(i, (i + shift) % n) for i in range(n)]


def axis_index(axis: str = AXIS_DATA, mesh=None) -> int:
    """This rank's coordinate along ``axis``."""
    return (mesh or get_active_mesh()).axis_index(axis)


def _specs(specs, n: int):
    if isinstance(specs, PartitionSpec) or specs is None or \
            isinstance(specs, str):
        return [specs] * n
    return list(specs)


def _split_axis(spec):
    if spec is None:
        return None
    if isinstance(spec, str):
        return spec
    return spec[0] if len(spec) else None


def shard_mapped(fn: Callable, mesh=None, in_specs=None, out_specs=None,
                 check_vma: bool = False):
    """Wrap ``fn`` as an SPMD program on the mesh: each input whose spec
    splits the leading dim over an axis (default ``PartitionSpec("data")``)
    is cut to this rank's contiguous block, ``fn`` runs on the blocks, and
    each output whose spec splits an axis is gathered back along it (default
    ``PartitionSpec()``: the output is already replicated, e.g. after a
    ``psum``).  Inputs are the whole arrays, which every rank holds;
    ``check_vma`` is accepted for the reference's signature."""
    in_specs = in_specs if in_specs is not None else PartitionSpec(AXIS_DATA)
    out_specs = out_specs if out_specs is not None else PartitionSpec()

    @functools.wraps(fn)
    def wrapped(*args):
        m = mesh or get_active_mesh()
        local = []
        for a, spec in zip(args, _specs(in_specs, len(args))):
            ax = _split_axis(spec)
            if ax is None:
                local.append(a)
                continue
            t = _as_tensor(a)
            local.append(t[NamedSharding(m, PartitionSpec(ax)).block(
                t.shape[0])])
        out = fn(*local)
        single = not isinstance(out, tuple)
        outs = (out,) if single else out
        res = []
        for o, spec in zip(outs, _specs(out_specs, len(outs))):
            ax = _split_axis(spec)
            res.append(o if ax is None else all_gather(o, ax, mesh=m))
        return res[0] if single else tuple(res)

    return wrapped
