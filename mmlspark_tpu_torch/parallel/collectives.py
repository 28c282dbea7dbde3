"""Collectives over the mesh's process groups — the allreduce backend (port
of ``mmlspark_tpu/parallel/collectives.py``).

The reference's ``jax.lax`` collectives run inside ``shard_map``; here each
rank is a process and a collective is a ``torch.distributed`` call on the
group of the named mesh axis (``mesh.Mesh.group``).  An axis of size one is
the identity and needs no process group.  Every function takes the mesh
(default: the active one) and returns a new tensor; none copies a device
tensor to the host on its own.

Routes.  NCCL, and gloo on CPU tensors, carry ``all_gather`` by
``dist.all_gather`` and ``ppermute`` by send/recv.  gloo takes CUDA tensors
in ``all_reduce`` and ``broadcast`` only, and NCCL refuses two ranks on one
card, so ranks that share a card carry both by one ``all_reduce`` over a
*slot buffer*: a ``(P, *x.shape)`` buffer of zeros in which each rank
writes its tensor into its own slot (for ``ppermute``, the slot of its
destination), viewed as integers (``int32`` / ``int64`` for 4- and 8-byte
elements, bytes otherwise) and summed.  Every slot has one nonzero writer,
so the sum is the writer's bits exactly: no ``-0.0`` -> ``+0.0``, no
rounding, NaN payloads kept.  The route moves P times the bytes of
``all_gather`` (every rank sends and receives the whole buffer, P x
``x.nbytes``, instead of ``x.nbytes`` out and (P - 1) x ``x.nbytes`` in);
it is a transport, not a fallback: the tensors stay on the card and the
compute never moves to the CPU.

Every collective that crosses ranks is booked in this process, once, per
route (``collective_stats()["routes"]``: ``"all_reduce/sum"``,
``"all_gather/slot_all_reduce"``, ``"ppermute/send_recv"``, ...: calls and
bytes on the wire from this rank); the flat ``all_reduce_*`` keys are the
sums of the ``all_reduce/*`` routes (the ``all_reduce`` of
``psum``/``pmean``/``pmax``).  With ``timed`` set by
``reset_collective_stats``, each is also clocked between a device sync
before it and one after it (off by default, since the syncs cost the
overlap).

Autograd.  ``psum``, ``pmean``, ``ppermute`` and ``all_gather`` are
differentiable with the transposes ``jax.grad`` gives them inside
``shard_map(check_vma=False)``, the scale the reference's learning rates
assume: the backward of ``psum`` is a ``psum`` of the cotangent, of
``pmean`` a ``pmean``, of ``ppermute`` the inverse permutation, of
``all_gather`` a ``psum`` of the cotangent cut to this rank's block (the
reduce-scatter).  A step that differentiates a ``pmean``'d loss and then
sums its gradients therefore takes the reference's step, which is P times
the mean gradient (``seq_parallel``).  Where every rank then uses the
sum whole (the experts' combine), :func:`psum_invariant` and :func:`pvary`
give the ``check_vma=True`` pair instead: a sum whose backward is the
identity, and an identity whose backward is a sum.

Live axes.  ``jax.lax.axis_index`` raises ``NameError`` outside a
``shard_map`` that binds the axis; code that branches on it (the
transformer's ``attention_mode="ring"``, BatchNorm's statistics) asks
:func:`axis_is_live` here instead.  ``shard_mapped`` and the step makers
enter :func:`live_axes` for the mesh's axes.
"""
from __future__ import annotations

import contextlib
import contextvars
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


# ---------------------------------------------------------------------------
# live axes
# ---------------------------------------------------------------------------

_LIVE: contextvars.ContextVar = contextvars.ContextVar(
    "mmlspark_live_axes", default=(frozenset(), None))


@contextlib.contextmanager
def live_axes(mesh=None, axes=None):
    """Mark ``axes`` (default: every axis of ``mesh``, else of the active
    mesh) live on ``mesh`` for the block, as ``shard_map`` binds its
    mesh's axis names."""
    mesh = mesh or get_active_mesh()
    if axes is None:
        axes = mesh.axis_names
    token = _LIVE.set((_LIVE.get()[0] | frozenset(axes), mesh))
    try:
        yield
    finally:
        _LIVE.reset(token)


def axis_is_live(axis: str) -> bool:
    """Whether a ``live_axes`` block (``shard_mapped``, a step maker)
    binds ``axis`` here — where ``jax.lax.axis_index(axis)`` would not
    raise ``NameError``."""
    return axis in _LIVE.get()[0]


def live_mesh():
    """The mesh of the innermost ``live_axes`` block (else the active
    mesh): the one a collective inside a step maker's module runs on."""
    return _LIVE.get()[1] or get_active_mesh()


# ---------------------------------------------------------------------------
# the book
# ---------------------------------------------------------------------------

_STATS_LOCK = threading.Lock()
_ROUTES: dict = {}
_TIMED = False


def reset_collective_stats(timed: bool = False) -> None:
    """Zero the book; ``timed`` also clocks each collective between device
    syncs."""
    global _TIMED
    with _STATS_LOCK:
        _ROUTES.clear()
        _TIMED = bool(timed)


def collective_stats() -> dict:
    """This process's collectives since the last reset: ``routes``,
    ``"<collective>/<route>"`` -> calls, bytes and (timed) seconds, and
    ``all_reduce_calls``/``_bytes``/``_s``, the sums of the
    ``all_reduce/*`` routes (the ``all_reduce`` of
    ``psum``/``pmean``/``pmax``)."""
    with _STATS_LOCK:
        routes = {k: dict(v) for k, v in _ROUTES.items()}
    ar = [v for k, v in routes.items() if k.startswith("all_reduce/")]
    return {"all_reduce_calls": sum(v["calls"] for v in ar),
            "all_reduce_bytes": sum(v["bytes"] for v in ar),
            "all_reduce_s": sum(v["s"] for v in ar),
            "timed": _TIMED, "routes": routes}


def _sync(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


@contextlib.contextmanager
def _booked(collective: str, route: str, t: torch.Tensor, nbytes: int):
    """Book one collective on ``route`` (``nbytes`` on the wire from this
    rank), clocked between syncs of ``t``'s device when timed."""
    timed = _TIMED
    if timed:
        _sync(t)
    t0 = time.perf_counter()
    yield
    if timed:
        _sync(t)
    dt = time.perf_counter() - t0
    with _STATS_LOCK:
        row = _ROUTES.setdefault(f"{collective}/{route}",
                                 {"calls": 0, "bytes": 0, "s": 0.0})
        row["calls"] += 1
        row["bytes"] += int(nbytes)
        if timed:
            row["s"] += dt


def _backend(group) -> str:
    import torch.distributed as dist
    return str(dist.get_backend(group)).lower()


def _slot_route(t: torch.Tensor, group) -> bool:
    """Whether ``t`` travels by the slot all_reduce: a CUDA tensor on a
    gloo group."""
    return t.is_cuda and _backend(group) == "gloo"


def _as_ints(buf: torch.Tensor) -> torch.Tensor:
    """A same-width integer view of a contiguous buffer (bytes for widths
    gloo has no integer type of)."""
    width = buf.element_size()
    if width == 4:
        return buf.view(torch.int32)
    if width == 8:
        return buf.view(torch.int64)
    return buf.view(torch.uint8)


def _slot_reduce(buf: torch.Tensor, group, collective: str) -> None:
    """Sum the slot buffer over the group in place, bit-exactly."""
    import torch.distributed as dist
    ints = _as_ints(buf)
    with _booked(collective, "slot_all_reduce", buf,
                 buf.numel() * buf.element_size()):
        dist.all_reduce(ints, op=dist.ReduceOp.SUM, group=group)


def _axes(axis) -> tuple:
    return tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)


def _axes_size(axis, mesh) -> int:
    mesh = mesh or get_active_mesh()
    n = 1
    for a in _axes(axis):
        n *= mesh.shape[a]
    return n


def _all_reduce(x, axis, op: str, mesh=None) -> torch.Tensor:
    """``op`` over ``axis`` (a name, or a tuple of names: one all_reduce
    per axis of size > 1, in order)."""
    import torch.distributed as dist
    out = _as_tensor(x).detach().clone().contiguous()
    for a in _axes(axis):
        _, size, group = _axis(mesh, a)
        if size > 1:
            with _booked("all_reduce", op.lower(), out,
                         out.numel() * out.element_size()):
                dist.all_reduce(out, op=getattr(dist.ReduceOp, op),
                                group=group)
    return out


class _PSum(torch.autograd.Function):
    """``psum`` whose backward is a ``psum`` of the cotangent (JAX's
    transpose under ``check_vma=False``)."""

    @staticmethod
    def forward(ctx, x, axis, mesh):
        ctx.axis, ctx.mesh = axis, mesh
        return _all_reduce(x, axis, "SUM", mesh)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.axis, "SUM", ctx.mesh), None, None


class _PSumInvariant(torch.autograd.Function):
    """``psum`` whose backward is the cotangent unchanged."""

    @staticmethod
    def forward(ctx, x, axis, mesh):
        return _all_reduce(x, axis, "SUM", mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _PVary(torch.autograd.Function):
    """The identity whose backward is a ``psum`` of the cotangent."""

    @staticmethod
    def forward(ctx, x, axis, mesh):
        ctx.axis, ctx.mesh = axis, mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.axis, "SUM", ctx.mesh), None, None


def psum_invariant(x, axis=AXIS_DATA, mesh=None) -> torch.Tensor:
    """Sum over the axis for a result every rank then uses whole (the
    same loss on every rank): the backward hands each rank the cotangent
    as it is, with no second sum (JAX's transpose of ``psum`` under
    ``check_vma=True``).  Pairs with :func:`pvary`."""
    if _differentiable(x):
        return _PSumInvariant.apply(x, axis, mesh)
    return _all_reduce(x, axis, "SUM", mesh)


def pvary(x, axis=AXIS_DATA, mesh=None) -> torch.Tensor:
    """The identity on a value every rank holds whole, before each rank
    uses it for its own part: the backward sums the ranks' cotangents
    (``jax.lax.pvary``'s transpose).  Pairs with :func:`psum_invariant`."""
    if _differentiable(x):
        return _PVary.apply(x, axis, mesh)
    return x


def _differentiable(x) -> bool:
    return isinstance(x, torch.Tensor) and x.requires_grad and \
        torch.is_grad_enabled()


def psum(x, axis=AXIS_DATA, mesh=None) -> torch.Tensor:
    """Sum over the axis, or over a tuple of axes (integer sums wrap as
    int32/int64 adds do); differentiable (backward: a ``psum``)."""
    if _differentiable(x):
        return _PSum.apply(x, axis, mesh)
    return _all_reduce(x, axis, "SUM", mesh)


def pmean(x, axis=AXIS_DATA, mesh=None) -> torch.Tensor:
    """Mean over the axis (or axes): a sum, then a divide (``gloo`` has no
    AVG); differentiable (backward: a ``pmean``)."""
    return psum(x, axis, mesh) / _axes_size(axis, mesh)


def pmax(x, axis=AXIS_DATA, mesh=None) -> torch.Tensor:
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


def _all_gather(x: torch.Tensor, axis: str, mesh) -> torch.Tensor:
    """Every rank's ``x`` along the axis, stacked on a new leading dim."""
    import torch.distributed as dist
    mesh, size, group = _axis(mesh, axis)
    x = _as_tensor(x).detach().contiguous()
    if size == 1:
        return x.unsqueeze(0).clone()
    nbytes = x.numel() * x.element_size()
    if _slot_route(x, group):
        buf = x.new_zeros((size, *x.shape))
        buf[mesh.axis_index(axis)] = x
        _slot_reduce(buf, group, "all_gather")
        return buf
    parts = [torch.empty_like(x) for _ in range(size)]
    with _booked("all_gather", "all_gather", x, nbytes):
        dist.all_gather(parts, x, group=group)
    return torch.stack(parts)


class _AllGather(torch.autograd.Function):
    """``all_gather`` (stacked) whose backward is JAX's transpose: the
    cotangent summed over the axis, this rank's slot kept."""

    @staticmethod
    def forward(ctx, x, axis, mesh):
        ctx.axis, ctx.mesh = axis, mesh
        return _all_gather(x, axis, mesh)

    @staticmethod
    def backward(ctx, g):
        me = (ctx.mesh or get_active_mesh()).axis_index(ctx.axis)
        return _all_reduce(g, ctx.axis, "SUM", ctx.mesh)[me], None, None


def all_gather(x, axis: str = AXIS_DATA, tiled: bool = True, mesh=None):
    """Every rank's ``x`` along the axis, in axis order: concatenated on
    dim 0 (``tiled``) or stacked on a new leading dim.  Differentiable
    (backward: the cotangent's ``psum``, this rank's block)."""
    x = _as_tensor(x)
    out = _AllGather.apply(x, axis, mesh) if _differentiable(x) \
        else _all_gather(x, axis, mesh)
    return out.reshape(-1, *x.shape[1:]) if tiled else out


def _ppermute(x: torch.Tensor, perm, axis: str, mesh) -> torch.Tensor:
    import torch.distributed as dist
    mesh, size, group = _axis(mesh, axis)
    x = _as_tensor(x).detach().contiguous()
    me = mesh.axis_index(axis)
    pairs = [(int(s), int(d)) for s, d in perm]
    if size == 1:
        return x.clone() if (me, me) in pairs else torch.zeros_like(x)
    if _slot_route(x, group):
        buf = x.new_zeros((size, *x.shape))
        for src, dst in pairs:
            if src == me:
                buf[dst] = x
        _slot_reduce(buf, group, "ppermute")
        return buf[me].clone()
    out = torch.zeros_like(x)
    ranks = mesh.axis_ranks(axis)
    ops = []
    for src, dst in pairs:
        if src == me and dst == me:
            out.copy_(x)
        elif src == me:
            ops.append(dist.P2POp(dist.isend, x, ranks[dst], group=group))
        elif dst == me:
            ops.append(dist.P2POp(dist.irecv, out, ranks[src], group=group))
    if ops:
        sent = sum(1 for s, d in pairs if s == me and d != me)
        with _booked("ppermute", "send_recv", x,
                     sent * x.numel() * x.element_size()):
            for req in dist.batch_isend_irecv(ops):
                req.wait()
    return out


class _PPermute(torch.autograd.Function):
    """``ppermute`` whose backward sends the cotangent back along the
    inverse permutation."""

    @staticmethod
    def forward(ctx, x, perm, axis, mesh):
        ctx.perm, ctx.axis, ctx.mesh = perm, axis, mesh
        return _ppermute(x, perm, axis, mesh)

    @staticmethod
    def backward(ctx, g):
        inverse = [(d, s) for s, d in ctx.perm]
        return _ppermute(g, inverse, ctx.axis, ctx.mesh), None, None, None


def ppermute(x, perm, axis: str = AXIS_DATA, mesh=None):
    """Send ``x`` along ``perm`` (``(source, destination)`` pairs of axis
    coordinates); a rank no pair sends to receives zeros, as in
    ``jax.lax.ppermute``.  Differentiable (backward: the inverse
    permutation)."""
    perm = [(int(s), int(d)) for s, d in perm]
    if _differentiable(x):
        return _PPermute.apply(x, perm, axis, mesh)
    return _ppermute(_as_tensor(x), perm, axis, mesh)


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
    ``check_vma`` is accepted for the reference's signature.  The mesh's
    axes are live (:func:`axis_is_live`) while ``fn`` runs."""
    in_specs = in_specs if in_specs is not None else PartitionSpec(AXIS_DATA)
    out_specs = out_specs if out_specs is not None else PartitionSpec()

    @functools.wraps(fn)
    def wrapped(*args):
        m = mesh or get_active_mesh()
        with live_axes(m):
            return _run(m, args)

    def _run(m, args):
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
