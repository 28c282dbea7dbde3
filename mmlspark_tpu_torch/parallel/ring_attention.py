"""Ring attention — sequence/context parallelism over the mesh (port of
``mmlspark_tpu/parallel/ring_attention.py``).

``blockwise_attention`` streams K/V blocks through an online softmax
(flash-style) in float32 accumulators, so a long sequence never holds its
``(L, L)`` score matrix: the memory-efficient path of
``models.transformer`` (``attention_mode="blockwise"``, and ``"ring"``
outside a sequence-parallel group).  The reference scans the blocks with
``lax.scan``; here a Python loop over the blocks runs eagerly, one block's
``(Lq, block)`` scores at a time.

``ring_attention`` runs on the ranks of the ``seq`` axis, each holding a
contiguous slice of the sequence: K/V blocks rotate around the ring by the
differentiable ``collectives.ppermute`` (P - 1 useful hops; the reference's
loop makes P and so does this one, the last rotation returning every block
home) while each rank folds each block into its queries' online softmax.
Causal positions are global, ``me * Lloc + arange(Lloc)``.  Memory per
rank: O(L/P x d) activations plus one ``(Lloc, Lloc)`` score block.
``make_ring_attention_fn`` is the reference's jitted ``shard_map``: it cuts
the global ``(B, H, L, D)`` inputs to this rank's slice, runs the ring
under the mesh's live axes, and all-gathers the output along the sequence.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .mesh import AXIS_SEQ, get_active_mesh, mesh_device


def _online_softmax_step(carry, kv, q, scale, mask_value=-1e30,
                         block_mask=None):
    """One KV block of streaming attention.  carry = (acc, row_max,
    row_sum)."""
    acc, m_prev, l_prev = carry
    k, v = kv
    s = (q @ k.transpose(-1, -2)) * scale               # (..., q_len, kv_len)
    if block_mask is not None:
        s = torch.where(block_mask, s, mask_value)
    m_new = torch.maximum(m_prev, s.amax(dim=-1))
    alpha = torch.exp(m_prev - m_new)
    p = torch.exp(s - m_new[..., None])
    l_new = l_prev * alpha + p.sum(dim=-1)
    acc = acc * alpha[..., None] + p @ v
    return (acc, m_new, l_new)


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        block_size: int = 512, causal: bool = False,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Memory-efficient attention over KV blocks of ``block_size``.

    q, k, v: (..., seq, head_dim).  Equivalent to softmax(qk^T/sqrt(d))v:
    keys past the sequence's end (the last block's padding) are masked by
    ``kv_pos < L``, and ``causal`` masks ``kv_pos > q_pos``; scores,
    maxima and sums stay float32 whatever the inputs' dtype, and the
    output is ``acc / max(l, 1e-30)`` cast back to ``q``'s dtype."""
    L = k.shape[-2]
    Lq = q.shape[-2]
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / np.sqrt(d)
    nb = max(1, (L + block_size - 1) // block_size)
    pad = nb * block_size - L
    k32, v32 = k.float(), v.float()
    if pad:
        zeros = k32.new_zeros((*k.shape[:-2], pad, d))
        k32 = torch.cat([k32, zeros], dim=-2)
        v32 = torch.cat([v32, zeros], dim=-2)
    q32 = q.float()
    q_pos = torch.arange(Lq, device=q.device)
    acc = q32.new_zeros((*q.shape[:-2], Lq, d))
    m = q32.new_full((*q.shape[:-2], Lq), -float("inf"))
    l = q32.new_zeros((*q.shape[:-2], Lq))
    carry = (acc, m, l)
    for bi in range(nb):
        blk = slice(bi * block_size, (bi + 1) * block_size)
        kv_pos = bi * block_size + torch.arange(block_size, device=q.device)
        mask = kv_pos[None, :] < L
        if causal:
            mask = mask & (kv_pos[None, :] <= q_pos[:, None])
        carry = _online_softmax_step(carry, (k32[..., blk, :],
                                             v32[..., blk, :]),
                                     q32, scale, block_mask=mask)
    acc, m, l = carry
    return (acc / torch.clamp(l[..., None], min=1e-30)).to(q.dtype)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   axis_name: str = AXIS_SEQ, causal: bool = False,
                   scale: Optional[float] = None, mesh=None) -> torch.Tensor:
    """Attention with the sequence sharded over ``axis_name``: each rank
    holds its local ``(..., L/P, d)`` Q/K/V slices.  K/V rotate around
    the ring; the online-softmax statistics merge the partial results, so
    the output equals full attention over the global sequence.  Scores,
    maxima and sums are float32; the output is cast back to ``q``'s
    dtype.  Differentiable (the rotation's backward is the inverse
    rotation)."""
    from .collectives import ppermute
    mesh = mesh or get_active_mesh()
    if axis_name not in mesh.shape:
        raise ValueError(f"ring_attention: the mesh {mesh.shape} has no "
                         f"{axis_name!r} axis (the reference's NameError)")
    P = mesh.shape[axis_name]
    me = mesh.axis_index(axis_name)
    Lloc = q.shape[-2]
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / np.sqrt(d)
    perm = [(i, (i + 1) % P) for i in range(P)]
    q32 = q.float()
    acc = q32.new_zeros((*q.shape[:-2], Lloc, d))
    m = q32.new_full((*q.shape[:-2], Lloc), -float("inf"))
    l = q32.new_zeros((*q.shape[:-2], Lloc))
    local = torch.arange(Lloc, device=q.device)
    q_pos = me * Lloc + local
    k_cur, v_cur = k, v
    for step in range(P):
        src = (me - step) % P                      # whose KV block this is
        mask = None
        if causal:
            kv_pos = src * Lloc + local
            mask = kv_pos[None, :] <= q_pos[:, None]
        acc, m, l = _online_softmax_step(
            (acc, m, l), (k_cur.float(), v_cur.float()), q32, scale,
            block_mask=mask)
        k_cur = ppermute(k_cur, perm, axis_name, mesh)
        v_cur = ppermute(v_cur, perm, axis_name, mesh)
    return (acc / torch.clamp(l[..., None], min=1e-30)).to(q.dtype)


def make_ring_attention_fn(mesh=None, axis_name: str = AXIS_SEQ,
                           causal: bool = False):
    """``f(q, k, v)`` on global ``(batch, heads, seq, head_dim)`` inputs
    (every rank holds the same) with the sequence sharded over
    ``axis_name``: the reference's jitted ``shard_map``, booked through
    ``instrumented_call`` (its gloo collectives stay outside any CUDA
    graph), on the mesh's device
    (:func:`parallel.mesh.mesh_device`)."""
    from ..observability.compute import instrumented_call
    from .collectives import all_gather, live_axes
    from .sharding import NamedSharding, PartitionSpec
    mesh = mesh or get_active_mesh()
    spec = NamedSharding(mesh, PartitionSpec(None, None, axis_name, None))
    dev = mesh_device(mesh)

    def fn(q, k, v):
        q, k, v = (torch.as_tensor(t).to(dev) for t in (q, k, v))
        with live_axes(mesh):
            out = ring_attention(spec.local(q), spec.local(k),
                                 spec.local(v), axis_name, causal,
                                 mesh=mesh)
        parts = all_gather(out, axis_name, tiled=False, mesh=mesh)
        return torch.cat(list(parts.unbind(0)), dim=-2)

    return instrumented_call(fn, name="parallel.ring_attention")
