"""Blockwise attention — the single-device half of the port of
``mmlspark_tpu/parallel/ring_attention.py``.

``blockwise_attention`` streams K/V blocks through an online softmax
(flash-style) in float32 accumulators, so a long sequence never holds its
``(L, L)`` score matrix: the memory-efficient path of
``models.transformer`` (``attention_mode="blockwise"``, and ``"ring"``
outside a sequence-parallel group).  The reference scans the blocks with
``lax.scan``; here a Python loop over the blocks runs eagerly, one block's
``(Lq, block)`` scores at a time.

``ring_attention`` and ``make_ring_attention_fn`` — K/V rotating around a
``torch.distributed`` ring of cards — are not ported: they raise
``NotImplementedError`` naming ROADMAP.md §1 item 10.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

_NOT_PORTED = ("ring_attention (sequence parallelism over a ring of cards) "
               "is not ported yet (ROADMAP.md §1 item 10, the rest of "
               "parallel/)")


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


def ring_attention(*_args, **_kwargs):
    """Not ported: raises ``NotImplementedError`` (ROADMAP.md §1 item
    10)."""
    raise NotImplementedError(_NOT_PORTED)


def make_ring_attention_fn(*_args, **_kwargs):
    """Not ported: raises ``NotImplementedError`` (ROADMAP.md §1 item
    10)."""
    raise NotImplementedError(_NOT_PORTED)
