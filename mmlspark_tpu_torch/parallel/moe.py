"""Expert parallelism — a mixture-of-experts layer sharded over ``expert``
(port of ``mmlspark_tpu/parallel/moe.py``).

Token-choice top-1 routing with capacity-free dense dispatch, as the
reference computes it: every token's gate picks one expert, the expert
FFNs run densely over the one-hot dispatch, and the combine weighs the
chosen expert's output by its gate probability.

Under a live ``expert`` axis (``parallel.collectives.axis_is_live``, e.g.
inside ``shard_mapped`` or a step that enters ``live_axes``) each rank
holds E / n experts (:func:`shard_moe_params` keeps this rank's block of
``w_in`` / ``w_out``), runs them on its tokens, and the combine is a
``psum`` over ``expert``.  Every rank then holds the same output and the
same loss, so the combine is ``collectives.psum_invariant`` (its backward
hands each rank the cotangent as it is, no second sum) and the experts'
input goes through ``collectives.pvary`` (its backward sums the ranks'
cotangents; the gate's part of it is already whole on every rank): the
gradients are the dense layer's, as GSPMD's are in the reference.
"""
from __future__ import annotations

import math
from typing import Any, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from .mesh import AXIS_EXPERT


def _lecun_normal(shape, fan_in: int, fan_out: int, gen) -> torch.Tensor:
    """flax's ``lecun_normal`` for an einsum kernel of ``shape`` (truncated
    normal, std sqrt(1 / fan_in) / 0.8796, cut at two standard
    deviations)."""
    t = torch.empty(shape)
    nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return t * (math.sqrt(1.0 / fan_in) / 0.87962566103423978)


class MoELayer(nn.Module):
    """Dense-dispatch top-1 MoE FFN: ``y = sum_e gate_e(x) FFN_e(x)`` with a
    one-hot gate (straight-through top-1).  ``d_model`` is the input width
    (flax infers it at the first call).

    Parameters keep the flax module's names: ``gate`` (a ``Linear(d, E)``),
    ``w_in`` ``(E, d, hidden)`` and ``w_out`` ``(E, hidden, d)``
    (``convert.moe_state_dict_from_flax`` carries them across).

    The Switch-style load-balancing loss, ``aux_loss_weight * E *
    sum(mean prob * mean dispatch)``, is what the reference sows into its
    ``losses`` collection: after each forward it is ``self.losses``,
    ``{"moe_aux": (value,)}``, the shape ``apply(..., mutable=["losses"])``
    returns it in (add ``sum(layer.losses["moe_aux"])`` to the loss)."""

    def __init__(self, num_experts: int, hidden: int, d_model: int,
                 aux_loss_weight: float = 0.01, dtype: Any = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        E, H, d = int(num_experts), int(hidden), int(d_model)
        self.num_experts, self.hidden, self.d_model = E, H, d
        self.aux_loss_weight = float(aux_loss_weight)
        self.dtype = dtype
        gen = generator if generator is not None else \
            torch.Generator().manual_seed(0)
        self.gate = nn.Linear(d, E, dtype=dtype)
        with torch.no_grad():
            self.gate.weight.copy_(_lecun_normal((E, d), d, E, gen))
            self.gate.bias.zero_()
        # flax's lecun_normal reads fan_in as the second-to-last axis times
        # the leading ones: E * d for w_in, E * H for w_out
        self.w_in = nn.Parameter(_lecun_normal((E, d, H), E * d, H, gen)
                                 .to(dtype))
        self.w_out = nn.Parameter(_lecun_normal((E, H, d), E * H, d, gen)
                                  .to(dtype))
        self.losses = {}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        from .collectives import (axis_is_live, live_mesh, psum_invariant,
                                  pvary)
        T, d = x.shape
        E = self.num_experts
        xc = x.to(self.dtype)
        gate_logits = self.gate(xc)                             # (T, E)
        probs = torch.softmax(gate_logits, dim=-1)
        top1 = probs.argmax(dim=-1)                             # (T,)
        dispatch = F.one_hot(top1, E).to(self.dtype)            # (T, E)
        gate_val = (probs * dispatch).sum(-1, keepdim=True)     # (T, 1)
        e_loc = self.w_in.shape[0]
        live = axis_is_live(AXIS_EXPERT) and e_loc < E
        if live:
            mesh = live_mesh()
            off = mesh.axis_index(AXIS_EXPERT) * e_loc
            disp = dispatch[:, off:off + e_loc]
            xe = pvary(xc, AXIS_EXPERT, mesh)
        else:
            disp, xe = dispatch, xc
        h = disp[:, :, None] * torch.einsum("td,edh->teh", xe, self.w_in)
        h = F.gelu(h, approximate="tanh")
        y = torch.einsum("teh,ehd->td", h, self.w_out)
        if live:
            y = psum_invariant(y, AXIS_EXPERT, mesh)
        y = y * gate_val
        me = probs.mean(dim=0)
        ce = dispatch.mean(dim=0)
        self.losses = {"moe_aux": (self.aux_loss_weight * E *
                                   torch.sum(me * ce),)}
        return y.to(x.dtype)


def shard_moe_params(params, mesh):
    """Place expert-stacked leaves (>= 3-d, leading dim divisible by the
    ``expert`` axis) as this rank's block over ``expert``, and replicate
    the rest: a dict of tensors on the mesh's device
    (:func:`parallel.mesh.mesh_device`), for
    ``torch.func.functional_call``."""
    from .mesh import mesh_device
    from .sharding import NamedSharding, PartitionSpec
    e_size = mesh.shape[AXIS_EXPERT]
    mesh_device(mesh)               # the card, or a mesh built for the CPU

    def place(leaf):
        t = leaf.detach() if isinstance(leaf, torch.Tensor) else leaf
        if getattr(t, "ndim", 0) >= 3 and t.shape[0] % e_size == 0:
            sh = NamedSharding(mesh, PartitionSpec(AXIS_EXPERT))
        else:
            sh = NamedSharding(mesh, PartitionSpec())
        return sh.place(t, site="parallel.moe").clone()

    return {k: place(v) for k, v in params.items()}
