"""Sequence-parallel training step — dp x sp over the ``(data, seq)`` mesh
axes (port of ``mmlspark_tpu/parallel/seq_parallel.py``).

Long-context training where each rank holds a slice of every sequence:
tokens shard over both batch (``data``) and sequence (``seq``); attention
is ring attention over ``seq`` (``models.transformer``'s
``attention_mode="ring"`` while the axes are live); the loss ``pmean`` and
the gradient ``psum`` are the only other collectives.

The step takes the reference's scale: the loss is ``pmean``'d over
``(data, seq)`` and differentiated on each rank (the ``pmean``'s backward
is a ``pmean``, the ring's backward carries each block's cotangent home),
then the gradients are ``psum``'d.  That is P = data x seq times the
global mean loss's gradient, which is what ``jax.grad`` under
``shard_map(check_vma=False)`` gives the reference, and what its learning
rates assume.
"""
from __future__ import annotations

import numpy as np
import torch

from .mesh import AXIS_DATA, AXIS_SEQ, get_active_mesh, mesh_device


def make_seq_parallel_train_step(module, learning_rate: float = 1e-3,
                                 mesh=None):
    """SGD train step for a per-token classifier (``pool="none"``,
    ``attention_mode="ring"``) with tokens ``(B, L)`` sharded
    ``(data, seq)``.

    Returns ``(init_fn, step_fn)``:

    - ``init_fn(rng, tokens, positions)`` -> the module's parameters as a
      dict of tensors on the mesh's device (replicated: every rank holds
      them whole; ``rng`` is accepted for the reference's signature — the
      module holds its initial weights);
    - ``step_fn(params, tokens, positions, labels)`` -> ``(params, loss)``
      on global ``(B, L)`` inputs every rank holds; the loss is the global
      mean (a 0-d tensor).

    It runs on the mesh's device (:func:`parallel.mesh.mesh_device`)."""
    import torch.nn.functional as F
    from torch.func import functional_call
    from ..observability.compute import device_put, instrumented_call
    from .collectives import live_axes, pmean, psum
    from .sharding import NamedSharding, PartitionSpec
    mesh = mesh or get_active_mesh()
    module = module.to(mesh_device(mesh))
    rows = NamedSharding(mesh, PartitionSpec(AXIS_DATA))
    cols = NamedSharding(mesh, PartitionSpec(None, AXIS_SEQ))
    axes = (AXIS_DATA, AXIS_SEQ)

    def local(t):
        t = torch.as_tensor(np.asarray(t)) if not isinstance(
            t, torch.Tensor) else t
        return cols.local(rows.local(t)).to(mesh.device)

    def local_step(params, tokens, positions, labels):
        tok, pos, lab = local(tokens), local(positions), local(labels)
        leaves = {n: p.detach().requires_grad_(True)
                  for n, p in params.items()}
        with live_axes(mesh, axes):
            logits = functional_call(module, leaves, (tok,),
                                     {"positions": pos})
            ll = F.cross_entropy(logits.float().reshape(-1, logits.shape[-1]),
                                 lab.reshape(-1).long())
            loss = pmean(ll, axes, mesh)
            loss.backward()
        names = list(leaves)
        flat = torch.cat([leaves[n].grad.reshape(-1) for n in names])
        flat = psum(flat, axes, mesh)
        new, off = {}, 0
        for n in names:
            p = params[n]
            g = flat[off:off + p.numel()].view_as(p)
            off += p.numel()
            new[n] = (p - learning_rate * g).detach()
        return new, loss.detach()

    step_fn = instrumented_call(local_step, name="parallel.seq_step")

    def init_fn(rng, tokens, positions):
        return device_put({n: p.detach().clone()
                           for n, p in module.named_parameters()},
                          mesh.device, site="parallel.seq_init")

    return init_fn, step_fn


def global_positions(batch: int, seq_len: int) -> np.ndarray:
    """(B, L) global position ids to shard alongside tokens."""
    return np.broadcast_to(np.arange(seq_len, dtype=np.int32)[None, :],
                           (batch, seq_len)).copy()
