"""Pipeline parallelism — GPipe-style microbatch pipelining over the
``pipe`` axis (port of ``mmlspark_tpu/parallel/pipeline_parallel.py``).

Stage s of a depth-S sequential model lives on pipe rank s: its params are
the s-th slice of leading-axis-stacked arrays.  The schedule runs
M + S - 1 ticks; each tick every rank passes its activation rightward with
the differentiable ``collectives.ppermute`` while stage 0 injects the next
microbatch — the classic GPipe schedule including its bubble.  The last
stage's outputs, and its loss, are selected by a masked ``psum`` over
``pipe``.  The whole schedule is differentiable: one backward gives every
stage its gradient, carried back stage by stage through the ``ppermute``'s
inverse.  Every rank runs every collective of the schedule, forward and
backward (a rank's discarded values stay in its graph, masked), so the
ranks' collectives always pair up.

The gradient is the reference's: ``jax.grad`` through the masked ``psum``
under ``shard_map(check_vma=False)`` transposes the ``psum`` to a ``psum``
of the cotangent, so each stage's step is S times the loss's gradient, and
the reference's learning rates assume that scale; the ``psum`` here has the
same backward.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from .mesh import AXIS_PIPE, get_active_mesh, mesh_device


def make_pipeline_train_step(stage_apply: Callable, num_stages: int,
                             loss_fn: Callable, learning_rate: float = 1e-2,
                             mesh=None):
    """Build ``(init_fn, step_fn, forward_fn)`` for a pipelined sequential
    model.

    ``stage_apply(stage_params, x) -> x'``: one stage's computation on a
    dict of tensors; every stage preserves the activation shape.
    ``loss_fn(outputs (M, mb, d), y (M, mb, ...)) -> scalar``, evaluated
    on the final stage's collected outputs.  Params are a dict of arrays
    with leading dim ``num_stages``.

    - ``init_fn(params_stacked)`` -> this rank's stage: each array's
      ``[s:s+1]`` slice as a tensor on the mesh's device;
    - ``step_fn(params_stage, x, y)`` -> ``(params_stage, loss)``, SGD;
    - ``forward_fn(params_stage, x)`` -> the final stage's ``(M, mb, d)``
      outputs on every rank.

    ``x`` is ``(M, mb, d)`` microbatches (:func:`microbatch`), the same on
    every rank.  The steps run on the mesh's device
    (:func:`parallel.mesh.mesh_device`)."""
    from ..observability.compute import device_put, instrumented_call
    from .collectives import live_axes, ppermute, psum
    mesh = mesh or get_active_mesh()
    S = num_stages
    if mesh.shape[AXIS_PIPE] != S:
        raise ValueError(f"mesh pipe axis {mesh.shape[AXIS_PIPE]} != stages {S}")
    dev = mesh_device(mesh)

    def as_dev(t):
        return (t if isinstance(t, torch.Tensor)
                else torch.as_tensor(np.asarray(t))).to(dev)

    def local_forward(params_stage, x_mb):
        params_local = {k: v[0] for k, v in params_stage.items()}
        idx = mesh.axis_index(AXIS_PIPE)
        first = torch.tensor(idx == 0, device=dev)
        M = x_mb.shape[0]
        T = M + S - 1
        perm = [(i, i + 1) for i in range(S - 1)]        # rightward shift
        act = torch.zeros_like(x_mb[0])
        outs = []
        for t in range(T):
            act_in = ppermute(act, perm, AXIS_PIPE, mesh)
            act_in = torch.where(first, x_mb[min(t, M - 1)], act_in)
            act = stage_apply(params_local, act_in)
            outs.append(act)
        # on the last stage, outs[m + S - 1] is microbatch m's result
        return torch.stack(outs[S - 1:])                  # (M, mb, d)

    def last(value):
        is_last = torch.tensor(mesh.axis_index(AXIS_PIPE) == S - 1,
                               device=dev)
        return psum(torch.where(is_last, value, torch.zeros_like(value)),
                    AXIS_PIPE, mesh)

    def local_collect(params_stage, x_mb):
        with torch.no_grad(), live_axes(mesh):
            return last(local_forward(params_stage, as_dev(x_mb)))

    def local_step(params_stage, x_mb, y_mb):
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params_stage.items()}
        with live_axes(mesh):
            outs = local_forward(leaves, as_dev(x_mb))
            loss = last(loss_fn(outs, as_dev(y_mb)))
            loss.backward()
        new = {k: (v - learning_rate * v.grad).detach()
               for k, v in leaves.items()}
        return new, loss.detach()

    step_fn = instrumented_call(local_step, name="parallel.pipeline_step")
    forward_fn = instrumented_call(local_collect,
                                   name="parallel.pipeline_forward")

    def init_fn(params_stacked):
        s = mesh.axis_index(AXIS_PIPE)
        return device_put({k: np.asarray(a)[s:s + 1]
                           for k, a in params_stacked.items()}, dev,
                          site="parallel.pipeline_init")

    return init_fn, step_fn, forward_fn


def microbatch(x: np.ndarray, num_microbatches: int) -> np.ndarray:
    """(batch, ...) -> (M, batch/M, ...)."""
    n = x.shape[0]
    if n % num_microbatches:
        raise ValueError(f"batch {n} not divisible by {num_microbatches} microbatches")
    return x.reshape(num_microbatches, n // num_microbatches, *x.shape[1:])
