"""Sharding helpers — put arrays where the mesh wants them (port of
``mmlspark_tpu/parallel/sharding.py``).

The reference annotates arrays with a ``NamedSharding`` and lets XLA place
the shards.  Here every rank holds the whole host array (the SPMD contract:
each rank is handed the same inputs) and a placement says which block of
it this rank keeps on its device: ``batch_sharded`` splits the leading dim
into contiguous blocks over an axis, in rank order along it; ``replicated``
keeps the whole array.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .mesh import AXIS_DATA, Mesh, get_active_mesh


class PartitionSpec(tuple):
    """Per-dim mesh axis names (None = not split), as
    ``jax.sharding.PartitionSpec``: ``PartitionSpec("data")`` splits the
    leading dim over ``data``; ``PartitionSpec()`` replicates."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A placement: ``spec`` over ``mesh``.  Only the leading dim may be
    split (the batch)."""
    mesh: Mesh
    spec: PartitionSpec

    @property
    def axis(self) -> Optional[str]:
        return self.spec[0] if len(self.spec) else None

    def block(self, n: int) -> slice:
        """This rank's rows of a leading dim of ``n`` (divisible by the
        axis size when split)."""
        if self.axis is None:
            return slice(0, n)
        parts = self.mesh.shape[self.axis]
        if n % parts:
            raise ValueError(f"leading dim {n} is not divisible by the "
                             f"{self.axis!r} axis size {parts}")
        m = n // parts
        r = self.mesh.axis_index(self.axis)
        return slice(r * m, (r + 1) * m)

    def place(self, x, site: str = "parallel.place") -> torch.Tensor:
        """This rank's block of ``x`` on the mesh's device."""
        from ..observability.compute import device_put
        t = torch.as_tensor(np.asarray(x)) if not isinstance(
            x, torch.Tensor) else x
        return device_put(t[self.block(t.shape[0])] if t.ndim else t,
                          self.mesh.device, site=site)


def named_sharding(mesh=None, *spec) -> NamedSharding:
    return NamedSharding(mesh or get_active_mesh(), PartitionSpec(*spec))


def replicated(mesh=None) -> NamedSharding:
    return named_sharding(mesh)


def batch_sharded(mesh=None, axis: str = AXIS_DATA) -> NamedSharding:
    """Leading dim sharded over the data axis; rest replicated."""
    return named_sharding(mesh, axis)


def shard_batch(x, mesh=None, axis: str = AXIS_DATA):
    """This rank's contiguous block of a host array's leading dim, on its
    device, with the unpadded length: ``(block, n)``.  Pads the batch up to
    a multiple of the axis size first (padding rows are repeated last rows;
    callers mask via the returned valid-count)."""
    mesh = mesh or get_active_mesh()
    x, n = pad_to_multiple(np.asarray(x), mesh.shape[axis])
    return batch_sharded(mesh, axis).place(x, site="parallel.shard_batch"), n


def replicate(x, mesh=None) -> torch.Tensor:
    """The whole of ``x`` on this rank's device."""
    return replicated(mesh or get_active_mesh()).place(
        x, site="parallel.replicate")


def pad_to_multiple(x: np.ndarray, multiple: int, axis: int = 0,
                    fill: Optional[float] = None):
    """Pad along `axis` to a multiple; returns (padded, original_length)."""
    n = x.shape[axis]
    rem = (-n) % multiple
    if not rem:
        return x, n
    pad_shape = list(x.shape)
    pad_shape[axis] = rem
    if fill is None:
        idx = [slice(None)] * x.ndim
        idx[axis] = slice(n - 1, n)
        pad = np.repeat(x[tuple(idx)], rem, axis=axis)
    else:
        pad = np.full(pad_shape, fill, dtype=x.dtype)
    return np.concatenate([x, pad], axis=axis), n
