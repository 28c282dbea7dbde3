"""Process-group bootstrap and the device mesh (port of
``mmlspark_tpu/parallel/mesh.py``).

The reference forms a ``jax.sharding.Mesh`` over devices and lets XLA
collectives ride it.  Here every position of the mesh is one process (a
rank of ``torch.distributed``) with one device, and a collective over an
axis is a call on that axis's process group.  Axis names keep the
reference's conventions:

- ``data``  — data parallelism (batch sharding; gradient/histogram psum)
- ``model`` — tensor parallelism (weight sharding)
- ``seq``   — sequence/context parallelism (ring attention)
- ``pipe``  — pipeline parallelism stages
- ``expert``— expert parallelism (MoE)

Without an initialized process group the world is this one process: a
mesh of one position whose collectives are the identity.
"""
from __future__ import annotations

import datetime
import os
from contextlib import contextmanager
from typing import Dict, Optional, Sequence

import numpy as np
import torch

AXIS_DATA = "data"
AXIS_MODEL = "model"
AXIS_SEQ = "seq"
AXIS_PIPE = "pipe"
AXIS_EXPERT = "expert"

_ACTIVE_MESH = None


def _dist():
    import torch.distributed as dist
    return dist if dist.is_available() and dist.is_initialized() else None


def world_size() -> int:
    """Ranks of the default process group (1 without one)."""
    dist = _dist()
    return dist.get_world_size() if dist is not None else 1


def world_rank() -> int:
    """This process's rank in the default group (0 without one)."""
    dist = _dist()
    return dist.get_rank() if dist is not None else 0


def default_device() -> torch.device:
    """The device of this rank: the current CUDA device when there is a
    card, else the CPU."""
    if torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, *,
                           backend: Optional[str] = None,
                           timeout_s: float = 300.0) -> None:
    """Join the process group: the rendezvous every rank calls before any
    collective (the reference's ``jax.distributed.initialize``).

    ``coordinator_address`` is ``host:port`` (rank 0 listens there), or a
    ``tcp://`` / ``file://`` URL; unset, the ``MASTER_ADDR`` /
    ``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK`` environment is read.
    ``backend`` is ``"nccl"`` for one rank per card and ``"gloo"`` for CPU
    tensors or for ranks that share a card (NCCL refuses two ranks on one
    device); unset, ``nccl`` with a card and ``gloo`` without.  With a card
    the rank's current device becomes ``cuda:<local rank>`` (the
    ``LOCAL_RANK`` variable, else the rank modulo the visible cards)."""
    import torch.distributed as dist
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    kwargs = {"backend": backend,
              "timeout": datetime.timedelta(seconds=timeout_s)}
    if coordinator_address:
        url = coordinator_address
        if "://" not in url:
            url = f"tcp://{url}"
        kwargs["init_method"] = url
    if num_processes is not None:
        kwargs["world_size"] = int(num_processes)
    if process_id is not None:
        kwargs["rank"] = int(process_id)
    if torch.cuda.is_available():
        rank = int(process_id if process_id is not None
                   else os.environ.get("RANK", 0))
        local = int(os.environ.get("LOCAL_RANK",
                                   rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    dist.init_process_group(**kwargs)


class Mesh:
    """A mesh of ranks: ``axis_names``, ``shape`` (axis -> size), and
    ``devices``, an array of the axes' shape holding the rank at each
    position — what ``io.checkpoint.topology_stanza`` reads of a
    ``jax.sharding.Mesh``.  ``device`` is this rank's device (the card, else
    the CPU; the step makers and the trainer run on it only when it was
    named, :func:`mesh_device`); ``group(axis)``
    is the process group of the ranks that differ only along ``axis``
    (None: the default group, or no group in a world of one)."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str],
                 device: Optional[torch.device] = None, groups=None):
        self.devices = np.asarray(devices)
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, self.devices.shape))
        #: whether the caller named the device (``device="cpu"``)
        self.device_given = device is not None
        self.device = torch.device(device) if device is not None \
            else default_device()
        self._groups = dict(groups or {})
        me = np.argwhere(self.devices == world_rank())
        self._coords = tuple(int(c) for c in me[0]) if len(me) else None

    def group(self, axis: str):
        return self._groups.get(axis)

    def axis_index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        if self._coords is None:
            raise ValueError(f"rank {world_rank()} is not on this mesh")
        return self._coords[self.axis_names.index(axis)]

    def axis_ranks(self, axis: str) -> list:
        """Global ranks along ``axis`` through this rank, in axis order."""
        k = self.axis_names.index(axis)
        idx = list(self._coords)
        out = []
        for i in range(self.devices.shape[k]):
            idx[k] = i
            out.append(int(self.devices[tuple(idx)]))
        return out

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, device={self.device})"


def mesh_device(mesh: Mesh) -> torch.device:
    """The device an entry point of ``parallel`` runs on: the mesh's, which
    is this rank's card unless the mesh was built with ``device="cpu"``.
    Without a card and without that ask it raises, as
    ``_device.resolve_device`` does."""
    if mesh.device.type == "cpu" and not mesh.device_given:
        from .._device import resolve_device
        return resolve_device(None)
    return mesh.device


def _axis_groups(dev_array: np.ndarray, names: Sequence[str]) -> Dict:
    """One process group per axis for this rank, made collectively: every
    rank creates every group in the same order (``new_group``'s rule).  An
    axis that spans the whole world uses the default group."""
    dist = _dist()
    groups: Dict[str, object] = {}
    if dist is None or dev_array.size == 1:
        return groups
    me = world_rank()
    world = dist.get_world_size()
    for k, name in enumerate(names):
        if dev_array.shape[k] == world:
            groups[name] = None
            continue
        lines = np.moveaxis(dev_array, k, -1).reshape(-1, dev_array.shape[k])
        for line in lines:
            g = dist.new_group([int(r) for r in line])
            if me in line:
                groups[name] = g
    return groups


def make_mesh(axes: Optional[Dict[str, int]] = None,
              devices: Optional[Sequence] = None,
              device: Optional[torch.device] = None) -> Mesh:
    """Build a Mesh whose axis sizes multiply to the rank count.

    ``axes`` maps axis name -> size; a single ``-1`` size is inferred.  With
    no axes, returns a 1-d data-parallel mesh over all ranks.  ``devices``
    (the ranks to lay out, default every rank of the world) sets the count.
    In a world larger than one every rank must call this in the same order:
    an axis that does not span the world gets process groups of its own."""
    devices = list(devices) if devices is not None \
        else list(range(world_size()))
    n = len(devices)
    if not axes:
        axes = {AXIS_DATA: n}
    axes = dict(axes)
    sizes = list(axes.values())
    if sizes.count(-1) > 1:
        raise ValueError("at most one axis size may be -1")
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1]))
        if n % known:
            raise ValueError(f"cannot infer axis: {n} devices not divisible by {known}")
        sizes[sizes.index(-1)] = n // known
        axes = dict(zip(axes.keys(), sizes))
    total = int(np.prod(list(axes.values())))
    if total != n:
        raise ValueError(f"mesh axes {axes} require {total} devices, have {n}")
    dev_array = np.asarray(devices).reshape(*axes.values())
    groups = _axis_groups(dev_array, tuple(axes.keys()))
    return Mesh(dev_array, tuple(axes.keys()), device=device, groups=groups)


def data_parallel_mesh(num_devices: Optional[int] = None) -> Mesh:
    """A 1-d ``data`` mesh over the first ``num_devices`` ranks (all by
    default)."""
    ranks = list(range(world_size()))[: num_devices or None]
    return make_mesh({AXIS_DATA: len(ranks)}, ranks)


def get_active_mesh() -> Mesh:
    """The framework-wide mesh: the one set, else a data mesh over the
    default group's world (one position, this process's device, when no
    group is initialized).  The default is formed per call, so a group
    initialized later is seen."""
    if _ACTIVE_MESH is None:
        return data_parallel_mesh()
    return _ACTIVE_MESH


def set_active_mesh(mesh) -> None:
    global _ACTIVE_MESH
    _ACTIVE_MESH = mesh


@contextmanager
def active_mesh(mesh):
    global _ACTIVE_MESH
    prev = _ACTIVE_MESH
    _ACTIVE_MESH = mesh
    try:
        yield mesh
    finally:
        _ACTIVE_MESH = prev
