"""Training-state checkpoint/resume for the distributed trainer (port of
``mmlspark_tpu/parallel/checkpoint.py``).

A train-state checkpoint is params + optimizer state + step +
batch_stats.  Two backends, the reference's layout and marker:

- ``npz`` (default): NPZ arrays + the pickled optimizer state (nests of
  numpy arrays), every file published atomically through
  ``io.checkpoint.atomic_write``, so a crash mid-save cannot tear the only
  copy.
- ``orbax``: the port may not import orbax (it imports jax), so its twin
  is ``torch.distributed.checkpoint`` (DCP) in the same ``orbax``
  subdirectory of ``path``, with the same ``LATEST_BACKEND`` marker and
  the same contract: restore needs a ``template`` whose nest the restored
  state keeps.  DCP writes its files in place, so a save writes into a
  temporary sibling directory and publishes it with ``os.replace``.  In a
  world of several ranks every rank calls and DCP's planner writes each
  (replicated) item once; without a process group it runs in the plain
  process.  A directory the JAX package's orbax wrote (no DCP
  ``.metadata``) raises ``NotImplementedError``: the port cannot read
  orbax's format (ROADMAP.md fact 3.20).

Backend selection on load is the reference's: a forced ``backend=``, else
the marker when both backends wrote, else the newer of the two, else the
one that exists.

A snapshot holds WHOLE tensors whatever the sharding it was taken under
(``Trainer.full_state`` gathers the model-sharded blocks), so a world of 2
resumes at 1 and the other way round: ``load_train_state(trainer=...)``
and :meth:`TrainLoopCheckpointer.load_latest` re-place it through the
trainer's partition rules.

:class:`TrainLoopCheckpointer` adds step-numbered periodic snapshots with
keep-last-K retention, an async writer and torn-newest fallback
(``io.checkpoint.CheckpointManager``), plus the topology stanza elastic
resume diffs — the loop-level layer ``Trainer.train_stream`` rides.
"""
from __future__ import annotations

import os
import shutil
from typing import Dict, Optional

import numpy as np

from ..io.checkpoint import CheckpointManager, atomic_write
from .trainer import TrainState

#: the file DCP's writer publishes last, with the checkpoint's layout
_DCP_METADATA = ".metadata"


def _host(x):
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _flatten(tree, prefix: str) -> Dict[str, np.ndarray]:
    """``{"a": {"b": x}}`` under ``prefix`` -> ``{"prefix/a/b": x}``."""
    out: Dict[str, np.ndarray] = {}
    for k, v in (tree or {}).items():
        key = f"{prefix}/{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        elif v is not None:
            out[key] = np.array(_host(v))
    return out


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict:
    out: Dict = {}
    for key, v in flat.items():
        node = out
        *mods, leaf = key.split("/")
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = v
    return out


def _host_state(state: TrainState, trainer=None) -> TrainState:
    """Whole host arrays of ``state`` (gathered by ``trainer`` when
    given: every rank of its mesh must call this)."""
    if trainer is not None:
        return trainer.full_state(state)
    return TrainState(
        params=_unflatten(_flatten(state.params, "p")).get("p", {}),
        opt_state=_unflatten(_flatten(state.opt_state, "o")).get("o", {}),
        step=np.asarray(_host(state.step)),
        batch_stats=_unflatten(_flatten(state.batch_stats, "b")).get("b"))


def save_train_state(state: TrainState, path: str,
                     backend: str = "npz", *, trainer=None) -> None:
    """Write ``state`` under ``path``: ``npz`` writes ``state.npz``
    (params, batch_stats, step) and ``opt_state.pkl``, each atomically;
    ``orbax`` writes a ``torch.distributed.checkpoint`` directory
    ``path/orbax``, published whole; then the ``LATEST_BACKEND`` marker.
    Pass the ``trainer`` of a model-sharded state so its blocks are
    gathered whole.  In a world of several ranks every rank calls it (the
    gathers, DCP's plan and a closing barrier are collectives) and world
    rank 0 writes the npz files, the marker and the publish."""
    if backend not in ("npz", "orbax"):
        raise ValueError(f"backend must be 'npz' or 'orbax', got {backend!r}")
    host = _host_state(state, trainer)
    from .mesh import world_rank
    from .trainer import _world_barrier
    if backend == "orbax":
        _write_dcp(host, path)
    elif world_rank() == 0:
        _write_npz(host, path)
    # written before any rank returns: a load that follows reads it
    _world_barrier()


def _state_tree(host: TrainState) -> Dict:
    """The reference's checkpoint tree of a state of host arrays
    (``_host_state``), its leaves as CPU tensors sharing their memory."""
    import torch

    def tensors(node):
        if isinstance(node, dict):
            return {k: tensors(v) for k, v in node.items()}
        return torch.as_tensor(np.asarray(node))

    return tensors({"params": host.params, "opt_state": host.opt_state
                    or {}, "step": host.step,
                    "batch_stats": host.batch_stats or {}})


def _write_dcp(host: TrainState, path: str) -> None:
    """Every rank: DCP-save ``host`` into ``path/.orbax.tmp``; rank 0 then
    publishes it as ``path/orbax`` (the old one moved aside first, then
    removed) and writes the marker."""
    import torch.distributed.checkpoint as dcp
    from .mesh import world_rank
    from .trainer import _world_barrier
    root = os.path.abspath(path)
    target = os.path.join(root, "orbax")
    tmp = os.path.join(root, ".orbax.tmp")
    if world_rank() == 0:
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
    _world_barrier()
    dcp.save(_state_tree(host), storage_writer=dcp.FileSystemWriter(tmp))
    _world_barrier()
    if world_rank() == 0:
        old = os.path.join(root, ".orbax.old")
        shutil.rmtree(old, ignore_errors=True)
        if os.path.exists(target):
            os.replace(target, old)
        os.replace(tmp, target)
        shutil.rmtree(old, ignore_errors=True)
        _write_marker(path, "orbax")


def _write_npz(host: TrainState, path: str) -> None:
    os.makedirs(path, exist_ok=True)
    flat = _flatten({"t": {"params": host.params,
                           "batch_stats": host.batch_stats or {}}}, "")
    flat = {k[1:]: v for k, v in flat.items()}
    flat["t/step"] = np.asarray(host.step)
    with atomic_write(os.path.join(path, "state.npz"), "wb") as f:
        np.savez(f, **flat)
    from ..utils import pickling
    with atomic_write(os.path.join(path, "opt_state.pkl"), "wb") as f:
        pickling.dump(host.opt_state, f)
    _write_marker(path, "npz")


def _write_marker(path: str, backend: str) -> None:
    """Record which backend wrote last (mtimes survive neither cp nor
    rsync reliably)."""
    os.makedirs(path, exist_ok=True)
    with atomic_write(os.path.join(path, "LATEST_BACKEND"), "w") as f:
        f.write(backend)


def load_train_state(path: str, trainer=None,
                     template: Optional[TrainState] = None,
                     backend: Optional[str] = None) -> TrainState:
    """Load a checkpoint of whole host arrays; with ``trainer`` given,
    place it on its mesh (``Trainer.shard_state``).  ``backend`` forces a
    backend; otherwise the ``LATEST_BACKEND`` marker decides where both
    wrote, with the mtimes as a last resort for pre-marker checkpoints.
    An ``orbax`` restore needs ``template`` (the reference's target, e.g.
    ``trainer.init_state()``): it loads into the template's whole-shape
    host state (``trainer.full_state(template)`` when a trainer is given,
    so every rank of its mesh must call), and the restored state keeps the
    template's nest."""
    orbax_dir = os.path.join(os.path.abspath(path), "orbax")
    npz_path = os.path.join(path, "state.npz")
    marker = os.path.join(path, "LATEST_BACKEND")
    if backend is not None:
        if backend not in ("npz", "orbax"):
            raise ValueError(
                f"backend must be 'npz' or 'orbax', got {backend!r}")
        use_orbax = backend == "orbax"
    elif os.path.exists(orbax_dir) and os.path.exists(npz_path):
        if os.path.exists(marker):
            with open(marker) as f:
                use_orbax = f.read().strip() == "orbax"
        else:
            # both backends wrote here pre-marker: take the newer artifact
            use_orbax = os.path.getmtime(orbax_dir) >= \
                os.path.getmtime(npz_path)
    else:
        use_orbax = os.path.exists(orbax_dir)
    if use_orbax:
        state = _read_dcp(orbax_dir, trainer, template)
    elif os.path.exists(npz_path):
        with np.load(npz_path, allow_pickle=False) as z:
            tree = _unflatten({k: z[k] for k in z.files})["t"]
        from ..utils import pickling
        with open(os.path.join(path, "opt_state.pkl"), "rb") as f:
            opt_state = pickling.load(f)
        state = TrainState(params=tree.get("params", {}),
                           opt_state=opt_state, step=tree["step"],
                           batch_stats=tree.get("batch_stats") or None)
    else:
        raise FileNotFoundError(f"no checkpoint at {path}")
    if trainer is not None:
        state = trainer.shard_state(state)
    return state


def _read_dcp(orbax_dir: str, trainer,
              template: Optional[TrainState]) -> TrainState:
    """The DCP checkpoint at ``orbax_dir`` loaded into ``template``'s whole
    host state, as numpy leaves in the template's nest (completed by the
    checkpoint's own entries where the template has none)."""
    if template is None:
        raise ValueError(
            "orbax restore needs template= (a TrainState with the target "
            "structure, e.g. trainer.init_state())")
    if not os.path.exists(os.path.join(orbax_dir, _DCP_METADATA)):
        raise NotImplementedError(
            f"{orbax_dir} has no torch.distributed.checkpoint metadata: it "
            "was written by the JAX package's orbax StandardCheckpointer, "
            "whose format the port cannot read (it may not import orbax); "
            "re-save it from the JAX package with backend='npz'")
    import torch
    import torch.distributed.checkpoint as dcp
    reader = dcp.FileSystemReader(orbax_dir)
    tree = _state_tree(_host_state(template, trainer))
    # a torch optimizer makes its state at its first step, so a fresh
    # template may lack entries the checkpoint holds: they are loaded too,
    # into tensors of their saved shape and dtype
    for key, meta in reader.read_metadata().state_dict_metadata.items():
        *mods, leaf = key.split(".")
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        if leaf not in node and hasattr(meta, "size"):
            node[leaf] = torch.empty(tuple(meta.size),
                                     dtype=meta.properties.dtype)
    dcp.load(tree, storage_reader=reader)

    def host(node):
        if isinstance(node, dict):
            return {k: host(v) for k, v in node.items()}
        return node.numpy()

    tree = host(tree)
    return TrainState(params=tree["params"], opt_state=tree["opt_state"],
                      step=tree["step"],
                      batch_stats=tree.get("batch_stats") or None)


class TrainLoopCheckpointer:
    """Periodic TrainState snapshots for long-running training loops.

    Rides :class:`~mmlspark_tpu_torch.io.checkpoint.CheckpointManager`:
    each snapshot is ONE atomically-published ``state_<step>.npz``
    (flattened params/batch_stats arrays, the step scalar, and the
    optimizer nest pickled into a uint8 payload lane), with keep-last-K
    retention, async background writes, the shared
    ``mmlspark_checkpoint_*`` telemetry, and torn-newest fallback on load.

    ``save`` takes a state of whole host arrays (``Trainer.full_state``):
    the one synchronous cost on the training thread is that copy, since
    the step updates the state's tensors in place.  ``writer=False`` (every
    rank but one in a world) makes ``save`` a no-op, so one process owns
    the directory."""

    _OPT_KEY = "__opt_state__"
    _STEP_KEY = "__step__"

    def __init__(self, directory: str, *, keep_last: int = 3,
                 site: str = "parallel.trainer", registry=None,
                 topology: Optional[dict] = None, writer: bool = True):
        self._mgr = CheckpointManager(directory, site=site,
                                      keep_last=keep_last, prefix="state",
                                      registry=registry)
        self.site = site
        self.writer = bool(writer)
        self._registry = registry
        self.topology = dict(topology) if topology else None
        self.last_topology_delta: Optional[dict] = None
        #: the step of the last ``save`` (on every rank, writer or not)
        self.last_step: Optional[int] = None

    @property
    def manager(self) -> CheckpointManager:
        return self._mgr

    def save(self, state: TrainState, step: int, *,
             meta: Optional[dict] = None, block: bool = False) -> None:
        self.last_step = int(step)
        if not self.writer:
            return
        from ..utils import pickling
        host = _host_state(state)
        arrays = _flatten({"params": host.params,
                           "batch_stats": host.batch_stats or {}}, "t")
        arrays[self._STEP_KEY] = np.array(host.step)
        arrays[self._OPT_KEY] = np.frombuffer(
            pickling.dumps(host.opt_state), dtype=np.uint8)
        meta = dict(meta or {}, kind="train_state")
        if self.topology is not None:
            meta["topology"] = self.topology
        self._mgr.save(step, arrays, meta, block=block)

    def wait(self) -> None:
        self._mgr.wait()

    def close(self) -> None:
        self._mgr.close()

    def load_latest(self, trainer=None) -> Optional[TrainState]:
        """Newest valid snapshot as a TrainState (placed on ``trainer``'s
        mesh when given), or None.  A torn newest snapshot falls back to
        the previous one.  With a topology stanza, the snapshot's recorded
        stanza is diffed against it: a change is booked
        (``mmlspark_reshard_total{driver="parallel.trainer"}``) and
        surfaced as ``last_topology_delta``."""
        got = self._mgr.load_latest(current_topology=self.topology)
        self.last_topology_delta = None
        if got is None:
            return None
        _, arrays, _meta = got
        delta = _meta.get("topology_delta")
        if delta is not None:
            self.last_topology_delta = delta
            if delta["changed"]:
                from ..io.checkpoint import book_reshard
                book_reshard("parallel.trainer", delta,
                             registry=self._registry)
        from ..utils import pickling
        flat = {k: v for k, v in arrays.items()
                if k not in (self._OPT_KEY, self._STEP_KEY)}
        tree = _unflatten(flat).get("t", {})
        opt_state = pickling.loads(arrays[self._OPT_KEY].tobytes())
        state = TrainState(params=tree.get("params", {}),
                           opt_state=opt_state,
                           step=arrays[self._STEP_KEY],
                           batch_stats=tree.get("batch_stats") or None)
        if trainer is not None:
            state = trainer.shard_state(state)
        return state
