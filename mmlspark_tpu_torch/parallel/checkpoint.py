"""Training-state checkpoint/resume for the distributed trainer (port of
``mmlspark_tpu/parallel/checkpoint.py``).

A train-state checkpoint is params + optimizer state + step +
batch_stats.  The ``npz`` backend: NPZ arrays + the pickled optimizer
state (nests of numpy arrays), every file published atomically through
``io.checkpoint.atomic_write``, so a crash mid-save cannot tear the only
copy.  The reference's ``orbax`` backend raises: the port has no orbax.

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
from typing import Dict, Optional

import numpy as np

from ..io.checkpoint import CheckpointManager, atomic_write
from .trainer import TrainState

_NO_ORBAX = ("backend='orbax' is the reference's orbax StandardCheckpointer; "
             "the port has no orbax: use backend='npz'")


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
    """Write ``state`` under ``path``: ``state.npz`` (params, batch_stats,
    step) and ``opt_state.pkl``, each atomically, then the
    ``LATEST_BACKEND`` marker.  Pass the ``trainer`` of a model-sharded
    state so its blocks are gathered whole.  In a world of several ranks
    every rank calls it (the gathers and a closing barrier are
    collectives) and world rank 0 writes."""
    if backend not in ("npz", "orbax"):
        raise ValueError(f"backend must be 'npz' or 'orbax', got {backend!r}")
    if backend == "orbax":
        raise NotImplementedError(_NO_ORBAX)
    host = _host_state(state, trainer)
    from .mesh import world_rank
    from .trainer import _world_barrier
    if world_rank() == 0:
        _write_npz(host, path)
    # written before any rank returns: a load that follows reads it
    _world_barrier()


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
    place it on its mesh (``Trainer.shard_state``).  ``template`` is
    accepted for the reference's signature (the orbax restore's target);
    ``backend="orbax"`` raises: the port has no orbax."""
    if backend is not None and backend not in ("npz", "orbax"):
        raise ValueError(f"backend must be 'npz' or 'orbax', got {backend!r}")
    if backend == "orbax" or (backend is None and os.path.exists(
            os.path.join(os.path.abspath(path), "orbax"))):
        raise NotImplementedError(_NO_ORBAX)
    npz_path = os.path.join(path, "state.npz")
    if not os.path.exists(npz_path):
        raise FileNotFoundError(f"no checkpoint at {path}")
    with np.load(npz_path, allow_pickle=False) as z:
        tree = _unflatten({k: z[k] for k in z.files})["t"]
    from ..utils import pickling
    with open(os.path.join(path, "opt_state.pkl"), "rb") as f:
        opt_state = pickling.load(f)
    state = TrainState(params=tree.get("params", {}), opt_state=opt_state,
                       step=tree["step"],
                       batch_stats=tree.get("batch_stats") or None)
    if trainer is not None:
        state = trainer.shard_state(state)
    return state


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
