"""Executor runtime — rank processes, the mesh formed at startup (port of
``mmlspark_tpu/parallel/executor.py``).

The reference hands every executor the coordinator address and its process
index, then ``jax.distributed.initialize`` forms the global device view.
Here an executor process is one or more ranks of a ``torch.distributed``
process group: ``ExecutorConfig`` / ``bootstrap_executor`` are what a
launcher calls inside each rank (``initialize_distributed``, then
``make_mesh`` and ``set_active_mesh``), and ``run_local_cluster`` starts
real separate processes on this host to drive the multi-process path end
to end.

One rank is one position of the mesh.  ``devices_per_process = D`` maps an
executor process onto D ranks (the reference's process with D devices):
process ``i`` is ranks ``i * D ... i * D + D - 1``, each its own OS
process, and the result ``run_local_cluster`` returns for process ``i`` is
that of its first rank.

``backend`` (unset): ``nccl`` when every rank can have a card of its own,
``gloo`` otherwise (CPU ranks, or ranks sharing a card: NCCL refuses two
ranks on one device; ``parallel.collectives`` carries gloo's missing CUDA
collectives over ``all_reduce``).

The function a cluster runs is pickled by name when the ranks can import
its module from the repository root (the package, a script at the root);
otherwise it goes by value, which needs ``cloudpickle`` (a test module, a
lambda, ``__main__``).  Without cloudpickle such a function raises: pass a
module-level function of an importable module.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import socket
import subprocess
import sys
import tempfile
import time
from typing import Callable, Dict, List, Optional


@dataclasses.dataclass
class ExecutorConfig:
    """One rank's bootstrap: the rendezvous (``host:port``, or a ``tcp://``
    / ``file://`` URL), the executor processes, this rank's process and
    its index among the process's ``devices_per_process`` ranks, the mesh
    axes and the process-group backend (None: see the module doc)."""
    coordinator_address: str
    num_processes: int
    process_id: int
    devices_per_process: int = 1
    mesh_axes: Optional[Dict[str, int]] = None
    local_index: int = 0
    backend: Optional[str] = None

    @property
    def world_size(self) -> int:
        return self.num_processes * self.devices_per_process

    @property
    def rank(self) -> int:
        return self.process_id * self.devices_per_process + self.local_index


def free_port() -> int:
    with socket.socket() as s:  # graft-lint: disable=RES001 — binds an ephemeral local port; no remote I/O, nothing to breaker/deadline
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def make_cluster_configs(num_processes: int, devices_per_process: int = 1,
                         host: str = "127.0.0.1",
                         mesh_axes: Optional[Dict[str, int]] = None,
                         coordinator_address: Optional[str] = None,
                         backend: Optional[str] = None
                         ) -> List[ExecutorConfig]:
    """Driver role: allocate the coordinator endpoint (``host`` and a free
    port, unless ``coordinator_address`` is given) and one config per
    rank, process-major."""
    addr = coordinator_address or f"{host}:{free_port()}"
    return [ExecutorConfig(addr, num_processes, i, devices_per_process,
                           mesh_axes, j, backend)
            for i in range(num_processes)
            for j in range(devices_per_process)]


def _default_backend(world: int) -> str:
    import torch
    if torch.cuda.is_available() and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


def bootstrap_executor(cfg: ExecutorConfig):
    """Worker role: join the process group and build the global mesh
    (also made the active one)."""
    from .mesh import initialize_distributed, make_mesh, set_active_mesh
    initialize_distributed(cfg.coordinator_address, cfg.world_size,
                           cfg.rank, backend=cfg.backend or
                           _default_backend(cfg.world_size))
    mesh = make_mesh(cfg.mesh_axes)
    set_active_mesh(mesh)
    return mesh


_WORKER = r"""
import os, pickle, sys
sys.path.insert(0, {repo_root!r})
from mmlspark_tpu_torch.parallel.world import _die_with_parent
_die_with_parent({parent_pid!r})
import torch
if {threads!r}:
    torch.set_num_threads({threads!r})
from mmlspark_tpu_torch.parallel.executor import bootstrap_executor
from mmlspark_tpu_torch.utils import pickling
with open({cfg_path!r}, "rb") as f:
    cfg = pickle.load(f)
mesh = bootstrap_executor(cfg)
try:
    with open({fn_path!r}, "rb") as f:
        fn = pickling.load(f)
    result = fn(mesh, cfg.process_id)
    if cfg.local_index == 0:
        with open({out_path!r}, "wb") as f:
            pickle.dump(result, f)
finally:
    torch.distributed.destroy_process_group()
"""


def _importable(mod, repo_root: str) -> bool:
    """Whether the ranks (``sys.path``: the repository root first) find
    ``mod`` by its name."""
    name = getattr(mod, "__name__", "__main__")
    if name == "__main__":
        return False
    base = os.path.join(repo_root, *name.split("."))
    return os.path.exists(base + ".py") or os.path.exists(
        os.path.join(base, "__init__.py"))


def _ship(fn: Callable, path: str, repo_root: str) -> None:
    """Pickle ``fn`` for the ranks: by name when they can import its
    module, else by value under cloudpickle; without cloudpickle such a
    function raises."""
    import functools
    import inspect
    from ..utils import pickling
    target = fn
    while isinstance(target, functools.partial):
        target = target.func
    mod = inspect.getmodule(target)
    by_name = mod is not None and _importable(mod, repo_root) and \
        "<" not in getattr(target, "__qualname__", "<")
    if not by_name:
        try:
            import cloudpickle
        except ImportError:
            raise ValueError(
                f"run_local_cluster: {getattr(target, '__qualname__', fn)!r}"
                f" (module {getattr(mod, '__name__', None)}) cannot be "
                "shipped: without cloudpickle the ranks import the function "
                "by name, so it must be a module-level function of a module "
                "importable from the repository root (import the script as "
                "a module and pass the function from there)") from None
        if mod is not None and mod.__name__ != "__main__":
            cloudpickle.register_pickle_by_value(mod)
    with open(path, "wb") as f:
        pickling.dump(fn, f)


def run_local_cluster(fn: Callable, num_processes: int = 2,
                      devices_per_process: int = 2,
                      mesh_axes: Optional[Dict[str, int]] = None,
                      timeout_s: float = 300.0, *,
                      backend: Optional[str] = None,
                      threads: Optional[int] = None) -> List:
    """Run ``fn(mesh, process_id)`` in ``num_processes`` executor processes
    of ``devices_per_process`` ranks each — real separate OS processes, one
    per rank, forming one mesh of ``num_processes * devices_per_process``
    positions (``mesh_axes``, default 1-d ``data``).  Returns each
    executor process's result (its first rank's), pickled back.

    The rendezvous is a ``file://`` URL in a fresh temporary directory, so
    concurrent clusters never race for a port.  ``threads`` caps each
    rank's torch threads.  A rank that fails, or a cluster that overruns
    ``timeout_s``, raises with each failing rank's stderr tail; the other
    ranks (which may wait in a collective) are killed."""
    world = num_processes * devices_per_process
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    with tempfile.TemporaryDirectory(prefix="mmlspark_cluster_") as d:
        configs = make_cluster_configs(
            num_processes, devices_per_process, mesh_axes=mesh_axes,
            coordinator_address="file://" + os.path.join(d, "rendezvous"),
            backend=backend or _default_backend(world))
        fn_path = os.path.join(d, "fn.pkl")
        _ship(fn, fn_path, repo_root)
        env = dict(os.environ)
        env.pop("PYTHONPATH", None)
        procs, outs = [], []
        for cfg in configs:
            tag = f"{cfg.process_id}_{cfg.local_index}"
            cfg_path = os.path.join(d, f"cfg_{tag}.pkl")
            out_path = os.path.join(d, f"out_{tag}.pkl")
            with open(cfg_path, "wb") as f:
                pickle.dump(cfg, f)
            code = _WORKER.format(repo_root=repo_root, threads=threads,
                                  parent_pid=os.getpid(),
                                  cfg_path=cfg_path, fn_path=fn_path,
                                  out_path=out_path)
            procs.append(subprocess.Popen(
                [sys.executable, "-c", code], env=env, cwd=repo_root,
                stdout=subprocess.DEVNULL, stderr=subprocess.PIPE))
            outs.append(out_path)
        errors = _wait_all(procs, configs, timeout_s)
        if errors:
            raise RuntimeError("local cluster failed:\n" + "\n".join(errors))
        results = []
        for cfg, out_path in zip(configs, outs):
            if cfg.local_index == 0:
                with open(out_path, "rb") as f:
                    results.append(pickle.load(f))
        return results


def _wait_all(procs, configs, timeout_s: float) -> List[str]:
    """Wait for every rank; after the first failure (or the deadline) the
    rest get a short grace, then are killed.  Returns the failures."""
    import threading
    tails: Dict[int, bytes] = {}

    def drain(i, p):
        tails[i] = p.stderr.read()

    readers = [threading.Thread(target=drain, args=(i, p), daemon=True)
               for i, p in enumerate(procs)]
    for t in readers:
        t.start()
    deadline = time.monotonic() + timeout_s
    errors: List[str] = []
    while any(p.poll() is None for p in procs):
        failed = [p for p in procs if p.poll() not in (None, 0)]
        if failed or time.monotonic() > deadline:
            if not failed:
                errors.append(f"timed out after {timeout_s} s")
            grace = time.monotonic() + 5.0
            while any(p.poll() is None for p in procs) and \
                    time.monotonic() < grace:
                time.sleep(0.05)
            for p in procs:
                if p.poll() is None:
                    p.kill()
            break
        time.sleep(0.05)
    for p in procs:
        p.wait()
    for t in readers:
        t.join(timeout=10)
    for i, (p, cfg) in enumerate(zip(procs, configs)):
        if p.returncode != 0:
            errors.append(f"proc {cfg.process_id} rank {cfg.rank} "
                          f"rc={p.returncode}: "
                          f"{tails.get(i, b'').decode(errors='replace')[-2000:]}")
    return errors
