"""A world of ranks in spawned processes, for SPMD programs on one host.

``World(width)`` starts ``width`` processes (``spawn``), each joins one
process group (``file://`` rendezvous in a fresh directory, so concurrent
worlds never share a port) and then waits for work: ``run(fn, *args)``
hands the same call to every rank and returns their results in rank order.
One world serves many calls, so a caller pays the processes' start once.

``backend="gloo"`` runs CPU ranks, or ranks that share one card (NCCL
refuses two ranks on a device; gloo takes CUDA tensors in ``all_reduce``);
``"nccl"`` puts one rank on each card.  A rank's current CUDA device is
``cuda:<rank mod cards>`` when there is a card.  ``fn`` must be importable
by name (a module-level function): the ranks unpickle it.

Failure: a rank that raises fails the call with every rank's traceback;
the world is then torn down (its other ranks may wait in a collective) and
the next call starts a new one.  Ranks die with the process that started
them (``PR_SET_PDEATHSIG`` on Linux), so a killed launcher leaves none
behind.
"""
from __future__ import annotations

import os
import queue
import shutil
import signal
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional


def _die_with_parent(parent_pid: int) -> None:
    try:
        import ctypes
        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        libc.prctl(1, signal.SIGKILL)           # PR_SET_PDEATHSIG
    except OSError:
        return
    if os.getppid() != parent_pid:              # the parent died first
        os._exit(1)


def _rank_main(rank: int, width: int, backend: str, init_file: str,
               tasks, results, timeout_s: float, parent_pid: int,
               threads: Optional[int]) -> None:
    _die_with_parent(parent_pid)
    import torch
    from .mesh import initialize_distributed
    if threads:
        torch.set_num_threads(threads)
    try:
        initialize_distributed(f"file://{init_file}", width, rank,
                               backend=backend, timeout_s=timeout_s)
    except BaseException:                        # noqa: BLE001
        results.put((rank, False, traceback.format_exc()))
        return
    import torch.distributed as dist
    try:
        while True:
            task = tasks.get()
            if task is None:
                break
            fn, args, kwargs = task
            try:
                results.put((rank, True, fn(*args, **kwargs)))
            except BaseException:                # noqa: BLE001
                results.put((rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


class World:
    """``width`` ranks over one process group (see the module doc)."""

    def __init__(self, width: int, backend: str = "gloo",
                 timeout_s: float = 300.0, threads: Optional[int] = None):
        if width < 1:
            raise ValueError(f"width must be >= 1, got {width}")
        self.width, self.backend = int(width), backend
        self.timeout_s, self.threads = float(timeout_s), threads
        self._procs: List = []
        self._dir: Optional[str] = None

    def start(self) -> "World":
        if self._procs:
            return self
        import multiprocessing as mp
        ctx = mp.get_context("spawn")
        self._dir = tempfile.mkdtemp(prefix="mmlspark_world_")
        init_file = os.path.join(self._dir, "rendezvous")
        self._results = ctx.Queue()
        self._tasks = [ctx.Queue() for _ in range(self.width)]
        for r in range(self.width):
            p = ctx.Process(target=_rank_main, daemon=True,
                            args=(r, self.width, self.backend, init_file,
                                  self._tasks[r], self._results,
                                  self.timeout_s, os.getpid(), self.threads),
                            name=f"mmlspark-rank-{r}")
            p.start()
            self._procs.append(p)
        return self

    def run(self, fn: Callable, *args, **kwargs) -> List[Any]:
        """``fn(*args, **kwargs)`` on every rank at once; the results in
        rank order.  Raises if any rank raises, dies or overruns
        ``timeout_s``."""
        self.start()
        for q in self._tasks:
            q.put((fn, args, kwargs))
        got, failed = {}, []
        deadline = time.monotonic() + self.timeout_s
        while len(got) + len(failed) < self.width:
            try:
                rank, ok, val = self._results.get(timeout=0.2)
            except queue.Empty:
                dead = [p.name for p in self._procs if not p.is_alive()]
                if dead or time.monotonic() > deadline:
                    if dead or not failed:
                        failed.append(f"ranks {dead} died" if dead else
                                      f"timed out after {self.timeout_s} s")
                    break
                continue
            if ok:
                got[rank] = val
            else:
                failed.append(f"rank {rank}:\n{val}")
                # the others may wait on it in a collective: a short grace
                deadline = min(deadline, time.monotonic() + 5.0)
        if failed:
            self.close(force=True)
            raise RuntimeError(f"{getattr(fn, '__name__', fn)} failed in a "
                               f"world of {self.width}:\n"
                               + "\n".join(failed))
        return [got[r] for r in range(self.width)]

    def close(self, force: bool = False) -> None:
        """Stop the ranks (at once with ``force``) and drop the rendezvous
        directory."""
        procs, self._procs = self._procs, []
        if not force:
            for q in self._tasks if procs else ():
                q.put(None)
            for p in procs:
                p.join(timeout=30)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        if self._dir is not None:
            shutil.rmtree(self._dir, ignore_errors=True)
            self._dir = None

    def __enter__(self) -> "World":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close(force=exc[0] is not None)

