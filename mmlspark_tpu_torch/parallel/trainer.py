"""Distributed training — data x model sharded train steps (port
of ``mmlspark_tpu/parallel/trainer.py``).

The reference jits a step over a ``data x model`` mesh and lets GSPMD insert
the gradient sums and weight gathers from sharding annotations.  Here each
rank is one position of that mesh (``parallel.mesh``) and the step does by
hand what GSPMD's arithmetic does:

- **data**: the batch is cut into contiguous blocks over ``data``; each rank
  takes the mean loss of its block, and the gradients are averaged over
  ``data`` by one ``all_reduce`` of the flattened gradients (with the loss
  riding in the same buffer), so the step is the global batch's mean-loss
  step.  BatchNorm statistics are the global batch's (``models.resnet.
  BatchNorm`` sums over the live ``data`` axis, and the sum's backward
  sums the cotangent).
- **model**: big >= 2-d kernels shard their last axis over ``model``
  (:func:`param_spec`, the reference's rule read on the port's leaf).  Each
  rank stores its block (and its optimizer state's block); the forward
  all-gathers the full kernel, every ``model`` rank computes the same
  forward and backward on it, and the gradient goes back to the block by
  keeping this rank's slice of the full kernel's gradient.

The module is a ``torch.nn.Module`` holding its initial weights (torch
initializes at construction; the reference draws them from ``rng``).  The
optimizer is a factory ``optimizer(params) -> torch.optim.Optimizer`` over
the list of this rank's parameter blocks, in place of an optax
transformation: ``lambda ps: torch.optim.SGD(ps, lr=0.1, momentum=0.9)``.
A :class:`TrainState` holds tensors: ``params`` and ``batch_stats`` as
nests of dicts named after the module's ``named_parameters`` /
``named_buffers`` (``"0.weight"`` -> ``params["0"]["weight"]``),
``opt_state`` as the optimizer's per-parameter state under the same names,
and ``step``.  The step updates the tensors in place (the reference
donates its state buffers) and returns the same ``params`` nest.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from .mesh import AXIS_DATA, AXIS_MODEL, get_active_mesh, mesh_device
from .sharding import NamedSharding, PartitionSpec


@dataclasses.dataclass
class TrainState:
    params: Any
    opt_state: Any
    step: Any
    batch_stats: Any = None


def param_spec(leaf, model_axis_size: int, min_size: int = 2 ** 16):
    """Sharding rule: shard the last axis of big >=2-d kernels over
    ``model``; replicate everything else.  Keeps small params replicated
    (cheap) and the big matmuls' weights tensor-parallel."""
    shape = tuple(getattr(leaf, "shape", ()))
    if len(shape) >= 2 and np.prod(shape) >= min_size and \
            model_axis_size > 1 and shape[-1] % model_axis_size == 0:
        return PartitionSpec(*([None] * (len(shape) - 1) + [AXIS_MODEL]))
    return PartitionSpec()


def shard_params_by_rule(params, mesh, min_size: int = 2 ** 16):
    """The :class:`NamedSharding` of every leaf of ``params`` under
    :func:`param_spec`."""
    from .partition import tree_map_with_path
    model_size = mesh.shape.get(AXIS_MODEL, 1)
    return tree_map_with_path(
        lambda _name, leaf: NamedSharding(
            mesh, param_spec(leaf, model_size, min_size)), params)


def _nest(named) -> Dict:
    """``{"a.b": t}`` -> ``{"a": {"b": t}}``."""
    out: Dict = {}
    for name, t in named:
        node = out
        *mods, leaf = name.split(".")
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = t
    return out


def _flat(nest, prefix: str = "") -> Dict[str, Any]:
    """``{"a": {"b": t}}`` -> ``{"a.b": t}`` (insertion order)."""
    out: Dict[str, Any] = {}
    for k, v in (nest or {}).items():
        name = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flat(v, name))
        else:
            out[name] = v
    return out


def _gather_dim(t: torch.Tensor, dim: int, mesh) -> torch.Tensor:
    """The full tensor of ``t``'s blocks along ``dim`` over ``model``."""
    from .collectives import all_gather
    parts = all_gather(t, AXIS_MODEL, tiled=False, mesh=mesh)
    return torch.cat(list(parts.unbind(0)), dim=dim)


class Trainer:
    """Builds sharded train steps for a ``torch.nn.Module`` (see the module
    doc).

    ``loss_fn(logits, batch) -> scalar``; the module is applied to
    ``batch["x"]`` (with ``train=True`` when its ``forward`` takes
    ``train``, and ``apply_kwargs``).  ``has_batch_stats`` keeps the
    module's buffers (BatchNorm running statistics) in the state.
    ``device_time_every`` samples the device phase (a synchronize) every
    N steps, default 32; 0 disables it.  The trainer runs on the mesh's
    device: the card, or the CPU for a mesh built with ``device="cpu"``
    (without a card it raises otherwise)."""

    DEVICE_TIME_EVERY_DEFAULT = 32

    def __init__(self, module, optimizer, loss_fn: Callable,
                 mesh=None, has_batch_stats: bool = False,
                 apply_kwargs: Optional[Dict[str, Any]] = None,
                 min_shard_size: int = 2 ** 16,
                 device_time_every: Optional[int] = None):
        self.mesh = mesh or get_active_mesh()
        self.module = module.to(mesh_device(self.mesh))
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.has_batch_stats = has_batch_stats
        self.apply_kwargs = dict(apply_kwargs or {})
        self.min_shard_size = min_shard_size
        if device_time_every is None:
            device_time_every = self.DEVICE_TIME_EVERY_DEFAULT
        self.device_time_every = max(0, int(device_time_every))
        self._step_count = 0
        self._train_step = None
        self._opt = None
        #: the state the last step returned (what a per-step callback of
        #: ``train_stream``, which gets no state, reads)
        self.last_state: Optional[TrainState] = None
        self._names: list = []
        self._specs: Dict[str, PartitionSpec] = {}
        import inspect
        try:
            self._takes_train = "train" in inspect.signature(
                module.forward).parameters
        except (TypeError, ValueError):
            self._takes_train = False
        from ..observability import get_registry
        from ..observability.tracing import current_trace_id
        reg = get_registry()
        self._m_step = reg.histogram(
            "mmlspark_parallel_train_step_seconds",
            "train_step dispatch+wait time on the host (async under jit: "
            "the device may still be running when the call returns)")
        self._m_phase = reg.histogram(
            "mmlspark_parallel_train_step_phase_seconds",
            "train_step breakdown: trace (compile), dispatch (host enqueue), "
            "device (sampled block_until_ready wait)", labels=("phase",))
        self._current_trace_id = current_trace_id

    # ------------------------------------------------------------------ init
    def init_state(self, rng=None, example_batch=None) -> TrainState:
        """The module's current weights as a placed :class:`TrainState`.
        ``rng`` and ``example_batch`` are accepted for the reference's
        signature: a torch module is initialized at construction."""
        params = _nest((n, p.detach()) for n, p in
                       self.module.named_parameters())
        batch_stats = _nest((n, b.detach()) for n, b in
                            self.module.named_buffers()) \
            if self.has_batch_stats else None
        state = TrainState(params=params, opt_state={},
                           step=torch.zeros((), dtype=torch.int64),
                           batch_stats=batch_stats)
        return self.shard_state(state)

    def partition_rules(self):
        """Ordered ``(regex, PartitionSpec-or-callable)`` placement table
        for a TrainState tree (``parallel.partition`` semantics): params
        and their optimizer state ride the size-aware kernel rule (big
        >=2-d kernels shard their last axis over ``model``; a moment has
        its parameter's shape, so it lands on the same block), the step
        and the batch statistics replicate.  The same rules place a fresh
        ``init_state`` and a checkpoint restored onto a different mesh."""
        model_size = self.mesh.shape.get(AXIS_MODEL, 1)
        min_size = self.min_shard_size

        def kernel_rule(name, leaf):
            return param_spec(leaf, model_size, min_size)

        return ((r"^(params|opt_state)(/|$)", kernel_rule),
                (r"^(step|batch_stats)(/|$)", PartitionSpec()))

    def shard_state(self, state: TrainState) -> TrainState:
        """Place a state of WHOLE tensors (a fresh init, a restored
        snapshot) on this trainer's mesh under :meth:`partition_rules`,
        and bind the optimizer to the placed parameter blocks."""
        from .partition import match_partition_rules, replace_on_mesh
        tree = {"params": state.params, "opt_state": state.opt_state or {},
                "step": torch.as_tensor(np.asarray(
                    state.step.cpu() if isinstance(state.step, torch.Tensor)
                    else state.step)).to(torch.int64),
                "batch_stats": state.batch_stats or {}}
        rules = self.partition_rules()
        specs = match_partition_rules(rules, tree)
        placed = replace_on_mesh(tree, rules, self.mesh,
                                 site="parallel.trainer.shard_state",
                                 specs=specs)
        flat_params = _flat(placed["params"])
        spec_params = _flat(specs["params"])
        self._names = list(flat_params)
        self._specs = {n: spec_params[n] for n in self._names}
        own = dict(self.module.named_parameters())
        for n in self._names:
            t = flat_params[n].detach()
            ref = own.get(n)
            # the module's own layout (channels_last convolutions): a
            # restored snapshot must run the kernels a fresh init runs
            t = torch.empty_like(ref).copy_(t) if ref is not None and \
                ref.shape == t.shape else t.clone()
            flat_params[n] = t.requires_grad_(t.is_floating_point())
        self._opt = self.optimizer([flat_params[n] for n in self._names])
        # scalar optimizer state (Adam's step count) stays on the host, as
        # a non-capturable torch optimizer keeps it
        opt_tree = {n: {k: v.cpu() if v.ndim == 0 else v.clone()
                        for k, v in st.items()}
                    for n, st in _flat_opt(placed["opt_state"]).items()}
        if opt_tree:
            sd = self._opt.state_dict()
            sd["state"] = {i: opt_tree[n] for i, n in enumerate(self._names)
                           if n in opt_tree}
            self._opt.load_state_dict(sd)
        self._train_step = None
        params = _nest(flat_params.items())
        bs = _nest((n, v.clone()) for n, v in
                   _flat(placed["batch_stats"]).items()) \
            if self.has_batch_stats else None
        return TrainState(params=params, opt_state=self._opt_tree(),
                          step=placed["step"], batch_stats=bs)

    def _opt_tree(self) -> Dict:
        """The optimizer's per-parameter state as a nest named like the
        params (tensors shared with the optimizer, not copied)."""
        plist = [p for g in self._opt.param_groups for p in g["params"]]
        out = {}
        for n, p in zip(self._names, plist):
            kept = {k: v for k, v in self._opt.state.get(p, {}).items()
                    if isinstance(v, torch.Tensor)}
            if kept:
                out[n] = kept
        return _nest_opt(out)

    def full_state(self, state: TrainState) -> TrainState:
        """``state`` with every model-sharded leaf gathered whole, on the
        host (numpy): what a snapshot holds, whatever the sharding.  Every
        rank of the mesh must call it (the gathers are collectives)."""
        def whole(t, spec):
            t = t.detach()
            d = NamedSharding(self.mesh, spec).dim
            if d is not None and self.mesh.shape.get(spec[d], 1) > 1:
                t = _gather_dim(t, d, self.mesh)
            return t.cpu().numpy().copy()

        params = _flat(state.params)
        opt = _flat_opt(state.opt_state)
        return TrainState(
            params=_nest((n, whole(params[n], self._specs[n]))
                         for n in params),
            opt_state=_nest_opt({n: {k: whole(v, self._specs[n]
                                              if tuple(v.shape) ==
                                              tuple(params[n].shape)
                                              else PartitionSpec())
                                     for k, v in st.items()}
                                 for n, st in opt.items()}),
            step=np.asarray(int(state.step)),
            batch_stats=None if state.batch_stats is None else _nest(
                (n, v.detach().cpu().numpy().copy())
                for n, v in _flat(state.batch_stats).items()))

    # ------------------------------------------------------------------ steps
    def _place_batch(self, batch, site: str):
        sh = NamedSharding(self.mesh, PartitionSpec(AXIS_DATA))
        return {k: sh.place(v, site=site) for k, v in batch.items()}

    def _step_fn(self, state: TrainState, batch) -> Tuple[TrainState, Any]:
        from torch.func import functional_call
        from .collectives import live_axes, psum
        mesh = self.mesh
        flat = _flat(state.params)
        if flat and next(iter(flat.values())) is not \
                self._opt.param_groups[0]["params"][0]:
            raise RuntimeError("the state's params are not this trainer's "
                               "placed ones: place it with shard_state")
        full = {}
        for n in self._names:
            p, spec = flat[n], self._specs[n]
            d = NamedSharding(mesh, spec).dim
            if d is not None and mesh.shape.get(spec[d], 1) > 1:
                g = _gather_dim(p.detach(), d, mesh)
                full[n] = g.requires_grad_(True)
            else:
                full[n] = p
        tensors = dict(full)
        if self.has_batch_stats:
            tensors.update(_flat(state.batch_stats))
        kw = dict(self.apply_kwargs)
        if self._takes_train:
            kw["train"] = True
        with live_axes(mesh):
            out = functional_call(self.module, tensors, (batch["x"],), kw)
            loss = self.loss_fn(out, batch)
            loss.backward()
        grads = []
        for n in self._names:
            g = full[n].grad
            if g is None:
                g = torch.zeros_like(full[n])
            spec = self._specs[n]
            g = NamedSharding(mesh, spec).local(g)
            grads.append(g.reshape(-1))
        flat_g = torch.cat(grads + [loss.detach().reshape(1)])
        parts = mesh.shape.get(AXIS_DATA, 1)
        if parts > 1:
            flat_g = psum(flat_g, AXIS_DATA, mesh) / parts
        off = 0
        for n in self._names:
            p = flat[n]
            k = p.numel()
            p.grad = flat_g[off:off + k].view_as(p).to(p.dtype)
            off += k
        self._opt.step()
        self._opt.zero_grad(set_to_none=True)
        for t in full.values():
            t.grad = None
        new = TrainState(params=state.params, opt_state=self._opt_tree(),
                         step=state.step + 1, batch_stats=state.batch_stats)
        return new, flat_g[-1]

    def train_step(self, state: TrainState, batch) -> Tuple[TrainState, Any]:
        """One step on the global ``batch`` (every rank passes the same
        host arrays; each keeps its ``data`` block).  Returns the new
        state and the global batch's mean loss (a 0-d tensor).  The step
        is booked through ``instrumented_call("parallel.train_step")``: a
        torch optimizer makes its state at its first step, so the first
        two steps are two signatures."""
        return self._dispatch(state, self._place_batch(
            batch, "parallel.trainer.train_step"))

    def _dispatch(self, state, batch):
        if self._train_step is None:
            if self._opt is None:
                raise RuntimeError(
                    "call init_state/shard_state before train_step")
            from ..observability.compute import instrumented_call
            self._train_step = instrumented_call(
                self._step_fn, name="parallel.train_step",
                donate_argnums=(0,))
        fn = self._train_step
        trace_id = self._current_trace_id()
        compiles_before = fn.compiles
        t0 = time.perf_counter()
        out = fn(state, batch)
        dispatch_s = time.perf_counter() - t0
        self.last_state = out[0]
        self._m_step.observe(dispatch_s, trace_id)
        if fn.compiles != compiles_before:
            self._m_phase.observe(fn.last_compile_s, trace_id, phase="trace")
            dispatch_s = max(0.0, dispatch_s - fn.last_compile_s)
        self._m_phase.observe(dispatch_s, trace_id, phase="dispatch")
        self._step_count += 1
        if self.device_time_every and \
                self._step_count % self.device_time_every == 0:
            t1 = time.perf_counter()
            if self.mesh.device.type == "cuda":
                torch.cuda.synchronize(self.mesh.device)
            device_s = time.perf_counter() - t1
            self._m_phase.observe(device_s, trace_id, phase="device")
            from ..observability.tracing import Span, export_span
            span = Span("compute.train_step", trace_id=trace_id,
                        start_s=t0,
                        attributes={"dispatch_s": round(dispatch_s, 6),
                                    "device_s": round(device_s, 6),
                                    "step": self._step_count})
            span.finish(time.perf_counter())
            export_span(span)
        return out

    def train_stream(self, state: TrainState, batches,
                     site: str = "parallel.trainer.stream",
                     checkpoint_dir: Optional[str] = None,
                     checkpoint_every: int = 0,
                     checkpoint_keep_last: int = 3,
                     resume: str = "auto",
                     callbacks: Optional[list] = None,
                     total_steps: Optional[int] = None,
                     monitor_port: Optional[int] = None,
                     monitor_stall_timeout_s: Optional[float] = None):
        """Out-of-core training loop: host batches (every rank iterates the
        same global ones) go through a double-buffered
        ``io.chunked.TilePrefetcher`` — batch ``k+1`` is cut to this rank's
        ``data`` block and copied to the device on a background thread
        while the step runs on batch ``k``.

        Fault tolerance: with ``checkpoint_dir`` set, the state snapshots
        every ``checkpoint_every`` steps (plus once at the end) through
        :class:`parallel.checkpoint.TrainLoopCheckpointer` — whole tensors
        gathered from every rank, written by world rank 0 — and
        ``resume="auto"`` restores the newest valid snapshot and skips
        ``batches`` past the steps it holds (pass the SAME iterable again;
        ``"never"`` disables restoring, ``"must"`` raises without a usable
        snapshot).  Elastic resume: a snapshot taken on another world
        width re-places through the partition rules; the change is booked
        (``mmlspark_reshard_total``) and surfaced as
        ``stats["resharded"]``.  SIGTERM/SIGINT (or
        ``utils.resilience.request_preemption``) ends the loop at the next
        step boundary with a final snapshot and ``stats["preempted"]``.

        ``callbacks`` run after every step as ``cb(step_index, None)``;
        ``monitor_port`` (0 = ephemeral) serves a training monitor named
        after ``site``; ``total_steps`` gives it a progress ratio.

        Returns ``(state, losses, stats)``."""
        import contextlib
        import itertools
        from ..io.chunked import TilePrefetcher
        from ..io.checkpoint import (check_resume_arg,
                                     resume_required_error, topology_stanza)
        from ..utils.resilience import PreemptionToken, preemption_scope
        from .mesh import world_rank
        check_resume_arg(resume, checkpoint_dir=checkpoint_dir)
        ckpt = None
        skip = 0
        step0 = None
        resharded = False
        if checkpoint_dir:
            from .checkpoint import TrainLoopCheckpointer
            ckpt = TrainLoopCheckpointer(
                checkpoint_dir, keep_last=checkpoint_keep_last, site=site,
                topology=topology_stanza(
                    mesh=self.mesh,
                    shard_count=int(self.mesh.shape.get(AXIS_DATA, 1))),
                writer=world_rank() == 0)
            step0 = int(state.step)
            if resume in ("auto", "must"):
                restored = ckpt.load_latest(trainer=self)
                if restored is None and resume == "must":
                    raise resume_required_error(checkpoint_dir)
                if restored is not None:
                    skip = max(0, int(restored.step) - step0)
                    state = restored
                    delta = ckpt.last_topology_delta
                    resharded = bool(delta and delta["changed"])

        def _load(batch):
            return self._place_batch(batch, site)

        items = itertools.islice(iter(batches), skip, None) if skip \
            else batches
        prefetcher = TilePrefetcher(items, _load, site=site)
        losses = []
        steps_done = skip
        preempted = False
        from ..observability.tracing import ambient_phase
        watch = wsrv = None
        if monitor_port is not None or monitor_stall_timeout_s is not None:
            from ..observability.trainwatch import start_training_monitor
            watch, wsrv = start_training_monitor(
                site, total_steps=total_steps, monitor_port=monitor_port,
                stall_timeout_s=monitor_stall_timeout_s,
                driver="parallel.trainer")
            watch.set_phase("parallel.train_step")
            watch.set_prefetch_fn(prefetcher.snapshot)
        scope = preemption_scope() if ckpt is not None \
            else contextlib.nullcontext(PreemptionToken())
        with contextlib.ExitStack() as stack:
            if wsrv is not None:
                stack.callback(wsrv.stop)
            if watch is not None:
                stack.callback(watch.close)
            token = stack.enter_context(scope)
            if watch is not None:
                watch.set_preemption_token(token)
            for batch in prefetcher:
                with ambient_phase("parallel.train_step"):
                    state, loss = self._dispatch(state, batch)
                losses.append(loss)
                steps_done += 1
                if callbacks:
                    for cb in callbacks:
                        cb(steps_done - 1, None)
                if watch is not None:
                    rows = int(next(iter(batch.values())).shape[0]) \
                        if batch else 0
                    watch.tick(step=steps_done, rows=rows)
                if ckpt is not None and token.requested:
                    ckpt.save(self.full_state(state), step0 + steps_done,
                              block=True)
                    preempted = True
                    break
                if ckpt is not None and checkpoint_every > 0 \
                        and steps_done % checkpoint_every == 0:
                    ckpt.save(self.full_state(state), step0 + steps_done)
        losses = [float(l) for l in losses]
        stats = prefetcher.overlap_stats()
        stats.update(steps=float(steps_done), resumed_from_step=float(skip),
                     preempted=float(preempted), resharded=float(resharded))
        if ckpt is not None:
            final = step0 + steps_done
            if not preempted and (steps_done > skip or skip == 0):
                # the terminal snapshot; a periodic save of this very
                # step is only waited for, not written twice
                if ckpt.last_step == final:
                    ckpt.wait()
                else:
                    ckpt.save(self.full_state(state), final, block=True)
            stats["checkpoint_saves"] = float(ckpt.manager.saves_ok)
            ckpt.close()
            # the writer's snapshots are on disk before any rank returns:
            # a resume that follows reads what every rank saved
            _world_barrier()
        return state, losses, stats


def _world_barrier() -> None:
    """Wait for every rank of the default group (a no-op in a world of
    one)."""
    from .mesh import _dist
    dist = _dist()
    if dist is not None and dist.get_world_size() > 1:
        dist.barrier()


def _flat_opt(nest) -> Dict[str, Dict[str, Any]]:
    """``opt_state`` nest -> ``{param name: {state key: tensor}}``: the
    innermost dicts whose values are not dicts are one parameter's
    state."""
    out: Dict[str, Dict[str, Any]] = {}

    def walk(prefix, node):
        if all(not isinstance(v, dict) for v in node.values()):
            out[prefix] = dict(node)
            return
        for k, v in node.items():
            walk(f"{prefix}.{k}" if prefix else str(k), v)

    if nest:
        walk("", nest)
    return out


def _nest_opt(flat: Dict[str, Dict[str, Any]]) -> Dict:
    return _nest((n, st) for n, st in flat.items())


def softmax_cross_entropy(logits, batch):
    """Mean softmax cross-entropy of ``logits`` against ``batch["y"]``:
    integer labels, or one-hot rows of the logits' shape."""
    import torch.nn.functional as F
    labels = batch["y"]
    logits = logits.float()
    if labels.ndim == logits.ndim:  # one-hot
        return -(labels * F.log_softmax(logits, -1)).sum(-1).mean()
    return F.cross_entropy(logits, labels.long())
