"""Compute-plane telemetry — the twin of the JAX package's
``observability/compute.py``, under the reference's metric names.

- :func:`compile_report` — the JSON behind ``GET /debug/compile`` on
  ``PipelineServer``: per-function compile counts and signatures of the
  registered :class:`InstrumentedJit` wrappers.
- :func:`ensure_device_memory_gauges` —
  ``mmlspark_device_bytes_in_use{device}`` and
  ``mmlspark_device_peak_bytes_in_use{device}``, callback gauges sampled
  from ``torch.cuda.memory_stats`` at scrape time (``allocated_bytes.all
  .current`` / ``.peak``).  Without a card nothing registers: a dashboard
  should see no series, not a wall of NaN.
- :func:`ensure_build_info` — ``mmlspark_build_info``, constant 1,
  labelled with the torch version, the CUDA version, the device kind and
  the local device count.
- :func:`transfer_nbytes` and :func:`device_put` — host -> device
  transfer accounting: ``mmlspark_device_transfer_bytes_total{site}``,
  booked on the host before the copy, with no sync.

- :class:`InstrumentedJit` / :func:`instrumented_jit` — the reference's
  compiled-program layer.  Every call keys its arguments' signature (the
  nest's structure and each leaf's shape, dtype and device; static
  arguments by value); the first call of a new signature is booked as
  that signature's compile (``mmlspark_jit_compile_total{fn}``, its wall
  time in ``mmlspark_jit_compile_seconds{fn}``, the recompile-storm trip
  at ``MMLSPARK_TPU_JIT_STORM_SIGS`` distinct signatures), and the
  wrapper registers in the registry's ``_jit_wrappers`` table, so
  :func:`compile_report` lists it in the reference's shape.  On a CUDA
  device the compiled program is a captured ``torch.cuda.CUDAGraph``:
  the signature's first call runs eagerly on a side stream (its result
  is that call's answer), the same call is captured into a memory pool
  the process's graphs share, and every later call copies its tensors
  into the graph's static inputs and replays.  On the CPU the call runs
  eagerly under the same booking.
- :class:`InstrumentedCall` / :func:`instrumented_call` — the same
  booking around a call that is never captured, for the steps whose
  collectives or backward passes cannot ride a graph (``parallel/``).
- :func:`captured` — the twin of a plain ``jax.jit``: the same capture
  and replay as :class:`InstrumentedJit`, with nothing booked and
  nothing registered, so :func:`compile_report` lists no name the
  reference's lacks (the VW step, the speech encoder's step, the lasso's
  ISTA loop, the Word2Vec epoch's blocks of steps).
- :func:`graph_pool_bytes` — the device bytes the shared graph pool
  holds; :func:`release_graphs` drops every captured graph (their static
  inputs and outputs with them): a later call captures again, booked as
  a re-capture, never a compile.

``torch`` is imported lazily inside functions, as the reference imports
jax.
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import gc
import inspect
import os
import threading
import time
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple

from .metrics import MetricsRegistry, get_registry

#: ``InstrumentedCall``, ``instrumented_call``, ``captured``,
#: ``graph_pool_bytes``, ``release_graphs`` and ``capture_scope`` are the
#: port's own and stay out of ``__all__``, which is the reference's
__all__ = ["InstrumentedJit", "instrumented_jit", "device_put",
           "transfer_nbytes", "compile_report",
           "ensure_device_memory_gauges", "ensure_build_info",
           "STORM_SIGNATURES_ENV", "DEFAULT_STORM_SIGNATURES"]

#: env override for the recompile-storm threshold (the reference's knob;
#: reported by :func:`compile_report`)
STORM_SIGNATURES_ENV = "MMLSPARK_TPU_JIT_STORM_SIGS"
DEFAULT_STORM_SIGNATURES = 8



def _storm_threshold() -> int:
    raw = os.environ.get(STORM_SIGNATURES_ENV, "")
    try:
        return max(2, int(raw)) if raw.strip() else DEFAULT_STORM_SIGNATURES
    except ValueError:
        return DEFAULT_STORM_SIGNATURES


# ---------------------------------------------------------------------------
# signatures
# ---------------------------------------------------------------------------

_DTYPE_SHORT = {"float32": "f32", "float64": "f64", "float16": "f16",
                "bfloat16": "bf16", "int32": "i32", "int64": "i64",
                "int16": "i16", "int8": "i8", "uint8": "u8",
                "uint16": "u16", "uint32": "u32", "bool": "b1"}


#: dtype and device -> their names in a signature (memoized: the names are
#: read on every call)
_NAMES: Dict[Any, str] = {}


def _name(x) -> str:
    out = _NAMES.get(x)
    if out is None:
        out = _NAMES[x] = str(x).replace("torch.", "")
    return out


def _leaf_sig(leaf) -> Tuple:
    """One leaf's identity: a tensor or array keys on its shape, dtype and
    device; a Python scalar on its type only (a new value is not a new
    signature, as under ``jax.jit``)."""
    if hasattr(leaf, "shape") and hasattr(leaf, "dtype"):
        return ("a", tuple(leaf.shape), _name(leaf.dtype),
                _name(getattr(leaf, "device", "cpu")))
    return ("py", type(leaf).__name__)


def _flat(tree, leaves: List) -> Tuple:
    """The structure of a nest of dicts (keys sorted), lists, tuples,
    named tuples and dataclasses, appending its leaves in order."""
    if tree is None:
        return ("none",)
    if isinstance(tree, dict):
        keys = sorted(tree)
        return ("dict", tuple((k, _flat(tree[k], leaves)) for k in keys))
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__, tuple(_flat(v, leaves) for v in tree))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return (type(tree).__name__, tuple(
            (f.name, _flat(getattr(tree, f.name), leaves))
            for f in dataclasses.fields(tree)))
    leaves.append(tree)
    return ("*",)


def _render_leaf(sig: Tuple) -> str:
    if sig[0] == "a":
        dt = _DTYPE_SHORT.get(sig[2], sig[2])
        return f"{dt}[{','.join(str(d) for d in sig[1])}]"
    return f"py:{sig[1]}"


class _SigEntry:
    __slots__ = ("rendered", "compile_s", "capture_s")

    def __init__(self, rendered: str, compile_s: float,
                 capture_s: Optional[float] = None):
        self.rendered, self.compile_s = rendered, compile_s
        #: the capture's own wall time (None: the call was not captured)
        self.capture_s = capture_s


class InstrumentedCall:
    """``fn`` with the reference's compile-boundary telemetry (see the
    module doc), called eagerly.  The steady state is one signature build
    and a dict hit before the call; a new signature books its first
    call's wall time as its compile, then checks the storm threshold.

    ``static_argnums`` / ``static_argnames`` key those arguments by value.
    ``in_shardings``, ``out_shardings``, ``donate_argnums`` and
    ``donate_argnames`` (and any other ``jax.jit`` keyword) are accepted
    for the reference's signature and kept on the wrapper
    (``jit_kwargs``): placement is the caller's (a rank already holds its
    blocks, ``parallel.sharding``); donation is read by
    :class:`InstrumentedJit`'s capture.  ``last_cost_analysis`` is always
    ``None``: nothing is lowered, so there is no cost analysis to read.

    This form captures nothing, so it is not a tracing root of
    graft-lint's TRC rules: the ``parallel/`` steps book through it, and
    the host clocks, locks and gloo collectives they run are ordinary
    host code.

    ``booked=False`` (the port's own, :func:`captured`) keys signatures
    as above but books no compile, storm or metric and registers nowhere:
    the twin of a plain ``jax.jit``."""

    def __init__(self, fn: Callable, *, name: Optional[str] = None,
                 registry: Optional[MetricsRegistry] = None,
                 storm_signatures: Optional[int] = None,
                 static_argnums=(), static_argnames=(), booked: bool = True,
                 **jit_kwargs):
        self._fn = fn
        self.booked = bool(booked)
        self.name = name or getattr(fn, "__name__", None) or "anonymous"
        self.registry = registry if registry is not None else get_registry()
        self.storm_signatures = storm_signatures or _storm_threshold()
        self.jit_kwargs = dict(jit_kwargs)
        self._static_nums = set(int(i) for i in (
            (static_argnums,) if isinstance(static_argnums, int)
            else static_argnums or ()))
        self._static_names = set((static_argnames,) if isinstance(
            static_argnames, str) else static_argnames or ())
        self._params: List[str] = []
        try:
            self._params = list(inspect.signature(fn).parameters)
        except (TypeError, ValueError):
            pass
        self._static_nums |= {self._params.index(n)
                              for n in self._static_names
                              if n in self._params}
        self._entries: Dict[Tuple, _SigEntry] = {}
        self._lock = threading.Lock()
        self._storm_tripped = False
        self.last_compile_s = 0.0
        if not self.booked:
            return
        reg = self.registry
        self._c_compile = reg.counter(
            "mmlspark_jit_compile_total",
            "XLA compilations by instrumented function",
            labels=("fn",)).labels(fn=self.name)
        self._h_compile = reg.histogram(
            "mmlspark_jit_compile_seconds",
            "lower+compile wall time per new abstract signature",
            labels=("fn",)).labels(fn=self.name)
        self._c_storm = reg.counter(
            "mmlspark_jit_recompile_storm_total",
            "signatures compiled at/over the recompile-storm threshold",
            labels=("fn",)).labels(fn=self.name)
        table = getattr(reg, "_jit_wrappers", None)
        if table is None:
            table = reg._jit_wrappers = {}
        table.setdefault(self.name, weakref.WeakSet()).add(self)

    def _signature(self, args, kwargs) -> Tuple:
        sig: List = []
        for i, a in enumerate(args):
            if i in self._static_nums:
                sig.append(("static", a))
                continue
            leaves: List = []
            struct = _flat(a, leaves)
            sig.append((struct, tuple(_leaf_sig(l) for l in leaves)))
        for k in sorted(kwargs):
            if k in self._static_names:
                sig.append((k, ("static", kwargs[k])))
                continue
            leaves = []
            struct = _flat(kwargs[k], leaves)
            sig.append((k, struct, tuple(_leaf_sig(l) for l in leaves)))
        return tuple(sig)

    @staticmethod
    def _render(sig: Tuple, n_pos: int) -> str:
        """A signature as ``/debug/compile`` shows it (made only when a
        signature is booked or named in an error)."""
        out = []
        for i, part in enumerate(sig):
            if i < n_pos:
                out.append(f"static:{part[1]!r}" if part[0] == "static"
                           else "/".join(map(_render_leaf, part[1])) or "()")
            elif len(part) == 2:             # (name, ("static", value))
                out.append(f"{part[0]}=static:{part[1][1]!r}")
            else:                            # (name, structure, leaves)
                out.append(f"{part[0]}="
                           + ("/".join(map(_render_leaf, part[2])) or "()"))
        return ", ".join(out)

    def __call__(self, *args, **kwargs):
        return self._run(self._signature(args, kwargs), args, kwargs)

    def _run(self, sig, args, kwargs):
        if sig in self._entries:             # GIL-atomic read; hot path
            return self._fn(*args, **kwargs)
        t0 = time.perf_counter()
        out = self._fn(*args, **kwargs)
        self._book_new(sig, len(args), time.perf_counter() - t0)
        return out

    def _book_new(self, sig, n_pos: int, dt: float,
                  capture_s: Optional[float] = None) -> None:
        with self._lock:
            if sig not in self._entries:
                self._entries[sig] = _SigEntry(self._render(sig, n_pos), dt,
                                               capture_s)
                self.last_compile_s = dt
                self._book_compile(self._entries[sig], len(self._entries))

    def _book_compile(self, entry: _SigEntry, n_sigs: int) -> None:
        if not self.booked:
            return
        self._c_compile.inc()
        self._h_compile.observe(entry.compile_s)
        if n_sigs >= self.storm_signatures:
            self._c_storm.inc()
            if not self._storm_tripped:
                self._storm_tripped = True
                from ..core.logging import log_event  # lazy: import cycle
                log_event({"event": "recompile_storm",
                           "className": "InstrumentedJit", "fn": self.name,
                           "distinct_signatures": n_sigs,
                           "threshold": self.storm_signatures,
                           "last_signature": entry.rendered})

    @property
    def compiles(self) -> int:
        return len(self._entries)

    def snapshot(self) -> Dict[str, Any]:
        """JSON-able state for ``/debug/compile``."""
        with self._lock:
            entries = list(self._entries.values())
            tripped = self._storm_tripped
        return {"fn": self.name, "compiles": len(entries),
                "storm_threshold": self.storm_signatures,
                "storm_tripped": tripped,
                "signatures": [{"signature": e.rendered,
                                "compile_seconds": round(e.compile_s, 6),
                                "cost_analysis": None, "aot": False}
                               for e in entries],
                "last_cost_analysis": None, **self._snapshot_extra()}

    def _snapshot_extra(self) -> Dict[str, Any]:
        return {}

    def __repr__(self):
        return (f"{type(self).__name__}({self.name!r}, "
                f"signatures={len(self._entries)})")


#: captured graphs kept per signature, one per set of donated addresses
#: (least recently replayed first out)
MAX_GRAPHS_PER_SIGNATURE = 4

#: the dtype a Python scalar is staged in on the card (``jax.jit`` traces a
#: Python float weak-typed as float32, an int as int32; torch's int is
#: int64, which indexes without a cast)
_SCALAR_DTYPES = {bool: "bool", int: "int64", float: "float32"}

#: per thread: the capture under way (see ``capture_scope``)
_LOCAL = threading.local()


def capture_scope() -> Optional[Dict[str, List]]:
    """The CUDA-graph capture under way on this thread, or None.  Code that
    ``fn`` runs keeps what the graph must own in it: ``"keep"`` holds
    tensors the captured kernels read or write beyond the call (they live
    as long as the graph), ``"on_replay"`` zero-argument callables each
    replay runs on the host after the graph (the launch counters of
    ``ops.cuda_histogram``: a replay launches what the capture recorded,
    and runs no Python)."""
    return getattr(_LOCAL, "scope", None)


#: one lock over every capture and replay of the process: the graphs share
#: one memory pool, where a graph captured later may reuse the memory an
#: earlier one's outputs sit in, so a replay and the copy-out of its
#: outputs must not interleave with another graph's replay
_GRAPH_LOCK = threading.RLock()
#: card -> [pool handle, live graphs holding it]
_POOLS: Dict[int, List] = {}
_POOL_LOCK = threading.Lock()
_SIDE_STREAMS: Dict[int, Any] = {}
#: card -> (stream, event) of the last replay: a replay on another stream
#: waits for it, so two graphs sharing the pool never run at once
_LAST_REPLAY: Dict[int, Tuple] = {}


def _graph_pool(index: int):
    """The memory pool every live captured graph on card ``index``
    allocates from (``torch.cuda.graph_pool_handle()``).  The allocator
    releases a pool once its last graph is gone and refuses its handle
    after that, so a card with no live graph gets a fresh handle."""
    import torch
    with _POOL_LOCK:
        ent = _POOLS.get(index)
        if ent is None:
            ent = _POOLS[index] = [torch.cuda.graph_pool_handle(), 0]
        return ent[0]


def _pool_held(index: int, handle, graph) -> None:
    """Count ``graph`` among the pool's holders until it is collected."""
    with _POOL_LOCK:
        ent = _POOLS.get(index)
        if ent is not None and ent[0] == handle:
            ent[1] += 1
    weakref.finalize(graph, _pool_released, index, handle, 1)


def _pool_released(index: int, handle, n: int) -> None:
    with _POOL_LOCK:
        ent = _POOLS.get(index)
        if ent is not None and ent[0] == handle:
            ent[1] -= n
            if ent[1] <= 0:
                del _POOLS[index]


def _abandon_capture(index: int, handle) -> None:
    """Undo what a failed capture left behind.  A capture that fails
    before ``capture_end`` stops its recording leaves the allocator
    recording into the pool and holding the use the capture took: end the
    recording and give the use back (when ``capture_end`` got as far as
    ending it, there is nothing to undo).  A pool whose capture failed
    with a CUDA error is refused by every later capture ("already
    recording"), so its handle is retired: the graphs that hold it keep
    it, later captures share a fresh one."""
    import torch
    try:
        torch._C._cuda_endAllocateToPool(index, handle)
    except RuntimeError:
        pass
    else:
        torch._C._cuda_releasePool(index, handle)
    with _POOL_LOCK:
        ent = _POOLS.get(index)
        if ent is not None and ent[0] == handle:
            del _POOLS[index]


def graph_pool_bytes(index: int = 0) -> Optional[int]:
    """Device bytes reserved by the shared graph pool of card ``index``
    (the segments ``torch.cuda.memory_snapshot()`` files under its pool
    id; a pool retired after a failed capture is not counted); ``None``
    when no captured graph is live on that card."""
    import torch
    with _POOL_LOCK:
        ent = _POOLS.get(index)
    if ent is None:
        return None
    want = tuple(ent[0])
    return sum(int(seg["total_size"])
               for seg in torch.cuda.memory_snapshot()
               if seg.get("device") == index
               and tuple(seg.get("segment_pool_id", ())) == want)


#: every captured-program wrapper of the process (``release_graphs``)
_PROGRAMS: "weakref.WeakSet" = weakref.WeakSet()


def release_graphs() -> int:
    """Drop the captured graphs of every program in the process, with the
    static inputs, outputs and pool memory they hold; returns how many.
    The compile booking stays: a later call of a dropped signature
    captures again, booked in ``recaptures``."""
    n = 0
    with _GRAPH_LOCK:
        for w in list(_PROGRAMS):
            n += sum(len(g) for g in w._graphs.values())
            w._graphs.clear()
    return n


def _tree_flatten(tree, leaves: List):
    """Leaves of a nest of dicts, lists, tuples and named tuples, in
    order, and a function that rebuilds the nest from a new leaf list."""
    if tree is None:
        return lambda it: None
    if isinstance(tree, dict):
        keys = sorted(tree)
        subs = [_tree_flatten(tree[k], leaves) for k in keys]
        return lambda it: {k: f(it) for k, f in zip(keys, subs)}
    if isinstance(tree, (list, tuple)):
        subs = [_tree_flatten(v, leaves) for v in tree]
        kind = type(tree)
        if hasattr(tree, "_fields"):
            return lambda it: kind(*(f(it) for f in subs))
        return lambda it: kind(f(it) for f in subs)
    leaves.append(tree)
    return lambda it: next(it)


def _is_array(leaf) -> bool:
    return hasattr(leaf, "shape") and hasattr(leaf, "dtype")


def _as_tensor(leaf):
    import torch
    if isinstance(leaf, torch.Tensor):
        return leaf
    return torch.from_numpy(__import__("numpy").ascontiguousarray(leaf))


def _is_scalar(leaf) -> bool:
    return type(leaf) in _SCALAR_DTYPES


def _card_index(leaves) -> Optional[int]:
    """The CUDA device of the call's tensors (None: a host call).  Leaves
    on two cards are refused: one graph runs on one card."""
    import torch
    cards = {l.device.index for l in leaves
             if isinstance(l, torch.Tensor) and l.device.type == "cuda"}
    if len(cards) > 1:
        raise ValueError(f"one captured call takes tensors of one card, "
                         f"got cuda:{sorted(cards)}")
    if not cards:
        return None
    (index,) = cards
    return index if index is not None else torch.cuda.current_device()


def _refs(leaves, donated) -> List:
    """Weak references to the tensors a graph reads in place."""
    return [weakref.ref(l) for l, d in zip(leaves, donated) if d]


def _addr(t) -> Tuple:
    return (t.data_ptr(), tuple(t.shape), tuple(t.stride()), str(t.dtype))


class _Graph:
    """One capture: the graph, its static inputs (``None`` where a leaf is
    donated or borrowed and read in place), how each output leaf comes
    back, what the capture's code kept for it (``capture_scope``) and weak
    references to the tensors it reads in place (a graph whose tensors
    are all gone is the first to be dropped)."""
    __slots__ = ("graph", "statics", "outs", "rebuild_out", "inference",
                 "scope", "refs")

    def __init__(self, graph, statics, outs, rebuild_out, inference, scope,
                 refs):
        self.graph, self.statics, self.outs = graph, statics, outs
        self.rebuild_out, self.inference = rebuild_out, inference
        self.scope, self.refs = scope, refs

    def alive(self) -> bool:
        return any(r() is not None for r in self.refs) or not self.refs


class InstrumentedJit(InstrumentedCall):
    """The reference's ``instrumented_jit``: :class:`InstrumentedCall`'s
    booking, and on a CUDA device a captured program per signature.

    **Capture** (a signature's first call whose tensors lie on a card):
    the tensor arguments are copied into static inputs on the card (host
    tensors and numpy arrays too: the copy is the one host -> device
    transfer, outside the graph), ``fn`` runs eagerly on them on a side
    stream (that call's answer, and the warm-up that makes cuBLAS handles
    and workspaces before the capture), then the same call is captured
    into a ``torch.cuda.CUDAGraph`` whose memory comes from one pool the
    process's graphs share.  The compile booking times both; the capture
    alone is ``snapshot()``'s ``capture_seconds``.  A capture that fails
    (a host sync inside ``fn``, a refused launch) raises ``RuntimeError``
    naming the function and the signature: no call on a card runs
    eagerly in its place; the pool it was recording into is retired, so
    later captures go on in a fresh one.

    **Replay**: the call's tensors are copied into the static inputs and
    the graph replays on the current stream (after the last replay on the
    card, when that ran on another stream).  A Python ``bool``, ``int``
    or ``float`` that is not a static argument is staged as a 0-d tensor
    (bool, int64, float32) among the static inputs, filled at each replay,
    and ``fn`` receives that tensor: the signature keys a scalar by its
    type, so a new value is not a new program (``jax.jit`` traces such a
    value weak-typed).  Any other Python value is refused on the card.

    **Donation** (``donate_argnums`` / ``donate_argnames``, the
    reference's): a donated argument is the graph's in-place state.  It
    is not copied: the graph reads and writes the caller's tensors at the
    addresses they had at capture, and ``fn`` must update them in place.
    A call whose donated tensors lie elsewhere (a rebuilt KV slab, another
    decoder's mask) is captured again for those addresses: booked in
    ``recaptures``, never as a compile, so ``compiles`` keeps the
    reference's meaning of one per signature.  Up to
    ``MAX_GRAPHS_PER_SIGNATURE`` captures are kept per signature; a new
    capture first drops the graphs whose in-place tensors are all gone,
    then the least recently replayed, so fits on several threads, each
    with its own state, do not evict one another while they run.

    **Borrowing** (``inplace_argnums`` / ``inplace_argnames``, the port's
    own): a borrowed argument is read in place as a donated one is, but
    ``fn`` does not write it.  A fit's fixed inputs (the bins, labels and
    weights, the staged tiles) are borrowed, so a replay copies none of
    them and no second copy lives on the card.

    **Outputs** never change under the caller: an output that is (a view
    of) a donated argument comes back as that view of the caller's tensor;
    every other output is copied out of the graph's pool at each replay,
    so each call's tensors are its own (``apply_batch`` keeps every
    chunk's output until the last; ``decode`` keeps every step's logits).

    A replay computes no gradients: ``fn`` must run under
    ``torch.inference_mode()`` or ``torch.no_grad()`` on the card (an
    output that requires grad refuses the capture).  Captures and replays
    of the process take one lock, as the pool's reuse across graphs
    requires.

    A tracing root of graft-lint's TRC rules (``analysis/checkers.py``):
    a host clock, RNG draw, lock or sync inside ``fn`` is frozen into the
    graph or refused by the capture."""

    def __init__(self, fn: Callable, **kwargs):
        super().__init__(fn, **kwargs)
        self._donate_nums, self._donate_names = set(), set()
        for kind in ("donate", "inplace"):
            nums = self.jit_kwargs.get(f"{kind}_argnums", ())
            self._donate_nums |= set(int(i) for i in (
                (nums,) if isinstance(nums, int) else nums or ()))
            names = self.jit_kwargs.get(f"{kind}_argnames", ())
            names = (names,) if isinstance(names, str) else names or ()
            self._donate_nums |= {self._params.index(n) for n in names
                                  if n in self._params}
            self._donate_names |= set(names)
        #: signature -> {donated addresses: _Graph}, LRU-ordered
        self._graphs: Dict[Tuple, collections.OrderedDict] = {}
        self.captures = 0
        self.recaptures = 0
        self.replays = 0
        _PROGRAMS.add(self)

    def _run(self, sig, args, kwargs):
        leaves: List = []
        donated: List[bool] = []
        kw_keys = sorted(kwargs)
        parts = [(i in self._static_nums, i in self._donate_nums, a)
                 for i, a in enumerate(args)]
        parts += [(k in self._static_names, k in self._donate_names,
                   kwargs[k]) for k in kw_keys]
        rebuilds = []
        for static, don, a in parts:
            if static:
                rebuilds.append(a)
                continue
            n0 = len(leaves)
            rebuilds.append(_tree_flatten(a, leaves))
            donated += [don] * (len(leaves) - n0)
        index = _card_index(leaves)
        if index is None:
            return super()._run(sig, args, kwargs)
        for leaf in leaves:
            if not (_is_array(leaf) or _is_scalar(leaf)):
                raise TypeError(
                    f"{self.name}: a captured call takes tensors and Python "
                    f"scalars; the Python value {leaf!r} would be frozen "
                    "into the graph (pass it as a static argument)")
        key = tuple(_addr(l) for l, d in zip(leaves, donated) if d)

        def call(call_leaves):
            it = iter(call_leaves)
            vals = [a if static else rb(it)
                    for (static, _, a), rb in zip(parts, rebuilds)]
            return self._fn(*vals[:len(args)],
                            **dict(zip(kw_keys, vals[len(args):])))

        with _GRAPH_LOCK:
            graphs = self._graphs.get(sig)
            entry = graphs.get(key) if graphs is not None else None
            if entry is None:
                return self._capture(sig, len(args), index, call, leaves,
                                     donated, key)
            graphs.move_to_end(key)
            if entry.refs:
                entry.refs = _refs(leaves, donated)
            self.replays += 1
            return self._replay(entry, leaves, index)

    def _capture(self, sig, n_pos, index, call, leaves, donated, key):
        import torch
        t0 = time.perf_counter()
        dev = torch.device("cuda", index)
        inference = torch.is_inference_mode_enabled()
        current = torch.cuda.current_stream(dev)
        side = _SIDE_STREAMS.get(index)
        if side is None:
            side = _SIDE_STREAMS[index] = torch.cuda.Stream(dev)
        statics, call_leaves = [], []
        for leaf, don in zip(leaves, donated):
            if don:
                if not (isinstance(leaf, torch.Tensor)
                        and leaf.device == dev):
                    raise TypeError(f"{self.name}: a donated or borrowed "
                                    f"argument must be a tensor on {dev}")
                statics.append(None)
                call_leaves.append(leaf)
                continue
            if _is_scalar(leaf):
                st = torch.full((), leaf, device=dev, dtype=getattr(
                    torch, _SCALAR_DTYPES[type(leaf)]))
            else:
                src = _as_tensor(leaf)
                st = torch.empty_like(src, device=dev)
                st.copy_(src, non_blocking=True)
            statics.append(st)
            call_leaves.append(st)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            first = call(call_leaves)
        current.wait_stream(side)
        firsts: List = []
        _tree_flatten(first, firsts)
        if any(isinstance(o, torch.Tensor) and o.requires_grad
               for o in firsts):
            raise RuntimeError(
                f"{self.name} [{self._render(sig, n_pos)}]: a CUDA graph "
                "replays no autograd; call it under torch.inference_mode()"
                " or torch.no_grad()")
        graph = torch.cuda.CUDAGraph()
        t_cap = time.perf_counter()
        # the warm-up's frees settle before the pool starts taking blocks.
        # The cyclic collector waits until the capture ends, so no dead
        # object of the process is finalized inside it: a finalizer's CUDA
        # calls (freeing pinned host memory queries CUDA events) are not
        # allowed while the thread captures, and their errors invalidate
        # the capture
        torch.cuda.synchronize(dev)
        err = out = None
        pool = _graph_pool(index)
        scope: Dict[str, List] = {"keep": [], "on_replay": []}
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.stream(side):
                try:
                    graph.capture_begin(pool=pool,
                                        capture_error_mode="thread_local")
                except Exception as exc:  # noqa: BLE001 — re-raised below
                    err = exc
                else:
                    _LOCAL.scope = scope
                    try:
                        out = call(call_leaves)
                    except Exception as exc:  # noqa: BLE001 — re-raised
                        err = exc
                    finally:
                        _LOCAL.scope = None
                    try:
                        graph.capture_end()
                    except Exception as exc:  # noqa: BLE001 — re-raised
                        err = err or exc
        finally:
            if collecting:
                gc.enable()
        if err is not None:
            del graph
            _abandon_capture(index, pool)
            free, total = torch.cuda.mem_get_info(dev)
            raise RuntimeError(
                f"CUDA-graph capture of {self.name} "
                f"[{self._render(sig, n_pos)}] failed: {err} (card "
                f"{free / 2**30:.1f} of {total / 2**30:.1f} GiB free, "
                f"{torch.cuda.memory_reserved(dev) / 2**30:.1f} GiB "
                "reserved)") from err
        capture_s = time.perf_counter() - t_cap
        _pool_held(index, pool, graph)
        outs: List = []
        rebuild_out = _tree_flatten(out, outs)
        donated_at = {l.untyped_storage().data_ptr(): i
                      for i, (l, d) in enumerate(zip(leaves, donated)) if d}
        static_ptrs = {s.untyped_storage().data_ptr()
                       for s in statics if s is not None}
        specs = []
        for o in outs:
            if not isinstance(o, torch.Tensor):
                specs.append(("value", o))
                continue
            ptr = o.untyped_storage().data_ptr()
            if ptr in donated_at:
                specs.append(("donated", donated_at[ptr], tuple(o.shape),
                              tuple(o.stride()), o.storage_offset()))
            else:
                specs.append(("static", o))
        entry = _Graph(graph, statics, specs, rebuild_out, inference, scope,
                       _refs(leaves, donated))
        graphs = self._graphs.get(sig)
        if graphs is None:
            graphs = self._graphs[sig] = collections.OrderedDict()
        for k in [k for k, g in graphs.items() if not g.alive()]:
            del graphs[k]
        if sig in self._entries:
            self.recaptures += 1
        graphs[key] = entry
        while len(graphs) > MAX_GRAPHS_PER_SIGNATURE:
            graphs.popitem(last=False)
        self.captures += 1
        if sig in self._entries:
            with self._lock:
                self._entries[sig].capture_s = capture_s
        else:
            self._book_new(sig, n_pos, time.perf_counter() - t0,
                           capture_s)
        # the first call's answer: outputs that alias a static input are
        # the graph's to overwrite, so they are copied
        fixed = [o.clone() if isinstance(o, torch.Tensor)
                 and o.untyped_storage().data_ptr() in static_ptrs else o
                 for o in firsts]
        return _tree_flatten(first, [])(iter(fixed))

    def _replay(self, entry: _Graph, leaves, index: int):
        import torch
        ctx = torch.inference_mode() if entry.inference else \
            torch.no_grad()
        with ctx:
            cur = torch.cuda.current_stream(index)
            last = _LAST_REPLAY.get(index)
            if last is not None and last[0] != cur:
                cur.wait_event(last[1])
            for st, leaf in zip(entry.statics, leaves):
                if st is None or leaf is st:
                    continue
                if _is_scalar(leaf):
                    st.fill_(leaf)
                else:
                    st.copy_(_as_tensor(leaf), non_blocking=True)
            entry.graph.replay()
            for hook in entry.scope["on_replay"]:
                hook()
            if last is None or last[0] != cur:
                last = _LAST_REPLAY[index] = (cur, torch.cuda.Event())
            last[1].record(cur)
            outs = []
            for spec in entry.outs:
                if spec[0] == "static":
                    outs.append(spec[1].clone())
                elif spec[0] == "donated":
                    _, i, shape, stride, offset = spec
                    outs.append(leaves[i].as_strided(shape, stride, offset))
                else:
                    outs.append(spec[1])
        return entry.rebuild_out(iter(outs))

    def _snapshot_extra(self) -> Dict[str, Any]:
        with self._lock:
            capture = [e.capture_s for e in self._entries.values()]
        return {"captures": self.captures, "recaptures": self.recaptures,
                "replays": self.replays,
                "capture_seconds": [None if c is None else round(c, 6)
                                    for c in capture]}


def instrumented_call(fn: Optional[Callable] = None, *,
                      name: Optional[str] = None,
                      registry: Optional[MetricsRegistry] = None,
                      storm_signatures: Optional[int] = None,
                      static_argnums=(), static_argnames=(), **jit_kwargs):
    """:class:`InstrumentedCall` as :func:`instrumented_jit` builds its
    wrapper: ``instrumented_call(fn, name=...)`` or
    ``@instrumented_call(name=...)``."""
    if fn is None:
        return functools.partial(
            instrumented_call, name=name, registry=registry,
            storm_signatures=storm_signatures, static_argnums=static_argnums,
            static_argnames=static_argnames, **jit_kwargs)
    return InstrumentedCall(fn, name=name, registry=registry,
                            storm_signatures=storm_signatures,
                            static_argnums=static_argnums,
                            static_argnames=static_argnames, **jit_kwargs)


def instrumented_jit(fn: Optional[Callable] = None, *,
                     name: Optional[str] = None,
                     registry: Optional[MetricsRegistry] = None,
                     storm_signatures: Optional[int] = None,
                     static_argnums=(), static_argnames=(), **jit_kwargs):
    """The reference's ``instrumented_jit``: ``instrumented_jit(fn,
    name=...)`` or ``@instrumented_jit(name=...)``.  See
    :class:`InstrumentedJit`."""
    if fn is None:
        return functools.partial(
            instrumented_jit, name=name, registry=registry,
            storm_signatures=storm_signatures, static_argnums=static_argnums,
            static_argnames=static_argnames, **jit_kwargs)
    return InstrumentedJit(fn, name=name, registry=registry,
                           storm_signatures=storm_signatures,
                           static_argnums=static_argnums,
                           static_argnames=static_argnames, **jit_kwargs)


def captured(fn: Optional[Callable] = None, *, name: Optional[str] = None,
             **jit_kwargs):
    """The twin of a plain ``jax.jit``: :class:`InstrumentedJit`'s capture
    and replay (one graph per signature in the shared pool, donated and
    borrowed tensors read in place, Python scalars staged, outputs copied
    out, a failed capture raising ``RuntimeError``; ``captures``,
    ``recaptures`` and ``replays`` on the object) with nothing booked and
    nothing registered: ``captured(fn, name=...)`` or
    ``@captured(name=...)``.  On the CPU ``fn`` runs eagerly.  ``name``
    only labels errors and the object."""
    if fn is None:
        return functools.partial(captured, name=name, **jit_kwargs)
    return InstrumentedJit(fn, name=name, booked=False, **jit_kwargs)


def compile_report(registry: Optional[MetricsRegistry] = None
                   ) -> Dict[str, Any]:
    """Aggregated per-function compile state — ``GET /debug/compile``, in
    the reference's shape.  Entries come from the :class:`InstrumentedJit`
    wrappers registered in the registry's ``_jit_wrappers`` table; wrappers
    sharing a ``name`` merge into one entry."""
    reg = registry if registry is not None else get_registry()
    table: Dict[str, Any] = getattr(reg, "_jit_wrappers", {})
    functions: Dict[str, Any] = {}
    for name in sorted(table):
        snaps = [w.snapshot() for w in list(table[name])]
        if not snaps:
            continue
        functions[name] = {
            "compiles": sum(s["compiles"] for s in snaps),
            "storm_threshold": min(s["storm_threshold"] for s in snaps),
            "storm_tripped": any(s["storm_tripped"] for s in snaps),
            "signatures": [sig for s in snaps for sig in s["signatures"]],
            "last_cost_analysis": next(
                (s["last_cost_analysis"] for s in reversed(snaps)
                 if s["last_cost_analysis"] is not None), None),
        }
    return {"functions": functions,
            "storm_threshold_default": _storm_threshold()}


# ---------------------------------------------------------------------------
# device-memory gauges
# ---------------------------------------------------------------------------

def _mem_stat(index: int, key: str) -> float:
    import torch
    stats = torch.cuda.memory_stats(index)
    return float(stats.get(key, float("nan")))


def ensure_device_memory_gauges(registry: Optional[MetricsRegistry] = None,
                                devices=None) -> bool:
    """Register per-card callback gauges sampled from
    ``torch.cuda.memory_stats`` at scrape time:

    - ``mmlspark_device_bytes_in_use{device}``
    - ``mmlspark_device_peak_bytes_in_use{device}``

    ``devices`` is an iterable of CUDA device indices (default: every
    visible card).  Idempotent per registry.  Without a card nothing
    registers.  Returns True when the gauges are live."""
    reg = registry if registry is not None else get_registry()
    state = getattr(reg, "_device_mem_gauges", None)
    if state:
        return True
    if state is False and devices is None:
        return False
    if devices is None:
        try:
            import torch
            if not torch.cuda.is_available():
                reg._device_mem_gauges = False
                return False
            devices = range(torch.cuda.device_count())
        except Exception:  # noqa: BLE001 — runtime unreachable: no
            return False   # verdict cached, retried next call
    live = [int(d) for d in devices]
    if not live:
        reg._device_mem_gauges = False
        return False
    g_use = reg.gauge("mmlspark_device_bytes_in_use",
                      "live allocated bytes per local device (sampled from "
                      "memory_stats at scrape time)", labels=("device",))
    g_peak = reg.gauge("mmlspark_device_peak_bytes_in_use",
                       "high-water allocated bytes per local device",
                       labels=("device",))
    for d in live:
        label = f"cuda:{d}"
        g_use.set_function(functools.partial(
            _mem_stat, d, "allocated_bytes.all.current"), device=label)
        g_peak.set_function(functools.partial(
            _mem_stat, d, "allocated_bytes.all.peak"), device=label)
    reg._device_mem_gauges = True
    return True


# ---------------------------------------------------------------------------
# host->device transfer accounting
# ---------------------------------------------------------------------------

def _leaves(x):
    """The leaves of a nest of dicts, lists and tuples, in the order
    ``jax.tree_util`` flattens them (dict keys sorted); ``None`` is an
    empty nest."""
    if x is None:
        return
    if isinstance(x, dict):
        for k in sorted(x):
            yield from _leaves(x[k])
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _leaves(v)
    else:
        yield x


def transfer_nbytes(x) -> int:
    """Total buffer bytes in a nest of tensors and numpy arrays (what a
    device_put will move or, for already-resident tensors, re-place)."""
    return sum(int(getattr(leaf, "nbytes", 0)) for leaf in _leaves(x))


def _transfer_child(site: str, reg: MetricsRegistry):
    cache = getattr(reg, "_transfer_children", None)
    if cache is None:
        cache = reg._transfer_children = {}
    child = cache.get(site)
    if child is None:
        child = cache[site] = reg.counter(
            "mmlspark_device_transfer_bytes_total",
            "bytes offered to device_put by call site (host->device feed; "
            "already-resident arrays count as placement)",
            labels=("site",)).labels(site=site)
    return child


def _place(x, device, non_blocking: bool):
    import torch
    if x is None:
        return None
    if isinstance(x, dict):
        return {k: _place(v, device, non_blocking) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_place(v, device, non_blocking) for v in x)
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(x)
    return x.to(device, non_blocking=non_blocking)


def device_put(x, device=None, *, site: str = "unlabeled",
               registry: Optional[MetricsRegistry] = None,
               non_blocking: bool = False):
    """The port's ``jax.device_put``: books
    ``mmlspark_device_transfer_bytes_total{site}`` before the transfer,
    then moves every leaf of the nest to ``device`` (``None``: the card)
    with ``.to(device, non_blocking=...)``; numpy leaves become tensors.
    The byte count is computed on the host from the input leaves, so the
    booking adds no device sync."""
    from .._device import resolve_device
    dev = resolve_device(device)
    reg = registry if registry is not None else get_registry()
    _transfer_child(site, reg).inc(transfer_nbytes(x))
    return _place(x, dev, non_blocking)


# ---------------------------------------------------------------------------
# build info
# ---------------------------------------------------------------------------

def ensure_build_info(registry: Optional[MetricsRegistry] = None) -> bool:
    """Register the ``mmlspark_build_info`` gauge (constant 1) labelled with
    the torch version, the CUDA version torch was built with (``"none"``
    on a CPU build), the backend, the device kind and the local device
    count.  Idempotent per registry."""
    reg = registry if registry is not None else get_registry()
    state = getattr(reg, "_build_info_done", None)
    if state is not None:
        return state
    try:
        import torch
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        kind = torch.cuda.get_device_name(0) if n else "cpu"
        reg.gauge("mmlspark_build_info",
                  "constant 1; labels identify the compute environment",
                  labels=("torch", "cuda", "backend", "device_kind",
                          "device_count")
                  ).set(1.0, torch=torch.__version__,
                        cuda=str(torch.version.cuda or "none"),
                        backend="cuda" if n else "cpu", device_kind=kind,
                        device_count=str(n))
    except Exception:  # noqa: BLE001 — runtime unreachable: skip quietly
        reg._build_info_done = False
        return False
    reg._build_info_done = True
    return True
