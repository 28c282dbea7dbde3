"""Model runner — the port of ``mmlspark_tpu/models/runner.py``: the batch
front (``bucket_rows``, ``_pad_rows``, ``ModelRunner.apply_batch``) and the
static batched decode (``PagePool``, ``DecodeResult``,
``ModelRunner.decode`` in its dense and paged cache layouts).

One object takes an in-tree model (``models.resnet``,
``models.transformer``, ``models.bilstm``), an ONNX import
(``dl/onnx_import.py``) or any ``apply_fn(state, batch)`` callable, places
it on its device once, and scores stacked host batches of any row count:
chunk to ``batch_size``, pad each chunk to its power-of-two latency bucket
(a 1-row request pads to 1, not ``batch_size``), run, unpad, concatenate.
There is no jit: PyTorch runs eagerly, so a bucket is an eager call under
``torch.inference_mode()``, and the buckets keep the reference's padding
(and with it its outputs) rather than a compile cache.  The batch counters
(``mmlspark_runner_batches_total``, ``_rows_total``, ``_pad_rows_total``)
book into the port's registry under the reference's names.

``decode`` is the reference's cold path: power-of-two batch and prompt
buckets, ragged ``lengths`` (each sequence writes and reads the cache at
its own frontier), pad rows born finished, ``eos_id`` freezing, greedy
sampling on the device (one ``(B,)`` token fetch per step) or a host
``sample_fn`` / ``collect_logits``.  ``kv_layout="paged"`` allocates
fixed-size pages from a shared ``PagePool`` by true length, extends at
page boundaries, frees on eos, and turns a budgeted pool's mid-decode
exhaustion into a partial result (``denied_rows`` / ``denied_at``).  Each
step is one eager forward of the model with the cache updated in place
(the analogue of the reference's donated buffers); the decode counters
and the page pool's gauges keep the reference's names.

Not ported (each raises ``NotImplementedError`` naming ROADMAP.md §1 item
9, the decode/serving engine): ``prefix_cache=True`` and ``watchdog=`` on
``decode``, ``decode_stream``, ``ContinuousDecoder``, ``StreamHandle``,
``ShedReply``, the prefix cache and ``scorer``.  The decode's span and the
useful/wasted token ledger wait for the port's observability (item 13);
``DecodeResult.extras`` carries the ledger's numbers all the same.
"""
from __future__ import annotations

import copy
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from ..utils.concurrency import make_condition, make_lock

__all__ = ["ModelRunner", "DecodeResult", "PagePool", "ContinuousDecoder",
           "StreamHandle", "PagePoolExhausted", "SlotsExhausted", "ShedReply",
           "bucket_rows"]

#: fronts a batch can arrive through; metric label values
FRONTS = ("transform", "serving", "decode")

_NOT_PORTED = ("the serving and continuous-decode side of models/runner.py "
               "(decode_stream, ContinuousDecoder, the prefix cache, the "
               "stall watchdog, scorer) is not ported yet (ROADMAP.md §1 "
               "item 9, the decode/serving engine)")


def _not_ported(*_args, **_kwargs):
    raise NotImplementedError(_NOT_PORTED)


class _NotPorted:
    """A reference name of the serving/continuous engine: raises on use."""

    def __init__(self, *args, **kwargs):
        _not_ported()


class ContinuousDecoder(_NotPorted):
    pass


class StreamHandle(_NotPorted):
    pass


class ShedReply(_NotPorted):
    pass


class PagePoolExhausted(RuntimeError):
    """The page pool cannot cover an allocation — admission control, not a
    crash.  ``shed`` duck-types the serving layer's shed path."""
    shed = True


class SlotsExhausted(RuntimeError):
    """Reference admission-control error of continuous decode (not
    ported)."""
    shed = True


def bucket_rows(m: int, batch_size: int) -> int:
    """Power-of-two latency bucket for an ``m``-row chunk: a 1-row serving
    request pads to 1, not ``batch_size``; full chunks use ``batch_size``
    itself."""
    if m >= batch_size:
        return batch_size
    return min(batch_size, 1 << (max(1, m) - 1).bit_length())


def _pad_rows(x: np.ndarray, target: int) -> np.ndarray:
    """Pad the leading dim to ``target`` by repeating the last row (cheap,
    and keeps the padded rows numerically tame for any model)."""
    m = x.shape[0]
    if m == target:
        return x
    pad = np.repeat(x[-1:], target - m, axis=0)
    return np.concatenate([x, pad], axis=0)


def _on_device(module: torch.nn.Module, dev: torch.device
               ) -> torch.nn.Module:
    """``module`` if all its tensors lie on ``dev``, else a copy moved
    there (the caller's module stays where it was)."""
    tensors = list(module.parameters()) + list(module.buffers())
    if all(t.device == dev for t in tensors):
        return module
    return copy.deepcopy(module).to(dev)


def _greedy_freeze(logits: torch.Tensor, finished: torch.Tensor,
                   eos_id: Optional[int]):
    """On-device greedy sampling + eos freeze — the ONE copy of the rule
    shared by the decode step and the prefill sampler: frozen sequences
    keep emitting ``eos_id``, and emitting it freezes.  ``argmax`` takes
    the first maximum, as ``jnp.argmax`` does."""
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    if eos_id is not None:
        tok = torch.where(finished, torch.full_like(tok, eos_id), tok)
        finished = finished | (tok == eos_id)
    return tok, finished


def _cached_apply(module, toks, positions, table, cache):
    """One call shape for every decode forward: ``table`` is ``None`` on
    the dense layout, and the kwarg is withheld so modules that only know
    ``init_cache`` keep working."""
    kw = {} if table is None else {"page_table": table}
    return module(toks, positions=positions, kv_cache=cache, **kw)


def _nbytes(cache) -> int:
    return sum(t.numel() * t.element_size() for pair in cache for t in pair)


@dataclass
class DecodeResult:
    """One batched decode: ``tokens[b, t]`` is the t-th generated token of
    sequence b; ``logits`` (collect_logits=True) holds the distribution
    that produced each token; ``steps`` counts step forwards (prefill
    excluded); ``lengths`` echoes the prompt lengths the loop honoured;
    ``extras`` surfaces the resolved cache geometry — kv_layout,
    real_tokens (unfrozen steps only), cache_bytes_per_seq, and for the
    paged layout page_size / table_width / pages_peak /
    page_occupancy_pct."""
    tokens: np.ndarray                 # (B, T) int32
    lengths: np.ndarray                # (B,) prompt lengths
    steps: int
    logits: Optional[np.ndarray] = None  # (B, T, V) float32
    extras: Optional[Dict[str, Any]] = None


class PagePool:
    """Fixed-size KV-cache page allocator — the shared device memory behind
    ``ModelRunner.decode(kv_layout="paged")``.

    The pool owns ``num_pages`` pages of ``page_size`` token slots each,
    held on the device as ``module.init_paged_cache`` slabs of
    ``(num_pages, page_size, heads, head_dim)`` per layer, plus the host
    free list that hands pages to sequences: allocate by TRUE prompt
    length at prefill, extend one page at a time when a decode frontier
    crosses a page boundary, free on eos/completion.  Page 0 is the
    reserved trash page (pad rows and unallocated table entries point
    there; it is never handed out), so ``capacity == num_pages - 1``.

    The slabs are BORROWED by one decode loop at a time (the loop updates
    them in place, so two concurrent borrowers would write over each
    other); :meth:`borrow_cache` blocks until the previous borrower
    returns.  The accounting half (allocate/extend/pin/free/occupancy) is
    lock-protected and usable standalone, without a module.
    """

    #: booking ops — each books pages moved, not call count ("denied"
    #: books pages REFUSED: the admission-control outcome); "pin" books
    #: refcount increments on shared pages, "cow" the reference's
    #: copy-on-write splits (its prefix cache, not ported)
    OPS = ("allocate", "extend", "free", "denied", "pin", "cow")

    def __init__(self, module=None, num_pages: int = 0, page_size: int = 64,
                 *, name: str = "pool", registry=None,
                 clock: Callable[[], float] = time.monotonic):
        if num_pages < 2:
            raise ValueError(f"num_pages {num_pages} < 2: page 0 is the "
                             "reserved trash page, so a usable pool needs "
                             "at least one allocatable page")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.module = module
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self._name = name
        #: free physical pages; page 0 (trash) is never in this list
        self._free = list(range(self.num_pages - 1, 0, -1))
        #: per-page refcounts: a page is in ``_free`` with no entry here,
        #: or held with refcount >= 1; ``free()`` returns it at zero
        self._ref: Dict[int, int] = {}
        self._cond = make_condition("PagePool._cond")
        self._cache = None          # built lazily, rebuilt if dropped
        self._cache_nbytes = 0
        self._borrowed = False
        self.high_water = 0
        #: True when the owning runner sized this pool implicitly (from a
        #: decode's worst case) — such pools may be grown for a larger
        #: batch; an explicitly budgeted pool is never resized behind the
        #: caller's back
        self.auto_sized = False
        from ..observability.metrics import get_registry
        reg = registry if registry is not None else get_registry()
        self._registry = reg
        # page_size is in the label set because one runner keeps a pool
        # PER page size
        ops = reg.counter(
            "mmlspark_runner_page_ops_total",
            "KV page-pool pages moved by op (allocate/extend/free)",
            labels=("runner", "page_size", "op"))
        self._c_ops = {op: ops.labels(runner=name,
                                      page_size=str(self.page_size), op=op)
                       for op in self.OPS}
        self._g_used = reg.gauge(
            "mmlspark_runner_page_pool_used_pages",
            "KV pages currently held by live sequences",
            labels=("runner", "page_size"))
        self._g_hw = reg.gauge(
            "mmlspark_runner_page_pool_high_water_pages",
            "max KV pages ever simultaneously held",
            labels=("runner", "page_size"))
        # page-seconds integral: pages held x wall time, integrated
        # exactly at the alloc/extend/free edges
        self._clock = clock
        self._page_seconds = 0.0
        self._t_integral = self._clock()
        self._c_pagesec = reg.counter(
            "mmlspark_runner_page_seconds_total",
            "KV page-seconds consumed (pages held x wall time, integrated "
            "at pool-op edges)", labels=("runner", "page_size")).labels(
                runner=name, page_size=str(self.page_size))
        self._book("allocate", 0)   # gauges live from construction

    # ---------------------------------------------------------- accounting
    @property
    def capacity(self) -> int:
        """Allocatable pages (the trash page is not allocatable)."""
        return self.num_pages - 1

    def token_capacity(self) -> int:
        """Total token slots the pool can hold across all sequences."""
        return self.capacity * self.page_size

    def pages_in_use(self) -> int:
        return self.capacity - len(self._free)

    def occupancy_pct(self) -> float:
        return 100.0 * self.pages_in_use() / max(self.capacity, 1)

    def _integrate_locked(self) -> None:
        """Advance the page-seconds integral to now (under the pool lock,
        BEFORE the free-list mutation)."""
        now = self._clock()
        delta = self.pages_in_use() * max(0.0, now - self._t_integral)
        self._t_integral = now
        if delta > 0:
            self._page_seconds += delta
            self._c_pagesec.inc(delta)

    def page_seconds(self) -> float:
        """Cumulative pages-held x wall-time integral, current to now."""
        with self._cond:
            self._integrate_locked()
            return self._page_seconds

    def _book(self, op: str, n: int) -> None:
        """Book one pool operation: the op counter plus the occupancy and
        high-water gauges (called under the pool lock)."""
        used = self.pages_in_use()
        if used > self.high_water:
            self.high_water = used
        self._c_ops[op].inc(n)
        ps = str(self.page_size)
        self._g_used.set(float(used), runner=self._name, page_size=ps)
        self._g_hw.set(float(self.high_water), runner=self._name,
                       page_size=ps)

    def allocate(self, n: int, op: str = "allocate",
                 shared=None) -> List[int]:
        """Hand out ``n`` fresh pages (prefill sizing: ``ceil(true_len /
        page_size)`` per sequence).  ``shared`` names already-resident
        pages to PIN instead of copy — each gains a refcount and rides
        ahead of the fresh pages in the returned list.  Atomic: a refused
        allocation pins nothing.  Raises :class:`PagePoolExhausted` when
        the budget is exhausted — admission control, not overcommit."""
        shared = [int(p) for p in shared] if shared else []
        with self._cond:
            self._integrate_locked()
            if n > len(self._free):
                # book the refusal before raising: the denied outcome is
                # the admission-control signal dashboards alert on
                self._book("denied", n)
                raise PagePoolExhausted(
                    f"page pool exhausted: need {n} page(s), "
                    f"{len(self._free)} free of {self.capacity} "
                    f"(page_size={self.page_size}) — free finished "
                    "sequences, shrink the batch, or size the pool larger")
            if shared:
                self._pin_locked(shared)
            pages = [self._free.pop() for _ in range(n)]
            for p in pages:
                self._ref[p] = 1
            self._book(op, n)
            return shared + pages

    def extend(self, n: int = 1) -> List[int]:
        """Allocate at a decode page-boundary crossing (same free list,
        booked as ``op="extend"`` so growth is attributable)."""
        return self.allocate(n, op="extend")

    def _pin_locked(self, pages) -> None:
        for p in pages:
            r = self._ref.get(p)
            if r is None:
                raise ValueError(f"pin of page {p} which is not allocated")
            self._ref[p] = r + 1
        self._book("pin", len(pages))

    def pin(self, pages) -> None:
        """Add a reference to already-resident pages: ``free()`` from any
        one holder then drops only that holder's reference."""
        pages = [int(p) for p in pages]
        with self._cond:
            self._integrate_locked()
            self._pin_locked(pages)

    def refcount(self, page: int) -> int:
        """Current reference count of ``page`` (0 when free)."""
        with self._cond:
            return self._ref.get(int(page), 0)

    def shortfall(self, n: int) -> int:
        """Free-list deficit for an ``n``-page allocation (0 when it would
        succeed) — no booking, no side effects."""
        with self._cond:
            return max(0, int(n) - len(self._free))

    def free(self, pages) -> None:
        """Drop one reference per page (eos/completion); a page returns to
        the free list only at refcount zero.  Freed pages are not zeroed:
        stale k/v in a reused page sits past the new owner's frontier until
        overwritten, so it is never admissible."""
        pages = [int(p) for p in pages]
        if any(p <= 0 or p >= self.num_pages for p in pages):
            raise ValueError(f"free() of invalid page in {pages} "
                             "(page 0 is the reserved trash page)")
        with self._cond:
            self._integrate_locked()
            for p in pages:
                r = self._ref.get(p)
                if r is None:
                    raise ValueError(f"double free of page {p}")
                if r > 1:
                    self._ref[p] = r - 1
                else:
                    del self._ref[p]
                    self._free.append(p)
            self._book("free", len(pages))

    # ------------------------------------------------------- device slabs
    def page_nbytes(self) -> int:
        """Device bytes per page across all layers (0 until slabs built)."""
        return self._cache_nbytes // self.num_pages if self._cache_nbytes \
            else 0

    def borrow_cache(self):
        """Take exclusive ownership of the device slabs (building them on
        the module's device at first use), blocking while another decode
        holds them."""
        if self.module is None:
            raise TypeError("this PagePool was built without a module — "
                            "accounting only, no device slabs")
        with self._cond:
            while self._borrowed:
                self._cond.wait()
            self._borrowed = True
            cache = self._cache
            self._cache = None
        if cache is None:
            try:
                cache = self.module.init_paged_cache(self.num_pages,
                                                     self.page_size)
                self._cache_nbytes = _nbytes(cache)
            except Exception:
                # a failed slab build (device memory exhausted) must not
                # leave the pool borrowed forever
                self.return_cache(None)
                raise
        return cache

    def resized(self, num_pages: int) -> "PagePool":
        """A fresh pool with the same module/page size/metric identity but
        ``num_pages`` pages.  Refuses while sequences hold pages or a
        decode holds the slabs — resizing would orphan them."""
        with self._cond:
            if self._borrowed or self.pages_in_use():
                raise RuntimeError(
                    f"cannot resize a busy page pool ({self.pages_in_use()} "
                    "page(s) held, borrowed="
                    f"{self._borrowed}) — wait for in-flight decodes")
        pool = PagePool(self.module, num_pages, self.page_size,
                        name=self._name, registry=self._registry,
                        clock=self._clock)
        pool.auto_sized = self.auto_sized
        return pool

    def return_cache(self, cache) -> None:
        """Give the slabs back (pass ``None`` after a failed loop — the
        slabs' state is unknown, so the next borrower rebuilds)."""
        with self._cond:
            self._borrowed = False
            self._cache = cache
            self._cond.notify()


class ModelRunner:
    """Device placement + the batch front.

    Accepts any of:

    - ``payload`` — an object exposing ``module`` / ``apply_fn`` /
      ``variables`` / ``apply_kwargs``: ``dl.FlaxModelPayload``,
      ``dl.OnnxModelPayload``;
    - ``module=`` — an ``nn.Module`` holding its weights; ``apply_kwargs``
      forward to its ``forward`` (an ``apply_fn`` takes none, as in the
      reference);
    - ``apply_fn=`` + ``variables=`` — a ``(state, batch)`` callable and its
      state (a dict of arrays or tensors, moved to the device once).

    ``name`` labels every metric series this runner books — keep it
    low-cardinality (a model family, not a uid).  ``device``: ``None`` is
    the card (an error without one), ``"cpu"`` the host.

    ``phase_s`` accumulates where ``apply_batch`` spends its time:
    ``h2d`` (host batch -> device), ``device`` (the model), ``d2h``
    (outputs back), from CUDA events on the card and the host clock on
    the CPU; ``stack`` is booked by the callers that stack rows into the
    host batch (``dl.JaxModel``, ``dl.ImageFeaturizer``).

    ``decode`` books ``mmlspark_runner_decode_steps_total``,
    ``_decode_tokens_total`` and ``_decode_phase_seconds`` (``dispatch``
    every step; ``device``, a synchronize every ``device_time_every``
    steps on the card, 0 disables it).
    """

    #: sampled synchronize cadence of the decode's dispatch/device split
    DEVICE_TIME_EVERY_DEFAULT = 32

    def __init__(self, payload=None, *, module=None, variables=None,
                 apply_fn: Optional[Callable] = None,
                 apply_kwargs: Optional[Dict[str, Any]] = None,
                 name: str = "model", batch_size: int = 64,
                 registry=None, device: DeviceLike = None,
                 device_time_every: Optional[int] = None):
        if payload is not None:
            module = getattr(payload, "module", None)
            apply_fn = getattr(payload, "apply_fn", None)
            variables = payload.variables
            apply_kwargs = getattr(payload, "apply_kwargs", None)
        if apply_fn is None and module is None:
            raise ValueError("need a payload, a module, or an apply_fn")
        self.device = resolve_device(device)
        self.apply_kwargs = dict(apply_kwargs or {})
        self.module: Optional[torch.nn.Module] = None
        self.state: Dict[str, torch.Tensor] = {}
        if apply_fn is not None:
            self._apply_fn = apply_fn
            self.state = {k: (v if isinstance(v, torch.Tensor) else
                              torch.from_numpy(np.array(v))).to(self.device)
                          for k, v in (variables or {}).items()}
        else:
            self.module = _on_device(module, self.device).eval()
        self.name = name
        self.batch_size = int(batch_size)
        #: bucket rows -> eager calls made at that bucket
        self.bucket_calls: Dict[int, int] = {}
        self.phase_s = {"stack": 0.0, "h2d": 0.0, "device": 0.0, "d2h": 0.0}
        from ..observability.metrics import get_registry
        self.registry = registry if registry is not None else get_registry()
        reg = self.registry
        c_batches = reg.counter(
            "mmlspark_runner_batches_total",
            "device dispatches per runner by front",
            labels=("runner", "front"))
        c_rows = reg.counter(
            "mmlspark_runner_rows_total",
            "real (unpadded) rows scored per runner by front",
            labels=("runner", "front"))
        self._c_batches = {f: c_batches.labels(runner=name, front=f)
                           for f in FRONTS}
        self._c_rows = {f: c_rows.labels(runner=name, front=f)
                        for f in FRONTS}
        self._c_pad = reg.counter(
            "mmlspark_runner_pad_rows_total",
            "padding rows added by bucketing (wasted device work)",
            labels=("runner",)).labels(runner=name)
        self._c_decode_steps = reg.counter(
            "mmlspark_runner_decode_steps_total",
            "single-token decode-step dispatches",
            labels=("runner",)).labels(runner=name)
        self._c_decode_tokens = reg.counter(
            "mmlspark_runner_decode_tokens_total",
            "per-sequence real generated tokens (unfrozen steps only; "
            "eos-frozen tails and pad rows are not generated work)",
            labels=("runner",)).labels(runner=name)
        # decode-step split: dispatch = host time to enqueue each step,
        # device = a sampled synchronize every device_time_every steps
        if device_time_every is None:
            device_time_every = self.DEVICE_TIME_EVERY_DEFAULT
        self.device_time_every = max(0, int(device_time_every))
        h_phase = reg.histogram(
            "mmlspark_runner_decode_phase_seconds",
            "decode-step breakdown: dispatch (host enqueue) vs device "
            "(sampled synchronize wait)", labels=("runner", "phase"))
        self._h_phase_dispatch = h_phase.labels(runner=name,
                                                phase="dispatch")
        self._h_phase_device = h_phase.labels(runner=name, phase="device")
        self._lock = make_lock("ModelRunner._lock")
        #: page size -> the runner's shared PagePool for paged decode
        self._pools: Dict[int, PagePool] = {}
        #: resolved geometry of the most recent decode (DecodeResult.extras)
        self.last_decode_extras: Optional[Dict[str, Any]] = None

    def __call__(self, batch: torch.Tensor) -> torch.Tensor:
        """The model on one device batch."""
        if self.module is not None:
            return self.module(batch, **self.apply_kwargs)
        return self._apply_fn(self.state, batch)

    # ------------------------------------------------------------ batch front
    def apply_batch(self, x: np.ndarray, front: str = "transform",
                    batch_size: Optional[int] = None) -> np.ndarray:
        """Score a stacked host batch of any row count: chunk to
        ``batch_size``, pad each chunk to its power-of-two bucket, run the
        model on the device, unpad, concatenate.  The chunks' outputs stay
        on the device until the last one is enqueued, then come back in
        one copy, so the host never waits for the card between chunks."""
        bs = int(batch_size or self.batch_size)
        n = x.shape[0]
        if n == 0:
            return np.empty((0,), dtype=np.float32)
        cuda = self.device.type == "cuda"
        marks = []                           # (start, copied, computed)
        outs = []
        pad_total = 0
        with torch.inference_mode():
            for start in range(0, n, bs):
                chunk = x[start:start + bs]
                m = chunk.shape[0]
                bucket = bucket_rows(m, bs)
                pad_total += bucket - m
                chunk = np.ascontiguousarray(_pad_rows(chunk, bucket))
                t = [_mark(cuda)]
                batch = torch.from_numpy(chunk).to(self.device)
                t.append(_mark(cuda))
                y = self(batch)
                outs.append(y[:m])
                t.append(_mark(cuda))
                marks.append(t)
                self.bucket_calls[bucket] = self.bucket_calls.get(bucket, 0) \
                    + 1
                self._c_batches[front].inc()
            t_out = _mark(cuda)
            y = torch.cat(outs)
            if y.dtype == torch.bfloat16:
                y = y.float()
            result = y.cpu().numpy()
            t_done = _mark(cuda)
        for a, b, c in marks:
            self.phase_s["h2d"] += _elapsed(a, b)
            self.phase_s["device"] += _elapsed(b, c)
        self.phase_s["d2h"] += _elapsed(t_out, t_done)
        self._c_rows[front].inc(n)
        if pad_total:
            self._c_pad.inc(pad_total)
        return result

    # ------------------------------------------------------------ decode front
    def page_pool(self, page_size: int = 64,
                  num_pages: Optional[int] = None) -> Optional[PagePool]:
        """The runner's shared :class:`PagePool` for ``page_size`` —
        created on first use (sized by ``num_pages``; a paged decode
        without an explicit pool sizes it to its own worst case and grows
        it for larger batches) and reused by every later paged decode at
        this page size.  Passing ``num_pages`` when a pool already exists
        RESIZES it (raises while sequences hold pages).  Returns ``None``
        when no pool exists yet and ``num_pages`` was not given."""
        key = int(page_size)
        with self._lock:
            pool = self._pools.get(key)
            if num_pages is not None:
                if pool is None:
                    pool = self._pools[key] = PagePool(
                        self.module, num_pages, page_size, name=self.name,
                        registry=self.registry)
                elif pool.num_pages != int(num_pages):
                    pool = self._pools[key] = pool.resized(int(num_pages))
                pool.auto_sized = False
            return pool

    def _auto_pool(self, page_size: int, need_pages: int) -> PagePool:
        """The implicit pool for a paged decode that brought no budget:
        create at this call's worst case, or GROW an earlier auto-sized
        pool that a larger batch has outrun (an explicitly budgeted pool is
        never resized — its exhaustion is admission control).  Growth is
        best-effort: a pool another decode holds pages of serves as is."""
        key = int(page_size)
        with self._lock:
            pool = self._pools.get(key)
            if pool is None:
                pool = self._pools[key] = PagePool(
                    self.module, need_pages, page_size, name=self.name,
                    registry=self.registry)
                pool.auto_sized = True
            elif pool.auto_sized and pool.num_pages < need_pages:
                try:
                    pool = self._pools[key] = pool.resized(need_pages)
                except RuntimeError:
                    pass                      # busy: keep the current pool
            return pool

    def decode(self, prompts: np.ndarray, lengths=None,
               max_new_tokens: int = 16, eos_id: Optional[int] = None,
               sample_fn: Optional[Callable] = None,
               collect_logits: bool = False,
               batch_bucket: Optional[int] = None,
               prompt_bucket: Optional[int] = None,
               cache_len: Optional[int] = None,
               kv_layout: str = "dense",
               page_size: int = 64,
               pool: Optional[PagePool] = None,
               prefix_cache: bool = False,
               watchdog=None) -> DecodeResult:
        """KV-cached batched autoregressive generation.

        ``prompts`` is ``(B, P)`` int (rows padded to the longest prompt);
        ``lengths`` gives each sequence's true prompt length, so ragged
        batches decode exactly.  ``B`` pads to a power-of-two row bucket
        (the pad rows are zero prompts of length 1, born finished) and
        ``P`` to a power-of-two prompt bucket.

        Cache memory (``kv_layout``): ``"dense"`` reserves one
        ``(cache_len,)`` slot row per sequence (``cache_len`` defaults to
        the next power of two covering prompt + new tokens); ``"paged"``
        allocates ``page_size`` pages from a shared :class:`PagePool` by
        ACTUAL length — ``ceil(true_len / page_size)`` at prefill, one
        more at each page-boundary crossing, freed on eos (pass ``pool=``
        to share an explicit budget; otherwise the runner's implicit pool
        for ``page_size``).  A budgeted pool that cannot fund an extend
        freezes that row: its tokens up to the denial are returned, the
        rest are eos (or 0) padding, and ``extras`` names the row in
        ``denied_rows`` / ``denied_at``.

        Sampling: ``sample_fn(logits) -> tokens`` (host numpy) defaults to
        greedy argmax; ``eos_id`` freezes finished sequences and ends the
        loop once all are.  With neither ``sample_fn`` nor
        ``collect_logits``, sampling and freezing run on the device and
        each step fetches only the ``(B,)`` tokens.  Paged + eos: a frozen
        row's pages are freed, so its later logits are unspecified (its
        tokens are eos either way); ``collect_logits=True`` keeps them
        live, so the recorded distributions match the dense layout.

        ``prefix_cache=True`` and ``watchdog=`` raise
        ``NotImplementedError`` (ROADMAP.md §1 item 9)."""
        if self.module is None or not hasattr(self.module, "init_cache"):
            raise TypeError(
                "decode() needs a module with init_cache (a KV-cache-capable "
                "model, e.g. models.TransformerEncoder with causal=True, "
                "pool='none'); this runner wraps "
                f"{type(self.module).__name__ if self.module else 'a raw apply_fn'}")
        if prefix_cache or watchdog is not None:
            raise NotImplementedError(
                "decode(prefix_cache=True / watchdog=...): "
                + _NOT_PORTED)
        prompts = np.asarray(prompts, np.int32)
        if prompts.ndim != 2:
            raise ValueError("prompts must be (batch, prompt_len) int32")
        B, P = prompts.shape
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if kv_layout not in ("dense", "paged"):
            raise ValueError("kv_layout must be dense|paged")
        paged = kv_layout == "paged" or pool is not None
        lengths = (np.full(B, P, np.int32) if lengths is None
                   else np.asarray(lengths, np.int32))
        if lengths.shape != (B,) or lengths.min() < 1 or lengths.max() > P:
            raise ValueError("lengths must be (batch,) in [1, prompt_len]")
        B_b = batch_bucket or 1 << (B - 1).bit_length()
        P_b = prompt_bucket or 1 << (P - 1).bit_length()
        if B_b < B or P_b < P:
            raise ValueError("bucket smaller than the batch/prompt it serves")
        # greedy/eos fast path: sample + freeze on the device
        fused = sample_fn is None and not collect_logits
        module, dev = self.module, self.device
        toks = np.zeros((B_b, P_b), np.int32)
        toks[:B, :P] = prompts
        lens = np.concatenate([lengths, np.ones(B_b - B, np.int32)])
        self._c_pad.inc((B_b - B) * P_b + B * (P_b - P))

        table = None
        seq_pages: List[List[int]] = []
        if paged:
            if not hasattr(module, "init_paged_cache"):
                raise TypeError(
                    "kv_layout='paged' needs a module with init_paged_cache "
                    "(e.g. models.TransformerEncoder); "
                    f"{type(module).__name__} has none")
            if cache_len is not None:
                raise ValueError(
                    "cache_len is a dense-layout parameter (it sizes the "
                    "per-sequence reservation); the paged layout sizes "
                    "cache by pages — use page_size/pool instead")
            if pool is not None:
                page_size = pool.page_size
            page_size = int(page_size)
            if page_size < 1:
                raise ValueError("page_size must be >= 1")
            table_w = -(-(P_b + max_new_tokens) // page_size)
            max_len = getattr(module, "max_len", None)
            if max_len is not None and P_b + max_new_tokens > max_len:
                raise ValueError(
                    f"prompt_bucket + max_new_tokens = "
                    f"{P_b + max_new_tokens} exceeds the module's max_len "
                    f"{max_len} (positional table bound)")
            if pool is None:
                pool = self._auto_pool(page_size, B_b * table_w + 1)
            table = np.zeros((B_b, table_w), np.int64)
            seq_pages = [[] for _ in range(B_b)]
            try:
                # allocate by TRUE length — pad rows (and unallocated table
                # entries) stay on the trash page and never hold pool pages
                for b in range(B):
                    n_pages = -(-int(lengths[b]) // page_size)
                    seq_pages[b] = pool.allocate(n_pages)
                    table[b, :n_pages] = seq_pages[b]
                cache = pool.borrow_cache()
            except Exception:
                # a failed allocation or slab build must not leak the pages
                # already handed to earlier rows
                leftover = [p for pgs in seq_pages for p in pgs]
                if leftover:
                    pool.free(leftover)
                raise
            if cache[0][0].device != dev:
                pool.free([p for pgs in seq_pages for p in pgs])
                pool.return_cache(cache)
                raise ValueError(f"the pool's slabs lie on "
                                 f"{cache[0][0].device}, the runner's model "
                                 f"on {dev}: build the pool from "
                                 "runner.module")
            pages_prefill = sum(len(p) for p in seq_pages)
            peak_pages = pool.pages_in_use()
        else:
            S = cache_len or 1 << (P_b + max_new_tokens - 1).bit_length()
            if S < P_b + max_new_tokens:
                raise ValueError(
                    f"cache_len {S} is below prompt_bucket + max_new_tokens "
                    f"= {P_b + max_new_tokens}: the dense layout reserves "
                    "one full (cache_len,) slot row per sequence up front, "
                    "so the reservation must cover the longest possible "
                    "generation — raise cache_len, or switch to "
                    "kv_layout='paged' to size by actual length instead")
            cache = module.init_cache(B_b, S)
            cache_nbytes = _nbytes(cache)
        positions = np.repeat(np.arange(P_b, dtype=np.int64)[None], B_b,
                              axis=0)
        sample = sample_fn or (lambda lg: np.argmax(lg, axis=-1))
        out_tokens = np.zeros((B_b, max_new_tokens), np.int32)
        out_logits: Optional[list] = [] if collect_logits else None
        # pad rows are born finished: their samples must never hold the
        # eos early-exit open (or inflate the step/token counters)
        finished = np.zeros(B_b, bool)
        finished[B:] = True
        steps = 0
        real_tokens = 0
        #: per-row unfrozen emissions (a denied row's pre-denial tokens)
        row_tokens = np.zeros(B, np.int64)
        #: row -> tokens emitted when its pool extend was DENIED
        denied_at: Dict[int, int] = {}
        ok = False
        table_dirty = False
        cuda = dev.type == "cuda"
        dte = self.device_time_every
        dispatch_s_total = device_s_total = 0.0
        t = 0
        try:
            with torch.inference_mode():
                table_d = torch.from_numpy(table).to(dev) if paged else None
                logits, cache = _cached_apply(
                    module, torch.from_numpy(toks).to(dev),
                    torch.from_numpy(positions), table_d, cache)
                # last REAL token's logits per sequence, gathered on the
                # device so the (B, P, V) tensor never crosses to the host
                rows = torch.arange(B_b, device=dev)
                last = logits[rows, torch.from_numpy(lens - 1).to(dev)]
                self._c_batches["decode"].inc()
                if fused:
                    tok_d, fin_d = _greedy_freeze(
                        last, torch.from_numpy(finished).to(dev), eos_id)
                for t in range(max_new_tokens):
                    if fused:
                        # the ONE host fetch of the fast path: the (B,)
                        # tokens; the device froze the rows it knows
                        # finished, the host folds in its page denials
                        tok = tok_d.cpu().numpy()
                        fin_now = finished | (tok == eos_id) \
                            if eos_id is not None else finished.copy()
                    else:
                        lg = last.float().cpu().numpy()        # (B_b, V)
                        if collect_logits:
                            out_logits.append(lg)
                        tok = np.asarray(sample(lg), np.int32)
                        if eos_id is not None:
                            tok = np.where(finished, eos_id, tok)
                            fin_now = finished | (tok == eos_id)
                        else:
                            fin_now = finished
                    # tokens emitted while a sequence was already frozen
                    # are eos padding, not generated work
                    real_tokens += B - int(finished[:B].sum())
                    row_tokens += ~finished[:B]
                    out_tokens[:, t] = tok
                    if paged and eos_id is not None and not collect_logits:
                        # free on eos: the frozen row keeps stepping, but its
                        # zeroed table row sends every write to the trash
                        # page (its logits become unspecified; its tokens
                        # are eos either way)
                        for b in np.nonzero(fin_now[:B] & ~finished[:B])[0]:
                            if seq_pages[b]:
                                pool.free(seq_pages[b])
                                seq_pages[b] = []
                                table[b, :] = 0
                                table_dirty = True
                    finished = fin_now
                    if t == max_new_tokens - 1 or \
                            ((eos_id is not None or denied_at)
                             and bool(finished.all())):
                        break
                    # token t sits at absolute position lengths + t; the
                    # step writes it at that frontier and returns logits
                    # for t+1 (host path) or the sampled token t+1 (fused)
                    pos = (lens + t).astype(np.int64)
                    if paged:
                        # extend at page boundaries: the write position must
                        # be backed by a real page BEFORE the step runs;
                        # frozen rows stop extending once freed, except
                        # under collect_logits, where they stay live
                        for b in range(B):
                            if b in denied_at or \
                                    (finished[b] and not collect_logits):
                                continue
                            pi = int(pos[b]) // page_size
                            if pi < len(seq_pages[b]):
                                continue
                            try:
                                new_page = pool.extend(1)[0]
                            except PagePoolExhausted:
                                # a budgeted pool's mid-decode exhaustion is
                                # admission control: freeze the row, free
                                # its pages for the survivors, return its
                                # generation so far
                                denied_at[b] = t + 1
                                finished[b] = True
                                if seq_pages[b]:
                                    pool.free(seq_pages[b])
                                    seq_pages[b] = []
                                table[b, :] = 0
                                table_dirty = True
                                continue
                            seq_pages[b].append(new_page)
                            table[b, pi] = new_page
                            table_dirty = True
                        peak_pages = max(peak_pages, pool.pages_in_use())
                        if table_dirty:
                            # re-upload only when extend/free changed it
                            table_d = torch.from_numpy(table).to(dev)
                            table_dirty = False
                    t_disp0 = time.perf_counter()
                    pos_t = torch.from_numpy(pos[:, None])
                    if fused:
                        logits, cache = _cached_apply(
                            module, tok_d[:, None], pos_t, table_d, cache)
                        tok_d, fin_d = _greedy_freeze(logits[:, 0], fin_d,
                                                      eos_id)
                    else:
                        logits, cache = _cached_apply(
                            module, torch.from_numpy(tok[:, None]).to(dev),
                            pos_t, table_d, cache)
                        last = logits[:, 0]
                    disp_s = time.perf_counter() - t_disp0
                    dispatch_s_total += disp_s
                    self._h_phase_dispatch.observe(disp_s)
                    steps += 1
                    self._c_decode_steps.inc()
                    if dte and cuda and steps % dte == 0:
                        # sampled only: the forced sync shows how long the
                        # card still had to run after the host enqueued
                        t_dev0 = time.perf_counter()
                        torch.cuda.synchronize(dev)
                        dev_s = time.perf_counter() - t_dev0
                        device_s_total += dev_s
                        self._h_phase_device.observe(dev_s)
            ok = True
        finally:
            if paged:
                for b in range(B_b):
                    if seq_pages[b]:
                        pool.free(seq_pages[b])
                        seq_pages[b] = []
                # after a failed step the slabs' state is unknown — drop
                # them so the next borrower rebuilds zeros
                pool.return_cache(cache if ok else None)
        n_generated = t + 1
        # a denied row's post-denial slots hold whatever the trash-page
        # steps produced — overwrite with eos padding
        for b, cut in denied_at.items():
            out_tokens[b, cut:] = eos_id if eos_id is not None else 0
        self._c_decode_tokens.inc(real_tokens)
        self._c_rows["decode"].inc(B)
        # every cell of the padded batch emitted lands in exactly one
        # outcome: useful + denied_row + pad_row == B_b x iterations
        denied_tokens = int(sum(int(row_tokens[b]) for b in denied_at))
        useful_tokens = int(real_tokens) - denied_tokens
        pad_cells = B_b * n_generated - int(real_tokens)
        device_s_attr = dispatch_s_total + device_s_total
        extras: Dict[str, Any] = {
            "kv_layout": "paged" if paged else "dense",
            "real_tokens": real_tokens,
            "batch_bucket": B_b,
            "dispatch_s": round(dispatch_s_total, 6),
            "device_s": round(device_s_total, 6),
            "attribution": {"useful": useful_tokens,
                            "denied_row": denied_tokens,
                            "pad_row": pad_cells,
                            "device_s_attributed": round(device_s_attr, 6)},
        }
        if denied_at:
            extras["denied_rows"] = sorted(denied_at)
            extras["denied_at"] = {int(b): int(c)
                                   for b, c in sorted(denied_at.items())}
        if paged:
            extras.update(
                page_size=page_size, table_width=table_w,
                pool_pages=pool.capacity, pages_prefill=pages_prefill,
                pages_peak=peak_pages,
                page_occupancy_pct=round(
                    100.0 * peak_pages / max(pool.capacity, 1), 2),
                cache_bytes_per_seq=pool.page_nbytes() * peak_pages
                / max(B, 1))
        else:
            extras.update(cache_len=S,
                          cache_bytes_per_seq=cache_nbytes / max(B, 1))
        self.last_decode_extras = extras
        logits_out = (np.stack(out_logits, axis=1)[:B] if collect_logits
                      else None)
        return DecodeResult(tokens=out_tokens[:B, :n_generated],
                            lengths=lengths, steps=steps, logits=logits_out,
                            extras=extras)

    # ---------------------------------------- serving/continuous: not ported
    scorer = decode_stream = prefix_cache = stall_watchdog = _not_ported


def _mark(cuda: bool):
    if not cuda:
        return time.perf_counter()
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def _elapsed(a, b) -> float:
    """Seconds between two marks (events must have completed)."""
    if isinstance(a, float):
        return b - a
    return a.elapsed_time(b) / 1e3
