"""Model runner — the port of ``mmlspark_tpu/models/runner.py``: the batch
front (``bucket_rows``, ``_pad_rows``, ``ModelRunner.apply_batch``), the
static batched decode (``PagePool``, ``DecodeResult``, ``ModelRunner.decode``
in its dense and paged cache layouts, with the prefix cache and the stall
watchdog), the continuous engine (``ContinuousDecoder``, ``StreamHandle``)
and the serving front (``ModelRunner.scorer``).

One object takes an in-tree model (``models.resnet``,
``models.transformer``, ``models.bilstm``), an ONNX import
(``dl/onnx_import.py``) or any ``apply_fn(state, batch)`` callable, places
it on its device once, and scores stacked host batches of any row count:
chunk to ``batch_size``, pad each chunk to its power-of-two latency bucket
(a 1-row request pads to 1, not ``batch_size``), run, unpad, concatenate.
The batch counters (``mmlspark_runner_batches_total``, ``_rows_total``,
``_pad_rows_total``) book into the port's registry under the reference's
names.

**Compiled programs.**  As the reference keeps one jitted executable per
signature, the runner keeps one :class:`~mmlspark_tpu_torch.observability.
compute.InstrumentedJit` per key of the reference's (``executable``, the
decode's prefill and step, dense and paged, greedy-fused with ``eos_id``
in the key, the on-device sampler, the copy-on-write page clone): on the
card each signature's first call is captured as a CUDA graph and every
later call replays it; on the CPU the same calls run eagerly under the
same booking.  ``compile_stats()`` gives the reference's dict: the keys,
``"/"``-joined and sorted (the device field is the port's own: the card's
index, or the ranks of a live ``data`` mesh), and the compiles, one per
signature.  What the reference donates is the graphs' in-place state:
the paged layout's pool slabs, the dense layout's cache (owned by its
(device, batch bucket, cache length) geometry and zeroed at each decode,
so a decode sees a fresh ``init_cache``), and each borrower's finished
masks.  ``graph_stats()`` counts the captures and the re-captures for new
storage (a rebuilt slab), which are not compiles.

``decode`` is the reference's cold path: power-of-two batch and prompt
buckets, ragged ``lengths`` (each sequence writes and reads the cache at
its own frontier), pad rows born finished, ``eos_id`` freezing, greedy
sampling on the device (one ``(B,)`` token fetch per step) or a host
``sample_fn`` / ``collect_logits``.  ``kv_layout="paged"`` allocates
fixed-size pages from a shared ``PagePool`` by true length, extends at
page boundaries, frees on eos, and turns a budgeted pool's mid-decode
exhaustion into a partial result (``denied_rows`` / ``denied_at``).
Positions are checked on the host, while they are numpy, before they
reach the card.  The decode counters, the useful/wasted token ledger,
the decode span and the page pool's gauges keep the reference's names.
``prefix_cache=True`` pins the cached prefix pages of
``models.prefix_cache.PrefixIndex`` and prefills only the suffix; a write
that would land on a shared page first splits it (copy-on-write: the
page's k and v copied in every layer's slabs, in place).

``ContinuousDecoder`` (``decode_stream``) keeps a fixed ``slots``-wide
batch on the paged pool: a request joins a free slot between steps (its
prompt prefilled alone at ``(1, prompt_bucket)``) and leaves the moment it
finishes.  It takes its step, its single-row prefill and its sampler from
the runner once, so a warmed one-shot decode at its geometry warms it and
a join mints no key.  A stall watchdog (``utils.resilience.Watchdog``)
brackets each dispatch and host fetch; a trip poison-aborts the engine
from the monitor thread, and the scorer's ``RestartSupervisor`` gates the
rebuild.  Where the reference treats donated slabs as unknown after an
abort, the port drops them as well: the rebuilt engine borrows fresh
slabs, and the aborted engine thread, should it still be running,
touches no slot state after the teardown (one engine lock orders the
two).
"""
from __future__ import annotations

import copy
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from ..core import DataFrame, Transformer
from ..core.schema import ColumnType
from ..utils.concurrency import make_condition, make_lock, make_rlock

__all__ = ["ModelRunner", "DecodeResult", "PagePool", "ContinuousDecoder",
           "StreamHandle", "PagePoolExhausted", "SlotsExhausted", "ShedReply",
           "bucket_rows"]

#: fronts a batch can arrive through; metric label values
FRONTS = ("transform", "serving", "decode")


class PagePoolExhausted(RuntimeError):
    """The page pool cannot cover an allocation — admission control, not a
    crash.  ``shed`` duck-types the serving layer's shed path."""
    shed = True


class SlotsExhausted(RuntimeError):
    """No free decode slot for a new arrival — the continuous engine's
    admission-control twin of :class:`PagePoolExhausted`."""
    shed = True


class EngineDraining(RuntimeError):
    """The decoder is draining (graceful shutdown): no new joins —
    existing slots run to eos/budget, arrivals shed retryably."""
    shed = True
    shed_reason = "draining"


class EngineUnavailable(RuntimeError):
    """The continuous decode engine cannot take this request right now —
    restart backoff in progress, or the runner is quarantined after
    repeated stalls.  A retryable shed (another worker can serve it), not
    a failure: ``shed`` duck-types the serving 503 path."""
    shed = True

    def __init__(self, msg: str, reason: str, retry_after_s: float = 1.0):
        super().__init__(msg)
        self.shed_reason = reason
        self.retry_after_s = float(retry_after_s)


class ShedReply:
    """Per-row shed sentinel: a scorer that must refuse ONE row of a batch
    (mid-decode page denial) returns this in the reply column, and the
    serving layer maps it to 503 + Retry-After.  Duck-typed on
    ``shed_reason`` so serving never imports the models package."""

    __slots__ = ("shed_reason", "retry_after_s")

    def __init__(self, reason: str, retry_after_s: Optional[float] = None):
        self.shed_reason = reason
        self.retry_after_s = retry_after_s


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


def _finished_mask(masks: Dict[int, torch.Tensor], rows: int,
                   dev: torch.device) -> torch.Tensor:
    """The borrower's ``(rows,)`` finished mask: donated state of the
    sampler and the fused step, so it keeps its storage across decodes."""
    m = masks.get(rows)
    if m is None or m.device != dev:
        with torch.inference_mode(False):
            m = masks[rows] = torch.ones(rows, dtype=torch.bool, device=dev)
    return m


def _check_positions(module, pos: np.ndarray) -> None:
    """The module's position bound, checked on the host while ``pos`` is
    numpy: on the card an index past ``max_len`` is a device-side assert,
    and reading positions back from the card would be a sync inside the
    captured forward."""
    max_len = getattr(module, "max_len", None)
    if max_len is None or pos.size == 0:
        return
    hi = int(pos.max())
    if hi >= max_len or int(pos.min()) < 0:
        raise ValueError(f"positions must lie in [0, max_len = {max_len}), "
                         f"got max {hi}")


class _DenseCache:
    """The dense layout's KV cache at one (device, batch bucket, cache
    length): the fixed storage its captured prefills and steps read and
    write.  One decode borrows it at a time; each borrow zeroes it, so a
    decode starts from what a fresh ``init_cache`` gives.  ``masks`` holds
    the borrower's finished masks."""

    __slots__ = ("cache", "masks", "busy")

    def __init__(self):
        self.cache = None
        self.masks: Dict[int, torch.Tensor] = {}
        self.busy = False

    def finished_mask(self, rows: int, dev: torch.device) -> torch.Tensor:
        return _finished_mask(self.masks, rows, dev)


class _ApplyProgram:
    """One bucket's compiled apply (``ModelRunner.executable``):
    ``local`` (an ``InstrumentedJit`` of the model) on this rank's rows of
    the bucket.  Under a live ``data`` axis that divides the bucket,
    ``rows`` is this rank's contiguous block and the block's outputs are
    all-gathered along ``data`` outside the graph."""

    def __init__(self, local, device: torch.device, mesh=None, rows=None):
        self.local, self.device = local, device
        self.mesh, self.rows = mesh, rows

    def __call__(self, batch) -> torch.Tensor:
        """The bucket's output for the full bucket ``batch`` (a tensor or
        numpy), a tensor of its own on the runner's device."""
        if not isinstance(batch, torch.Tensor):
            batch = torch.from_numpy(np.ascontiguousarray(batch))
        if self.rows is not None:
            batch = batch[self.rows]
        with torch.inference_mode():
            return self.run_block(batch.to(self.device))

    def run_block(self, block: torch.Tensor) -> torch.Tensor:
        """The program on this rank's block, already on the device."""
        y = self.local(block)
        if self.rows is not None:
            from ..parallel.collectives import all_gather
            y = all_gather(y, "data", mesh=self.mesh)
        return y


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
    #: refcount increments on shared pages (prefix hits), "cow" private
    #: copies minted by copy-on-write splits
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
        #: the prefix index retaining pages in this pool, if any (set by
        #: ``ModelRunner.prefix_cache``); ``resized()`` flushes it so a
        #: successor pool can never be handed a dangling page id
        self.prefix_index = None
        self._cond = make_condition("PagePool._cond")
        self._cache = None          # built lazily, rebuilt if dropped
        self._cache_nbytes = 0
        #: the slabs' borrower's finished masks (see finished_mask)
        self._masks: Dict[int, torch.Tensor] = {}
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

    def finished_mask(self, rows: int, dev: torch.device) -> torch.Tensor:
        """A ``(rows,)`` finished mask for the decode that holds the slabs
        (the sampler's and the fused step's donated state: it keeps its
        storage across borrowers, as the slabs do, so their captured
        programs replay)."""
        return _finished_mask(self._masks, rows, dev)

    def resized(self, num_pages: int) -> "PagePool":
        """A fresh pool with the same module/page size/metric identity but
        ``num_pages`` pages.  Refuses while sequences hold pages or a
        decode holds the slabs — resizing would orphan them.

        A prefix index retaining pages here is FLUSHED first (booked
        ``evicted{reason="pool_replaced"}``) and rebound to the successor:
        its entries name physical page ids of THIS pool's slabs."""
        idx = self.prefix_index
        if idx is not None:
            # outside the pool lock: flush frees pages back through
            # free(), which takes it (index-lock -> pool-lock order)
            idx.flush(reason="pool_replaced")
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
        if idx is not None:
            idx.rebind(pool)
            pool.prefix_index = idx
            self.prefix_index = None
        return pool

    def return_cache(self, cache) -> None:
        """Give the slabs back (pass ``None`` after a failed loop — the
        slabs' state is unknown, so the next borrower rebuilds)."""
        with self._cond:
            self._borrowed = False
            self._cache = cache
            self._cond.notify()


def _data_mesh():
    """The active mesh and its ``data`` axis size (1 without the axis)."""
    from ..parallel.mesh import get_active_mesh
    mesh = get_active_mesh()
    return mesh, int(mesh.shape.get("data", 1))


def _rows_of(mesh, bucket: int) -> slice:
    from ..parallel.sharding import batch_sharded
    return batch_sharded(mesh).block(bucket)


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
        #: bucket rows -> program calls made at that bucket
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
        # page-pool, continuous-engine, tail-tolerance, attribution and
        # prefix-cache families registered at construction (as the
        # reference does), so they exist for runners that never decode;
        # PagePool, ContinuousDecoder and PrefixIndex bind the children
        reg.counter("mmlspark_runner_page_ops_total",
                    "KV page-pool pages moved by op (allocate/extend/free)",
                    labels=("runner", "page_size", "op"))
        reg.gauge("mmlspark_runner_page_pool_used_pages",
                  "KV pages currently held by live sequences",
                  labels=("runner", "page_size"))
        reg.gauge("mmlspark_runner_page_pool_high_water_pages",
                  "max KV pages ever simultaneously held",
                  labels=("runner", "page_size"))
        reg.counter("mmlspark_runner_page_seconds_total",
                    "KV page-seconds consumed (pages held x wall time, "
                    "integrated at pool-op edges)",
                    labels=("runner", "page_size"))
        reg.counter("mmlspark_runner_slots_joined_total",
                    "requests spliced into the in-flight decode batch",
                    labels=("runner",))
        reg.counter("mmlspark_runner_slots_left_total",
                    "slots released by outcome (ok/denied/expired/cancelled)",
                    labels=("runner", "outcome"))
        reg.gauge("mmlspark_runner_slot_occupancy_pct",
                  "reserved+live decode slots as % of the in-flight bucket",
                  labels=("runner",))
        reg.histogram("mmlspark_runner_ttft_seconds",
                      "submit-to-first-token latency of continuous decode",
                      labels=("runner",))
        self._c_stalls = reg.counter(
            "mmlspark_runner_stalls_total",
            "device dispatches that exceeded the stall watchdog timeout",
            labels=("runner",)).labels(runner=name)
        reg.counter(
            "mmlspark_engine_restarts_total",
            "supervised decode-engine rebuilds after an abort/stall",
            labels=("runner",))
        from ..observability.attribution import attribution_instruments
        _att = attribution_instruments(reg)
        self._c_tok_outcome = _att["tokens"]
        self._c_device_s = _att["device"]
        from .prefix_cache import prefix_instruments
        prefix_instruments(reg)
        self._lock = make_lock("ModelRunner._lock")
        #: the reference's executable cache: key -> compiled program
        self._executables: Dict[Tuple, Callable] = {}
        #: every InstrumentedJit the cache made (compile_stats sums them)
        self._wrappers: list = []
        #: (device key, batch bucket, cache length) -> the dense cache
        self._dense: Dict[Tuple, _DenseCache] = {}
        self._dense_cond = make_condition("ModelRunner._dense_cond")
        #: page size -> the runner's shared PagePool for paged decode
        self._pools: Dict[int, PagePool] = {}
        #: resolved geometry of the most recent decode (DecodeResult.extras)
        self.last_decode_extras: Optional[Dict[str, Any]] = None
        # flight-recorder roster: the postmortem dump walks the registry's
        # live runners for their last decode geometry (a WeakSet)
        from ..observability.flightrecorder import _roster
        _roster(reg, "_model_runners").add(self)

    def __call__(self, batch: torch.Tensor) -> torch.Tensor:
        """The model on one device batch."""
        if self.module is not None:
            return self.module(batch, **self.apply_kwargs)
        return self._apply_fn(self.state, batch)

    # ------------------------------------------------------------- lowering
    def _device_key(self) -> Tuple:
        """The device the executables are specialized to: the ranks of a
        live ``data`` mesh, else the runner's device index (the port's own
        field of the reference's key; a mesh change re-keys instead of
        serving a stale placement)."""
        mesh, parts = _data_mesh()
        if parts > 1:
            return tuple(int(r) for r in mesh.devices.flat)
        return (self.device.index or 0,)

    def _instrumented(self, fn: Callable, suffix: str = "", **jit_kwargs):
        from ..observability.compute import instrumented_jit
        wrapper = instrumented_jit(
            fn, name=f"runner.{self.name}{suffix}",
            registry=self.registry, **jit_kwargs)
        self._wrappers.append(wrapper)
        return wrapper

    def executable(self, bucket_n: int, feat_shape: Tuple[int, ...]):
        """The compiled apply for one (device key, bucketed batch shape) —
        built on first use, a dict hit forever after: an
        :class:`_ApplyProgram` whose call takes the bucket's batch (a
        tensor or numpy) and returns the model's output on the runner's
        device, a tensor of its own (copied out of the graph, so chunks'
        outputs stay valid side by side).  On the card the model is a CUDA
        graph per signature; under a live ``data`` axis that divides the
        bucket, only this rank's block is captured and the gather stays
        outside the graph."""
        key = ("apply", self._device_key(), int(bucket_n),
               tuple(int(d) for d in feat_shape))
        fn = self._executables.get(key)
        if fn is not None:
            return fn
        with self._lock:
            fn = self._executables.get(key)
            if fn is not None:
                return fn
            mesh, parts = _data_mesh()
            local = self._instrumented(self.__call__)
            if parts > 1 and bucket_n % parts == 0:
                fn = _ApplyProgram(local, self.device, mesh,
                                   _rows_of(mesh, int(bucket_n)))
            else:
                fn = _ApplyProgram(local, self.device)
            self._executables[key] = fn
        return fn

    def compile_stats(self) -> Dict[str, Any]:
        """Introspection for tests and ops: executables cached by key plus
        the underlying compile count (one per signature by contract)."""
        return {
            "executables": sorted(
                "/".join(str(p) for p in k) for k in self._executables),
            "compiles": sum(getattr(w, "compiles", 0)
                            for w in self._wrappers),
        }

    def graph_stats(self) -> Dict[str, Any]:
        """The card's side of the cache: CUDA graphs captured, re-captures
        for new donated storage (not compiles), and each signature's
        capture seconds by wrapper name.  All zero on the CPU."""
        captures = recaptures = 0
        seconds: Dict[str, List[float]] = {}
        for w in self._wrappers:
            captures += getattr(w, "captures", 0)
            recaptures += getattr(w, "recaptures", 0)
            snap = w.snapshot().get("capture_seconds", ())
            seconds.setdefault(w.name, []).extend(
                c for c in snap if c is not None)
        return {"captures": captures, "recaptures": recaptures,
                "capture_seconds": seconds}

    # ------------------------------------------------------------ batch front
    def apply_batch(self, x: np.ndarray, front: str = "transform",
                    batch_size: Optional[int] = None) -> np.ndarray:
        """Score a stacked host batch of any row count: chunk to
        ``batch_size``, pad each chunk to its power-of-two bucket, run the
        bucket's :meth:`executable` (a replayed CUDA graph on the card),
        unpad, concatenate.  The chunks' outputs (each copied out of its
        graph) stay on the device until the last one is enqueued, then
        come back in one copy, so the host never waits for the card
        between chunks.  ``phase_s`` splits as before: ``h2d`` is the
        chunk's upload, ``device`` the program (the copy into the graph's
        static input, the replay, the copy out).

        Under an active mesh whose ``data`` axis has P > 1 positions, a
        bucket that P divides is sharded (the reference's inference data
        parallelism): this rank scores its contiguous block of the bucket
        and the rows are all-gathered along ``data``, so every rank, which
        holds the same batch, gets every row.  Every rank must call this
        with the same batch (the executor model)."""
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
                chunk = _pad_rows(chunk, bucket)
                prog = self.executable(bucket, chunk.shape[1:])
                if prog.rows is not None:
                    # this rank's contiguous block; the rows all-gathered
                    chunk = chunk[prog.rows]
                t = [_mark(cuda)]
                batch = torch.from_numpy(np.ascontiguousarray(chunk)).to(
                    self.device)
                t.append(_mark(cuda))
                y = prog.run_block(batch)
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

    # ---------------------------------------------------------- serving front
    def scorer(self, input_col: str = "request", reply_col: str = "reply",
               prepare: Optional[Callable] = None,
               encode: Optional[Callable] = None,
               mode: str = "score", continuous: bool = False,
               report_ttft: bool = False, supervisor=None,
               **decode_kwargs) -> "Transformer":
        """A ``Transformer`` front for ``PipelineServer`` / the streaming
        facade.  ``mode="score"`` stacks request rows (via ``prepare``,
        default ``np.asarray(..., float32)``) and scores them through
        :meth:`apply_batch`; ``mode="decode"`` treats each request as a
        token-id prompt and returns generated token lists from
        :meth:`decode` (``decode_kwargs`` forward — ``max_new_tokens=``,
        ``eos_id=``, and the cache layout).  The server's continuous-mode
        drain is the admission window: whatever is in flight when the
        scorer runs becomes ONE bucketed device batch.

        ``continuous=True`` (decode mode only) upgrades the drain from
        batch ticks to SLOT-level continuous batching: the scorer owns a
        :class:`ContinuousDecoder` (``decode_kwargs`` become
        :meth:`decode_stream` kwargs — ``slots=``, ``prompt_bucket=``,
        ``max_new_tokens=``, ``eos_id=``, ``page_size=``, ``pool=``) and
        exposes ``continuous_submit`` so ``PipelineServer``/the streaming
        facade admit each request into a free slot of the in-flight batch
        the moment it is drained.  Admission failure (no free slot, page
        pool exhausted) sheds with 503 + Retry-After.  ``supervisor``
        (continuous only) overrides the default
        :class:`~mmlspark_tpu_torch.utils.resilience.RestartSupervisor`
        gating engine rebuilds.  ``report_ttft=True`` wraps decode replies
        as ``{"tokens", "ttft_ms"}`` — the in-band first-token latency
        ``mixed_load``'s ``ttft_p99_ms`` gate reads (for the ticked drain
        its honest TTFT is the full latency)."""
        if mode not in ("score", "decode"):
            raise ValueError("scorer mode must be score|decode")
        return _RunnerScorer(self, input_col, reply_col, prepare, encode,
                             mode, decode_kwargs, continuous=continuous,
                             report_ttft=report_ttft, supervisor=supervisor)

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

    def prefix_cache(self, page_size: int = 64, *,
                     budget_pages: int = 64, pool: Optional[PagePool] = None):
        """Get-or-create the :class:`~.prefix_cache.PrefixIndex` attached
        to ``pool`` (default: the runner's shared pool for ``page_size``,
        created minimal if absent — a later decode grows it).  The index
        rides the pool (``pool.prefix_index``), so ``resized()`` /
        auto-grow flush-and-rebind it in one place.  ``budget_pages``
        applies only at creation."""
        from .prefix_cache import PrefixIndex
        if pool is None:
            pool = self._auto_pool(int(page_size), 2)
        if pool.prefix_index is None:
            pool.prefix_index = PrefixIndex(
                pool, budget_pages=budget_pages, name=self.name,
                registry=self.registry)
        return pool.prefix_index

    @staticmethod
    def _alloc_with_reclaim(pool: PagePool, index, n: int,
                            op: str = "allocate", shared=None):
        """``pool.allocate`` with one prefix-eviction retry: under pool
        pressure the index's refcount-0 retentions are reclaimable memory,
        evicted LRU (``reason="pressure"``) BEFORE the allocation is
        denied.  Caller-level so the lock order stays index -> pool."""
        if index is not None and n > 0:
            short = pool.shortfall(n)
            if short:
                index.evict_pages(short, reason="pressure")
        return pool.allocate(n, op=op, shared=shared)

    def _cow_executable(self):
        """Device-side page copy for copy-on-write splits: clone one
        physical page's k/v rows (every layer) from ``src`` into ``dst``.
        src/dst are ``(1,)`` index tensors and the slabs are donated (the
        copy is in place), so one program serves every page of a pool
        geometry and mints no per-page key."""
        key = ("cow_copy", self._device_key())
        fn = self._executables.get(key)
        if fn is not None:
            return fn
        with self._lock:
            fn = self._executables.get(key)
            if fn is None:
                def _cow(cache, src, dst):
                    for k, v in cache:
                        src_d, dst_d = src.to(k.device), dst.to(k.device)
                        k.index_copy_(0, dst_d, k.index_select(0, src_d))
                        v.index_copy_(0, dst_d, v.index_select(0, src_d))
                    return cache

                fn = self._executables[key] = self._instrumented(
                    _cow, suffix=".cow_copy", donate_argnums=(0,))
        return fn

    def _cow_split_page(self, pool: PagePool, index, cache, donor: int):
        """Split a shared page before a divergent write lands on it: mint
        a private page, copy the donor's k/v rows into it in every layer
        (the cow_copy program, in place on the slabs), drop the caller's
        reference on the donor, book the split.  Returns ``(cache,
        new_page)`` — the caller updates its page-table row and pages
        list.  Raises :class:`PagePoolExhausted` (after a pressure-eviction
        retry) when no page is mintable — the caller sheds the row like
        any other mid-flight denial."""
        new_page = self._alloc_with_reclaim(pool, index, 1, op="cow")[0]
        # the slabs are written under inference mode everywhere (they may
        # be inference tensors, which refuse in-place updates outside it)
        with torch.inference_mode():
            cache = self._cow_executable()(
                cache, torch.tensor([donor], dtype=torch.int64),
                torch.tensor([new_page], dtype=torch.int64))
        pool.free([donor])
        if index is not None:
            index.book_cow()
        return cache, new_page

    def _decode_executables(self, batch_b: int, prompt_b: int,
                            cache_len: Optional[int] = None, *,
                            page_size: Optional[int] = None,
                            table_w: Optional[int] = None,
                            fused: bool = False,
                            eos_id: Optional[int] = None):
        """(prefill, step) programs for one decode signature, under the
        reference's keys.

        Dense: prefill keys on (batch bucket, prompt bucket, cache length),
        the step on (batch bucket, cache length).  Paged: prefill keys on
        (batch bucket, prompt bucket, page size, table width) and the step
        on (batch bucket, page size, table width) — cache length is no
        compile key.  ``fused=True`` builds the greedy/eos step that
        samples and freezes on the device and returns the ``(B,)`` next
        token; ``eos_id`` is part of its key.

        Arguments, on the card: ``prefill(toks, positions, lengths,
        table, cache)`` with host ``toks`` (int32), ``positions`` and
        ``lengths`` (int64), the device ``table`` (int64; ``None`` dense)
        and the device ``cache``; the fused ``step(tok, positions, table,
        finished, cache)`` with the device ``tok`` and host ``positions``
        ``(B,)``; the logits step ``step(tok, positions, table, cache)``
        with host ``(B, 1)`` ``tok`` and ``positions``.  The cache and the
        finished mask are donated: updated in place, returned as the
        caller's tensors."""
        module = self.module
        dkey = self._device_key()
        paged = page_size is not None
        if paged:
            kp = ("prefill_paged", dkey, batch_b, prompt_b, page_size,
                  table_w)
            ks = ("step_paged", dkey, batch_b, page_size, table_w)
        else:
            kp = ("prefill", dkey, batch_b, prompt_b, cache_len)
            ks = ("step", dkey, batch_b, cache_len)
        if fused:
            ks = ks + ("fused", eos_id)
        prefill = self._executables.get(kp)
        step = self._executables.get(ks)
        if prefill is not None and step is not None:
            return prefill, step
        sfx = "_paged" if paged else ""
        with self._lock:
            prefill = self._executables.get(kp)
            if prefill is None:
                def _prefill(toks, positions, lengths, table, cache,
                             _m=module):
                    logits, cache = _cached_apply(_m, toks, positions,
                                                  table, cache)
                    # last REAL token's logits per sequence, gathered on
                    # the device so (B, P, V) never crosses to the host
                    rows = torch.arange(logits.shape[0],
                                        device=logits.device)
                    last = logits[rows, (lengths - 1).to(logits.device)]
                    return last, cache

                prefill = self._executables[kp] = self._instrumented(
                    _prefill, suffix=f".prefill{sfx}", donate_argnums=(4,))
            step = self._executables.get(ks)
            if step is None:
                if fused:
                    def _step(tok, positions, table, finished, cache,
                              _m=module, _eos=eos_id):
                        logits, cache = _cached_apply(
                            _m, tok[:, None], positions[:, None], table,
                            cache)
                        nxt, fin = _greedy_freeze(logits[:, 0], finished,
                                                  _eos)
                        finished.copy_(fin)
                        return nxt, finished, cache

                    step = self._instrumented(
                        _step, suffix=f".decode_step{sfx}",
                        donate_argnums=(3, 4))
                else:
                    def _step(tok, positions, table, cache, _m=module):
                        logits, cache = _cached_apply(_m, tok, positions,
                                                      table, cache)
                        return logits[:, 0], cache

                    step = self._instrumented(
                        _step, suffix=f".decode_step{sfx}",
                        donate_argnums=(3,))
                self._executables[ks] = step
        return prefill, step

    def _sample_executable(self, batch_b: int, eos_id: Optional[int]):
        """On-device greedy sampler for the fused path: argmax + eos
        freeze of the prefill's last logits; the finished mask is donated
        (updated in place)."""
        key = ("sample", self._device_key(), batch_b, eos_id)
        fn = self._executables.get(key)
        if fn is not None:
            return fn
        with self._lock:
            fn = self._executables.get(key)
            if fn is None:
                def _sample(last, finished, _eos=eos_id):
                    tok, fin = _greedy_freeze(last, finished, _eos)
                    finished.copy_(fin)
                    return tok, finished

                fn = self._executables[key] = self._instrumented(
                    _sample, suffix=".decode_sample", donate_argnums=(1,))
        return fn

    def _borrow_dense(self, batch_b: int, cache_len: int) -> _DenseCache:
        """The dense cache of this geometry, held by one decode at a time
        (a second decode at the geometry waits, as one-shot paged decodes
        wait for a pool's slabs) and zeroed: equal to a fresh
        ``init_cache``."""
        key = (self._device_key(), int(batch_b), int(cache_len))
        with self._dense_cond:
            st = self._dense.get(key)
            if st is None:
                st = self._dense[key] = _DenseCache()
            while st.busy:
                # bounded waits: the holder is a decode loop on another
                # thread, which returns the cache in its finally
                self._dense_cond.wait(1.0)
            st.busy = True
        try:
            if st.cache is None:
                st.cache = self.module.init_cache(batch_b, cache_len)
            else:
                with torch.inference_mode():
                    for k, v in st.cache:
                        k.zero_()
                        v.zero_()
        except Exception:
            self._return_dense(st)
            raise
        return st

    def _return_dense(self, st: _DenseCache) -> None:
        with self._dense_cond:
            st.busy = False
            self._dense_cond.notify_all()

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

        ``prefix_cache=True`` (paged + greedy only) consults the runner's
        :class:`~.prefix_cache.PrefixIndex` at admission: each row's cached
        prefix pages are PINNED instead of re-prefilled, only the suffix
        is allocated, and the prefill runs position-offset over the
        uncached suffix.  Rows that complete ok are retained into the
        index for the next request's hit.  ``watchdog`` (a
        :meth:`stall_watchdog`) arms one section over the prefill and the
        token loop, with a heartbeat after each host fetch."""
        if self.module is None or not hasattr(self.module, "init_cache"):
            raise TypeError(
                "decode() needs a module with init_cache (a KV-cache-capable "
                "model, e.g. models.TransformerEncoder with causal=True, "
                "pool='none'); this runner wraps "
                f"{type(self.module).__name__ if self.module else 'a raw apply_fn'}")
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
        if prefix_cache and not paged:
            raise ValueError("prefix_cache=True needs kv_layout='paged' — "
                             "the cache shares resident PagePool pages")
        if prefix_cache and (sample_fn is not None or collect_logits):
            raise ValueError(
                "prefix_cache=True supports the greedy fused path only: "
                "cached positions' logits are never recomputed, so a "
                "sample_fn / collect_logits caller would observe a "
                "different distribution surface than a cold decode")
        module, dev = self.module, self.device
        toks = np.zeros((B_b, P_b), np.int32)
        toks[:B, :P] = prompts
        lens = np.concatenate([lengths, np.ones(B_b - B, np.int32)])
        self._c_pad.inc((B_b - B) * P_b + B * (P_b - P))

        table = None
        seq_pages: List[List[int]] = []
        index = None
        #: per-row cached prompt positions (prefix hit) — 0 without a hit;
        #: prefill positions offset past these, the step loop keeps TRUE
        #: lengths (cached k/v is read through the shared pages)
        shared_n = np.zeros(B_b, np.int64)
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
            if prefix_cache:
                index = self.prefix_cache(page_size, pool=pool)
            prefill, step = self._decode_executables(
                B_b, P_b, page_size=page_size, table_w=table_w,
                fused=fused, eos_id=eos_id)
            table = np.zeros((B_b, table_w), np.int64)
            seq_pages = [[] for _ in range(B_b)]
            try:
                # allocate by TRUE length — pad rows (and unallocated table
                # entries) stay on the trash page and never hold pool pages.
                # With the prefix cache, cached prefix pages are pinned by
                # lookup() and only the suffix is freshly allocated; the
                # row's prompt tokens shift left to the uncached suffix
                for b in range(B):
                    if index is not None:
                        cpages, covered = index.lookup(
                            prompts[b, :int(lengths[b])])
                    else:
                        cpages, covered = [], 0
                    n_pages = -(-int(lengths[b]) // page_size)
                    try:
                        pgs = self._alloc_with_reclaim(
                            pool, index, n_pages - len(cpages))
                    except Exception:
                        if cpages:
                            pool.free(cpages)   # drop the lookup pins
                        raise
                    seq_pages[b] = list(cpages) + list(pgs)
                    table[b, :n_pages] = seq_pages[b]
                    if covered:
                        shared_n[b] = covered
                        suffix = int(lengths[b]) - covered
                        toks[b, :] = 0
                        toks[b, :suffix] = prompts[b, covered:int(lengths[b])]
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
            if index is not None:
                # copy-on-write guard over the prefill write range: a
                # suffix (or pad-tail) write landing on a refcount>1 page
                # would corrupt the other holders' admissible slots — mint
                # a private copy first
                try:
                    for b in range(B):
                        lo = int(shared_n[b]) // page_size
                        hi = (int(lengths[b]) - 1) // page_size
                        for pi in range(lo, hi + 1):
                            pg = seq_pages[b][pi]
                            if pool.refcount(pg) > 1:
                                cache, newp = self._cow_split_page(
                                    pool, index, cache, pg)
                                seq_pages[b][pi] = newp
                                table[b, pi] = newp
                except Exception:
                    for pgs in seq_pages:
                        if pgs:
                            pool.free(pgs)
                    seq_pages = [[] for _ in range(B_b)]
                    pool.return_cache(None)
                    raise
            pages_prefill = sum(len(p) for p in seq_pages)
            peak_pages = pool.pages_in_use()
            store = pool
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
            prefill, step = self._decode_executables(
                B_b, P_b, cache_len=S, fused=fused, eos_id=eos_id)
            store = self._borrow_dense(B_b, S)
            cache = store.cache
            cache_nbytes = _nbytes(cache)
        # prefill positions offset past each row's cached prefix (all-zero
        # offsets without a hit — the cold layout); the gather lengths are
        # SUFFIX lengths so the last-real-token logits come from the final
        # uncached position
        positions = _prefill_positions(shared_n, P_b, module)
        plens = (lens - shared_n).astype(np.int64)
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
        from ..observability.tracing import (Span, _enter_phase,
                                             _exit_phase, current_trace_id,
                                             export_span)
        t_loop0 = time.perf_counter()
        if watchdog is not None:
            # one armed section spans prefill + the whole token loop, with
            # a heartbeat after each host fetch: the timeout bounds any
            # SINGLE dispatch/fetch, never the loop's total wall time
            watchdog.arm("runner.decode")
        _phase = _enter_phase("runner.decode")
        try:
            with torch.inference_mode():
                _check_positions(module, positions)
                table_d = torch.from_numpy(table).to(dev) if paged else None
                last, cache = prefill(
                    torch.from_numpy(toks), torch.from_numpy(positions),
                    torch.from_numpy(plens), table_d, cache)
                self._c_batches["decode"].inc()
                if fused:
                    # the borrowed state's mask: donated, so it keeps its
                    # storage from one decode to the next
                    fin_d = store.finished_mask(B_b, dev)
                    fin_d.copy_(torch.from_numpy(finished))
                    tok_d, fin_d = self._sample_executable(B_b, eos_id)(
                        last, fin_d)
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
                    if watchdog is not None:
                        watchdog.heartbeat()   # this step's fetch returned
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
                    _check_positions(module, pos)
                    if paged:
                        # extend at page boundaries: the write position must
                        # be backed by a real page BEFORE the step runs;
                        # frozen rows stop extending once freed, except
                        # under collect_logits, where they stay live.  A
                        # write landing on a shared page splits it first
                        for b in range(B):
                            if b in denied_at or \
                                    (finished[b] and not collect_logits):
                                continue
                            pi = int(pos[b]) // page_size
                            needs_page = pi >= len(seq_pages[b])
                            needs_cow = (not needs_page and index is not None
                                         and pool.refcount(
                                             seq_pages[b][pi]) > 1)
                            if not (needs_page or needs_cow):
                                continue
                            try:
                                if needs_cow:
                                    cache, new_page = self._cow_split_page(
                                        pool, index, cache, seq_pages[b][pi])
                                else:
                                    new_page = self._alloc_with_reclaim(
                                        pool, index, 1, op="extend")[0]
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
                            if needs_cow:
                                seq_pages[b][pi] = new_page
                            else:
                                seq_pages[b].append(new_page)
                            table[b, pi] = new_page
                            table_dirty = True
                        peak_pages = max(peak_pages, pool.pages_in_use())
                        if table_dirty:
                            # re-upload only when extend/free changed it
                            table_d = torch.from_numpy(table).to(dev)
                            table_dirty = False
                    t_disp0 = time.perf_counter()
                    if fused:
                        # donated dispatch: fin_d and cache are updated in
                        # place and come back as the same storage
                        tok_d, fin_d, cache = step(
                            tok_d, torch.from_numpy(pos), table_d, fin_d,
                            cache)
                    else:
                        last, cache = step(
                            torch.from_numpy(np.ascontiguousarray(
                                tok[:, None])),
                            torch.from_numpy(pos[:, None]), table_d, cache)
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
            _exit_phase(_phase)
            if watchdog is not None:
                watchdog.disarm()
            if paged:
                # retention: an ok row's pages hold valid k/v for its
                # prompt + every fed-back token (the final sampled token is
                # never written) — hand them to the prefix index as the
                # next request's hit instead of the free list.  Denied/
                # eos-freed rows and failed loops free as before
                for b in range(B_b):
                    pgs = seq_pages[b]
                    if not pgs:
                        continue
                    if (index is not None and ok and b < B
                            and b not in denied_at):
                        ids = np.concatenate(
                            [prompts[b, :int(lengths[b])],
                             out_tokens[b, :max(int(t), 0)]])
                        index.release(ids, pgs)
                    else:
                        pool.free(pgs)
                    seq_pages[b] = []
                # after a failed step the slabs' state is unknown — drop
                # them so the next borrower rebuilds zeros
                pool.return_cache(cache if ok else None)
            else:
                self._return_dense(store)
        n_generated = t + 1
        # a denied row's post-denial slots hold whatever the trash-page
        # steps produced — overwrite with eos padding
        for b, cut in denied_at.items():
            out_tokens[b, cut:] = eos_id if eos_id is not None else 0
        self._c_decode_tokens.inc(real_tokens)
        self._c_rows["decode"].inc(B)
        # useful-vs-wasted ledger: every cell of the padded batch emitted
        # lands in exactly one outcome — useful + denied_row + pad_row ==
        # B_b x iterations, a conservation law
        denied_tokens = int(sum(int(row_tokens[b]) for b in denied_at))
        useful_tokens = int(real_tokens) - denied_tokens
        pad_cells = B_b * n_generated - int(real_tokens)
        if useful_tokens:
            self._c_tok_outcome.inc(useful_tokens, outcome="useful")
        if denied_tokens:
            self._c_tok_outcome.inc(denied_tokens, outcome="denied_row")
        if pad_cells:
            self._c_tok_outcome.inc(pad_cells, outcome="pad_row")
        # attributed device-seconds: host-observed step time (enqueue +
        # the sampled residual device wait)
        device_s_attr = dispatch_s_total + device_s_total
        self._c_device_s.inc(device_s_attr)
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
        # one span per decode call carrying the split (never per token);
        # joins the ambient trace when the call rides a served request
        span = Span("runner.decode", trace_id=current_trace_id(),
                    start_s=t_loop0,
                    attributes={"runner": self.name, "steps": steps,
                                "dispatch_s": round(dispatch_s_total, 6),
                                "device_s": round(device_s_total, 6),
                                "device_time_every": dte})
        span.finish(time.perf_counter())
        export_span(span, self.registry)
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
            if index is not None:
                extras["prefix"] = {
                    "cached_tokens": int(shared_n[:B].sum()),
                    "hit_rows": int((shared_n[:B] > 0).sum()),
                    **index.stats()}
        else:
            extras.update(cache_len=S,
                          cache_bytes_per_seq=cache_nbytes / max(B, 1))
        self.last_decode_extras = extras
        logits_out = (np.stack(out_logits, axis=1)[:B] if collect_logits
                      else None)
        return DecodeResult(tokens=out_tokens[:B, :n_generated],
                            lengths=lengths, steps=steps, logits=logits_out,
                            extras=extras)

    # --------------------------------------------------------- stall watchdog
    def stall_watchdog(self, stall_timeout_s: float,
                       clock: Callable[[], float] = time.monotonic,
                       on_stall: Optional[Callable] = None):
        """A :class:`~mmlspark_tpu_torch.utils.resilience.Watchdog` wired to
        this runner's stall telemetry: an armed section overrunning
        ``stall_timeout_s`` books ``mmlspark_runner_stalls_total`` and
        fires a flight-recorder postmortem dump on the stall edge
        (``trigger="stall"`` — the engine state BEFORE recovery tears it
        down), then chains the caller's ``on_stall(label, elapsed_s)``
        (the continuous engine hangs its poison-abort there).  Pass the
        result to :meth:`decode`'s ``watchdog=``, or let
        ``decode_stream(stall_timeout_s=...)`` build one internally."""
        from ..utils.resilience import Watchdog

        def _trip(label: str, elapsed: float) -> None:
            self._c_stalls.inc()
            try:
                from ..observability.flightrecorder import get_flight_recorder
                get_flight_recorder(self.registry).dump(trigger="stall")
            except Exception:  # noqa: BLE001 — the dump must never block
                pass           # stall recovery
            if on_stall is not None:
                on_stall(label, elapsed)

        return Watchdog(stall_timeout_s, clock=clock, on_stall=_trip,
                        name=self.name)

    # ------------------------------------------------------ continuous front
    def decode_stream(self, *, slots: int = 4, prompt_bucket: int = 16,
                      max_new_tokens: int = 16,
                      eos_id: Optional[int] = None, page_size: int = 64,
                      pool: Optional[PagePool] = None,
                      clock: Optional[Callable[[], float]] = None,
                      stall_timeout_s: Optional[float] = None,
                      prefix_cache: bool = False
                      ) -> "ContinuousDecoder":
        """A persistent in-flight decode loop over the paged pool: a fixed
        ``slots``-wide batch whose per-slot state (page-table row, length,
        finished flag) supports slot-level JOIN (a new arrival prefills
        alone at ``(1, prompt_bucket)`` into freshly allocated pages and
        splices into the running batch between steps) and LEAVE
        (eos/budget frees the slot's pages mid-flight; the slot is
        immediately admissible again).  Greedy/eos fast path only
        (``sample_fn``/``collect_logits`` stay one-shot); greedy tokens
        equal :meth:`decode`'s for the same prompt, a row's computation
        depending only on its own pages and mask.

        With ``prefix_cache=True`` admission consults the pool's
        :class:`~.prefix_cache.PrefixIndex`: a join allocates only the
        uncached suffix pages and prefills only the uncached positions,
        and a finished request's pages are retained in the index instead
        of freed, funding the next arrival's hit.

        Drive it with :meth:`ContinuousDecoder.submit` + either
        :meth:`ContinuousDecoder.start` (background engine thread — what
        serving uses) or manual :meth:`ContinuousDecoder.step` calls
        (deterministic tests)."""
        return ContinuousDecoder(self, slots=slots,
                                 prompt_bucket=prompt_bucket,
                                 max_new_tokens=max_new_tokens,
                                 eos_id=eos_id, page_size=page_size,
                                 pool=pool, clock=clock,
                                 stall_timeout_s=stall_timeout_s,
                                 prefix_cache=prefix_cache)


def _prefill_positions(offsets: np.ndarray, P_b: int, module) -> np.ndarray:
    """``(rows, P_b)`` int64 prefill positions, each row offset past its
    cached prefix.  Past ``max_len`` only pad cells can lie (a row's real
    positions end below ``prompt_bucket``): they are clamped to the last
    position, where the reference's gather clamps its embedding read;
    their k/v land past the row's frontier or on the trash page, and
    their outputs are never read."""
    pos = offsets[:, None] + np.arange(P_b, dtype=np.int64)[None, :]
    max_len = getattr(module, "max_len", None)
    if max_len is not None:
        np.minimum(pos, max_len - 1, out=pos)
    return pos


class StreamHandle:
    """One request in flight on a :class:`ContinuousDecoder`.

    Lifecycle: ``queued`` (slot + prompt pages reserved at submit) →
    ``live`` (spliced into the batch; ``t_first_s``/``ttft_s`` set) → a
    terminal outcome: ``ok`` (eos or token budget), ``denied`` (page pool
    exhausted mid-flight — the generation so far is on ``tokens``),
    ``expired`` (deadline passed mid-flight), ``cancelled`` (decoder
    closed) or ``error`` (engine failure).  ``done`` fires at the terminal
    transition; ``on_done(handle)`` (if given) runs on the engine thread
    right after it."""

    __slots__ = ("prompt", "length", "max_new_tokens", "deadline_s",
                 "on_done", "slot", "tokens", "status", "done",
                 "t_submit_s", "t_first_s", "pages", "trace_id", "cost",
                 "prompt_hash", "covered")

    def __init__(self, prompt: np.ndarray, length: int, max_new_tokens: int,
                 deadline_s: Optional[float], on_done: Optional[Callable],
                 trace_id: Optional[str] = None,
                 prompt_hash: Optional[str] = None):
        self.prompt = prompt
        self.length = int(length)
        self.max_new_tokens = int(max_new_tokens)
        self.deadline_s = deadline_s
        self.on_done = on_done
        # the request's trace id: the TTFT histogram observation carries it
        # as an exemplar (the engine thread has no ambient span)
        self.trace_id = trace_id
        self.slot = -1
        self.tokens: List[int] = []
        self.status = "queued"
        self.done = threading.Event()
        self.t_submit_s = 0.0
        self.t_first_s: Optional[float] = None
        self.pages: List[int] = []
        # per-request cost ledger — attached at submit; engine edges
        # mutate it, the terminal outcome classifies its tokens
        self.cost = None
        # prefix-cache seam: the admission-time prompt hash the serving
        # layer passed through (observability only), and how many leading
        # prompt positions the index covered (0 = cold)
        self.prompt_hash = prompt_hash
        self.covered = 0

    @property
    def ttft_s(self) -> Optional[float]:
        """Submit-to-first-token latency (None until the join prefill)."""
        if self.t_first_s is None:
            return None
        return max(0.0, self.t_first_s - self.t_submit_s)

    def result(self, timeout: Optional[float] = None) -> DecodeResult:
        """Block until terminal and return a one-row :class:`DecodeResult`
        (partial for denied/expired/cancelled outcomes)."""
        if not self.done.wait(timeout):
            raise TimeoutError("decode stream request still in flight")
        toks = np.asarray(self.tokens, np.int32).reshape(1, -1)
        return DecodeResult(
            tokens=toks,
            lengths=np.asarray([self.length], np.int32),
            steps=max(0, len(self.tokens) - 1),
            extras={"status": self.status, "ttft_s": self.ttft_s})


class ContinuousDecoder:
    """Slot-level continuous batching on the paged KV pool.

    A fixed in-flight batch of ``slots`` rows decodes one greedy step at a
    time; requests join free slots between steps and leave (freeing their
    pages) the moment they finish, so tokens/s tracks the arrival process
    instead of the slowest member of a drained batch.  Per-slot state is
    the paged decode's: a page-table row, a true length and a finished
    flag — empty slots are pad rows (finished, table row on the trash
    page).

    Join = a ``(1, prompt_bucket)`` prefill of the arrival alone into its
    freshly allocated pages, between steps — device work proportional to
    the arrival, never the batch width, and live rows' pages untouched
    (the prefill's table names only the joiner's pages).

    Admission control at :meth:`submit`: no free slot raises
    :class:`SlotsExhausted`; the prompt's pages are allocated up front so
    pool exhaustion raises :class:`PagePoolExhausted` (booked as
    ``op="denied"``) — serving maps both to 503 + Retry-After.  A
    mid-flight extend denial resolves that slot as ``denied`` with its
    partial generation.

    Metrics: ``mmlspark_runner_slots_{joined,left}_total``,
    ``mmlspark_runner_slot_occupancy_pct``, and the
    ``mmlspark_runner_ttft_seconds`` histogram, all labelled by runner.

    Threading: ``submit`` is thread-safe; :meth:`step` must have ONE
    driver — the :meth:`start` engine thread, or a single test/bench loop.
    The engine thread enters ``torch.inference_mode()`` and selects the
    runner's card itself (both are thread-local); serving handler threads
    only submit.  The slot state is written under one engine lock, held
    around the bookkeeping and never across a forward or a host fetch, so
    a stall abort from the watchdog's monitor thread waits at most for the
    bookkeeping, and the aborted engine, when its dispatch returns, finds
    the teardown done and touches nothing.  The decoder borrows the pool's
    device slabs at the first join and returns them when idle or at
    :meth:`close` (one-shot paged decodes on the same pool block until
    then); an abort drops them, so the next borrower builds fresh ones.
    """

    OUTCOMES = ("ok", "denied", "expired", "cancelled", "error")

    def __init__(self, runner: ModelRunner, *, slots: int = 4,
                 prompt_bucket: int = 16, max_new_tokens: int = 16,
                 eos_id: Optional[int] = None, page_size: int = 64,
                 pool: Optional[PagePool] = None,
                 clock: Optional[Callable[[], float]] = None,
                 stall_timeout_s: Optional[float] = None,
                 prefix_cache: bool = False):
        module = runner.module
        if module is None or not hasattr(module, "init_paged_cache"):
            raise TypeError(
                "decode_stream() needs a module with init_paged_cache "
                "(e.g. models.TransformerEncoder with causal=True)")
        if slots < 1 or prompt_bucket < 1 or max_new_tokens < 1:
            raise ValueError("slots, prompt_bucket and max_new_tokens "
                             "must all be >= 1")
        self.runner = runner
        self.slots = int(slots)
        self.prompt_bucket = int(prompt_bucket)
        self.max_new_tokens = int(max_new_tokens)
        self.eos_id = eos_id
        self.clock = clock or time.monotonic
        if pool is not None:
            page_size = pool.page_size
        if page_size < 1:
            raise ValueError("page_size must be >= 1")
        self.page_size = int(page_size)
        self.table_w = -(-(self.prompt_bucket + self.max_new_tokens)
                         // self.page_size)
        max_len = getattr(module, "max_len", None)
        if max_len is not None and \
                self.prompt_bucket + self.max_new_tokens > max_len:
            raise ValueError(
                f"prompt_bucket + max_new_tokens = "
                f"{self.prompt_bucket + self.max_new_tokens} exceeds the "
                f"module's max_len {max_len} (positional table bound)")
        self._explicit_pool = pool is not None
        self.pool = pool if pool is not None else runner._auto_pool(
            self.page_size, self.slots * self.table_w + 1)
        # cross-request prefix cache: the index rides the POOL (resized()
        # and auto-grow flush-and-rebind it there), the decoder only holds
        # the reference
        self._prefix_enabled = bool(prefix_cache)
        self.index = runner.prefix_cache(
            self.page_size, pool=self.pool) if prefix_cache else None
        # the one-shot programs AT THE STREAM GEOMETRY — shared cache
        # entries, so a warmed one-shot decode warms the stream and vice
        # versa, and a join can never mint a new compile key.  The step
        # runs at the full batch bucket; a join prefills its arrival ALONE
        # at the (1, prompt_bucket) signature, device work proportional to
        # the arrival, with one-shot parity by row independence
        _, self._step = runner._decode_executables(
            self.slots, self.prompt_bucket, page_size=self.page_size,
            table_w=self.table_w, fused=True, eos_id=eos_id)
        self._prefill1, _ = runner._decode_executables(
            1, self.prompt_bucket, page_size=self.page_size,
            table_w=self.table_w, fused=True, eos_id=eos_id)
        self._sample1 = runner._sample_executable(1, eos_id)
        #: the borrowed pool's finished masks (the step's and the join
        #: sampler's donated state), fetched with the slabs
        self._mask_step: Optional[torch.Tensor] = None
        self._mask_join: Optional[torch.Tensor] = None
        # per-slot state: empty slots behave as pad rows
        self._tok = np.zeros(self.slots, np.int32)
        self._fin = np.ones(self.slots, bool)
        self._lens = np.ones(self.slots, np.int64)
        self._emitted = np.zeros(self.slots, np.int64)
        self._table = np.zeros((self.slots, self.table_w), np.int64)
        self._table_dev = None
        self._table_dirty = True
        #: device copies of _tok/_fin for the steady state — the previous
        #: step's outputs feed the next step directly (as the one-shot
        #: fused loop does); a join/leave invalidates them so the next
        #: step re-uploads the mutated host state
        self._tok_dev = None
        self._fin_dev = None
        self._handles: List[Optional[StreamHandle]] = [None] * self.slots
        self._free: List[int] = list(range(self.slots - 1, -1, -1))
        self._arrivals: "deque[StreamHandle]" = deque()
        self._cond = make_condition("ContinuousDecoder._cond")
        #: the slot state's lock: the engine's bookkeeping and the
        #: teardown, never held across a forward or a host fetch
        self._elock = make_rlock("ContinuousDecoder._elock")
        self._cache = None
        self._live = 0
        self._closed = False
        self._poisoned = False
        self._torn = False
        self._draining = False
        #: why the engine died ("stall"/"error"; None while alive or after
        #: a clean close) — the serving seam reads it to map stall-aborted
        #: handles to a retryable 503 instead of a 500
        self.abort_reason: Optional[str] = None
        self._thread: Optional[threading.Thread] = None
        # dispatch hang watchdog: armed around every engine dispatch +
        # fetch; a trip books the stall, dumps the flight recorder
        # (runner.stall_watchdog wires both), then poison-aborts this
        # engine from the monitor thread
        self.watchdog = None if stall_timeout_s is None else \
            runner.stall_watchdog(stall_timeout_s, clock=self.clock,
                                  on_stall=self._stall_abort)
        self.steps = 0       # batch steps (join prefills excluded)
        self.joined = 0
        self.left = 0
        reg, name = runner.registry, runner.name
        self._name = name
        self._c_joined = reg.counter(
            "mmlspark_runner_slots_joined_total",
            "requests spliced into the in-flight decode batch",
            labels=("runner",)).labels(runner=name)
        fam_left = reg.counter(
            "mmlspark_runner_slots_left_total",
            "slots released by outcome (ok/denied/expired/cancelled)",
            labels=("runner", "outcome"))
        self._c_left = {o: fam_left.labels(runner=name, outcome=o)
                        for o in self.OUTCOMES}
        self._g_occ = reg.gauge(
            "mmlspark_runner_slot_occupancy_pct",
            "reserved+live decode slots as % of the in-flight bucket",
            labels=("runner",))
        self._h_ttft = reg.histogram(
            "mmlspark_runner_ttft_seconds",
            "submit-to-first-token latency of continuous decode",
            labels=("runner",)).labels(runner=name)
        # attribution plane: token outcomes and attributed device-seconds
        # on the runner's shared families, all host-side
        from ..observability.attribution import (ENGINE_OUTCOME_MAP,
                                                 RequestCost)
        self._RequestCost = RequestCost
        self._outcome_map = ENGINE_OUTCOME_MAP
        self._c_tok_outcome = runner._c_tok_outcome
        self._c_device_s = runner._c_device_s
        self._book_occupancy()
        # flight-recorder roster: the postmortem dump reads the live slot
        # table + pool occupancy from here (WeakSet-held)
        from ..observability.flightrecorder import _roster
        _roster(reg, "_decode_streams").add(self)

    # -------------------------------------------------------------- admission
    @property
    def closed(self) -> bool:
        """True once :meth:`close` ran or the engine aborted — a closed
        decoder refuses submits; callers holding one should rebuild."""
        return self._closed

    @property
    def draining(self) -> bool:
        """True once :meth:`drain` started: no new joins, existing slots
        running to completion."""
        return self._draining

    def occupancy(self) -> int:
        """Slots reserved or live (free slots are ``slots - occupancy``)."""
        with self._cond:
            return self.slots - len(self._free)

    def _book_occupancy(self) -> None:
        """Occupancy gauge — called with ``_cond`` held."""
        occ = self.slots - len(self._free)
        self._g_occ.set(100.0 * occ / self.slots, runner=self._name)

    def _adopt_current_pool_locked(self) -> None:
        """A FULLY idle stream re-binds to the runner's CURRENT implicit
        pool for its page size (``_cond`` held): ``page_pool(num_pages=)``
        resizes and ``_auto_pool`` growth REPLACE the runner's pool
        object, and a stream that kept the old reference would allocate
        from an orphaned budget.  Only when zero slots are reserved and
        the slabs are returned; a stream built on an explicit ``pool=``
        keeps it — that budget is the caller's contract."""
        if self._explicit_pool or self._cache is not None \
                or self._live or self._arrivals \
                or len(self._free) != self.slots:
            return
        current = self.runner._pools.get(self.page_size)
        if current is not None and current is not self.pool:
            self.pool = current
            if self._prefix_enabled:
                self.index = self.runner.prefix_cache(
                    self.page_size, pool=current)

    def submit(self, prompt, *, max_new_tokens: Optional[int] = None,
               deadline_s: Optional[float] = None,
               on_done: Optional[Callable] = None,
               trace_id: Optional[str] = None,
               prompt_hash: Optional[str] = None) -> StreamHandle:
        """Admit one request: reserve a free slot and allocate its prompt
        pages NOW (the admission decision), splice into the batch at the
        next step boundary.  Raises :class:`SlotsExhausted` /
        :class:`PagePoolExhausted` when the engine is full, and
        :class:`EngineDraining` once :meth:`drain` started — admission
        control, the serving layer's 503 signal.

        With the stream's prefix cache enabled, admission consults the
        index first: the longest page-aligned cached prefix is pinned
        (shared, refcounted) and only the SUFFIX pages are freshly
        allocated — the join then prefills only the uncached positions.
        ``prompt_hash`` is recorded on the handle; the index matches on
        token content."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        length = int(prompt.size)
        if not 1 <= length <= self.prompt_bucket:
            raise ValueError(
                f"prompt length {length} outside [1, "
                f"{self.prompt_bucket}] (the stream's prompt bucket)")
        budget = (self.max_new_tokens if max_new_tokens is None
                  else int(max_new_tokens))
        if not 1 <= budget <= self.max_new_tokens:
            raise ValueError(
                f"max_new_tokens {budget} outside [1, "
                f"{self.max_new_tokens}] (the stream's table bound)")
        n_pages = -(-length // self.page_size)
        with self._cond:
            if self._closed:
                raise RuntimeError("decoder is closed")
            if self._draining:
                raise EngineDraining(
                    "decoder is draining — no new joins")
            self._adopt_current_pool_locked()
            if not self._free:
                raise SlotsExhausted(
                    f"no free decode slot ({self.slots} in flight) — "
                    "retry after a sequence finishes, or run more slots")
            # pages allocated inside the slot reservation so the two
            # admission resources can never disagree — lock order
            # decoder._cond -> index._lock -> pool._cond
            covered = 0
            cpages: List[int] = []
            if self.index is not None:
                cpages, covered = self.index.lookup(prompt)
            try:
                pages = list(cpages) + list(self.runner._alloc_with_reclaim(
                    self.pool, self.index, n_pages - len(cpages)))
            except Exception:
                if cpages:
                    self.pool.free(cpages)
                raise
            slot = self._free.pop()
            handle = StreamHandle(prompt, length, budget, deadline_s,
                                  on_done, trace_id=trace_id,
                                  prompt_hash=prompt_hash)
            handle.slot = slot
            handle.pages = pages
            handle.covered = covered
            handle.t_submit_s = self.clock()
            handle.cost = self._RequestCost(prefill_tokens=length)
            handle.cost.prefill_cached = covered
            handle.cost.page_edge(handle.t_submit_s, len(handle.pages))
            self._arrivals.append(handle)
            self._book_occupancy()
            self._cond.notify_all()
        return handle

    # ----------------------------------------------------------------- engine
    def _borrow(self) -> None:
        if self._cache is None:
            self._cache = self.pool.borrow_cache()
            dev = self.runner.device
            self._mask_step = self.pool.finished_mask(self.slots, dev)
            self._mask_join = self.pool.finished_mask(1, dev)

    def _return_cache_if_idle(self) -> None:
        """Hand the borrowed slabs back while the engine is EMPTY (no live
        slot, no queued arrival): an idle engine holds no pages, so its
        slab contents are irrelevant — returning them lets one-shot paged
        decodes (and other streams on the same pool) interleave.  The next
        join re-borrows."""
        with self._elock:
            if self._cache is None or self._torn:
                return
            with self._cond:
                if self._arrivals:
                    return
            cache, self._cache = self._cache, None
        self.pool.return_cache(cache)

    def warmup(self) -> None:
        """Run the join prefill, its sampler and the batch step (and, with
        the prefix cache, the copy-on-write clone) once with all-trash
        inputs (zero page tables: no pool pages held, no slot state
        touched), so the first real join pays no capture.  The signatures
        are shared with one-shot :meth:`ModelRunner.decode` at this
        geometry, so a warmed one-shot also warms the stream."""
        self._borrow()
        S, P_b, W = self.slots, self.prompt_bucket, self.table_w
        dev = self.runner.device
        try:
            with torch.inference_mode():
                last, _ = self._prefill1(
                    torch.zeros((1, P_b), dtype=torch.int32),
                    torch.arange(P_b, dtype=torch.int64)[None],
                    torch.ones(1, dtype=torch.int64),
                    torch.zeros((1, W), dtype=torch.int64, device=dev),
                    self._cache)
                self._mask_join.fill_(True)
                self._sample1(last, self._mask_join)
                self._mask_step.fill_(True)
                tok, _, _ = self._step(
                    torch.zeros(S, dtype=torch.int32, device=dev),
                    torch.zeros(S, dtype=torch.int64),
                    torch.zeros((S, W), dtype=torch.int64, device=dev),
                    self._mask_step, self._cache)
                if self.index is not None:
                    # the CoW clone at this pool geometry, warmed by a
                    # trash self-copy (page 0 -> page 0)
                    self.runner._cow_executable()(
                        self._cache, torch.zeros(1, dtype=torch.int64),
                        torch.zeros(1, dtype=torch.int64))
                tok.cpu()
        except Exception:
            with self._cond:
                self._poisoned = True   # slab state unknown (see step)
            raise
        if self._live == 0:
            self._return_cache_if_idle()

    def step(self) -> int:
        """One engine round: splice queued arrivals (join prefill), advance
        every live slot one greedy step, release finished slots (leave).
        ONE driver only — the :meth:`start` thread or a single test/bench
        loop.  Returns the number of live slots remaining.  The round runs
        under the ``runner.decode.step`` ambient phase, so host-stack
        samples attribute the engine thread's time to it by name."""
        from ..observability.tracing import _enter_phase, _exit_phase
        with self._cond:
            joiners = list(self._arrivals)
            self._arrivals.clear()
        leavers: List[StreamHandle] = []
        _phase = _enter_phase("runner.decode.step")
        try:
            with torch.inference_mode():
                if joiners:
                    self._join(joiners, leavers)
                if self._live:
                    self._advance(leavers)
        except Exception:
            # a failed forward leaves the slab state unknown — poison the
            # borrow so close()/abort drop the slabs and the next borrower
            # rebuilds zeros
            with self._cond:
                self._poisoned = True
            raise
        finally:
            _exit_phase(_phase)
        self._finish(leavers)
        if self._live == 0:
            self._return_cache_if_idle()
        return self._live

    def _finish(self, leavers: List[StreamHandle]) -> None:
        for h in leavers:
            h.done.set()
            if h.on_done is not None:
                try:
                    h.on_done(h)
                except Exception:  # noqa: BLE001 — a reply callback must
                    pass           # never kill the shared engine

    def _join(self, joiners: List[StreamHandle],
              leavers: List[StreamHandle]) -> None:
        """Splice arrivals into their reserved slots.  Each joiner
        prefills ALONE at ``(1, prompt_bucket)`` into its freshly allocated
        pool pages — a row's computation depends only on its own pages and
        mask, so its tokens are those of a one-shot decode of the prompt,
        while the device work is proportional to the arrival; live rows'
        pages are untouched because the prefill's table names only the
        joiner's pages."""
        runner = self.runner
        module, dev = runner.module, runner.device
        P_b, W = self.prompt_bucket, self.table_w
        ps = self.page_size
        for h in joiners:
            with self._elock:
                if self._torn:
                    # the teardown ran between the snapshot and the splice
                    self._cancel_arrival(h, "cancelled", leavers)
                    continue
                self._borrow()
                s = h.slot
                off = int(h.covered)
                if off and self.index is not None:
                    # admission CoW guard: the suffix prefill writes
                    # positions [off, length) — a refcount>1 page there
                    # (the partially covered tail page of a mid-page hit)
                    # is split to a private copy BEFORE the write lands
                    try:
                        for pi in range(off // ps, (h.length - 1) // ps + 1):
                            if pi < len(h.pages) and \
                                    self.pool.refcount(h.pages[pi]) > 1:
                                _, newp = runner._cow_split_page(
                                    self.pool, self.index, self._cache,
                                    h.pages[pi])
                                h.pages[pi] = newp
                    except PagePoolExhausted:
                        # admission-time denial: the arrival never joined
                        self._cancel_arrival(h, "denied", leavers)
                        continue
                suffix = h.length - off
                toks = np.zeros((1, P_b), np.int32)
                toks[0, :suffix] = h.prompt[off:]
                jtable = np.zeros((1, W), np.int64)
                n = len(h.pages)
                jtable[0, :n] = h.pages
                self._table[s, :] = 0
                self._table[s, :n] = h.pages
                self._table_dirty = True
                self._handles[s] = h
                cache, mask = self._cache, self._mask_join
            positions = _prefill_positions(np.asarray([off], np.int64), P_b,
                                           module)
            _check_positions(module, positions)
            if self.watchdog is not None:
                self.watchdog.arm("runner.decode.join")
            # positions offset past the cached prefix (zero when cold):
            # data at the same (1, prompt_bucket) signature, so a hit join
            # replays the cold join's program
            last, _ = self._prefill1(
                torch.from_numpy(toks), torch.from_numpy(positions),
                torch.tensor([suffix], dtype=torch.int64),
                torch.from_numpy(jtable).to(dev), cache)
            mask.zero_()
            tok_d, fin_d = self._sample1(last, mask)
            got = torch.stack([tok_d, fin_d.to(torch.int32)]).cpu().numpy()
            if self.watchdog is not None:
                self.watchdog.disarm()
            tok0, fin0 = int(got[0, 0]), bool(got[1, 0])
            with self._elock:
                if self._torn:
                    return          # the teardown released this slot
                runner._c_batches["decode"].inc()
                now = self.clock()
                h.status = "live"
                h.t_first_s = now
                # exemplar: the request's trace id rides the handle
                self._h_ttft.observe(max(0.0, now - h.t_submit_s),
                                     h.trace_id)
                self._c_joined.inc()
                self.joined += 1
                self._live += 1
                self._lens[s] = h.length
                self._emitted[s] = 1
                self._tok[s] = tok0
                self._fin[s] = fin0
                self._tok_dev = None     # splice mutated host state
                self._fin_dev = None
                h.tokens.append(tok0)
                if h.cost is not None:
                    h.cost.decode_tokens += 1
                runner._c_decode_tokens.inc()
                runner._c_rows["decode"].inc()
                if fin0 or h.max_new_tokens <= 1:
                    self._release(s, "ok", leavers)

    def _advance(self, leavers: List[StreamHandle]) -> None:
        """One greedy step over the batch: deadline leaves first (never
        spend a step on a dead client), page-boundary extends (a denial
        leaves the slot with its partial generation), then the forward
        and the ONE host fetch of the step's tokens and finished flags."""
        runner = self.runner
        module, dev = runner.module, runner.device
        with self._elock:
            if self._torn:
                return
            now = self.clock()
            for s, h in enumerate(self._handles):
                if h is not None and h.deadline_s is not None \
                        and now > h.deadline_s:
                    self._release(s, "expired", leavers)
            if not self._live:
                return
            pos = np.zeros(self.slots, np.int64)
            for s, h in enumerate(self._handles):
                if h is None:
                    continue
                p = int(self._lens[s] + self._emitted[s] - 1)
                pos[s] = p
                pi = p // self.page_size
                needs_page = pi >= len(h.pages)
                # step-site CoW guard: this step writes position p; if the
                # page holding p is shared (refcount>1) the write must land
                # on a private copy
                needs_cow = (not needs_page and self.index is not None
                             and self.pool.refcount(h.pages[pi]) > 1)
                if needs_page or needs_cow:
                    try:
                        if needs_cow:
                            _, new_page = runner._cow_split_page(
                                self.pool, self.index, self._cache,
                                h.pages[pi])
                        else:
                            new_page = runner._alloc_with_reclaim(
                                self.pool, self.index, 1, op="extend")[0]
                    except PagePoolExhausted:
                        # mid-flight denial: the slot leaves with what it
                        # has, its pages fund the survivors
                        self._release(s, "denied", leavers)
                        continue
                    if needs_cow:
                        h.pages[pi] = new_page
                    else:
                        h.pages.append(new_page)
                        if h.cost is not None:
                            h.cost.page_edge(now, 1)
                    self._table[s, pi] = new_page
                    self._table_dirty = True
            if not self._live:
                return
            _check_positions(module, pos)
            if self._table_dirty or self._table_dev is None:
                self._table_dev = torch.from_numpy(self._table).to(dev)
                self._table_dirty = False
            tok_in = self._tok_dev if self._tok_dev is not None \
                else torch.from_numpy(self._tok).to(dev)
            fin_in = self._fin_dev
            if fin_in is None:
                # the donated mask keeps its storage: the host state is
                # copied into it
                fin_in = self._mask_step
                fin_in.copy_(torch.from_numpy(self._fin))
            table_dev, cache = self._table_dev, self._cache
        if self.watchdog is not None:
            # the armed section covers the forward AND the host fetch
            # below — both are the hang shapes
            self.watchdog.arm("runner.decode.step")
        t_disp0 = time.perf_counter()
        tok_d, fin_d, _ = self._step(tok_in, torch.from_numpy(pos),
                                     table_dev, fin_in, cache)
        # the forward above is the host enqueue; the fetch below IS the
        # device wait (already a sync), so timing it costs one clock read
        disp_s = time.perf_counter() - t_disp0
        t_dev0 = time.perf_counter()
        got = torch.stack([tok_d, fin_d.to(torch.int32)]).cpu().numpy()
        dev_s = time.perf_counter() - t_dev0
        if self.watchdog is not None:
            self.watchdog.disarm()
        with self._elock:
            if self._torn:
                return              # the teardown released every slot
            runner._h_phase_dispatch.observe(disp_s)
            self._tok_dev, self._fin_dev = tok_d, fin_d
            tok, fin = got[0], got[1].astype(bool)
            self.steps += 1
            dte = runner.device_time_every
            if dte and self.steps % dte == 0:
                runner._h_phase_device.observe(dev_s)
            runner._c_decode_steps.inc()
            # attribution: the step's host-observed device work (enqueue +
            # device wait) is amortized over the slots that had a live
            # request behind them; the rest of the width was pad cells
            live = self._live
            step_s = disp_s + dev_s
            share = step_s / live if live else 0.0
            if step_s > 0:
                self._c_device_s.inc(step_s)
            pad = self.slots - live
            if pad > 0:
                self._c_tok_outcome.inc(pad, outcome="pad_row")
            for s, h in enumerate(self._handles):
                if h is None:
                    continue
                self._tok[s] = tok[s]
                self._fin[s] = bool(fin[s])
                self._emitted[s] += 1
                h.tokens.append(int(tok[s]))
                if h.cost is not None:
                    h.cost.decode_tokens += 1
                    h.cost.device_s += share
                runner._c_decode_tokens.inc()
                if self._fin[s] or len(h.tokens) >= h.max_new_tokens:
                    self._release(s, "ok", leavers)

    def _release(self, s: int, outcome: str,
                 leavers: List[StreamHandle]) -> None:
        """Leave: free the slot's pages mid-flight, reset it to pad-row
        state (trash table row, finished), and hand the slot back to
        admission — the batch keeps stepping around it.  Called with the
        engine lock held."""
        h = self._handles[s]
        if h is None:
            return
        self._handles[s] = None
        h.status = outcome
        if h.cost is not None:
            # terminal classification: every token this request generated
            # lands in exactly one outcome bucket
            h.cost.close_pages(self.clock())
            if h.cost.decode_tokens > 0:
                self._c_tok_outcome.inc(h.cost.decode_tokens,
                                        outcome=self._outcome_map[outcome])
        if h.pages:
            if outcome == "ok" and self.index is not None and h.tokens:
                # prefix retention: a cleanly finished request donates its
                # pages to the index keyed by every position actually
                # WRITTEN — prompt + generated[:-1] (the final sampled
                # token's k/v was never written)
                ids = np.concatenate(
                    [h.prompt, np.asarray(h.tokens[:-1], np.int32)])
                self.index.release(ids, h.pages)
            else:
                self.pool.free(h.pages)
            h.pages = []
        self._table[s, :] = 0
        self._table_dirty = True
        self._fin[s] = True
        self._tok[s] = 0
        self._lens[s] = 1
        self._emitted[s] = 0
        self._tok_dev = None     # host state mutated: next step
        self._fin_dev = None     # re-uploads instead of reusing device copies
        self._c_left[outcome].inc()
        self.left += 1
        self._live -= 1
        leavers.append(h)
        with self._cond:
            self._free.append(s)
            self._book_occupancy()
            self._cond.notify_all()

    # ------------------------------------------------------------- postmortem
    def debug_state(self) -> Dict[str, Any]:
        """JSON-able engine state for the flight recorder: the slot table,
        per-slot progress, and pool occupancy.  Read under the admission
        lock so a dump mid-join sees a consistent table."""
        with self._cond:
            slots = []
            for s in range(self.slots):
                h = self._handles[s]
                slots.append({
                    "slot": s,
                    "live": h is not None,
                    "status": None if h is None else h.status,
                    "length": int(self._lens[s]),
                    "emitted": int(self._emitted[s]),
                    "finished": bool(self._fin[s]),
                    "pages": list(map(int, self._table[s]))})
            state = {
                "runner": self._name,
                "slots": self.slots,
                "occupancy": self.slots - len(self._free),
                "live": self._live,
                "queued_arrivals": len(self._arrivals),
                "steps": self.steps,
                "joined": self.joined,
                "left": self.left,
                "closed": self._closed,
                "draining": self._draining,
                "abort_reason": self.abort_reason,
                "slot_table": slots,
            }
        if self.watchdog is not None:
            state["watchdog"] = self.watchdog.as_dict()
        state["pool"] = {
            "page_size": self.pool.page_size,
            "capacity": self.pool.capacity,
            "pages_in_use": self.pool.pages_in_use(),
            "occupancy_pct": round(self.pool.occupancy_pct(), 2)}
        if self.index is not None:
            state["prefix_cache"] = self.index.stats()
        return state

    # -------------------------------------------------------------- lifecycle
    def start(self) -> "ContinuousDecoder":
        """Run the engine on a background thread: steps while any slot is
        live, sleeps on the condition otherwise."""
        with self._cond:
            if self._torn:
                raise RuntimeError("decoder is closed — build a fresh "
                                   "stream (decode_stream()) instead")
            if self._thread is not None:
                return self
            self._closed = False
            self._thread = threading.Thread(
                target=self._run, daemon=True,
                name=f"mmlspark-decode-stream-{self._name}")
            self._thread.start()
        if self.watchdog is not None:
            # monitor thread mode: a test driving step() manually on a
            # FakeClock skips start() and polls watchdog.check() itself
            self.watchdog.start()
        return self

    def _run(self) -> None:
        # the current card is thread-local: select the runner's here
        if self.runner.device.type == "cuda":
            torch.cuda.set_device(self.runner.device)
        while True:
            with self._cond:
                while not self._closed and not self._arrivals \
                        and self._live == 0:
                    self._cond.wait(0.1)
                if self._closed:
                    return
            try:
                self.step()
            except Exception:  # noqa: BLE001 — a poisoned step must not
                self._abort()  # strand clients on done.wait
                raise

    def _stall_abort(self, label: str, elapsed: float) -> None:
        """Watchdog trip (runs on the MONITOR thread — the engine thread
        is stuck inside the hung dispatch): mark the abort as a stall
        FIRST, so the on_done callbacks the teardown fires read it and
        shed 503 ``shed_engine_stall`` instead of erroring 500, then
        poison-abort — in-flight handles resolve, pages free, and the
        borrowed slabs drop (a forward may still be writing them)."""
        self.abort_reason = "stall"
        self._abort()

    def _abort(self) -> None:
        """Engine failure: resolve every queued/live handle as ``error``
        and drop the borrowed slabs (their state is unknown — the next
        borrower builds fresh ones)."""
        if self.abort_reason is None:
            self.abort_reason = "error"
        with self._cond:
            self._closed = True
            self._poisoned = True
            # the engine thread is exiting through this very call (or is
            # wedged): clear the handle so close() does not join it
            self._thread = None
            self._cond.notify_all()
        self._teardown("error")

    def _teardown(self, outcome: str) -> None:
        """Release every queued/live handle with ``outcome`` and return
        (or drop, when poisoned) the borrowed slabs.  Claimed exactly
        once — ``_abort`` on the engine or monitor thread and ``close()``
        on the caller can otherwise race the release loop into
        double-freed pages and a twice-listed free slot."""
        leavers: List[StreamHandle] = []
        with self._elock:
            with self._cond:
                if self._torn:
                    return
                self._torn = True
                arrivals = list(self._arrivals)
                self._arrivals.clear()
            for h in arrivals:
                self._cancel_arrival(h, outcome, leavers)
            for s, h in enumerate(self._handles):
                if h is not None:
                    self._release(s, outcome, leavers)
            cache, self._cache = self._cache, None
        self._finish(leavers)
        if cache is not None:
            self.pool.return_cache(None if self._poisoned else cache)
        if self.watchdog is not None:
            # the engine is gone — nothing left to watch.  stop() is safe
            # from the monitor thread itself (stall-abort path)
            self.watchdog.disarm()
            self.watchdog.stop()

    def _cancel_arrival(self, h: StreamHandle, outcome: str,
                        leavers: List[StreamHandle]) -> None:
        h.status = outcome
        if h.cost is not None:
            # a cancelled arrival never joined: zero decode tokens, so no
            # outcome booking — only its reserved page-seconds close out
            h.cost.close_pages(self.clock())
        if h.pages:
            self.pool.free(h.pages)
            h.pages = []
        self._c_left[outcome].inc()
        self.left += 1
        leavers.append(h)
        with self._cond:
            self._free.append(h.slot)
            self._book_occupancy()

    def drain(self, timeout_s: Optional[float] = None,
              poll_s: float = 0.05) -> bool:
        """Graceful wind-down: stop admitting — ``submit`` sheds
        :class:`EngineDraining` from here on — let queued arrivals and
        live slots run to eos/budget/deadline, then :meth:`close`.

        Returns True when every slot finished inside ``timeout_s`` (None
        = wait indefinitely), False when the timeout cut the wait short —
        ``close()`` then cancels the survivors (partial tokens stay on
        their handles).  Needs the :meth:`start` engine thread (or a
        concurrent external ``step()`` driver) to make progress."""
        with self._cond:
            self._draining = True
        deadline = None if timeout_s is None else self.clock() + timeout_s
        drained = False
        with self._cond:
            while not self._torn:
                if len(self._free) == self.slots and not self._arrivals:
                    drained = True
                    break
                if deadline is not None and self.clock() >= deadline:
                    break
                self._cond.wait(poll_s)
        self.close()
        return drained

    def close(self) -> None:
        """Stop the engine, cancel queued arrivals and live slots (partial
        tokens stay on their handles), free their pages, and return the
        borrowed device slabs to the pool.  A closed decoder is final —
        holders rebuild (``_RunnerScorer._ensure_decoder`` does)."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
            thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=60)
        self._teardown("cancelled")


def _resolve_takes_cost(resolve: Callable) -> bool:
    """Whether a serving ``resolve`` callback accepts the ``cost=`` kwarg.
    Introspected per request terminal, so older callers (the streaming
    facade, out-of-tree fronts) keep working unchanged."""
    import inspect
    try:
        sig = inspect.signature(resolve)
    except (TypeError, ValueError):
        return False
    for p in sig.parameters.values():
        if p.kind is inspect.Parameter.VAR_KEYWORD or p.name == "cost":
            return True
    return False


class _RunnerScorer(Transformer):
    """Private serving front: built by :meth:`ModelRunner.scorer`, scored by
    ``PipelineServer`` / the streaming facade.  Not a registered stage —
    it is constructed programmatically around a live runner, never from
    params."""

    def __init__(self, runner: ModelRunner, input_col: str, reply_col: str,
                 prepare: Optional[Callable], encode: Optional[Callable],
                 mode: str, decode_kwargs: Dict[str, Any],
                 continuous: bool = False, report_ttft: bool = False,
                 supervisor=None):
        super().__init__()
        self.runner = runner
        self.input_col, self.reply_col = input_col, reply_col
        self.prepare = prepare or (lambda v: np.asarray(v, np.float32))
        self.encode = encode or (lambda y: y)
        self.mode = mode
        self.decode_kwargs = dict(decode_kwargs)
        self.continuous = bool(continuous)
        self.report_ttft = bool(report_ttft)
        self._decoder: Optional[ContinuousDecoder] = None
        self._dec_lock = make_lock("_RunnerScorer._dec_lock")
        #: duck-typed health signal: PipelineServer's /health reads it — a
        #: quarantined runner flips it False
        self.serving_healthy = True
        self.supervisor = None
        if self.continuous:
            if mode != "decode":
                raise ValueError("continuous=True requires mode='decode' "
                                 "(scoring rows already admit into the "
                                 "server's in-flight drain)")
            # instance attribute, not a class method: its PRESENCE is the
            # protocol — PipelineServer/streaming route entries here only
            # when the model exposes it
            self.continuous_submit = self._continuous_submit
            # supervised engine recovery: rebuilds after an abort ride
            # capped exponential backoff; repeated stalls quarantine the
            # runner (serving_healthy -> False)
            from ..utils.resilience import RestartSupervisor
            self.supervisor = supervisor if supervisor is not None else \
                RestartSupervisor(
                    clock=self.decode_kwargs.get("clock") or time.monotonic)
            self._pending_restart = False
            self._c_restarts = runner.registry.counter(
                "mmlspark_engine_restarts_total",
                "supervised decode-engine rebuilds after an abort/stall",
                labels=("runner",)).labels(runner=runner.name)

    # ---------------------------------------------------- continuous protocol
    def _ensure_decoder(self) -> ContinuousDecoder:
        with self._dec_lock:
            dec = self._decoder
            if dec is not None and not dec.closed:
                return dec
            if dec is not None:
                # the engine died under us: the first observer books the
                # death; the backoff below gates every rebuilder, so a
                # request storm cannot thrash rebuild-abort cycles
                self._decoder = None
                self.supervisor.note_failure(dec.abort_reason or "error")
                self._pending_restart = True
            if self.supervisor.quarantined:
                self.serving_healthy = False
                raise EngineUnavailable(
                    "decode engine quarantined after repeated stalls",
                    reason="engine_quarantined",
                    retry_after_s=self.supervisor.retry_after_s())
            wait = self.supervisor.retry_after_s()
            if wait > 0:
                raise EngineUnavailable(
                    f"decode engine restarting; backoff {wait:.2f}s left",
                    reason="engine_restarting",
                    retry_after_s=max(0.1, wait))
            self._decoder = self.runner.decode_stream(
                **self.decode_kwargs).start()
            if self._pending_restart:
                self._pending_restart = False
                self.supervisor.note_restart()
                self._c_restarts.inc()
            return self._decoder

    def continuous_close(self) -> None:
        """Stop the owned decode stream (PipelineServer.stop() calls this
        when present); a later request lazily reopens it."""
        with self._dec_lock:
            decoder, self._decoder = self._decoder, None
        if decoder is not None:
            decoder.close()
            if self.supervisor is not None:
                # a clean operator close is engine health, not failure
                self.supervisor.note_success()

    def continuous_drain(self, timeout_s: Optional[float] = None) -> bool:
        """Graceful wind-down of the owned stream: no new joins, existing
        slots run to eos/budget, then close.  Returns True when every
        in-flight slot finished inside ``timeout_s``.  A later request
        lazily reopens a fresh engine (a drain is a clean close — no
        restart backoff)."""
        with self._dec_lock:
            decoder, self._decoder = self._decoder, None
        if decoder is None:
            return True
        drained = decoder.drain(timeout_s=timeout_s)
        if self.supervisor is not None:
            self.supervisor.note_success()
        return drained

    def _reply_body(self, tokens, ttft_s: Optional[float]):
        body = self.encode(np.asarray(tokens, np.int32))
        if isinstance(body, np.ndarray):
            # the default identity encode would otherwise reach the HTTP
            # writer as an ndarray
            body = body.tolist()
        if self.report_ttft:
            body = {"tokens": body,
                    "ttft_ms": None if ttft_s is None
                    else round(1000.0 * ttft_s, 3)}
        return body

    def _continuous_submit(self, payload, resolve, queue_age_s=0.0,
                           deadline_budget_s=None, trace_id=None,
                           prompt_hash=None) -> None:
        """The serving seam: admit ONE request into the in-flight batch.
        ``resolve(reply=, status=, verdict=, retry_after_s=, ttft_s=)``
        fires on the engine thread at the request's terminal outcome;
        admission failures raise out of here with ``.shed`` set so the
        caller sheds 503 + Retry-After.  The caller's timing crosses the
        seam as relative durations (``queue_age_s``, ``deadline_budget_s``),
        never absolute timestamps.  Reported TTFT = queue age + the
        engine's submit-to-first-token."""
        decoder = self._ensure_decoder()
        prompt = np.asarray(payload, np.int32).reshape(-1)
        deadline_s = None if deadline_budget_s is None \
            else decoder.clock() + max(0.0, deadline_budget_s)
        pre_s = max(0.0, queue_age_s or 0.0)
        takes_cost = _resolve_takes_cost(resolve)

        def on_done(h: StreamHandle) -> None:
            kw = {}
            if h.cost is not None:
                h.cost.queue_s = pre_s
                if takes_cost:
                    kw["cost"] = h.cost
            if h.status == "ok":
                ttft_s = None if h.ttft_s is None else pre_s + h.ttft_s
                resolve(reply=self._reply_body(h.tokens, ttft_s),
                        status=200, verdict="ok", ttft_s=ttft_s, **kw)
            elif h.status == "denied":
                resolve(reply={"error": "shed: page pool exhausted "
                                        "mid-decode"},
                        status=503, verdict="shed_page_pool",
                        retry_after_s=1.0, **kw)
            elif h.status == "expired":
                resolve(reply={"error": "deadline expired mid-decode"},
                        status=504, verdict="deadline_expired_decoding",
                        **kw)
            elif decoder.abort_reason == "stall":
                # the watchdog killed a hung dispatch under this request:
                # a retryable 503, not a 500
                resolve(reply={"error": "shed: decode engine stalled"},
                        status=503, verdict="shed_engine_stall",
                        retry_after_s=1.0, **kw)
            else:  # cancelled / error — the engine went away under us
                resolve(reply={"error": f"decode {h.status}"},
                        status=500, verdict="error", **kw)

        decoder.submit(prompt, deadline_s=deadline_s, on_done=on_done,
                       trace_id=trace_id, prompt_hash=prompt_hash)

    # ------------------------------------------------------------- batch path
    def _decode_batch(self, col, n: int, out: np.ndarray, age) -> None:
        """Ticked/batch decode: one one-shot decode over the drained rows.
        Mid-decode page denials surface per row as :class:`ShedReply`;
        ``report_ttft`` wraps replies with the honest ticked TTFT — the
        full latency (queue age at drain + decode wall)."""
        t0 = time.monotonic()
        prompts = [np.asarray(v, np.int32).reshape(-1) for v in col]
        lengths = np.asarray([len(q) for q in prompts], np.int32)
        P = int(lengths.max())
        stacked = np.zeros((n, P), np.int32)
        for i, q in enumerate(prompts):
            stacked[i, :len(q)] = q
        res = self.runner.decode(stacked, lengths=lengths,
                                 **self.decode_kwargs)
        denied = set((res.extras or {}).get("denied_rows", ()))
        wall_s = time.monotonic() - t0
        for i in range(n):
            if i in denied:
                out[i] = ShedReply("page pool exhausted mid-decode")
            elif age is not None:
                out[i] = self._reply_body(
                    res.tokens[i], max(0.0, float(age[i])) + wall_s)
            else:
                out[i] = self._reply_body(res.tokens[i], None)

    def _decode_batch_continuous(self, col, n: int, out: np.ndarray,
                                 age) -> None:
        """Batch front of a continuous scorer (streaming fallback, batch
        transform): rows ride the live stream — submit each into a slot,
        waiting for a free one when the batch is wider than the engine."""
        decoder = self._ensure_decoder()
        handles: List[Optional[StreamHandle]] = [None] * n
        outstanding: List[StreamHandle] = []
        for i in range(n):
            prompt = np.asarray(col[i], np.int32).reshape(-1)
            while True:
                try:
                    handles[i] = decoder.submit(prompt)
                    outstanding.append(handles[i])
                    break
                except SlotsExhausted:
                    # wait for capacity instead of shedding our own batch
                    if outstanding:
                        outstanding.pop(0).done.wait()
                    else:
                        time.sleep(0.005)
                except PagePoolExhausted as ex:
                    out[i] = ShedReply(str(ex))
                    break
        for i in range(n):
            h = handles[i]
            if h is None:
                continue
            h.done.wait()
            if h.status == "ok":
                pre_s = max(0.0, float(age[i])) if age is not None else 0.0
                out[i] = self._reply_body(
                    h.tokens, None if h.ttft_s is None
                    else pre_s + h.ttft_s)
            else:
                out[i] = ShedReply(f"decode {h.status}")

    def _transform(self, df: DataFrame) -> DataFrame:
        def per_part(p):
            col = p[self.input_col]
            n = len(col)
            out = np.empty(n, dtype=object)
            if n == 0:
                return {**p, self.reply_col: out}
            age = p.get("_enq_age_s") if hasattr(p, "get") else None
            if self.mode == "decode" and self.continuous:
                self._decode_batch_continuous(col, n, out, age)
            elif self.mode == "decode":
                self._decode_batch(col, n, out, age)
            else:
                x = np.stack([self.prepare(v) for v in col])
                y = self.runner.apply_batch(x, front="serving")
                for i in range(n):
                    out[i] = self.encode(y[i])
            return {**p, self.reply_col: out}

        return df.map_partitions(per_part)

    def transform_schema(self, schema):
        schema.require(self.input_col)
        return schema.add(self.reply_col, ColumnType.VECTOR)

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
