"""Cross-request prefix cache — radix index over page-granular token chunks.

An own copy of the JAX package's ``models/prefix_cache.py``, verbatim
apart from module paths.  Millions of requests share system prompts and templates, so most prefill
work recomputes KV state already resident in the :class:`~.runner.PagePool`.
This module is the index half of the prefix-caching tentpole: a radix trie
over **page-granular token chunks** of completed prompts, mapping each chunk
to the resident physical page holding its k/v.  The pool half (refcounts,
pin-on-hit, copy-on-write splits) lives in ``models/runner.py``.

Match rule
----------
Lookup walks full ``page_size``-token chunks from the root — a chunk matches
only byte-exactly, so a hit is always **page-aligned**.  The final partial
page of a retained prompt is kept as a *tail* on its last full-chunk node;
lookup extends a full-chunk match token-wise into the tail, so two prompts
sharing a template that ends mid-page still share that page (the divergent
write there is what the pool's copy-on-write split handles).  The covered
length is always capped at ``len(prompt) - 1``: the final prompt position is
the logits source for the first generated token and is always recomputed,
which keeps the suffix prefill non-empty (the same prefill call shape,
~one token of device work on a full hit) and the greedy tokens bit-identical to a
cold decode.

Lifecycle
---------
- **retain** (:meth:`PrefixIndex.release`): a finished request's pages are
  handed to the index instead of the free list — the index takes over the
  request's reference, so retention is free (no copy) and an entry's page
  can simultaneously back live requests (refcount > 1).
- **pin** (:meth:`PrefixIndex.lookup`): a hit pins the matched pages under
  the index lock, atomically with respect to eviction — an entry is never
  evicted out from under an admission that just matched it.
- **evict**: entries are evicted leaf-first in LRU order from a bounded
  ``budget_pages`` budget, and on demand under pool pressure
  (:meth:`evict_pages`).  Eviction drops only the INDEX's reference; a page
  shared with a live request stays resident until that request frees it —
  eviction under pressure can never yank a live page table's pages.
- **flush** (``reason="pool_replaced"``): ``PagePool.resized()`` flushes the
  index before building its successor — index entries name physical page
  ids of the old pool's slabs, and a dangling entry surviving a resize
  would hand freed page ids out against the replacement's memory.

Locking: the index lock is always taken BEFORE the pool lock (lookup pins,
release/evict free — both under the index lock).  Nothing in the pool calls
back into the index, so the sanitizer-checked lock order is acyclic.
"""
from __future__ import annotations

import itertools
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from ..utils.concurrency import make_lock

__all__ = ["PrefixIndex", "prefix_instruments"]


def prefix_instruments(registry=None) -> Dict[str, Any]:
    """Register (idempotently) and return the prefix-cache metric families.
    ``ModelRunner`` construction calls this so the families exist — and the
    telemetry-coverage sweep gates on them — even for runners that never
    enable the cache; :class:`PrefixIndex` binds the children."""
    if registry is None:
        from ..observability import get_registry
        registry = get_registry()
    return {
        "hits": registry.counter(
            "mmlspark_prefix_hits_total",
            "admission lookups that matched a cached prefix (>= 1 page)",
            labels=("runner",)),
        "misses": registry.counter(
            "mmlspark_prefix_misses_total",
            "admission lookups that matched nothing — full prefill",
            labels=("runner",)),
        "evictions": registry.counter(
            "mmlspark_prefix_evictions_total",
            "retained pages evicted from the prefix index, by reason "
            "(lru = budget, pressure = pool reclaim, pool_replaced = "
            "resize flush)", labels=("runner", "reason")),
        "cow_splits": registry.counter(
            "mmlspark_prefix_cow_splits_total",
            "shared pages split copy-on-write at the first divergent "
            "token write", labels=("runner",)),
        "hit_tokens": registry.counter(
            "mmlspark_prefix_hit_tokens_total",
            "prompt tokens whose prefill was skipped via a cached prefix "
            "(the cost ledger's prefill_cached lane)", labels=("runner",)),
        "hit_rate": registry.gauge(
            "mmlspark_prefix_hit_rate_pct",
            "lifetime prefix-lookup hit rate (hits / lookups)",
            labels=("runner",)),
        "retained": registry.gauge(
            "mmlspark_prefix_retained_pages",
            "pages currently retained by the prefix index (bounded by the "
            "budget_pages knob)", labels=("runner",)),
    }


class _Node:
    """One page-granular chunk of a retained prompt: ``chunk`` (the token
    bytes) under ``parent`` maps to physical ``page``; ``tail`` optionally
    holds the retained prompt's final partial page as ``(page, tokens)``."""

    __slots__ = ("id", "key", "chunk", "page", "parent", "nchildren",
                 "tail", "last_used")

    def __init__(self, nid: int, key, chunk: bytes, page: int, parent,
                 now: float):
        self.id = nid
        self.key = key
        self.chunk = chunk
        self.page = int(page)
        self.parent = parent           # _Node or None (root-level)
        self.nchildren = 0
        self.tail: Optional[Tuple[int, Tuple[int, ...]]] = None
        self.last_used = now


class PrefixIndex:
    """Radix trie mapping page-granular prompt chunks to resident pages.

    One index per :class:`~.runner.PagePool` (``pool.prefix_index``),
    created by ``ModelRunner.prefix_cache``.  All methods are thread-safe;
    pool operations (pin/free) happen under the index lock, index-lock ->
    pool-lock order."""

    def __init__(self, pool, *, budget_pages: int = 64,
                 name: str = "model", registry=None,
                 clock: Callable[[], float] = time.monotonic):
        if budget_pages < 1:
            raise ValueError(f"budget_pages must be >= 1, got {budget_pages}")
        self.pool = pool
        self.budget_pages = int(budget_pages)
        self.name = name
        self._clock = clock
        self._lock = make_lock("PrefixIndex._lock")
        self._ids = itertools.count(1)     # node id 0 is the root
        self._nodes: Dict[Tuple[int, bytes], _Node] = {}
        self._root_tail: Optional[Tuple[int, Tuple[int, ...]]] = None
        self._root_tail_t = 0.0
        self._retained = 0                 # pages held by entries + tails
        self._hits = 0
        self._misses = 0
        inst = prefix_instruments(registry)
        self._c_hits = inst["hits"].labels(runner=name)
        self._c_misses = inst["misses"].labels(runner=name)
        self._c_evict = inst["evictions"]
        self._c_cow = inst["cow_splits"].labels(runner=name)
        self._c_hit_tokens = inst["hit_tokens"].labels(runner=name)
        self._g_hit_rate = inst["hit_rate"]
        self._g_retained = inst["retained"]
        self._book_gauges_locked()

    # ------------------------------------------------------------- booking
    def _book_gauges_locked(self) -> None:
        total = self._hits + self._misses
        rate = 100.0 * self._hits / total if total else 0.0
        self._g_hit_rate.set(rate, runner=self.name)
        self._g_retained.set(float(self._retained), runner=self.name)

    def book_cow(self, n: int = 1) -> None:
        """Book copy-on-write splits (called by the pool-side split that
        routes a divergent write to a private copy)."""
        self._c_cow.inc(n)

    # -------------------------------------------------------------- lookup
    def lookup(self, tokens) -> Tuple[List[int], int]:
        """Longest cached prefix of ``tokens``: returns ``(pages,
        covered)`` where ``pages`` back prompt positions ``[0, covered)``
        and are PINNED on the caller's behalf (free them, or hand them to
        :meth:`release`, when the request terminates).  ``covered`` is
        capped at ``len(tokens) - 1`` — the final prompt position is always
        recomputed (see module docstring), so a miss returns ``([], 0)``
        and a full hit leaves a one-token suffix."""
        toks = np.asarray(tokens, dtype=np.int32).ravel()
        length = int(toks.size)
        ps = self.pool.page_size
        with self._lock:
            now = self._clock()
            pages: List[int] = []
            covered = 0
            node: Optional[_Node] = None
            pid = 0
            for ci in range(length // ps):
                nxt = self._nodes.get(
                    (pid, toks[ci * ps:(ci + 1) * ps].tobytes()))
                if nxt is None:
                    break
                node, pid = nxt, nxt.id
                nxt.last_used = now
                pages.append(nxt.page)
                covered += ps
            # tail extension: the retained prompt's final partial page —
            # matched token-wise, so divergence mid-page still shares the
            # agreeing slots (the CoW leg recomputes the rest)
            tail = node.tail if node is not None else self._root_tail
            if tail is not None and covered == len(pages) * ps \
                    and covered < length:
                tpage, ttoks = tail
                rem = toks[covered:]
                k = 0
                while k < len(ttoks) and k < rem.size \
                        and int(rem[k]) == ttoks[k]:
                    k += 1
                if k > 0:
                    pages.append(tpage)
                    covered += k
                    if node is not None:
                        node.last_used = now
                    else:
                        self._root_tail_t = now
            covered = min(covered, length - 1)
            if covered <= 0:
                pages, covered = [], 0
            else:
                pages = pages[:-(-covered // ps)]
            if pages:
                # pin under the index lock: atomic against eviction
                self.pool.pin(pages)
                self._hits += 1
                self._c_hits.inc()
                self._c_hit_tokens.inc(covered)
            else:
                self._misses += 1
                self._c_misses.inc()
            self._book_gauges_locked()
            return list(pages), int(covered)

    # ------------------------------------------------------------ retention
    def release(self, tokens, pages) -> None:
        """Terminal hand-off: ``pages`` back the k/v of ``tokens`` (the
        prompt plus every generated token that was fed back — the final
        sampled token's k/v is never written).  New chunks transfer the
        caller's page reference to the index; chunks already retained
        (including the very pages this request pinned at admission) drop
        the caller's reference instead.  Anything left over is freed.
        Enforces the LRU budget afterwards."""
        toks = np.asarray(tokens, dtype=np.int32).ravel()
        length = int(toks.size)
        pages = [int(p) for p in pages]
        ps = self.pool.page_size
        nfull = min(length // ps, len(pages))
        with self._lock:
            now = self._clock()
            node: Optional[_Node] = None
            pid = 0
            surplus: List[int] = []
            for ci in range(nfull):
                chunk = toks[ci * ps:(ci + 1) * ps].tobytes()
                key = (pid, chunk)
                ex = self._nodes.get(key)
                if ex is not None:
                    # chunk already cached (often literally the page we
                    # pinned at admission): drop OUR reference
                    surplus.append(pages[ci])
                    ex.last_used = now
                    node, pid = ex, ex.id
                else:
                    nid = next(self._ids)
                    fresh = _Node(nid, key, chunk, pages[ci], node, now)
                    self._nodes[key] = fresh
                    if node is not None:
                        node.nchildren += 1
                    self._retained += 1   # reference transferred to us
                    node, pid = fresh, nid
            rest = pages[nfull:]
            tail_toks = toks[nfull * ps:]
            if tail_toks.size > 0 and rest:
                holder = node.tail if node is not None else self._root_tail
                if holder is None:
                    tail = (rest[0], tuple(int(t) for t in tail_toks))
                    if node is not None:
                        node.tail = tail
                    else:
                        self._root_tail, self._root_tail_t = tail, now
                    self._retained += 1
                    rest = rest[1:]
                # else: an equivalent-or-diverged tail is already retained
                # (first-wins); our copy is surplus
            surplus.extend(rest)
            if surplus:
                self.pool.free(surplus)
            self._enforce_budget_locked()
            self._book_gauges_locked()

    # ------------------------------------------------------------- eviction
    def _evict_node_locked(self, node: _Node, reason: str) -> int:
        """Remove one leaf entry (page + any tail), freeing the index's
        references.  Returns pages whose refcount hit zero (actual
        free-list gain — a page shared with a live request stays
        resident)."""
        freed = [node.page]
        if node.tail is not None:
            freed.append(node.tail[0])
            node.tail = None
        del self._nodes[node.key]
        if node.parent is not None:
            node.parent.nchildren -= 1
        gained = sum(1 for p in freed if self.pool.refcount(p) == 1)
        self._retained -= len(freed)
        self.pool.free(freed)
        self._c_evict.labels(runner=self.name, reason=reason).inc(len(freed))
        return gained

    def _evict_root_tail_locked(self, reason: str) -> int:
        tail, self._root_tail = self._root_tail, None
        gained = 1 if self.pool.refcount(tail[0]) == 1 else 0
        self._retained -= 1
        self.pool.free([tail[0]])
        self._c_evict.labels(runner=self.name, reason=reason).inc(1)
        return gained

    def _lru_candidates_locked(self):
        cands = [(n.last_used, 0, n) for n in self._nodes.values()
                 if n.nchildren == 0]
        if self._root_tail is not None:
            cands.append((self._root_tail_t, 1, None))
        cands.sort(key=lambda c: (c[0], c[1]))
        return cands

    def _enforce_budget_locked(self, reason: str = "lru") -> None:
        while self._retained > self.budget_pages:
            cands = self._lru_candidates_locked()
            if not cands:
                break
            _, _, node = cands[0]
            if node is None:
                self._evict_root_tail_locked(reason)
            else:
                self._evict_node_locked(node, reason)

    def evict_pages(self, n: int, reason: str = "pressure") -> int:
        """Evict LRU entries until ``n`` pages actually return to the free
        list (refcount-0 retentions), or nothing evictable remains.
        Returns the free-list gain — callers retry their allocation only
        when it is > 0."""
        gained = 0
        with self._lock:
            while gained < n:
                cands = self._lru_candidates_locked()
                if not cands:
                    break
                _, _, node = cands[0]
                if node is None:
                    gained += self._evict_root_tail_locked(reason)
                else:
                    gained += self._evict_node_locked(node, reason)
            self._book_gauges_locked()
        return gained

    def flush(self, reason: str = "pool_replaced") -> int:
        """Evict EVERYTHING (booked under ``reason``) — the pool-resize
        seam: no entry may survive into a successor pool's page-id space.
        Returns pages released."""
        with self._lock:
            freed: List[int] = []
            for node in self._nodes.values():
                freed.append(node.page)
                if node.tail is not None:
                    freed.append(node.tail[0])
            if self._root_tail is not None:
                freed.append(self._root_tail[0])
                self._root_tail = None
            self._nodes.clear()
            self._retained = 0
            if freed:
                self.pool.free(freed)
                self._c_evict.labels(runner=self.name,
                                     reason=reason).inc(len(freed))
            self._book_gauges_locked()
            return len(freed)

    def rebind(self, pool) -> None:
        """Point the (flushed) index at a successor pool — called by
        ``PagePool.resized()`` after the flush."""
        with self._lock:
            if self._nodes or self._root_tail is not None:
                raise RuntimeError("rebind of a non-empty prefix index — "
                                   "flush() first (entries name the OLD "
                                   "pool's physical pages)")
            self.pool = pool

    # ---------------------------------------------------------------- intro
    def retained_pages(self) -> int:
        with self._lock:
            return self._retained

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            total = self._hits + self._misses
            return {
                "hits": self._hits,
                "misses": self._misses,
                "hit_rate_pct": round(100.0 * self._hits / total, 2)
                if total else 0.0,
                "retained_pages": self._retained,
                "budget_pages": self.budget_pages,
                "nodes": len(self._nodes),
            }
