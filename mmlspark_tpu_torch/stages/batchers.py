"""Iterator batchers backing the minibatch transformers.

An own copy of the JAX package's ``stages/batchers.py``, verbatim apart from module
paths.

Reference: ``core/.../stages/Batchers.scala:12-131`` (fixed-size, dynamic
buffered, and time-interval batching iterators feeding CNTKModel-style
minibatched inference).
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Iterable, Iterator, List, TypeVar

T = TypeVar("T")


def fixed_batches(items: Iterable[T], batch_size: int) -> Iterator[List[T]]:
    batch: List[T] = []
    for it in items:
        batch.append(it)
        if len(batch) >= batch_size:
            yield batch
            batch = []
    if batch:
        yield batch


def dynamic_batches(items: Iterable[T], max_batch_size: int = 2 ** 31) -> Iterator[List[T]]:
    """Background-producer batching: consume whatever buffered while the
    downstream was busy (reference DynamicBufferedBatcher)."""
    q: "queue.Queue" = queue.Queue(maxsize=max_batch_size)
    DONE = object()

    def produce():
        for it in items:
            q.put(it)
        q.put(DONE)

    t = threading.Thread(target=produce, daemon=True)
    t.start()
    done = False
    while not done:
        batch: List[T] = [q.get()]
        if batch[0] is DONE:
            break
        while len(batch) < max_batch_size:
            try:
                nxt = q.get_nowait()
            except queue.Empty:
                break
            if nxt is DONE:
                done = True
                break
            batch.append(nxt)
        if batch and batch[0] is not DONE:
            yield [b for b in batch if b is not DONE]


def time_interval_batches(items: Iterable[T], millis: int,
                          max_batch_size: int = 2 ** 31) -> Iterator[List[T]]:
    """Flush a batch every `millis` ms (reference TimeIntervalBatcher)."""
    batch: List[T] = []
    deadline = time.monotonic() + millis / 1000.0
    for it in items:
        batch.append(it)
        if len(batch) >= max_batch_size or time.monotonic() >= deadline:
            yield batch
            batch = []
            deadline = time.monotonic() + millis / 1000.0
    if batch:
        yield batch
