"""Binary file IO — directories of arbitrary files as frames.

An own copy of the JAX package's ``io/binary.py``, verbatim apart from
module paths.

Reference: ``core/.../io/binary/BinaryFileFormat.scala`` (Spark DataSource
over binary files with recursive parallel listing, batch AND streaming) and
``BinaryFileReader``.  Columns: path (string), bytes (binary).
"""
from __future__ import annotations

import fnmatch
import os
import threading
import time
from typing import Callable, List, Optional

import numpy as np

from ..core import DataFrame


def list_files(path: str, pattern: Optional[str] = None,
               recursive: bool = True) -> List[str]:
    out: List[str] = []
    if os.path.isfile(path):
        return [path]
    for root, dirs, files in os.walk(path):
        for f in sorted(files):
            if pattern is None or fnmatch.fnmatch(f, pattern):
                out.append(os.path.join(root, f))
        if not recursive:
            break
    return sorted(out)


def read_binary_files(path: str, pattern: Optional[str] = None,
                      recursive: bool = True, num_partitions: int = 1,
                      with_bytes: bool = True) -> DataFrame:
    files = list_files(path, pattern, recursive)
    paths = np.empty(len(files), dtype=object)
    blobs = np.empty(len(files), dtype=object)
    for i, f in enumerate(files):
        paths[i] = f
        if with_bytes:
            with open(f, "rb") as fh:
                blobs[i] = fh.read()
    cols = {"path": paths}
    if with_bytes:
        cols["bytes"] = blobs
    return DataFrame.from_dict(cols, num_partitions=max(1, min(num_partitions, len(files) or 1)))


class BinaryFileStream:
    """Streaming variant: files appearing under ``path`` become micro-batch
    frames (the reference's binary DataSource streams new files the same
    way; ``IOImplicits.readStream.binary``).  Poll-based; offsets are the
    set of already-seen paths, so each file is delivered exactly once."""

    def __init__(self, path: str, pattern: Optional[str] = None,
                 recursive: bool = True, poll_interval_s: float = 0.5,
                 settle_s: float = 0.0):
        self.path = path
        self.pattern = pattern
        self.recursive = recursive
        self.poll_interval_s = poll_interval_s
        # files are delivered once their mtime is at least settle_s old, so
        # a file mid-write isn't emitted truncated.  The default 0 assumes
        # the Spark-file-source convention: producers write to a temp name
        # and rename into the watched directory (rename is atomic).
        self.settle_s = settle_s
        self._seen = set()

    def get_batch(self) -> Optional[DataFrame]:
        """Frame of files not yet delivered, or None when nothing is new."""
        now = time.time()
        files = []
        for f in list_files(self.path, self.pattern, self.recursive):
            if f in self._seen:
                continue
            try:
                if self.settle_s and now - os.path.getmtime(f) < self.settle_s:
                    continue  # still settling; picked up on a later poll
            except OSError:
                continue  # vanished between list and stat
            files.append(f)
        if not files:
            return None
        paths, blobs = [], []
        for f in files:
            try:
                with open(f, "rb") as fh:
                    data = fh.read()
            except OSError:
                continue  # vanished between stat and open: not marked seen
            self._seen.add(f)
            paths.append(f)
            blobs.append(data)
        if not paths:
            return None
        p_col = np.empty(len(paths), dtype=object)
        b_col = np.empty(len(paths), dtype=object)
        for i, (p, b) in enumerate(zip(paths, blobs)):
            p_col[i], b_col[i] = p, b
        return DataFrame.from_dict({"path": p_col, "bytes": b_col})

    def for_each_batch(self, fn: Callable[[DataFrame], None]):
        """Background trigger loop (``writeStream.foreachBatch`` analogue);
        returns a handle with ``stop()`` and ``last_error``.  Per-batch
        errors (user fn or IO) are recorded on the handle and the stream
        keeps polling — one bad batch must not silently end the stream."""
        stop = threading.Event()

        class _Handle:
            last_error: Optional[str] = None

            def stop(self, timeout: float = 10.0):
                stop.set()
                t.join(timeout)

        handle = _Handle()

        def loop():
            while not stop.is_set():
                try:
                    batch = self.get_batch()
                    if batch is not None:
                        fn(batch)
                        continue
                except Exception as e:  # noqa: BLE001 — record and keep going
                    handle.last_error = str(e)
                time.sleep(self.poll_interval_s)

        t = threading.Thread(target=loop, daemon=True)
        t.start()
        return handle
