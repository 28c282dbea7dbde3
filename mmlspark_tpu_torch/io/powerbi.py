"""PowerBI writer — POST frames to a PowerBI streaming dataset.

An own copy of the JAX package's ``io/powerbi.py``, verbatim apart from
module paths.

Reference: ``core/.../io/powerbi/PowerBIWriter.scala:27-110`` (batch +
streaming POST through the HTTP transformer stack).
"""
from __future__ import annotations

import json
from typing import List, Optional

import numpy as np

from ..core import DataFrame
from ..io.http import AsyncHTTPClient, HTTPRequestData


def write(df: DataFrame, url: str, batch_size: int = 100,
          concurrency: int = 4) -> List[int]:
    """POST rows in batches to the PowerBI push URL; returns status codes."""
    client = AsyncHTTPClient(concurrency=concurrency)
    rows = []
    for r in df.iter_rows():
        rows.append({k: (v.tolist() if isinstance(v, np.ndarray) else
                         v.item() if isinstance(v, (np.floating, np.integer)) else v)
                     for k, v in r.items()})
    reqs = [HTTPRequestData.post_json(url, rows[s:s + batch_size])
            for s in range(0, len(rows), batch_size)]
    resps = client.send_all(reqs)
    return [r.status_code if r else 0 for r in resps]


def stream(source_df_fn, url: str, interval_s: float = 1.0, max_batches: int = 0):
    """Streaming variant: poll source_df_fn() for new frames and push them.
    Returns a stop() handle (reference PowerBIWriter.stream)."""
    import threading

    stop_evt = threading.Event()

    def loop():
        count = 0
        while not stop_evt.is_set():
            df = source_df_fn()
            if df is not None and df.count():
                write(df, url)
            count += 1
            if max_batches and count >= max_batches:
                break
            stop_evt.wait(interval_s)

    t = threading.Thread(target=loop, daemon=True)
    t.start()

    def stop() -> None:
        stop_evt.set()
        # the loop wakes within one interval; join so callers observe the
        # final push complete instead of racing it into teardown
        t.join(timeout=interval_s + 5.0)

    return stop
