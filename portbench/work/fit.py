"""The least time of a whole fit, bound by bytes: what ``fit_mfu_pct``
divides by the fit's wall time.

- binning: the raw float32 features read once, the one-byte bins written
  once;
- each iteration's gradient pass and score update: labels and scores read
  (8 bytes a row), the two one-byte quantized gradients written, the
  scores read and written again (8);
- the histogram builds and split searches (``hist_accumulate``,
  ``frontier_finish``);
- LambdaRank: every pair of a query's documents whose relevances differ,
  20 operations each (a difference, an exponential, the |delta NDCG|
  weight and the two sums).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from . import frontier_finish, hist_accumulate, peaks

PAIR_OPS = 20
ROW_ITER_BYTES = 18


def ranking_pairs(y: np.ndarray, group_ptr: np.ndarray) -> float:
    """Pairs of documents of one query whose relevances differ."""
    total = 0.0
    for a, b in zip(group_ptr[:-1], group_ptr[1:]):
        counts = np.bincount(y[a:b].astype(np.int64))
        m = float(b - a)
        total += (m * m - float((counts.astype(np.float64) ** 2).sum())) / 2
    return total


def least_s(booster, rows: int, features: int, bins: int,
            pairs: Optional[float] = None) -> float:
    binning = peaks.least_s(rows * features * 5, 0.0)
    iters = booster.num_iterations
    per_row = peaks.least_s(rows * ROW_ITER_BYTES * iters, 0.0)
    hist = hist_accumulate.least_s(booster, rows, features, bins)
    finish = frontier_finish.least_s(booster, features, bins)
    rank = peaks.least_s(0.0, pairs * PAIR_OPS * iters) if pairs else 0.0
    return binning + per_row + hist + finish + rank
