"""The split search's work in a fit: one scan of each node's ``F x B``
histogram cells (three int32 sums read) for its best split, for the root
and for both children of every split.  A cell costs a prefix add of its
three sums and the gain of splitting there: 16 operations."""
from __future__ import annotations

import numpy as np

from . import peaks

CELL_BYTES = 12
CELL_OPS = 16


def cells(booster, features: int, bins: int) -> float:
    splits = int(np.sum(np.asarray(booster.split_feature) >= 0))
    return float((booster.num_trees + 2 * splits) * features * bins)


def least_s(booster, features: int, bins: int) -> float:
    c = cells(booster, features, bins)
    return peaks.least_s(c * CELL_BYTES, c * CELL_OPS)
