"""The histogram build's work in a fit: what the algorithm needs, not what
the kernel launches.

Each tree builds the root's histogram from every row, and for each split
only the smaller child's (the larger is the parent's minus it).  A row
counted is read once: its ``F`` one-byte bins and its two one-byte
quantized gradients; each histogram built is written once, ``F x B``
cells of three int32 sums.  Every row adds three sums per feature.  The
smaller child's rows come from the fitted booster's node and leaf counts.
"""
from __future__ import annotations

import numpy as np

from . import peaks


def child_count(booster, t: int, c: int) -> float:
    if c < 0:
        return float(booster.leaf_count[t, ~c])
    return float(booster.internal_count[t, c])


def rows_and_histograms(booster, rows: int):
    """``(rows read, histograms built)`` summed over the booster's trees."""
    total_rows, hists = 0.0, 0
    for t in range(booster.num_trees):
        sf = booster.split_feature[t]
        live = np.nonzero(sf >= 0)[0]
        total_rows += rows
        hists += 1 + live.size
        for s in live:
            total_rows += min(child_count(booster, t, booster.left_child[t, s]),
                              child_count(booster, t,
                                          booster.right_child[t, s]))
    return total_rows, hists


def work(booster, rows: int, features: int, bins: int):
    """``(bytes, operations)`` of the fit's histogram builds."""
    r, h = rows_and_histograms(booster, rows)
    nbytes = r * (features + 2) + h * features * bins * 3 * 4
    return nbytes, r * features * 3


def least_s(booster, rows: int, features: int, bins: int) -> float:
    return peaks.least_s(*work(booster, rows, features, bins))
