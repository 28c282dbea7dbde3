"""A transform call's least work through the tree walk: the raw float32
features read once, the trees' node tables (feature, threshold, two
children: 16 bytes a node) and leaf values (4 bytes) read once, and each
row's raw score, two probabilities and prediction (32 bytes) written
once.  Each node visit (counted by the reference's walk of the same rows)
is a compare and a select: two operations."""
from __future__ import annotations

from . import peaks

OUT_BYTES = 32
NODE_BYTES = 16
VISIT_OPS = 2


def work(rows: int, features: int, trees: int, nodes: int, leaves: int,
         visits: float):
    nbytes = (rows * features * 4 + trees * (nodes * NODE_BYTES
                                             + leaves * 4)
              + rows * OUT_BYTES)
    return nbytes, visits * VISIT_OPS


def least_s(rows: int, features: int, trees: int, nodes: int, leaves: int,
            visits: float) -> float:
    return peaks.least_s(*work(rows, features, trees, nodes, leaves, visits))
