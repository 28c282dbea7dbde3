"""Ball trees for exact maximum-inner-product search (the port's own copy
of ``mmlspark_tpu/nn/balltree.py``; host, float64).  ``load`` unpickles
through ``utils.pickling``, so a tree the JAX package saved loads as this
module's class.

Reference: ``nn/BallTree.scala:109`` (balltree over mean-split hyperplanes
with inner-product bounds) and ``ConditionalBallTree`` (:202, label-aware
pruning via per-node label sets + ``ReverseIndex`` :181).

The production query path is a brute-force matmul top-k on the device
(``knn.py``); the trees are kept for host-side/serving queries and API
parity, including their ``save``/``load`` used by ComplexParams.
"""
from __future__ import annotations

import heapq
import os
from typing import List, Optional, Sequence, Set, Tuple

import numpy as np

from ..core.serialize import Saveable
from ..utils import pickling


class _Node:
    __slots__ = ("idx", "mu", "radius", "left", "right", "labels")

    def __init__(self, idx, mu, radius, left=None, right=None, labels=None):
        self.idx = idx          # leaf: indices into data
        self.mu = mu
        self.radius = radius
        self.left = left
        self.right = right
        self.labels = labels    # ConditionalBallTree: label set under node


class BallTree(Saveable):
    """Exact MIPS ball tree (mean-split, inner-product upper bounds)."""

    def __init__(self, data: np.ndarray, values: Optional[Sequence] = None,
                 leaf_size: int = 50):
        self.data = np.asarray(data, np.float64)
        self.values = list(values) if values is not None else list(range(len(self.data)))
        self.leaf_size = leaf_size
        self.norms = np.linalg.norm(self.data, axis=1)
        self.root = self._build(np.arange(len(self.data)), None)

    def _make_node(self, idx, labels) -> _Node:
        pts = self.data[idx]
        mu = pts.mean(axis=0)
        radius = float(np.max(np.linalg.norm(pts - mu, axis=1))) if len(idx) else 0.0
        return _Node(idx, mu, radius,
                     labels=None if labels is None else set(labels[i] for i in idx))

    def _build(self, idx: np.ndarray, labels) -> _Node:
        node = self._make_node(idx, labels)
        if len(idx) <= self.leaf_size:
            return node
        pts = self.data[idx]
        # split along direction of max spread (reference uses furthest-point pivots)
        a = pts[np.argmax(np.linalg.norm(pts - node.mu, axis=1))]
        b = pts[np.argmax(np.linalg.norm(pts - a, axis=1))]
        proj = pts @ (a - b)
        median = np.median(proj)
        left_mask = proj <= median
        if left_mask.all() or not left_mask.any():
            return node
        node.left = self._build(idx[left_mask], labels)
        node.right = self._build(idx[~left_mask], labels)
        node.idx = None
        return node

    @staticmethod
    def _bound(q: np.ndarray, node: _Node) -> float:
        # max over ball of q.x <= q.mu + ||q|| * radius
        return float(q @ node.mu) + float(np.linalg.norm(q)) * node.radius

    def find_maximum_inner_products(self, query: np.ndarray, k: int = 1,
                                    allowed: Optional[Set] = None) -> List[Tuple[int, float]]:
        """Top-k (index, inner product), optionally restricted to rows whose
        value is in `allowed` (ConditionalBallTree query)."""
        q = np.asarray(query, np.float64)
        heap: List[Tuple[float, int]] = []   # min-heap of (ip, idx)

        def visit(node: _Node):
            if node is None:
                return
            if allowed is not None and node.labels is not None and \
                    not (node.labels & allowed):
                return
            if len(heap) == k and self._bound(q, node) <= heap[0][0]:
                return
            if node.idx is not None:  # leaf
                for i in node.idx:
                    if allowed is not None and self.values[i] not in allowed:
                        continue
                    ip = float(q @ self.data[i])
                    if len(heap) < k:
                        heapq.heappush(heap, (ip, int(i)))
                    elif ip > heap[0][0]:
                        heapq.heapreplace(heap, (ip, int(i)))
                return
            # visit more promising child first
            bl = self._bound(q, node.left) if node.left else -np.inf
            br = self._bound(q, node.right) if node.right else -np.inf
            first, second = (node.left, node.right) if bl >= br else (node.right, node.left)
            visit(first)
            visit(second)

        visit(self.root)
        return [(i, ip) for ip, i in sorted(heap, reverse=True)]

    # ------------------------------------------------------------------ serde
    def save(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "tree.pkl"), "wb") as f:
            pickling.dump(self, f)

    @classmethod
    def load(cls, path: str) -> "BallTree":
        with open(os.path.join(path, "tree.pkl"), "rb") as f:
            return pickling.load(f)


class ConditionalBallTree(BallTree):
    """Label-conditioned ball tree (reference ``ConditionalBallTree:202``):
    each node stores the label set beneath it so conditional queries prune
    whole subtrees whose labels don't intersect the allowed set."""

    def __init__(self, data: np.ndarray, values: Sequence, labels: Sequence,
                 leaf_size: int = 50):
        self.labels_arr = list(labels)
        self.data = np.asarray(data, np.float64)
        self.values = list(values)
        self.leaf_size = leaf_size
        self.norms = np.linalg.norm(self.data, axis=1)
        self.root = self._build(np.arange(len(self.data)), self.labels_arr)

    def find_maximum_inner_products(self, query, k=1, conditioner: Optional[Set] = None):
        q = np.asarray(query, np.float64)
        heap: List[Tuple[float, int]] = []

        def visit(node: _Node):
            if node is None:
                return
            if conditioner is not None and node.labels is not None and \
                    not (node.labels & conditioner):
                return
            if len(heap) == k and self._bound(q, node) <= heap[0][0]:
                return
            if node.idx is not None:
                for i in node.idx:
                    if conditioner is not None and self.labels_arr[i] not in conditioner:
                        continue
                    ip = float(q @ self.data[i])
                    if len(heap) < k:
                        heapq.heappush(heap, (ip, int(i)))
                    elif ip > heap[0][0]:
                        heapq.heapreplace(heap, (ip, int(i)))
                return
            bl = self._bound(q, node.left) if node.left else -np.inf
            br = self._bound(q, node.right) if node.right else -np.inf
            first, second = (node.left, node.right) if bl >= br else (node.right, node.left)
            visit(first)
            visit(second)

        visit(self.root)
        return [(i, ip) for ip, i in sorted(heap, reverse=True)]
