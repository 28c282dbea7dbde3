"""Isolation forest anomaly detection (the port of
``mmlspark_tpu/isolationforest/iforest.py``).

Reference: ``isolationforest/IsolationForest.scala:16-65`` — a thin wrapper
over LinkedIn's isolation-forest library with params (numEstimators,
maxSamples, contamination, maxFeatures, scoreCol, predictedLabelCol).
Growing is the JAX package's, on the host, call for call on numpy's
generator, so the same seed grows the same trees.  Scoring runs on the
estimator's and the model's ``device``: each tree is flattened once into
padded node arrays (feature int32, threshold float64, children int32, and
a leaf's path length ``depth + c(size)`` in float64, computed on the host
as the reference computes it), and every tree is walked for a batch of
rows in at most ``max_depth`` gathers.  The rows go to the device in
float64: the thresholds are float64 draws between float64 column extremes,
and in float32 a comparison near a threshold flips.  Path lengths are
summed over the trees in tree order and divided by the tree count, as
numpy's mean over the reference's ``(trees, rows)`` stack does, and the
score ``2 ** (-mean / c(sub_size))`` is taken on the host, so a score
equals the reference's.
"""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from .._device import resolve_device
from ..core import (ComplexParam, DataFrame, Estimator, HasFeaturesCol,
                    HasPredictionCol, Model, Param)
from ..core.schema import ColumnType, stack_vector_column
from ..core.serialize import Saveable
from ..utils import pickling

#: rows walked at once: (rows x trees) node ids and their gathers
_WALK_ROWS = 1 << 16


def _c(n: float) -> float:
    """Average BST unsuccessful-search path length (iForest normalizer)."""
    if n <= 1:
        return 0.0
    return 2.0 * (math.log(n - 1) + 0.5772156649) - 2.0 * (n - 1) / n


class _ITree:
    __slots__ = ("feature", "threshold", "left", "right", "size")

    def __init__(self, feature=-1, threshold=0.0, left=None, right=None, size=0):
        self.feature, self.threshold = feature, threshold
        self.left, self.right, self.size = left, right, size

    def path_length(self, X: np.ndarray, depth: int = 0) -> np.ndarray:
        """The reference's recursive walk (host)."""
        if self.feature < 0 or self.left is None:
            return np.full(len(X), depth + _c(self.size))
        mask = X[:, self.feature] < self.threshold
        out = np.empty(len(X))
        if mask.any():
            out[mask] = self.left.path_length(X[mask], depth + 1)
        if (~mask).any():
            out[~mask] = self.right.path_length(X[~mask], depth + 1)
        return out


def _flatten(tree: _ITree):
    """One tree as node lists in breadth-first order (root 0); a leaf has
    feature -1 and its path length, an inner node its children."""
    feature, threshold, left, right, value = [], [], [], [], []
    queue = [(tree, 0)]
    depth_max = 0
    while queue:
        nxt = []
        for node, depth in queue:
            depth_max = max(depth_max, depth)
            i = len(feature)
            leaf = node.feature < 0 or node.left is None
            feature.append(-1 if leaf else int(node.feature))
            threshold.append(0.0 if leaf else float(node.threshold))
            value.append(depth + _c(node.size) if leaf else 0.0)
            left.append(i)
            right.append(i)
            if not leaf:
                nxt.append((node.left, depth + 1, i, "l"))
                nxt.append((node.right, depth + 1, i, "r"))
        queue = []
        for child, depth, parent, side in nxt:
            (left if side == "l" else right)[parent] = \
                len(feature) + len(queue)
            queue.append((child, depth))
    return feature, threshold, left, right, value, depth_max


class _Forest(Saveable):
    """The fitted trees.  ``trees`` and ``sub_size`` carry the reference's
    names, so a forest the JAX package pickled unpickles into this class
    (``utils.pickling``); the flattened arrays are built at first use, one
    copy per device, and never pickled."""

    def __init__(self, trees: List[_ITree], sub_size: int):
        self.trees = trees
        self.sub_size = sub_size

    def __getstate__(self):
        return {"trees": self.trees, "sub_size": self.sub_size}

    def _flat(self, dev: torch.device) -> Dict[str, torch.Tensor]:
        cache = self.__dict__.setdefault("_flat_cache", {})
        if dev not in cache:
            flat = [_flatten(t) for t in self.trees]
            M = max(len(f[0]) for f in flat)
            T = len(flat)
            arrays = {"feature": np.full((T, M), -1, np.int32),
                      "threshold": np.zeros((T, M), np.float64),
                      "left": np.zeros((T, M), np.int32),
                      "right": np.zeros((T, M), np.int32),
                      "value": np.zeros((T, M), np.float64)}
            for t, (f, thr, lft, rgt, val, _) in enumerate(flat):
                k = len(f)
                arrays["feature"][t, :k] = f
                arrays["threshold"][t, :k] = thr
                arrays["left"][t, :k] = lft
                arrays["right"][t, :k] = rgt
                arrays["value"][t, :k] = val
            # node ids become flat offsets into the (T * M) tables
            off = (np.arange(T, dtype=np.int64) * M)[:, None]
            tables = {k: torch.from_numpy(v.reshape(-1)).to(dev)
                      for k, v in arrays.items()}
            for k in ("left", "right"):
                tables[k] = torch.from_numpy(
                    (arrays[k] + off).reshape(-1)).to(dev)
            tables["root"] = torch.from_numpy(off[:, 0].copy()).to(dev)
            tables["depth"] = max(f[5] for f in flat)
            cache[dev] = tables
        return cache[dev]

    def mean_path_length(self, X, device=None) -> np.ndarray:
        """Mean path length over the trees for each row of ``X`` (float64),
        walked on ``device`` (``None``: the card)."""
        dev = resolve_device(device)
        tab = self._flat(dev)
        T = len(self.trees)
        out = np.empty(len(X), np.float64)
        for s in range(0, len(X), _WALK_ROWS):
            Xb = torch.from_numpy(np.ascontiguousarray(
                X[s:s + _WALK_ROWS], np.float64)).to(dev)
            node = tab["root"].expand(len(Xb), T).clone()      # (b, T)
            for _ in range(tab["depth"]):
                f = tab["feature"][node]
                go_left = Xb.gather(1, f.clamp(min=0).long()) \
                    < tab["threshold"][node]
                child = torch.where(go_left, tab["left"][node],
                                    tab["right"][node])
                node = torch.where(f >= 0, child, node)
            value = tab["value"][node]
            total = value[:, 0].clone()
            for t in range(1, T):       # tree order, as numpy's mean
                total += value[:, t]
            out[s:s + len(Xb)] = (total / T).cpu().numpy()
        return out

    def scores(self, X: np.ndarray, device=None) -> np.ndarray:
        depths = self.mean_path_length(X, device)
        return 2.0 ** (-depths / _c(self.sub_size))

    def save(self, path: str) -> None:
        import os
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "forest.pkl"), "wb") as f:
            pickling.dump(self, f)

    @classmethod
    def load(cls, path: str):
        import os
        with open(os.path.join(path, "forest.pkl"), "rb") as f:
            return pickling.load(f)


def _grow(X: np.ndarray, depth: int, max_depth: int, rng) -> _ITree:
    n = len(X)
    if depth >= max_depth or n <= 1:
        return _ITree(size=n)
    f = int(rng.integers(0, X.shape[1]))
    lo, hi = X[:, f].min(), X[:, f].max()
    if lo == hi:
        return _ITree(size=n)
    thr = float(rng.uniform(lo, hi))
    mask = X[:, f] < thr
    return _ITree(f, thr, _grow(X[mask], depth + 1, max_depth, rng),
                  _grow(X[~mask], depth + 1, max_depth, rng), n)


class IsolationForest(Estimator, HasFeaturesCol, HasPredictionCol):
    num_estimators = Param("num_estimators", "number of trees", "int", default=100)
    max_samples = Param("max_samples", "subsample per tree", "int", default=256)
    max_features = Param("max_features", "feature fraction per tree", "float", default=1.0)
    contamination = Param("contamination", "expected outlier fraction (sets "
                          "the predicted-label threshold)", "float", default=0.0)
    score_col = Param("score_col", "anomaly score output", "string", default="outlier_score")
    predicted_label_col = Param("predicted_label_col", "0/1 outlier label",
                                "string", default="predicted_label")
    random_seed = Param("random_seed", "seed", "int", default=1)
    device = Param("device", "where the trees are walked: unset = the CUDA "
                   "card (an error without one), 'cpu' = the host",
                   "string", default=None)

    def _fit(self, df: DataFrame) -> "IsolationForestModel":
        X = stack_vector_column(df.collect()[self.get_or_fail("features_col")])
        rng = np.random.default_rng(self.get("random_seed"))
        sub = min(self.get("max_samples"), len(X))
        max_depth = int(math.ceil(math.log2(max(sub, 2))))
        trees = []
        for _ in range(self.get("num_estimators")):
            idx = rng.choice(len(X), sub, replace=False)
            Xs = X[idx]
            f_frac = self.get("max_features")
            if f_frac < 1.0:
                keep = rng.choice(X.shape[1], max(1, int(f_frac * X.shape[1])),
                                  replace=False)
                proj = np.zeros_like(Xs)
                proj[:, keep] = Xs[:, keep]
                Xs = proj
            trees.append(_grow(Xs, 0, max_depth, rng))
        forest = _Forest(trees, sub)
        threshold = 0.5
        cont = self.get("contamination")
        if cont and cont > 0:
            threshold = float(np.quantile(
                forest.scores(X, self.get("device")), 1.0 - cont))
        m = IsolationForestModel()
        m.set("forest", forest)
        m.set("threshold", threshold)
        for pcol in ("features_col", "score_col", "predicted_label_col"):
            m.set(pcol, self.get(pcol))
        if self.is_set("device"):   # scoring runs where fitting ran
            m.set("device", self.get("device"))
        return m


class IsolationForestModel(Model, HasFeaturesCol):
    forest = ComplexParam("forest", "fitted isolation forest")
    threshold = Param("threshold", "outlier score threshold", "float", default=0.5)
    score_col = Param("score_col", "score output", "string", default="outlier_score")
    predicted_label_col = Param("predicted_label_col", "label output", "string",
                                default="predicted_label")
    device = Param("device", "where the trees are walked: unset = the CUDA "
                   "card (an error without one), 'cpu' = the host",
                   "string", default=None)

    def _transform(self, df: DataFrame) -> DataFrame:
        forest: _Forest = self.get_or_fail("forest")
        thr = self.get("threshold")
        fc = self.get_or_fail("features_col")
        device = self.get("device")

        def per_part(p):
            X = stack_vector_column(p[fc])
            s = forest.scores(X, device)
            return {**p, self.get("score_col"): s,
                    self.get("predicted_label_col"): (s >= thr).astype(np.float64)}

        return df.map_partitions(per_part)

    def transform_schema(self, schema):
        schema.require(self.get_or_fail("features_col"))
        return schema.add(self.get("score_col"), ColumnType.DOUBLE) \
            .add(self.get("predicted_label_col"), ColumnType.DOUBLE)
