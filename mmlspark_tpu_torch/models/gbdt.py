"""GBDT booster artifact — trees as dense arrays, prediction as a torch
gather walk (port of ``mmlspark_tpu/models/gbdt.py``).

A booster holds numpy arrays and serializes exactly as the JAX package's
(``to_string``/``from_string`` JSON, ``save``/``load`` npz + meta.json), so
either package reads the other's artifacts.  Every tree is an
array-of-nodes with explicit child pointers: ``left_child[i] >= 0`` is an
internal node, negative values encode leaves as ``~leaf_id``.
``max_depth`` is the walk bound; leaves self-loop, so a fixed-length walk
resolves every tree shape.  Scoring moves the rows to ``device`` (the card
unless the caller passes ``device="cpu"``) and walks all trees at once.

Categorical nodes route as the JAX package's walk does: with a
``cat_bitset`` a code in the node's set goes left, without one the code
``threshold`` alone goes left; NaN and codes outside the set go right.

Not ported yet: ``predict_contrib``, TreeSHAP and ``merge`` (ROADMAP, port
queue).
"""
from __future__ import annotations

import json
import os
from typing import List, Optional

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from ..core.serialize import Saveable

OBJECTIVES = ("regression", "regression_l1", "huber", "quantile", "binary",
              "multiclass", "lambdarank")


def _sigmoid(z):
    return 1.0 / (1.0 + np.exp(-z))


def perfect_tree_children(max_depth: int) -> tuple:
    """(left, right) child arrays of a perfect depth-D tree in BFS order:
    children of internal node i at 2i+1 / 2i+2; positions >= 2^D - 1 are
    leaves encoded ``~leaf_id``."""
    I = 2 ** max_depth - 1
    lc = np.empty(I, np.int32)
    rc = np.empty(I, np.int32)
    for i in range(I):
        l, r = 2 * i + 1, 2 * i + 2
        lc[i] = l if l < I else ~(l - I)
        rc[i] = r if r < I else ~(r - I)
    return lc, rc


def children_depth_bound(left_child: np.ndarray,
                         right_child: np.ndarray) -> int:
    """Longest internal-node chain over (T, M) child arrays — the static
    iteration count prediction walks need.  Child internal indices always
    exceed the parent's (creation order), so one forward pass suffices."""
    lc = np.asarray(left_child)
    rc = np.asarray(right_child)
    if lc.ndim == 1:
        lc, rc = lc[None], rc[None]
    T, M = lc.shape
    d = np.ones((T, M), np.int32)
    for i in range(M):
        for child in (lc[:, i], rc[:, i]):
            internal = child >= 0
            rows = np.nonzero(internal)[0]
            d[rows, child[rows]] = np.maximum(d[rows, child[rows]],
                                              d[rows, i] + 1)
    return int(d.max()) if M else 1


def walk_trees(X: torch.Tensor, split_feature: torch.Tensor,
               threshold: torch.Tensor, left_child: torch.Tensor,
               right_child: torch.Tensor, depth: int,
               is_cat: Optional[torch.Tensor] = None,
               bitset: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(n, T) leaf index of every row in every tree: ``depth`` rounds of
    gathers over raw float32 features.  NaN goes left (it compares as
    -inf), and ``x > threshold`` goes right.  Where ``is_cat`` ((F,) bool)
    marks the split feature categorical, the code ``round(x)`` goes left if
    it is in the node's ``bitset`` row (``(T, M, W)`` bool), or without a
    bitset if it equals ``threshold``; NaN and unseen codes go right."""
    n = X.shape[0]
    T = split_feature.shape[0]
    Xn = torch.nan_to_num(X, nan=-torch.inf)
    t_idx = torch.arange(T, device=X.device)[None, :]
    node = torch.zeros((n, T), dtype=torch.int64, device=X.device)
    for _ in range(max(1, depth)):
        j = node.clamp(min=0)
        f = split_feature[t_idx, j]
        xv = torch.gather(Xn, 1, f.clamp(min=0))
        thr = threshold[t_idx, j]
        right = xv > thr
        if is_cat is not None:
            if bitset is not None:
                W = bitset.shape[-1]
                code = torch.where(torch.isfinite(xv), torch.round(xv), -1.0)
                member = (code >= 0) & (code < W) & bitset[
                    t_idx, j, code.clamp(0, W - 1).to(torch.int64)]
                cat_right = ~member
            else:
                cat_right = torch.round(xv) != thr
            right = torch.where(is_cat[f.clamp(min=0)], cat_right, right)
        child = torch.where((f >= 0) & right, right_child[t_idx, j],
                            left_child[t_idx, j])
        node = torch.where(node >= 0, child, node)
    return ~node


class GBDTBooster(Saveable):
    """Immutable fitted booster.  T trees, M = num_leaves - 1 internal node
    slots, L = num_leaves leaf slots.  Arrays:

    - left_child:    (T, M) int32 child pointer (>=0 internal, <0 = ~leaf_id)
    - right_child:   (T, M) int32
    - split_feature: (T, M) int32, -1 where the node doesn't split
    - threshold:     (T, M) float32 raw-value threshold (x <= thr goes left)
    - threshold_bin: (T, M) int32 binned threshold (bin <= t goes left)
    - split_gain:    (T, M) float32
    - internal_value:(T, M) float32 (-G/(H+l2) at the node)
    - internal_count:(T, M) float32 row counts
    - leaf_value:    (T, L) float32
    - leaf_count:    (T, L) float32
    - tree_weight:   (T,)   float32 (DART/RF weights; 1.0 for gbdt)
    """

    def __init__(self, split_feature, threshold, threshold_bin, split_gain,
                 internal_value, internal_count, leaf_value, leaf_count,
                 tree_weight, *, max_depth: int, num_features: int,
                 objective: str = "regression", num_class: int = 1,
                 init_score: float = 0.0, average_output: bool = False,
                 feature_names: Optional[List[str]] = None,
                 best_iteration: int = -1, sigmoid: float = 1.0,
                 categorical_features: Optional[List[int]] = None,
                 left_child=None, right_child=None, cat_bitset=None):
        self.split_feature = np.asarray(split_feature, np.int32)
        if left_child is None:  # artifact without child arrays: perfect tree
            lc1, rc1 = perfect_tree_children(int(max_depth))
            T = self.split_feature.shape[0]
            left_child = np.tile(lc1, (T, 1))
            right_child = np.tile(rc1, (T, 1))
        self.left_child = np.asarray(left_child, np.int32)
        self.right_child = np.asarray(right_child, np.int32)
        self.threshold = np.asarray(threshold, np.float32)
        self.threshold_bin = np.asarray(threshold_bin, np.int32)
        self.split_gain = np.asarray(split_gain, np.float32)
        self.internal_value = np.asarray(internal_value, np.float32)
        self.internal_count = np.asarray(internal_count, np.float32)
        self.leaf_value = np.asarray(leaf_value, np.float32)
        self.leaf_count = np.asarray(leaf_count, np.float32)
        self.tree_weight = np.asarray(tree_weight, np.float32)
        self.max_depth = int(max_depth)
        self.num_features = int(num_features)
        self.objective = objective
        self.num_class = int(num_class)
        self.init_score = float(init_score)
        self.average_output = bool(average_output)  # rf mode
        self.feature_names = feature_names or [f"f{i}" for i in
                                               range(num_features)]
        self.best_iteration = int(best_iteration)
        self.sigmoid = float(sigmoid)
        # categorical splits: without ``cat_bitset`` one-vs-rest, the
        # threshold holding the category code; with it ``cat_bitset[t, m]``
        # is node m's (B,) LEFT category set (sorted-subset splits; one-vs-
        # rest nodes carry a single-bit set)
        self.categorical_features = sorted(int(i) for i in
                                           (categorical_features or []))
        self._is_cat = np.zeros(self.num_features, bool)
        if self.categorical_features:
            self._is_cat[self.categorical_features] = True
        self.cat_bitset = None if cat_bitset is None \
            else np.asarray(cat_bitset, bool)

    # ------------------------------------------------------------------ shape
    @property
    def num_trees(self) -> int:
        return self.split_feature.shape[0]

    @property
    def num_iterations(self) -> int:
        k = self.num_class if self.objective == "multiclass" else 1
        return self.num_trees // max(1, k)

    @property
    def num_leaves(self) -> int:
        return self.leaf_value.shape[1]

    def resolve_cat_bitset(self, B: int) -> np.ndarray:
        """(T, M, B) LEFT category sets, width-normalized to B bins; for
        one-vs-rest boosters the stored codes become one-bit sets (the two
        decision rules are equivalent, so this is lossless).  Codes >= B
        stay unset: they can never match a bin of width B."""
        T, M = self.split_feature.shape
        out = np.zeros((T, M, B), bool)
        if self.cat_bitset is not None:
            W = min(B, self.cat_bitset.shape[-1])
            out[:, :, :W] = self.cat_bitset[:, :, :W]
            return out
        is_cat_node = (self.split_feature >= 0) & \
            self._is_cat[np.maximum(self.split_feature, 0)] & \
            (self.threshold_bin < B)
        t_i, m_i = np.nonzero(is_cat_node)
        out[t_i, m_i, self.threshold_bin[t_i, m_i]] = True
        return out

    # ------------------------------------------------------------------ predict
    def _tree_tensors(self, dev: torch.device, use_trees: slice):
        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a[use_trees])).to(dev)
        return (t(self.split_feature.astype(np.int64)), t(self.threshold),
                t(self.left_child.astype(np.int64)),
                t(self.right_child.astype(np.int64)))

    def _walk_leaves(self, X: np.ndarray, use_trees: Optional[slice] = None,
                     device: DeviceLike = None) -> torch.Tensor:
        """(n, T') leaf index per tree, as an int64 tensor on ``device``."""
        dev = resolve_device(device)
        use_trees = use_trees or slice(None)
        sf, th, lca, rca = self._tree_tensors(dev, use_trees)
        Xt = torch.as_tensor(np.asarray(X, np.float32), device=dev)
        is_cat = bitset = None
        if self._is_cat.any():
            is_cat = torch.from_numpy(self._is_cat).to(dev)
            if self.cat_bitset is not None:
                bitset = torch.from_numpy(np.ascontiguousarray(
                    self.cat_bitset[use_trees])).to(dev)
        return walk_trees(Xt, sf, th, lca, rca, self.max_depth, is_cat,
                          bitset)

    def predict_leaf(self, X: np.ndarray,
                     device: DeviceLike = None) -> np.ndarray:
        """Reference ``predictLeaf`` (LightGBMBooster.scala:403)."""
        return self._walk_leaves(X, device=device).cpu().numpy()

    def raw_scores(self, X: np.ndarray, num_iteration: int = -1,
                   device: DeviceLike = None) -> np.ndarray:
        """(n, num_class) raw margins (reference ``score`` raw path)."""
        T = self.num_trees
        k = self.num_class if self.objective == "multiclass" else 1
        if num_iteration and num_iteration > 0:
            T = min(T, num_iteration * k)
        leaves = self._walk_leaves(X, slice(0, T), device)
        dev = leaves.device
        lv = torch.from_numpy(self.leaf_value[:T]).to(dev)
        w = torch.from_numpy(self.tree_weight[:T]).to(dev)
        # vals[i, t] = leaf_value[t, leaves[i, t]] * tree_weight[t]
        vals = torch.gather(lv.t(), 0, leaves) * w[None, :]
        out = torch.zeros((leaves.shape[0], k), dtype=torch.float64,
                          device=dev)
        for c in range(k):
            out[:, c] = vals[:, c::k].to(torch.float64).sum(dim=1)
            if self.average_output:
                out[:, c] /= max(1e-12, float(self.tree_weight[:T][c::k]
                                              .sum()))
        return (out + self.init_score).cpu().numpy()

    def predict(self, X: np.ndarray, num_iteration: int = -1,
                device: DeviceLike = None) -> np.ndarray:
        """Transformed scores: prob for binary (n,), softmax (n,K) for
        multiclass, exp(raw) for log-link objectives, raw otherwise."""
        raw = self.raw_scores(X, num_iteration, device)
        if self.objective == "binary":
            return _sigmoid(self.sigmoid * raw[:, 0])
        if self.objective == "multiclass":
            z = raw - raw.max(axis=1, keepdims=True)
            e = np.exp(z)
            return e / e.sum(axis=1, keepdims=True)
        if self.objective in ("poisson", "tweedie", "gamma"):
            return np.exp(np.clip(raw[:, 0], -30, 30))
        return raw[:, 0]

    # ------------------------------------------------------------------ utils
    def feature_importance(self, importance_type: str = "split") -> np.ndarray:
        """Reference ``getFeatureImportances:491``: 'split' counts or 'gain'."""
        out = np.zeros(self.num_features, np.float64)
        mask = self.split_feature >= 0
        feats = self.split_feature[mask]
        if importance_type == "split":
            np.add.at(out, feats, 1.0)
        elif importance_type == "gain":
            np.add.at(out, feats, self.split_gain[mask])
        else:
            raise ValueError("importance_type must be 'split' or 'gain'")
        return out

    # ------------------------------------------------------------------ serde
    _META = ("max_depth", "num_features", "objective", "num_class",
             "init_score", "average_output", "feature_names",
             "best_iteration", "sigmoid", "categorical_features")
    _ARRAYS = ("split_feature", "threshold", "threshold_bin", "split_gain",
               "internal_value", "internal_count", "leaf_value", "leaf_count",
               "tree_weight", "left_child", "right_child")
    _OPT_ARRAYS = ("cat_bitset",)

    def _present_arrays(self):
        return self._ARRAYS + tuple(k for k in self._OPT_ARRAYS
                                    if getattr(self, k) is not None)

    def to_string(self) -> str:
        """Model as a JSON string — the JAX package's format."""
        d = {k: getattr(self, k) for k in self._META}
        arrays = {k: getattr(self, k).tolist() for k in self._ARRAYS}
        if self.cat_bitset is not None:
            packed = np.packbits(self.cat_bitset, axis=-1)
            arrays["cat_bitset_packed"] = packed.tolist()
            d["cat_bitset_bins"] = int(self.cat_bitset.shape[-1])
        d["arrays"] = arrays
        return json.dumps(d)

    @staticmethod
    def from_string(s: str) -> "GBDTBooster":
        """Reads ``to_string`` output of either package."""
        d = json.loads(s)
        arrays = {k: np.asarray(v) for k, v in d.pop("arrays").items()}
        packed = arrays.pop("cat_bitset_packed", None)
        nbits = d.pop("cat_bitset_bins", 0)
        if packed is not None:
            arrays["cat_bitset"] = np.unpackbits(
                packed.astype(np.uint8), axis=-1)[..., :nbits].astype(bool)
        return GBDTBooster(**arrays, **d)

    def save(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        np.savez(os.path.join(path, "trees.npz"),
                 **{k: getattr(self, k) for k in self._present_arrays()})
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump({k: getattr(self, k) for k in self._META}, f)

    @classmethod
    def load(cls, path: str) -> "GBDTBooster":
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        with np.load(os.path.join(path, "trees.npz")) as z:
            arrays = {k: z[k]
                      for k in cls._ARRAYS + cls._OPT_ARRAYS if k in z.files}
        return cls(**arrays, **meta)
