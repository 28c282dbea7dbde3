"""GBDT booster artifact — trees as dense arrays, prediction as a torch
gather walk (port of ``mmlspark_tpu/models/gbdt.py``).

A booster holds numpy arrays and serializes exactly as the JAX package's
(``to_string``/``from_string`` JSON, ``save``/``load`` npz + meta.json), so
either package reads the other's artifacts.  Every tree is an
array-of-nodes with explicit child pointers: ``left_child[i] >= 0`` is an
internal node, negative values encode leaves as ``~leaf_id``.
``max_depth`` is the walk bound; leaves self-loop, so a fixed-length walk
resolves every tree shape.  Scoring moves the rows to ``device`` (the card
unless the caller passes ``device="cpu"``) and walks all trees at once:
past ``_SMALL_WALK`` rows x trees through the compiled program
``models.gbdt_walk`` (a CUDA graph per signature on the card), over row
buckets of at most ``_WALK_ROWS`` rows padded to a power of two, so any
row count replays a few signatures; smaller walks (the serving regime,
which the JAX package walks on the host) run as plain calls.

Categorical nodes route as the JAX package's walk does: with a
``cat_bitset`` a code in the node's set goes left, without one the code
``threshold`` alone goes left; NaN and codes outside the set go right.

Feature contributions (``predict_contrib``): exact path-dependent
TreeSHAP on the host (an own copy of the JAX package's numpy recursion)
or the Saabas path deltas, walked on ``device`` in float64.  ``merge``
concatenates two boosters' trees, as the JAX package's does.
"""
from __future__ import annotations

import json
import os
from typing import List, Optional

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from ..core.serialize import Saveable
from ..observability.compute import instrumented_jit

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


#: the walk programs built, per builder (``lightgbm.core.eager_programs``
#: swaps ``instrumented_call`` in for ``instrumented_jit``) and depth
_WALKS: dict = {}
#: rows x trees up to which a walk is a plain call (the JAX package's host
#: walk threshold)
_SMALL_WALK = 1 << 17
#: the largest row bucket of the walk program
_WALK_ROWS = 1 << 16


def _walk_program(depth: int):
    """``models.gbdt_walk`` for trees walked ``depth`` rounds."""
    key = (instrumented_jit, depth)
    prog = _WALKS.get(key)
    if prog is None:
        def walk(X, split_feature, threshold, left_child, right_child,
                 is_cat, bitset):
            return walk_trees(X, split_feature, threshold, left_child,
                              right_child, depth, is_cat, bitset)
        prog = _WALKS.setdefault(key, instrumented_jit(
            walk, name="models.gbdt_walk"))
    return prog


def _row_bucket(n: int) -> int:
    return min(_WALK_ROWS, 1 << max(0, n - 1).bit_length())


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
        n = Xt.shape[0]
        if n * sf.shape[0] <= _SMALL_WALK:
            return walk_trees(Xt, sf, th, lca, rca, self.max_depth, is_cat,
                              bitset)
        prog = _walk_program(self.max_depth)
        R = _row_bucket(n)
        out = []
        for lo in range(0, n, R):
            x = Xt[lo:lo + R]
            m = x.shape[0]
            if m < R:
                x = torch.cat([x, x.new_zeros((R - m, x.shape[1]))])
            out.append(prog(x, sf, th, lca, rca, is_cat, bitset)[:m])
        return out[0] if len(out) == 1 else torch.cat(out)

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

    def predict_contrib(self, X: np.ndarray, method: str = "tree_shap",
                        device: DeviceLike = None) -> np.ndarray:
        """Per-feature contributions (n, F+1), last col = expected value.

        method="tree_shap": exact path-dependent TreeSHAP (reference
        ``featuresShap:414`` parity), host numpy, additive (rows sum to the
        raw score).  method="saabas": the fast path-delta attribution,
        walked on ``device`` (the card unless ``device="cpu"``) with float64
        sums; additive too, except that, as in the JAX package, a node that
        does not split (a level-wise pass-through) attributes nothing, so a
        row crossing one loses that step's delta (ROADMAP.md §3.11).
        """
        if method == "tree_shap":
            return tree_shap(self, X)
        X = np.asarray(X, np.float32)
        n, F = X.shape
        k = self.num_class if self.objective == "multiclass" else 1
        if k > 1:
            raise ValueError("predict_contrib supports single-score models; "
                             "slice trees per class for multiclass")
        dev = resolve_device(device)
        D = max(1, self.max_depth)
        M = self.split_feature.shape[1]
        L = self.num_leaves
        f64 = torch.float64
        sf_a, th_a, lc_a, rc_a = self._tree_tensors(dev, slice(None))
        iv_a = torch.from_numpy(self.internal_value).to(dev)
        lv_a = torch.from_numpy(self.leaf_value).to(dev)
        w_a = torch.from_numpy(self.tree_weight).to(dev)
        is_cat = torch.from_numpy(self._is_cat).to(dev)
        bits = None if self.cat_bitset is None \
            else torch.from_numpy(self.cat_bitset).to(dev)
        Xn = torch.nan_to_num(torch.from_numpy(X).to(dev), nan=-torch.inf)
        out = torch.zeros((n, F + 1), dtype=f64, device=dev)
        out[:, F] = self.init_score
        for t in range(self.num_trees):
            w = w_a[t]
            node = torch.zeros((n,), dtype=torch.int64, device=dev)
            # float32 products widened to float64, as numpy rounds them
            cur_val = iv_a[t, 0].to(f64).expand(n)
            out[:, F] += (w * iv_a[t, 0]).to(f64)
            for _ in range(D):
                active = node >= 0
                j = node.clamp(min=0)
                f = sf_a[t, j]
                fc = f.clamp(min=0)
                thr = th_a[t, j]
                xv = torch.gather(Xn, 1, fc[:, None])[:, 0]
                isc = is_cat[fc]
                if bits is not None:
                    Bb = bits.shape[-1]
                    code = torch.where(torch.isfinite(xv), torch.round(xv),
                                       -1.0)
                    memb = (code >= 0) & (code < Bb) & bits[
                        t, j, code.clamp(0, Bb - 1).to(torch.int64)]
                    go_right = (f >= 0) & torch.where(isc, ~memb, xv > thr)
                else:
                    go_right = (f >= 0) & torch.where(
                        isc, torch.round(xv) != thr, xv > thr)
                nxt = torch.where(go_right, rc_a[t, j], lc_a[t, j])
                nxt_val = torch.where(
                    nxt >= 0, iv_a[t, nxt.clamp(0, M - 1)],
                    lv_a[t, (~nxt).clamp(0, L - 1)]).to(f64)
                attributed = active & (f >= 0)
                delta = torch.where(attributed,
                                    w.to(f64) * (nxt_val - cur_val), 0.0)
                col = torch.where(attributed, f, F)
                out.scatter_add_(1, col[:, None], delta[:, None])
                cur_val = torch.where(attributed, nxt_val, cur_val)
                node = torch.where(active, nxt, node)
        return out.cpu().numpy()

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

    def merge(self, other: "GBDTBooster") -> "GBDTBooster":
        """Concatenate trees (reference ``mergeBooster:252`` batch training)."""
        assert self.num_leaves == other.num_leaves and self.num_class == other.num_class
        assert self.categorical_features == other.categorical_features
        cat = lambda a, b: np.concatenate([a, b], axis=0)
        merged_bitset = None
        if self.cat_bitset is not None or other.cat_bitset is not None:
            W = max(b.cat_bitset.shape[-1] for b in (self, other)
                    if b.cat_bitset is not None)
            merged_bitset = cat(self.resolve_cat_bitset(W),
                                other.resolve_cat_bitset(W))
        return GBDTBooster(
            cat(self.split_feature, other.split_feature),
            cat(self.threshold, other.threshold),
            cat(self.threshold_bin, other.threshold_bin),
            cat(self.split_gain, other.split_gain),
            cat(self.internal_value, other.internal_value),
            cat(self.internal_count, other.internal_count),
            cat(self.leaf_value, other.leaf_value),
            cat(self.leaf_count, other.leaf_count),
            cat(self.tree_weight, other.tree_weight),
            left_child=cat(self.left_child, other.left_child),
            right_child=cat(self.right_child, other.right_child),
            max_depth=max(self.max_depth, other.max_depth),
            num_features=self.num_features,
            objective=self.objective, num_class=self.num_class,
            init_score=self.init_score, average_output=self.average_output,
            feature_names=self.feature_names, sigmoid=self.sigmoid,
            categorical_features=self.categorical_features,
            cat_bitset=merged_bitset)

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


# ---------------------------------------------------------------------------
# Path-dependent TreeSHAP (Lundberg Algorithm 2) over array-of-nodes trees
# ---------------------------------------------------------------------------

class _ShapPath:
    __slots__ = ("d", "z", "o", "w")

    def __init__(self, d, z, o, w):
        self.d, self.z, self.o, self.w = d, z, o, w


def _extend(path, pz, po, pi):
    # value-copy the elements: the recursion branches share parent paths
    path = [_ShapPath(p.d, p.z, p.o, p.w) for p in path] + \
        [_ShapPath(pi, pz, po, 1.0 if len(path) == 0 else 0.0)]
    l = len(path) - 1
    for i in range(l - 1, -1, -1):
        path[i + 1].w += po * path[i].w * (i + 1) / (l + 1)
        path[i].w = pz * path[i].w * (l - i) / (l + 1)
    return path


def _unwind(path, i):
    l = len(path) - 1
    path = [(_ShapPath(p.d, p.z, p.o, p.w)) for p in path]
    o, z = path[i].o, path[i].z
    nxt = path[l].w
    for j in range(l - 1, -1, -1):
        if o != 0:
            tmp = path[j].w
            path[j].w = nxt * (l + 1) / ((j + 1) * o)
            nxt = tmp - path[j].w * z * (l - j) / (l + 1)
        else:
            path[j].w = path[j].w * (l + 1) / (z * (l - j))
    for j in range(i, l):
        path[j].d, path[j].z, path[j].o = path[j + 1].d, path[j + 1].z, path[j + 1].o
    path.pop()
    return path


def _unwound_sum(path, i):
    l = len(path) - 1
    o, z = path[i].o, path[i].z
    total = 0.0
    if o != 0:
        nxt = path[l].w
        for j in range(l - 1, -1, -1):
            tmp = nxt / ((j + 1) * o)
            total += tmp
            nxt = path[j].w - tmp * z * (l - j)
    else:
        for j in range(l - 1, -1, -1):
            total += path[j].w / (z * (l - j))
    return total * (l + 1)


def _tree_shap_one(x, phi, t, booster: "GBDTBooster"):
    """Accumulate SHAP values of tree t for instance x into phi (F+1,).
    Nodes: j >= 0 internal (children via left/right_child), j < 0 leaf ~j."""
    sf = booster.split_feature[t]
    th = booster.threshold[t]
    lca = booster.left_child[t]
    rca = booster.right_child[t]
    ic = booster.internal_count[t]
    lv = booster.leaf_value[t]
    lc = booster.leaf_count[t]
    w = float(booster.tree_weight[t])

    def cover(j):
        return float(ic[j]) if j >= 0 else float(lc[~j])

    def value(j):
        return float(lv[~j])  # only leaves are valued in the recursion

    total_cover = max(float(lc.sum()), 1e-12)
    phi[-1] += w * float((lv * lc).sum()) / total_cover  # E[f] under covers

    def recurse(j, path, pz, po, pi):
        path = _extend(path, pz, po, pi)
        if j < 0:  # leaf
            for i in range(1, len(path)):
                phi[path[i].d] += w * _unwound_sum(path, i) * \
                    (path[i].o - path[i].z) * value(j)
            return
        f = int(sf[j])
        left, right = int(lca[j]), int(rca[j])
        if f < 0:
            # pass-through node: everything goes left
            recurse(left, path, 1.0, 1.0, -2)
            return
        xv = x[f]
        if booster._is_cat[f]:
            if not np.isfinite(xv):
                goes_left = False
            elif booster.cat_bitset is not None:
                code = int(round(xv))
                Bb = booster.cat_bitset.shape[-1]
                goes_left = bool(0 <= code < Bb
                                 and booster.cat_bitset[t, j, code])
            else:
                goes_left = round(xv) == th[j]
        else:
            goes_left = not (xv > th[j])    # NaN compares False -> left
        hot, cold = (left, right) if goes_left else (right, left)
        rj = max(cover(j), 1e-12)
        hz, cz = cover(hot) / rj, cover(cold) / rj
        iz, io = 1.0, 1.0
        # undo previous occurrence of this feature on the path
        for k in range(1, len(path)):
            if path[k].d == f:
                iz, io = path[k].z, path[k].o
                path = _unwind(path, k)
                break
        recurse(hot, path, iz * hz, io, f)
        recurse(cold, path, iz * cz, 0.0, f)

    recurse(0, [], 1.0, 1.0, -1)


def tree_shap(booster: "GBDTBooster", X: np.ndarray) -> np.ndarray:
    """(n, F+1) exact path-dependent SHAP values (last col = expected value).
    Reference parity: ``featuresShap`` (LightGBMBooster.scala:414)."""
    X = np.asarray(X, np.float64)
    n, F = X.shape
    if booster.num_class > 1 and booster.objective == "multiclass":
        raise ValueError("slice trees per class for multiclass SHAP")
    out = np.zeros((n, F + 1), np.float64)
    out[:, F] += booster.init_score
    for i in range(n):
        for t in range(booster.num_trees):
            _tree_shap_one(X[i], out[i], t, booster)
    return out
