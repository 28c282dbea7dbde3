"""Quantile feature binning — LightGBM's BinMapper equivalent (port of
``mmlspark_tpu/lightgbm/binning.py``, the numpy path).

Edge finding and bin application both run on the host in numpy, exactly as
the JAX package does whenever ``n * F < 65536`` (its threaded C++ data
plane takes over above that; that plane is a later slice of the port), so
the two packages produce identical edges and bins on the same input.  The
uint8 bins are 4x smaller than the float32 input, so binning before the
host-to-device copy quarters the transfer.

NaN handling: NaN sorts to bin 0 (routes left), matching the booster's
missing-goes-left convention.
"""
from __future__ import annotations

from typing import Optional

import numpy as np


class BinMapper:
    """Per-feature quantile bin edges.  edges[f] has length (max_bin - 1),
    padded with +inf for features with fewer distinct values."""

    def __init__(self, max_bin: int = 255, categorical_features=None):
        if not 2 <= max_bin <= 256:
            raise ValueError("max_bin must be in [2, 256]")
        self.max_bin = max_bin
        self.edges: Optional[np.ndarray] = None  # (F, max_bin - 1) float32
        # categorical features bin by CATEGORY CODE (bin = clip(round(x),
        # 0, max_bin-1)); no quantile edges exist for them
        self.categorical_features = sorted(int(i) for i in
                                           (categorical_features or []))

    @property
    def num_bins(self) -> int:
        return self.max_bin

    def fit(self, X: np.ndarray, sample_cnt: int = 200_000,
            seed: int = 3) -> "BinMapper":
        X = np.asarray(X, np.float32)
        n, F = X.shape
        if n > sample_cnt:
            idx = np.random.default_rng(seed).choice(n, sample_cnt,
                                                     replace=False)
            X = X[idx]
        B = self.max_bin
        edges = np.full((F, B - 1), np.inf, np.float32)
        qs = np.linspace(0, 1, B + 1)[1:-1]  # B-1 interior quantiles
        cats = set(self.categorical_features)
        for f in range(F):
            if f in cats:
                continue  # code-binned: no numerical edges
            col = X[:, f]
            col = col[~np.isnan(col)]
            if col.size == 0:
                continue
            uniq = np.unique(col)
            if uniq.size <= 1:
                continue
            if uniq.size <= B:
                # few distinct values: midpoints between consecutive uniques
                mids = (uniq[:-1] + uniq[1:]) / 2.0
                edges[f, :mids.size] = mids
            else:
                e = np.quantile(col, qs)
                e = np.unique(e.astype(np.float32))
                edges[f, :e.size] = e
        self.edges = edges
        return self

    def transform(self, X: np.ndarray) -> np.ndarray:
        """(n, F) raw -> (n, F) uint8 bins.  bin = #edges < x; NaN -> 0."""
        if self.edges is None:
            raise RuntimeError("BinMapper not fitted")
        X = np.asarray(X, np.float32)
        out = np.empty(X.shape, np.uint8)
        cats = set(self.categorical_features)
        for f in range(X.shape[1]):
            if f in cats:
                continue  # filled by _overwrite_cat_bins (single code path)
            finite_edges = self.edges[f][np.isfinite(self.edges[f])]
            out[:, f] = np.searchsorted(finite_edges,
                                        np.nan_to_num(X[:, f], nan=-np.inf),
                                        side="left")
        return self._overwrite_cat_bins(X, out)

    def _overwrite_cat_bins(self, X: np.ndarray,
                            out: np.ndarray) -> np.ndarray:
        """The one categorical code-binning path: NaN -> reserved last bin;
        codes must be non-negative ints."""
        for f in self.categorical_features:
            col = X[:, f]
            finite = col[~np.isnan(col)]
            if finite.size and finite.min() < 0:
                raise ValueError(
                    f"categorical feature {f} holds negative codes "
                    f"(min {finite.min()}); encode categories as "
                    f"non-negative integers (e.g. via ValueIndexer)")
            codes = np.nan_to_num(col, nan=float(self.max_bin - 1))
            out[:, f] = np.clip(np.round(codes), 0, self.max_bin - 1) \
                .astype(np.uint8)
        return out

    def bin_upper_value(self) -> np.ndarray:
        """(F, max_bin-1) raw threshold value for 'bin <= t' splits (+inf pad
        means the split cannot occur there)."""
        return self.edges
