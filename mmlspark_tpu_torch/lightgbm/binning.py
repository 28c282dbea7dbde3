"""Quantile feature binning — LightGBM's BinMapper equivalent (port of
``mmlspark_tpu/lightgbm/binning.py``).

Edges are found on the host, over a row sample, by the route the JAX
package itself picks: its threaded C++ loop (``csrc/binning.cpp``, a copy
of the reference's) when ``sample rows * F >= 65536`` and the host has at
least 4 cores, numpy otherwise.  ``transform`` applies the bins on the host
by the same predicate over ``X.size``; ``transform(X, device=...)`` is the
reference's ``transform(device=True)`` (``ops.histogram.bin_matrix``).  So
edges and host bins equal the reference's on every input, ±inf included.

The two host routes differ on non-finite edges, and ``bin_on_device``
keeps that difference: it applies on the card exactly the bins that the
host route for ``X`` would give, which is what ``train()`` uses.

- C++: only a feature's LEADING finite edges count, NaN -> bin 0.  A
  column holding ``-inf`` fits a first edge of ``-inf`` and bins every row
  to 0.
- numpy: the finite edges count, NaN -> ``-inf``, and ``±inf`` become
  ``±FLT_MAX`` (``np.nan_to_num``).

Categorical features bin by code on every route (``_overwrite_cat_bins``).

Out of core, ``BinMapper.fit_streaming`` finds the edges from a
``StreamingQuantileSketch`` fed one host tile at a time (copies of the
reference's, whose reservoir draws come from the same
``np.random.default_rng(seed)``, so both keep the very same rows).
"""
from __future__ import annotations

import multiprocessing
from typing import Iterable, Optional

import numpy as np
import torch

from .._device import DeviceLike
from ..ops import histogram as hist_ops

#: the JAX package's threshold for its C++ plane, in cells
NATIVE_MIN_CELLS = 1 << 16


def host_route(cells: int) -> str:
    """The reference's route predicate (``binning.py:95-101``,
    ``:167-171``): ``"cxx"`` for ``cells >= 65536`` on a host of at least
    4 cores, else ``"numpy"``."""
    if cells >= NATIVE_MIN_CELLS and multiprocessing.cpu_count() >= 4:
        return "cxx"
    return "numpy"


class StreamingQuantileSketch:
    """Bounded-memory quantile sketch for out-of-core edge finding: a
    vectorized row reservoir (Algorithm R) fed tile by tile.

    ``BinMapper.fit`` already computes edges from a <=``sample_cnt`` row
    sample; this sketch produces the SAME kind of sample without ever
    holding the full matrix — ``fit_streaming`` over host tiles is the
    out-of-core twin of ``fit``.  When the total row count fits the
    reservoir the sample is the exact dataset (every row retained in
    order), so streamed edges are IDENTICAL to the in-memory fit's; above
    the cap each row survives with probability ``cap / n`` (within-chunk
    replacement collisions resolve last-write-wins — a sketch, not a
    permutation-exact reservoir, which edge quantiles do not need).
    """

    def __init__(self, num_features: int, sample_cnt: int = 200_000,
                 seed: int = 3):
        self.cap = int(sample_cnt)
        self.seen = 0
        self._buf = np.empty((self.cap, num_features), np.float32)
        self._rng = np.random.default_rng(seed)

    def add(self, chunk: np.ndarray) -> "StreamingQuantileSketch":
        chunk = np.asarray(chunk, np.float32)
        m = chunk.shape[0]
        fill = max(0, min(self.cap - self.seen, m))
        if fill:
            self._buf[self.seen:self.seen + fill] = chunk[:fill]
        rest = chunk[fill:]
        if rest.shape[0]:
            s = self.seen + fill + np.arange(rest.shape[0])
            accept = self._rng.random(rest.shape[0]) < self.cap / (s + 1.0)
            idx = np.flatnonzero(accept)
            if idx.size:
                slots = self._rng.integers(0, self.cap, size=idx.size)
                self._buf[slots] = rest[idx]
        self.seen += m
        return self

    def sample(self) -> np.ndarray:
        """The retained row sample (the whole stream when it fit)."""
        return self._buf[: min(self.seen, self.cap)]


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
        if host_route(X.shape[0] * F) == "cxx":
            from ..utils.native_loader import bin_edges_native
            edges = bin_edges_native(X, B)
            if self.categorical_features:  # code-binned: no edges
                edges[self.categorical_features] = np.inf
            self.edges = edges
            return self
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

    def fit_streaming(self, chunks: Iterable[np.ndarray],
                      sample_cnt: int = 200_000, seed: int = 3) -> "BinMapper":
        """Out-of-core ``fit``: edges from a :class:`StreamingQuantileSketch`
        fed one host tile at a time — no full-matrix materialization.  When
        the stream's total rows fit ``sample_cnt`` the resulting edges are
        bit-identical to ``fit`` on the concatenated matrix (the reservoir
        holds every row; ``fit`` would have used them all too)."""
        sketch: Optional[StreamingQuantileSketch] = None
        for chunk in chunks:
            chunk = np.asarray(chunk, np.float32)
            if sketch is None:
                sketch = StreamingQuantileSketch(chunk.shape[1], sample_cnt,
                                                 seed)
            sketch.add(chunk)
        if sketch is None:
            raise ValueError("fit_streaming received an empty chunk stream")
        # the sample already fits fit()'s budget: no re-subsampling happens
        return self.fit(sketch.sample(), sample_cnt=sample_cnt, seed=seed)

    def _fitted(self) -> np.ndarray:
        if self.edges is None:
            raise RuntimeError("BinMapper not fitted")
        return self.edges

    def _host_bins(self, X: np.ndarray, route: str, edges: np.ndarray,
                   skip=()) -> np.ndarray:
        """Numerical bins of ``X`` by one host route (columns in ``skip``
        left unset on the numpy route)."""
        if route == "cxx":
            from ..utils.native_loader import bin_apply_native
            return bin_apply_native(X, edges, self.max_bin)
        out = np.empty(X.shape, np.uint8)
        for f in range(X.shape[1]):
            if f in skip:
                continue  # filled by _overwrite_cat_bins (single code path)
            finite_edges = edges[f][np.isfinite(edges[f])]
            out[:, f] = np.searchsorted(finite_edges,
                                        np.nan_to_num(X[:, f], nan=-np.inf),
                                        side="left")
        return out

    def transform(self, X: np.ndarray, device: DeviceLike = None
                  ) -> np.ndarray:
        """(n, F) raw -> (n, F) uint8 bins.  bin = #edges < x; NaN -> 0.

        Host binning by default, by the reference's route for ``X.size``;
        with ``device`` (the reference's ``device=True``) the bins are
        digitized there by ``ops.histogram.bin_matrix`` and returned."""
        edges = self._fitted()
        X = np.asarray(X, np.float32)
        if device is not None:
            x = torch.from_numpy(X).to(device)
            out = hist_ops.bin_matrix(x, torch.from_numpy(edges).to(device),
                                      self.max_bin).cpu().numpy()
            return self._overwrite_cat_bins(X, out)
        out = self._host_bins(X, host_route(X.size), edges,
                              set(self.categorical_features))
        return self._overwrite_cat_bins(X, out)

    def route_table(self, route: str):
        """The edges a host route searches, per feature, compacted to the
        front of a ``(F, max_bin - 1)`` float32 table padded with +inf
        (C++: the leading finite edges; numpy: every finite edge), and
        whether each feature's table is ascending (the fitted edges always
        are; a searchsorted needs it)."""
        edges = self._fitted()
        table = np.full_like(edges, np.inf)
        for f, e in enumerate(edges):
            fin = np.isfinite(e)
            if route == "cxx":
                keep = e if fin.all() else e[:int(np.argmin(fin))]
            else:
                keep = e[fin]
            table[f, :keep.size] = keep
        ascending = np.all(table[:, 1:] >= table[:, :-1], axis=1)
        return table, ascending

    def bin_on_device(self, X: np.ndarray,
                      device: DeviceLike) -> torch.Tensor:
        """The bins the host ``transform`` gives ``X``, applied on
        ``device``: ``X`` crosses once as float32 and the result is the
        feature-major ``(F, n)`` uint8 matrix the histogram kernel reads
        (``.t()`` is the ``(n, F)`` view the growers take).  The route is
        the one ``transform`` would take for ``X``; a feature whose table is
        not ascending (never from ``fit``) is binned on the host instead.
        Categorical codes follow ``_overwrite_cat_bins``, negative codes
        raising."""
        X = np.asarray(X, np.float32)
        route = host_route(X.size)
        table, ascending = self.route_table(route)
        dev = torch.device(device)
        x = torch.from_numpy(X).to(dev)
        bins = hist_ops.apply_bins(x, torch.from_numpy(table).to(dev),
                                   nan_to_num=route == "numpy")
        cats = self.categorical_features
        ascending[cats] = True
        host = np.nonzero(~ascending)[0]
        if host.size:
            cols = self._host_bins(np.ascontiguousarray(X[:, host]), route,
                                   self.edges[host])
            bins[torch.from_numpy(host).to(dev)] = torch.from_numpy(
                np.ascontiguousarray(cols.T)).to(dev)
        if cats:
            idx = torch.tensor(cats, device=dev)
            codes, low = hist_ops.category_bins(x.index_select(1, idx),
                                                self.max_bin)
            low = low.cpu().numpy()
            for f, m in zip(cats, low):
                if m < 0:
                    raise ValueError(self._negative_codes(f, np.float32(m)))
            bins[idx] = codes
        return bins

    @staticmethod
    def _negative_codes(f: int, low) -> str:
        return (f"categorical feature {f} holds negative codes (min {low}); "
                f"encode categories as non-negative integers (e.g. via "
                f"ValueIndexer)")

    def _overwrite_cat_bins(self, X: np.ndarray,
                            out: np.ndarray) -> np.ndarray:
        """The one categorical code-binning path: NaN -> reserved last bin;
        codes must be non-negative ints."""
        for f in self.categorical_features:
            col = X[:, f]
            finite = col[~np.isnan(col)]
            if finite.size and finite.min() < 0:
                raise ValueError(self._negative_codes(f, finite.min()))
            codes = np.nan_to_num(col, nan=float(self.max_bin - 1))
            out[:, f] = np.clip(np.round(codes), 0, self.max_bin - 1) \
                .astype(np.uint8)
        return out

    def bin_upper_value(self) -> np.ndarray:
        """(F, max_bin-1) raw threshold value for 'bin <= t' splits (+inf pad
        means the split cannot occur there)."""
        return self.edges
