"""Superpixel segmentation (SLIC-style).

An own copy of the JAX package's ``explainers/superpixel.py``, verbatim
apart from module paths.

Reference: legacy ``lime/Superpixel.scala:148`` — SLIC-like clustering used
by image LIME, plus ``SuperpixelTransformer``.  Implemented as a bounded
k-means over (color, position) features with grid initialisation; vectorized
numpy (host-side preprocessing, like the reference's JVM implementation).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..core import DataFrame, HasInputCol, HasOutputCol, Param, Transformer


def slic_superpixels(img: np.ndarray, cell_size: float = 16.0,
                     modifier: float = 130.0, iters: int = 5) -> np.ndarray:
    """(H, W, C) image -> (H, W) int32 superpixel labels."""
    H, W = img.shape[:2]
    C = img.shape[2] if img.ndim == 3 else 1
    img = img.reshape(H, W, C).astype(np.float64)
    S = max(int(cell_size), 2)
    gy = np.arange(S // 2, H, S)
    gx = np.arange(S // 2, W, S)
    centers = np.array([[y, x] for y in gy for x in gx], np.float64)
    k = len(centers)
    if k <= 1:
        return np.zeros((H, W), np.int32)
    cc = np.stack([img[int(y), int(x)] for y, x in centers])  # (k, C)

    yy, xx = np.mgrid[0:H, 0:W]
    pos = np.stack([yy, xx], axis=-1).astype(np.float64)      # (H, W, 2)
    # spatial weight balances color vs position (SLIC compactness m)
    m = max(modifier, 1e-3)
    ratio = (m / S) ** 2

    labels = np.zeros((H, W), np.int64)
    for _ in range(iters):
        # assign: distance to each center over a local window
        dist = np.full((H, W), np.inf)
        for ci in range(k):
            cy, cx = centers[ci]
            y0, y1 = max(0, int(cy) - 2 * S), min(H, int(cy) + 2 * S)
            x0, x1 = max(0, int(cx) - 2 * S), min(W, int(cx) + 2 * S)
            if y0 >= y1 or x0 >= x1:
                continue
            dc = ((img[y0:y1, x0:x1] - cc[ci]) ** 2).sum(axis=-1)
            ds = ((pos[y0:y1, x0:x1] - centers[ci]) ** 2).sum(axis=-1)
            d = dc + ratio * ds
            sub = dist[y0:y1, x0:x1]
            upd = d < sub
            sub[upd] = d[upd]
            labels[y0:y1, x0:x1][upd] = ci
        # update centers
        for ci in range(k):
            mask = labels == ci
            if mask.any():
                centers[ci] = pos[mask].mean(axis=0)
                cc[ci] = img[mask].mean(axis=0)
    # compact label ids
    uniq, remap = np.unique(labels, return_inverse=True)
    return remap.reshape(H, W).astype(np.int32)


class SuperpixelTransformer(Transformer, HasInputCol, HasOutputCol):
    """Reference ``SuperpixelTransformer``: image column -> superpixel map."""
    cell_size = Param("cell_size", "superpixel size", "float", default=16.0)
    modifier = Param("modifier", "compactness", "float", default=130.0)

    def _transform(self, df: DataFrame) -> DataFrame:
        in_col = self.get_or_fail("input_col")
        cs, mod = self.get("cell_size"), self.get("modifier")

        def per_part(p):
            out = np.empty(len(p[in_col]), dtype=object)
            for i, v in enumerate(p[in_col]):
                out[i] = slic_superpixels(np.asarray(v, np.float64), cs, mod)
            return {**p, self.get_or_fail("output_col"): out}

        return df.map_partitions(per_part)
