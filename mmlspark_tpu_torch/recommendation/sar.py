"""SAR — Smart Adaptive Recommendations.

Reference: ``recommendation/SAR.scala:36`` (item-item similarity via
cooccurrence / jaccard / lift with time-decayed user affinity) and
``SARModel.recommendForAllUsers`` (``SARModel.scala:53``; the distributed
score matrix multiply :106).

The port of ``mmlspark_tpu/recommendation/sar.py``: the item-item
co-occurrence ``seen.T @ seen`` and the scoring ``affinity @ similarity``
are dense matmuls on the estimator's and the model's ``device``, in
float32 with TF32 off (co-occurrence counts below 2^24 are exact, so the
co-occurrence and the similarity equal the host's bit for bit; scores agree
within float32 rounding).  The float64 host math (time decay, support
threshold, jaccard and lift) and ``recommend_for_all_users``' host
``argsort`` are the JAX package's.  numpy's default sort is not stable, so
equal scores keep the same order only when the scores are bit-identical.
"""
from __future__ import annotations

import math
import time
from typing import Dict, List, Optional

import numpy as np

import torch

from .._device import float32_exact, resolve_device
from ..core import (ComplexParam, DataFrame, Estimator, Model, Param)
from ..core.dataframe import _as_column


def _matmul(a: np.ndarray, b: Optional[np.ndarray], device) -> np.ndarray:
    """``a @ b`` in float32 (TF32 off) on ``device``, back as float64;
    ``b=None`` gives ``a.T @ a``."""
    dev = resolve_device(device)
    A = torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
    B = A if b is None else \
        torch.from_numpy(np.ascontiguousarray(b, np.float32)).to(dev)
    with float32_exact():
        out = A.T @ B if b is None else A @ B
    return out.cpu().numpy().astype(np.float64)


class SAR(Estimator):
    user_col = Param("user_col", "user id column", "string", default="user")
    item_col = Param("item_col", "item id column", "string", default="item")
    rating_col = Param("rating_col", "rating column", "string", default="rating")
    time_col = Param("time_col", "event timestamp column (seconds)", "string", default=None)
    support_threshold = Param("support_threshold", "min cooccurrence", "int", default=4)
    similarity_function = Param("similarity_function", "jaccard|lift|cooccurrence",
                                "string", default="jaccard")
    time_decay_coeff = Param("time_decay_coeff", "half-life days", "float", default=30.0)
    start_time = Param("start_time", "reference timestamp (seconds)", "float", default=None)
    device = Param("device", "where the matmuls run: unset = the CUDA card "
                   "(an error without one), 'cpu' = the host", "string",
                   default=None)

    def _fit(self, df: DataFrame) -> "SARModel":
        data = df.collect()
        uc, ic, rc = self.get("user_col"), self.get("item_col"), self.get("rating_col")
        users_raw = data[uc]
        items_raw = data[ic]
        ratings = np.asarray(data[rc], np.float64) if rc in data else np.ones(len(users_raw))

        user_ids, u_idx = np.unique(users_raw.astype(str), return_inverse=True)
        item_ids, i_idx = np.unique(items_raw.astype(str), return_inverse=True)
        n_u, n_i = len(user_ids), len(item_ids)

        # time-decayed affinity (reference: exp2(-(t0 - t)/T))
        tc = self.get("time_col")
        if tc and tc in data:
            t = np.asarray(data[tc], np.float64)
            t0 = self.get("start_time") or float(t.max())
            half_life_s = self.get("time_decay_coeff") * 86400.0
            decay = np.power(2.0, -(t0 - t) / half_life_s)
        else:
            decay = np.ones(len(u_idx))
        affinity = np.zeros((n_u, n_i), np.float64)
        np.add.at(affinity, (u_idx, i_idx), ratings * decay)

        # item-item cooccurrence on the device (one matmul)
        seen = np.zeros((n_u, n_i), np.float32)
        seen[u_idx, i_idx] = 1.0
        cooc = _matmul(seen, None, self.get("device"))
        thresh = self.get("support_threshold")
        cooc = np.where(cooc >= thresh, cooc, 0.0)
        diag = np.diag(cooc).copy()
        sim_fn = self.get("similarity_function")
        if sim_fn == "cooccurrence":
            sim = cooc
        elif sim_fn == "lift":
            denom = np.outer(diag, diag)
            sim = np.divide(cooc, denom, out=np.zeros_like(cooc), where=denom > 0)
        else:  # jaccard
            denom = diag[:, None] + diag[None, :] - cooc
            sim = np.divide(cooc, denom, out=np.zeros_like(cooc), where=denom > 0)

        m = SARModel()
        m.set("user_ids", user_ids.tolist())
        m.set("item_ids", item_ids.tolist())
        m.set("affinity", affinity.astype(np.float32))
        m.set("similarity", sim.astype(np.float32))
        m.set("seen", seen)
        for pcol in ("user_col", "item_col", "rating_col"):
            m.set(pcol, self.get(pcol))
        if self.is_set("device"):   # scoring runs where fitting ran
            m.set("device", self.get("device"))
        return m


class SARModel(Model):
    user_col = Param("user_col", "user id column", "string", default="user")
    item_col = Param("item_col", "item id column", "string", default="item")
    rating_col = Param("rating_col", "rating column", "string", default="rating")
    affinity = ComplexParam("affinity", "user x item affinity")
    similarity = ComplexParam("similarity", "item x item similarity")
    seen = ComplexParam("seen", "user x item seen mask")
    user_ids = Param("user_ids", "user vocabulary", "list")
    item_ids = Param("item_ids", "item vocabulary", "list")
    device = Param("device", "where scoring runs: unset = the CUDA card (an "
                   "error without one), 'cpu' = the host", "string",
                   default=None)

    def _scores(self) -> np.ndarray:
        """affinity @ similarity on the device (reference
        SARModel.scala:106)."""
        return _matmul(self.get_or_fail("affinity"),
                       self.get_or_fail("similarity"), self.get("device"))

    def recommend_for_all_users(self, num_items: int = 10,
                                remove_seen: bool = True) -> DataFrame:
        scores = self._scores()
        if remove_seen:
            scores = np.where(self.get_or_fail("seen") > 0, -np.inf, scores)
        top = np.argsort(-scores, axis=1)[:, :num_items]
        user_ids = self.get("user_ids")
        item_ids = np.asarray(self.get("item_ids"), dtype=object)
        recs = np.empty(len(user_ids), dtype=object)
        ratings = np.empty(len(user_ids), dtype=object)
        for u in range(len(user_ids)):
            items = top[u]
            valid = np.isfinite(scores[u, items])
            recs[u] = list(item_ids[items[valid]])
            ratings[u] = [float(s) for s in scores[u, items[valid]]]
        return DataFrame.from_dict({
            self.get("user_col"): _as_column(list(user_ids)),
            "recommendations": recs, "ratings": ratings})

    def _transform(self, df: DataFrame) -> DataFrame:
        """Score (user, item) pairs."""
        scores = self._scores()
        u_map = {v: i for i, v in enumerate(self.get("user_ids"))}
        i_map = {v: i for i, v in enumerate(self.get("item_ids"))}
        uc, ic = self.get("user_col"), self.get("item_col")

        def per_part(p):
            out = np.zeros(len(p[uc]), np.float64)
            for i in range(len(out)):
                u = u_map.get(str(p[uc][i]))
                it = i_map.get(str(p[ic][i]))
                out[i] = scores[u, it] if u is not None and it is not None else 0.0
            return {**p, "prediction": out}

        return df.map_partitions(per_part)
