"""KNN / ConditionalKNN estimators (the port of ``mmlspark_tpu/nn/knn.py``).

Reference: ``nn/ConditionalKNN.scala:31`` — fit broadcasts a (Conditional)
BallTree; transform queries it per row (``KNNFuncHolder.queryFunc:64``).

The default query path is brute-force MIPS on the model's ``device``:
``scores = Q @ X^T`` in float32 with TF32 off, then ``torch.topk``, over
chunks of 1,024 query rows, with the item table moved to the device once
per transform.  ``lax.top_k`` gives the lower index first among equal
scores and ``torch.topk`` on CUDA promises no order, so the chosen k are
sorted by (-score, index); which of several items tied at the k-th place
is chosen may still differ.  The ball tree (``use_ball_tree``) and
``ConditionalKNN`` stay on the host, as own copies; the tree is what gets
serialized either way.
"""
from __future__ import annotations

import numpy as np
import torch

from .._device import float32_exact, resolve_device
from ..core import (ComplexParam, DataFrame, Estimator, HasFeaturesCol,
                    HasOutputCol, Model, Param)
from ..core.schema import ColumnType, stack_vector_column
from .balltree import BallTree, ConditionalBallTree


def _device_topk(X: torch.Tensor, queries: np.ndarray, k: int,
                 batch: int = 1024):
    """(scores, indices) per query: ``queries @ X.T`` (float32, TF32 off)
    and its top ``k``, ``batch`` query rows at a time, each row's k sorted
    by (-score, index).  ``X`` is the float32 item table on the device."""
    out_scores, out_idx = [], []
    with float32_exact():
        for s in range(0, len(queries), batch):
            Q = torch.from_numpy(np.ascontiguousarray(
                queries[s:s + batch], np.float32)).to(X.device)
            sc, ix = torch.topk(Q @ X.T, k, dim=1)
            ix, order = torch.sort(ix, dim=1)
            sc = sc.gather(1, order)
            sc, order = torch.sort(sc, dim=1, descending=True, stable=True)
            out_scores.append(sc)
            out_idx.append(ix.gather(1, order))
    return (torch.cat(out_scores).cpu().numpy(),
            torch.cat(out_idx).cpu().numpy())


class KNN(Estimator, HasFeaturesCol, HasOutputCol):
    values_col = Param("values_col", "payload column returned with matches", "string",
                       default="values")
    k = Param("k", "neighbours per query", "int", default=5)
    leaf_size = Param("leaf_size", "ball tree leaf size", "int", default=50)
    device = Param("device", "where the model queries: unset = the CUDA "
                   "card (an error without one), 'cpu' = the host",
                   "string", default=None)

    def _fit(self, df: DataFrame) -> "KNNModel":
        data = df.collect()
        X = stack_vector_column(data[self.get_or_fail("features_col")])
        vc = self.get("values_col")
        values = list(data[vc]) if vc in data else list(range(len(X)))
        tree = BallTree(X, values, self.get("leaf_size"))
        m = KNNModel()
        m.set("ball_tree", tree)
        m.set("k", self.get("k"))
        m.set("features_col", self.get("features_col"))
        m.set("output_col", self.get("output_col"))
        if self.is_set("device"):
            m.set("device", self.get("device"))
        return m


class KNNModel(Model, HasFeaturesCol, HasOutputCol):
    ball_tree = ComplexParam("ball_tree", "fitted BallTree")
    k = Param("k", "neighbours per query", "int", default=5)
    use_ball_tree = Param("use_ball_tree", "query via tree instead of device "
                                           "matmul", "bool", default=False)
    device = Param("device", "where the matmul query runs: unset = the CUDA "
                   "card (an error without one), 'cpu' = the host",
                   "string", default=None)

    def _transform(self, df: DataFrame) -> DataFrame:
        tree: BallTree = self.get_or_fail("ball_tree")
        k = self.get("k")
        fc, oc = self.get_or_fail("features_col"), self.get_or_fail("output_col")
        host = self.get("use_ball_tree") or len(tree.data) < 32
        X = None if host else torch.from_numpy(np.ascontiguousarray(
            tree.data, np.float32)).to(resolve_device(self.get("device")))

        def per_part(p):
            Q = stack_vector_column(p[fc])
            out = np.empty(len(Q), dtype=object)
            if host:
                for i in range(len(Q)):
                    matches = tree.find_maximum_inner_products(Q[i], k)
                    out[i] = [{"value": tree.values[j], "distance": ip}
                              for j, ip in matches]
            else:
                scores, idx = _device_topk(X, Q, min(k, len(tree.data)))
                for i in range(len(Q)):
                    out[i] = [{"value": tree.values[j], "distance": float(s)}
                              for j, s in zip(idx[i], scores[i])]
            return {**p, oc: out}

        return df.map_partitions(per_part)

    def transform_schema(self, schema):
        schema.require(self.get_or_fail("features_col"))
        return schema.add(self.get_or_fail("output_col"), ColumnType.ARRAY)


class ConditionalKNN(Estimator, HasFeaturesCol, HasOutputCol):
    values_col = Param("values_col", "payload column", "string", default="values")
    label_col = Param("label_col", "conditioning label column", "string", default="labels")
    k = Param("k", "neighbours per query", "int", default=5)
    leaf_size = Param("leaf_size", "ball tree leaf size", "int", default=50)

    def _fit(self, df: DataFrame) -> "ConditionalKNNModel":
        data = df.collect()
        X = stack_vector_column(data[self.get_or_fail("features_col")])
        values = list(data[self.get("values_col")]) if self.get("values_col") in data \
            else list(range(len(X)))
        labels = list(data[self.get_or_fail("label_col")])
        tree = ConditionalBallTree(X, values, labels, self.get("leaf_size"))
        m = ConditionalKNNModel()
        m.set("ball_tree", tree)
        m.set("k", self.get("k"))
        m.set("features_col", self.get("features_col"))
        m.set("output_col", self.get("output_col"))
        return m


class ConditionalKNNModel(Model, HasFeaturesCol, HasOutputCol):
    ball_tree = ComplexParam("ball_tree", "fitted ConditionalBallTree")
    k = Param("k", "neighbours per query", "int", default=5)
    conditioner_col = Param("conditioner_col", "column holding allowed label sets",
                            "string", default="conditioner")

    def _transform(self, df: DataFrame) -> DataFrame:
        tree: ConditionalBallTree = self.get_or_fail("ball_tree")
        k = self.get("k")
        fc, oc = self.get_or_fail("features_col"), self.get_or_fail("output_col")
        cc = self.get("conditioner_col")

        def per_part(p):
            Q = stack_vector_column(p[fc])
            out = np.empty(len(Q), dtype=object)
            for i in range(len(Q)):
                cond = set(p[cc][i]) if cc in p else None
                matches = tree.find_maximum_inner_products(Q[i], k, cond)
                out[i] = [{"value": tree.values[j], "label": tree.labels_arr[j],
                           "distance": ip} for j, ip in matches]
            return {**p, oc: out}

        return df.map_partitions(per_part)

    def transform_schema(self, schema):
        schema.require(self.get_or_fail("features_col"))
        return schema.add(self.get_or_fail("output_col"), ColumnType.ARRAY)
