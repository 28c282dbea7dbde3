"""RecommendationIndexer — string user/item ids to contiguous indices (the
port's own copy of ``mmlspark_tpu/recommendation/indexer.py``; host).

Reference: ``recommendation/RecommendationIndexer.scala`` (wraps two
StringIndexers so ALS/SAR consume integer ids).
"""
from __future__ import annotations

import numpy as np

from ..core import DataFrame, Estimator, Model, Param


class RecommendationIndexer(Estimator):
    user_input_col = Param("user_input_col", "raw user column", "string", default="user")
    user_output_col = Param("user_output_col", "indexed user column", "string", default="user_idx")
    item_input_col = Param("item_input_col", "raw item column", "string", default="item")
    item_output_col = Param("item_output_col", "indexed item column", "string", default="item_idx")
    rating_col = Param("rating_col", "rating column", "string", default="rating")

    def _fit(self, df: DataFrame) -> "RecommendationIndexerModel":
        data = df.collect()
        users = sorted(set(str(v) for v in data[self.get("user_input_col")]))
        items = sorted(set(str(v) for v in data[self.get("item_input_col")]))
        m = RecommendationIndexerModel()
        for pcol in ("user_input_col", "user_output_col", "item_input_col",
                     "item_output_col", "rating_col"):
            m.set(pcol, self.get(pcol))
        m.set("user_vocab", users)
        m.set("item_vocab", items)
        return m


class RecommendationIndexerModel(Model):
    user_input_col = Param("user_input_col", "raw user column", "string", default="user")
    user_output_col = Param("user_output_col", "indexed user column", "string", default="user_idx")
    item_input_col = Param("item_input_col", "raw item column", "string", default="item")
    item_output_col = Param("item_output_col", "indexed item column", "string", default="item_idx")
    rating_col = Param("rating_col", "rating column", "string", default="rating")
    user_vocab = Param("user_vocab", "user values", "list")
    item_vocab = Param("item_vocab", "item values", "list")

    def _transform(self, df: DataFrame) -> DataFrame:
        u_map = {v: float(i) for i, v in enumerate(self.get("user_vocab"))}
        i_map = {v: float(i) for i, v in enumerate(self.get("item_vocab"))}
        uc, ic = self.get("user_input_col"), self.get("item_input_col")
        out = df.with_column(self.get("user_output_col"),
                             lambda p: np.asarray([u_map.get(str(v), -1.0) for v in p[uc]]))
        return out.with_column(self.get("item_output_col"),
                               lambda p: np.asarray([i_map.get(str(v), -1.0) for v in p[ic]]))

    def recover_user(self, idx: int):
        return self.get("user_vocab")[int(idx)]

    def recover_item(self, idx: int):
        return self.get("item_vocab")[int(idx)]
