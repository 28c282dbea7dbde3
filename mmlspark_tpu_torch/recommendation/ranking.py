"""Ranking evaluation infrastructure (the port's own copy of
``mmlspark_tpu/recommendation/ranking.py``; host).

Reference: ``recommendation/RankingAdapter.scala:69`` (wraps a recommender so
its per-user top-k output can be evaluated), ``RankingEvaluator`` (ndcgAt /
map / precisionAtK / recallAtK), ``RankingTrainValidationSplit.scala:25``
(per-user time/ratio splits :94).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..core import (ComplexParam, DataFrame, Estimator, Evaluator, Model, Param)
from ..core.dataframe import _as_column


class RankingAdapter(Estimator):
    """Fit the wrapped recommender; transform emits per-user (recs, ground
    truth) for the evaluator."""
    recommender = ComplexParam("recommender", "underlying recommender estimator")
    k = Param("k", "recommendations per user", "int", default=10)
    user_col = Param("user_col", "user column", "string", default="user")
    item_col = Param("item_col", "item column", "string", default="item")
    rating_col = Param("rating_col", "rating column", "string", default="rating")

    def __init__(self, recommender=None, uid=None, **kwargs):
        super().__init__(uid)
        if recommender is not None:
            self.set("recommender", recommender)
        if kwargs:
            self.set_params(**kwargs)

    def _fit(self, df: DataFrame) -> "RankingAdapterModel":
        fitted = self.get_or_fail("recommender").fit(df)
        m = RankingAdapterModel()
        m.set("fitted", fitted)
        for pcol in ("k", "user_col", "item_col", "rating_col"):
            m.set(pcol, self.get(pcol))
        return m


class RankingAdapterModel(Model):
    fitted = ComplexParam("fitted", "fitted recommender")
    k = Param("k", "recommendations per user", "int", default=10)
    user_col = Param("user_col", "user column", "string", default="user")
    item_col = Param("item_col", "item column", "string", default="item")
    rating_col = Param("rating_col", "rating column", "string", default="rating")

    def _transform(self, df: DataFrame) -> DataFrame:
        """Emit one row per user: prediction = recommended items, label =
        ground-truth items (sorted by rating)."""
        fitted = self.get_or_fail("fitted")
        uc, ic, rc = self.get("user_col"), self.get("item_col"), self.get("rating_col")
        recs = fitted.recommend_for_all_users(self.get("k"), remove_seen=False)
        rec_map = {str(r[uc]): list(r["recommendations"]) for r in recs.iter_rows()}
        data = df.collect()
        truth: Dict[str, List] = {}
        for i in range(len(data[uc])):
            truth.setdefault(str(data[uc][i]), []).append(
                (float(data[rc][i]) if rc in data else 1.0, data[ic][i]))
        users = sorted(truth)
        pred_col = np.empty(len(users), dtype=object)
        label_col = np.empty(len(users), dtype=object)
        for i, u in enumerate(users):
            pred_col[i] = [str(x) for x in rec_map.get(u, [])]
            label_col[i] = [str(it) for _, it in sorted(truth[u], reverse=True,
                                                        key=lambda t: t[0])]
        return DataFrame.from_dict({self.get("user_col"): _as_column(users),
                                    "prediction": pred_col, "label": label_col})


class RankingEvaluator(Evaluator):
    k = Param("k", "cutoff", "int", default=10)
    metric_name = Param("metric_name", "ndcgAt|map|precisionAtk|recallAtK|fcp",
                        "string", default="ndcgAt")
    prediction_col = Param("prediction_col", "ranked prediction lists", "string",
                           default="prediction")
    label_col = Param("label_col", "ground-truth lists", "string", default="label")

    def evaluate(self, df: DataFrame) -> float:
        k = self.get("k")
        metric = self.get("metric_name")
        data = df.collect()
        preds = data[self.get("prediction_col")]
        labels = data[self.get("label_col")]
        vals = []
        for pred, truth in zip(preds, labels):
            pred = list(pred)[:k]
            truth_set = set(truth)
            if not truth_set:
                continue
            hits = [1.0 if p in truth_set else 0.0 for p in pred]
            if metric == "precisionAtk":
                vals.append(sum(hits) / k)
            elif metric == "recallAtK":
                vals.append(sum(hits) / len(truth_set))
            elif metric == "map":
                s, h = 0.0, 0
                for i, hit in enumerate(hits):
                    if hit:
                        h += 1
                        s += h / (i + 1)
                vals.append(s / min(len(truth_set), k))
            else:  # ndcgAt
                dcg = sum(h / np.log2(i + 2) for i, h in enumerate(hits))
                idcg = sum(1.0 / np.log2(i + 2) for i in range(min(len(truth_set), k)))
                vals.append(dcg / idcg if idcg > 0 else 0.0)
        return float(np.mean(vals)) if vals else 0.0


class RankingTrainValidationSplit(Estimator):
    """Per-user holdout split + fit + evaluate (reference :25, split :94)."""
    estimator = ComplexParam("estimator", "ranking adapter / recommender")
    evaluator = ComplexParam("evaluator", "RankingEvaluator")
    train_ratio = Param("train_ratio", "per-user train fraction", "float", default=0.75)
    user_col = Param("user_col", "user column", "string", default="user")
    item_col = Param("item_col", "item column", "string", default="item")
    min_ratings_per_user = Param("min_ratings_per_user", "drop sparse users", "int", default=1)
    seed = Param("seed", "shuffle seed", "int", default=0)

    def _fit(self, df: DataFrame):
        uc = self.get("user_col")
        rng = np.random.default_rng(self.get("seed"))
        whole = df.collect()
        n = len(whole[uc])
        by_user: Dict[str, List[int]] = {}
        for i in range(n):
            by_user.setdefault(str(whole[uc][i]), []).append(i)
        train_idx, test_idx = [], []
        ratio = self.get("train_ratio")
        for u, idxs in by_user.items():
            if len(idxs) < self.get("min_ratings_per_user"):
                continue
            idxs = list(idxs)
            rng.shuffle(idxs)
            cut = max(1, int(round(len(idxs) * ratio)))
            train_idx.extend(idxs[:cut])
            test_idx.extend(idxs[cut:])
        tr = DataFrame([{k: v[np.asarray(train_idx, int)] for k, v in whole.items()}])
        te = DataFrame([{k: v[np.asarray(test_idx, int)] for k, v in whole.items()}]) \
            if test_idx else tr
        model = self.get_or_fail("estimator").fit(tr)
        ev = self.get("evaluator")
        self.validation_metrics = [ev.evaluate(model.transform(te))] if ev else []
        return model
