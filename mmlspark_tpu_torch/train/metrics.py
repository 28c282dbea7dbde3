"""Evaluation metrics engine.

Reference: ``train/ComputeModelStatistics.scala:58`` (confusion-matrix math
:330-371), ``ComputePerInstanceStatistics``, metric registry
``core/metrics/MetricConstants.scala``.  The port's own copy of
``mmlspark_tpu/train/metrics.py``.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..core import DataFrame, HasLabelCol, Param, Transformer
from ..core.schema import vector_column


class MetricConstants:
    ACCURACY = "accuracy"
    PRECISION = "precision"
    RECALL = "recall"
    AUC = "AUC"
    F1 = "f1_score"
    MSE = "mean_squared_error"
    RMSE = "root_mean_squared_error"
    MAE = "mean_absolute_error"
    R2 = "R^2"
    ALL = "all"
    CLASSIFICATION_METRICS = [ACCURACY, PRECISION, RECALL, AUC, F1]
    REGRESSION_METRICS = [MSE, RMSE, MAE, R2]


def _auc(y: np.ndarray, score: np.ndarray) -> float:
    order = np.argsort(score)
    y_s = y[order]
    pos = (y_s > 0).astype(float)
    neg = 1.0 - pos
    cum_neg = np.cumsum(neg)
    P, N = pos.sum(), neg.sum()
    if P == 0 or N == 0:
        return 0.5
    return float(np.sum(pos * (cum_neg - 0.5 * neg)) / (P * N))


def confusion_matrix(y: np.ndarray, pred: np.ndarray, classes: np.ndarray) -> np.ndarray:
    k = len(classes)
    idx = {c: i for i, c in enumerate(classes)}
    cm = np.zeros((k, k), np.float64)
    for t, p in zip(y, pred):
        cm[idx[t], idx[p]] += 1
    return cm


def classification_metrics(y: np.ndarray, pred: np.ndarray,
                           scores: Optional[np.ndarray] = None) -> Dict[str, float]:
    classes = np.unique(np.concatenate([y, pred]))
    cm = confusion_matrix(y, pred, classes)
    acc = float(np.trace(cm) / max(cm.sum(), 1))
    # macro precision/recall (reference computes per-class then averages)
    with np.errstate(invalid="ignore", divide="ignore"):
        prec = np.nan_to_num(np.diag(cm) / cm.sum(axis=0))
        rec = np.nan_to_num(np.diag(cm) / cm.sum(axis=1))
    precision, recall = float(prec.mean()), float(rec.mean())
    f1 = 2 * precision * recall / max(precision + recall, 1e-12)
    out = {MetricConstants.ACCURACY: acc, MetricConstants.PRECISION: precision,
           MetricConstants.RECALL: recall, MetricConstants.F1: f1}
    if scores is not None and len(classes) <= 2:
        pos_label = classes.max()
        out[MetricConstants.AUC] = _auc((y == pos_label).astype(float), scores)
    return out


def regression_metrics(y: np.ndarray, pred: np.ndarray) -> Dict[str, float]:
    err = pred - y
    mse = float(np.mean(err ** 2))
    return {MetricConstants.MSE: mse,
            MetricConstants.RMSE: float(np.sqrt(mse)),
            MetricConstants.MAE: float(np.mean(np.abs(err))),
            MetricConstants.R2: float(1.0 - mse / max(np.var(y), 1e-12))}


class ComputeModelStatistics(Transformer, HasLabelCol):
    """Metrics frame from a scored dataset (reference :58)."""

    scores_col = Param("scores_col", "prediction column", "string", default="prediction")
    scored_probabilities_col = Param("scored_probabilities_col",
                                     "probability column (binary AUC)", "string",
                                     default=None)
    evaluation_metric = Param("evaluation_metric", "classification|regression|all",
                              "string", default="all")

    def _transform(self, df: DataFrame) -> DataFrame:
        data = df.collect()
        y = np.asarray(data[self.get_or_fail("label_col")], np.float64)
        pred = np.asarray(data[self.get_or_fail("scores_col")], np.float64)
        kind = self.get("evaluation_metric")
        if kind in ("classification", "all") and len(np.unique(y)) <= max(20, 2):
            is_classification = np.allclose(y, np.round(y)) and len(np.unique(y)) <= 20
        else:
            is_classification = False
        if kind == "classification" or (kind == "all" and is_classification):
            scores = None
            pc = self.get("scored_probabilities_col")
            if pc and pc in data:
                col = data[pc]
                scores = np.asarray([np.asarray(v)[-1] if isinstance(v, (list, np.ndarray))
                                     else float(v) for v in col], np.float64)
            m = classification_metrics(y, pred, scores)
            m["confusion_matrix"] = confusion_matrix(
                y, pred, np.unique(np.concatenate([y, pred]))).tolist()
        else:
            m = regression_metrics(y, pred)
        return DataFrame.from_rows([m])


class ComputePerInstanceStatistics(Transformer, HasLabelCol):
    """Per-row loss/correctness columns (reference
    ``ComputePerInstanceStatistics.scala``)."""

    scores_col = Param("scores_col", "prediction column", "string", default="prediction")
    scored_probabilities_col = Param("scored_probabilities_col", "probability column",
                                     "string", default=None)
    evaluation_metric = Param("evaluation_metric", "classification|regression",
                              "string", default="regression")

    def _transform(self, df: DataFrame) -> DataFrame:
        lc, sc = self.get_or_fail("label_col"), self.get("scores_col")
        kind = self.get("evaluation_metric")
        pc = self.get("scored_probabilities_col")

        def per_part(p):
            y = np.asarray(p[lc], np.float64)
            pred = np.asarray(p[sc], np.float64)
            if kind == "classification":
                correct = (y == pred).astype(np.float64)
                res = {**p, "correct": correct}
                if pc and pc in p:
                    probs = np.asarray([np.asarray(v) for v in p[pc]])
                    picked = probs[np.arange(len(y)), y.astype(int)]
                    res["log_loss"] = -np.log(np.clip(picked, 1e-15, None))
                return res
            err = pred - y
            return {**p, "L1_loss": np.abs(err), "L2_loss": err ** 2}

        return df.map_partitions(per_part)
