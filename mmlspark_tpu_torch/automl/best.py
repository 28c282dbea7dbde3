"""FindBestModel — evaluate fitted models and keep the winner (the port's
own copy of ``mmlspark_tpu/automl/best.py``).

Reference: ``automl/FindBestModel.scala`` (``BestModel`` exposes the winning
transformer, evaluation results and ROC data).
"""
from __future__ import annotations

from typing import List

import numpy as np

from ..core import ComplexParam, DataFrame, Estimator, Model, Param
from .tune import _metric_value


class FindBestModel(Estimator):
    models = ComplexParam("models", "fitted transformers to compare")
    evaluation_metric = Param("evaluation_metric", "metric name", "string",
                              default="accuracy")
    label_col = Param("label_col", "label column", "string", default="label")

    def _fit(self, df: DataFrame) -> "BestModel":
        models = self.get_or_fail("models")
        metric = self.get("evaluation_metric")
        scores = []
        larger_better = True
        for m in models:
            scored = m.transform(df)
            v, larger_better = _metric_value(scored, self.get("label_col"), metric)
            scores.append(v)
        best_i = int(np.argmax(scores) if larger_better else np.argmin(scores))
        out = BestModel()
        out.set("best_model", models[best_i])
        out.set("best_model_metrics", scores[best_i])
        out.set("all_model_metrics", scores)
        return out


class BestModel(Model):
    best_model = ComplexParam("best_model", "winning transformer")
    best_model_metrics = Param("best_model_metrics", "winning metric", "float")
    all_model_metrics = Param("all_model_metrics", "all metrics", "list")

    def _transform(self, df: DataFrame) -> DataFrame:
        return self.get_or_fail("best_model").transform(df)

    def get_evaluation_results(self) -> List[float]:
        return self.get("all_model_metrics")
