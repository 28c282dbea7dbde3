"""TrainClassifier / TrainRegressor — auto-featurizing wrapped learners
(the port's own copy of ``mmlspark_tpu/train/trainers.py``: featurization
on the host, the wrapped learner where its own ``device`` says).

Reference: ``train/TrainClassifier.scala:49`` (label reindex + auto
featurization wiring :140-180) and ``TrainRegressor``: wrap any learner,
``Featurize`` the raw columns into a vector, reindex labels, fit, and emit a
model that runs featurization + scoring + label decode in one transform.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..core import (ComplexParam, DataFrame, Estimator, HasFeaturesCol,
                    HasLabelCol, Model, Param)
from ..featurize import Featurize, ValueIndexer


def _wire_categorical_slots(learner, featurizer) -> None:
    """Auto-pass index-encoded slots as LightGBM categorical features — the
    reference reads categorical slot metadata off the assembled vector
    (``getCategoricalIndexes``, LightGBMBase.scala:168).  Only fires when
    the learner HAS the param and the user hasn't set it explicitly."""
    if "categorical_features" not in type(learner)._params:
        return
    if learner.is_set("categorical_features"):
        return  # respect an explicit user setting, even an empty list
    slots = featurizer.categorical_slots()
    if slots:
        learner.set("categorical_features", slots)


class TrainClassifier(Estimator, HasLabelCol):
    model = ComplexParam("model", "underlying classifier estimator")
    features_col = Param("features_col", "assembled features column", "string",
                         default="TrainClassifier_features")
    number_of_features = Param("number_of_features", "hash dims for text", "int",
                               default=2 ** 8)
    one_hot_encode_categoricals = Param(
        "one_hot_encode_categoricals", "one-hot string columns; False = index"
        "-encode and auto-wire LightGBM categorical splits", "bool",
        default=True)
    reindex_label = Param("reindex_label", "index labels to 0..K-1", "bool", default=True)

    def __init__(self, model=None, uid=None, **kwargs):
        super().__init__(uid)
        if model is not None:
            self.set("model", model)
        if kwargs:
            self.set_params(**kwargs)

    def _fit(self, df: DataFrame) -> "TrainedClassifierModel":
        learner = self.get_or_fail("model")
        lc = self.get_or_fail("label_col")
        fc = self.get("features_col")

        label_model = None
        work = df
        if self.get("reindex_label"):
            label_model = ValueIndexer().set_params(
                input_col=lc, output_col=lc + "_idx").fit(df)
            work = label_model.transform(df)
            label_for_fit = lc + "_idx"
        else:
            label_for_fit = lc

        feat_cols = [c for c in df.columns if c != lc]
        featurizer = Featurize().set_params(
            input_cols=feat_cols, output_col=fc,
            one_hot_encode_categoricals=self.get("one_hot_encode_categoricals"),
            num_features=self.get("number_of_features")).fit(work)
        work = featurizer.transform(work)

        learner = learner.copy()
        learner.set("features_col", fc)
        learner.set("label_col", label_for_fit)
        _wire_categorical_slots(learner, featurizer)
        fitted = learner.fit(work)

        out = TrainedClassifierModel()
        out.set("featurizer", featurizer)
        out.set("inner_model", fitted)
        out.set("label_model", label_model)
        out.set("label_col", lc)
        out.set("features_col", fc)
        return out


class TrainedClassifierModel(Model, HasLabelCol):
    featurizer = ComplexParam("featurizer", "fitted featurize model")
    inner_model = ComplexParam("inner_model", "fitted classifier")
    label_model = ComplexParam("label_model", "fitted label indexer")
    features_col = Param("features_col", "features column", "string")

    def _transform(self, df: DataFrame) -> DataFrame:
        work = self.get_or_fail("featurizer").transform(df)
        scored = self.get_or_fail("inner_model").transform(work)
        label_model = self.get("label_model")
        if label_model is not None:
            levels = label_model.get("levels")

            def decode(p):
                out = np.empty(len(p["prediction"]), dtype=object)
                for i, v in enumerate(p["prediction"]):
                    iv = int(v)
                    out[i] = levels[iv] if 0 <= iv < len(levels) else None
                return out

            scored = scored.with_column("predicted_" + self.get("label_col"), decode)
        return scored.drop(self.get("features_col"))


class TrainRegressor(Estimator, HasLabelCol):
    model = ComplexParam("model", "underlying regressor estimator")
    features_col = Param("features_col", "assembled features column", "string",
                         default="TrainRegressor_features")
    number_of_features = Param("number_of_features", "hash dims for text", "int",
                               default=2 ** 8)
    one_hot_encode_categoricals = Param(
        "one_hot_encode_categoricals", "one-hot string columns; False = index"
        "-encode and auto-wire LightGBM categorical splits", "bool",
        default=True)

    def __init__(self, model=None, uid=None, **kwargs):
        super().__init__(uid)
        if model is not None:
            self.set("model", model)
        if kwargs:
            self.set_params(**kwargs)

    def _fit(self, df: DataFrame) -> "TrainedRegressorModel":
        learner = self.get_or_fail("model")
        lc = self.get_or_fail("label_col")
        fc = self.get("features_col")
        feat_cols = [c for c in df.columns if c != lc]
        featurizer = Featurize().set_params(
            input_cols=feat_cols, output_col=fc,
            one_hot_encode_categoricals=self.get("one_hot_encode_categoricals"),
            num_features=self.get("number_of_features")).fit(df)
        work = featurizer.transform(df)
        learner = learner.copy()
        learner.set("features_col", fc)
        learner.set("label_col", lc)
        _wire_categorical_slots(learner, featurizer)
        fitted = learner.fit(work)
        out = TrainedRegressorModel()
        out.set("featurizer", featurizer)
        out.set("inner_model", fitted)
        out.set("features_col", fc)
        return out


class TrainedRegressorModel(Model):
    featurizer = ComplexParam("featurizer", "fitted featurize model")
    inner_model = ComplexParam("inner_model", "fitted regressor")
    features_col = Param("features_col", "features column", "string")

    def _transform(self, df: DataFrame) -> DataFrame:
        work = self.get_or_fail("featurizer").transform(df)
        return self.get_or_fail("inner_model").transform(work) \
            .drop(self.get("features_col"))
