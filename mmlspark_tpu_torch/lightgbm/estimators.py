"""LightGBM-compatible estimators over the PyTorch GBDT core (port of
``mmlspark_tpu/lightgbm/estimators.py``: classifier, regressor, ranker).

Same param names, defaults and semantics as the JAX package.  The defaults
grow leaf-wise (``num_leaves`` = 31, LightGBM's best-first growth);
``max_depth`` set alone selects level-wise growth, and with ``num_leaves``
it caps the leaf-wise depth.  ``boosting_type`` gbdt, rf, dart and goss
with their rates, bagging, categorical features (one-vs-rest up to
``max_cat_to_onehot`` observed codes, sorted-subset above), binary and
multiclass labels, the regressor's objectives and the ranker's LambdaRank
pass through to ``train()``; the classifier's ``num_batches`` trains in
sequential batches with warm start between them (the reference's
``LightGBMBase.scala:46-61``), and the regressor, as the JAX package's,
trains in one batch whatever it says.  ``checkpoint_dir`` and
``checkpoint_every`` reach ``train()`` (periodic snapshots, preemption and
resume; with ``num_batches > 1`` each batch checkpoints into its own
``batch_{i:04d}`` directory, as in the reference).  ``monitor_port`` and
``monitor_stall_timeout_s`` reach ``train()``, which serves the live
training monitor (``observability.trainwatch``) while ``fit`` runs.  The
distributed params reach ``train()``: ``shard_rows`` shards the rows over
the active mesh's ``data`` axis (every rank of a process group fits with
the same frame and gets the same booster), and
``parallelism="voting_parallel"`` with ``top_k`` votes on the features to
sum there (on one device it grows the full-histogram trees, as in the JAX
package).  ``device`` picks where
training and scoring run: the card by default, ``"cpu"`` for the plain
PyTorch versions.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core import (ComplexParam, DataFrame, Estimator, HasFeaturesCol,
                    HasLabelCol, HasPredictionCol, HasProbabilityCol,
                    HasRawPredictionCol, HasWeightCol, Model, Param)
from ..core.schema import ColumnType, stack_vector_column
from ..models.gbdt import GBDTBooster
from . import core as gbdt_core
from .core import GBDTParams


def _shared_params(cls):
    """Attach the shared LightGBM param surface (TrainParams.scala names)."""
    specs = [
        ("num_iterations", "number of boosting iterations", "int", 100),
        ("learning_rate", "shrinkage rate", "float", 0.1),
        ("num_leaves", "max leaves per tree (leaf-wise best-first growth, "
                       "LightGBM numLeaves semantics)", "int", 31),
        ("max_depth", "max tree depth; set alone it selects level-wise "
                      "depth growth, with num_leaves it caps leaf-wise depth",
         "int", None),
        ("max_bin", "max histogram bins per feature", "int", 255),
        ("boosting_type", "gbdt|rf|dart|goss", "string", "gbdt"),
        ("lambda_l1", "L1 regularization", "float", 0.0),
        ("lambda_l2", "L2 regularization", "float", 0.0),
        ("min_data_in_leaf", "min rows per leaf", "int", 20),
        ("min_sum_hessian_in_leaf", "min hessian per leaf", "float", 1e-3),
        ("min_gain_to_split", "min split gain", "float", 0.0),
        ("bagging_fraction", "row subsample fraction", "float", 1.0),
        ("bagging_freq", "bagging frequency (0=off)", "int", 0),
        ("feature_fraction", "feature subsample fraction", "float", 1.0),
        ("top_rate", "GOSS large-gradient keep rate", "float", 0.2),
        ("other_rate", "GOSS small-gradient sample rate", "float", 0.1),
        ("drop_rate", "DART tree drop rate", "float", 0.1),
        ("max_drop", "DART max dropped trees", "int", 50),
        ("skip_drop", "DART skip probability", "float", 0.5),
        ("max_delta_step", "max leaf output", "float", 0.0),
        ("early_stopping_round", "stop if no valid improvement", "int", 0),
        ("metric", "eval metric name ('' = objective default)", "string", ""),
        ("validation_indicator_col", "bool column marking validation rows",
         "string", None),
        ("model_string", "warm-start model string", "string", None),
        ("num_batches", "split training into sequential batches "
                        "(LightGBMBase.scala:46-61)", "int", 0),
        ("growth", "tree growth strategy: leaf (LightGBM best-first) | "
                   "level (depth-wise) | auto (leaf unless only max_depth "
                   "is set)", "string", "auto"),
        ("seed", "random seed", "int", 0),
        ("parallelism", "data_parallel (full histogram psum) | "
                        "voting_parallel (top-k feature voting, O(k*B) comm) "
                        "| serial", "string", "data_parallel"),
        ("top_k", "voting_parallel: local top-k features voted per node "
                  "(reference TrainParams topK)", "int", 20),
        ("shard_rows", "shard rows over the active device mesh", "bool", False),
        ("categorical_features", "feature indices treated as categorical "
         "(one-vs-rest below max_cat_to_onehot cardinality, sorted-subset "
         "many-vs-many above)", "list", None),
        ("max_cat_to_onehot", "cardinality threshold below which categorical "
         "features split one-vs-rest instead of sorted-subset", "int", 4),
        ("cat_smooth", "grad/hess ratio smoothing when ordering categories "
         "for subset splits", "double", 10.0),
        ("cat_l2", "extra L2 regularization applied when scoring "
         "sorted-subset categorical splits", "double", 10.0),
        ("max_cat_threshold", "max categories on the smaller side of a "
         "sorted-subset split", "int", 32),
        ("use_quantized_grad", "quantized training (LightGBM 4.x): "
         "stochastically round per-row grad/hess to integer levels once "
         "per iteration and build packed integer histograms; unset = auto "
         "(on for the card, off on the CPU)", "bool", None),
        ("num_grad_quant_bins", "quantization levels for grad/hess under "
         "quantized training (4-128)", "int", 16),
        ("checkpoint_dir", "directory for periodic atomic booster "
         "checkpoints: the run snapshots booster + iteration + PRNG state "
         "every checkpoint_every iterations and auto-resumes from the "
         "newest valid snapshot (docs/RESILIENCE.md: training fault "
         "tolerance)", "string", None),
        ("checkpoint_every", "checkpoint cadence in boosting iterations "
         "(0 = off; requires checkpoint_dir)", "int", 0),
        ("monitor_port", "serve live training telemetry over HTTP while "
         "fit() runs: GET /progress (step, rows/sec, ETA, loss tail), "
         "/metrics, /debug/dump, /debug/profile (0 = ephemeral port; "
         "unset = no server; docs/OBSERVABILITY.md: training plane)",
         "int", None),
        ("monitor_stall_timeout_s", "arm the training stall watchdog with "
         "a FIXED timeout in seconds instead of the EWMA-scaled default "
         "(a trip books mmlspark_training_stalls_total and writes a "
         "train_stall flight dump); setting this alone enables the "
         "watchdog without the HTTP server", "double", None),
        ("device", "where training and scoring run: unset = the CUDA card "
         "(an error without one), 'cpu' = the plain PyTorch versions",
         "string", None),
    ]
    for name, doc, dtype, default in specs:
        setattr(cls, name, Param(name, doc, dtype, default))
    cls._params = {**{p.name: p for p in cls.params()},
                   **{s[0]: getattr(cls, s[0]) for s in specs}}
    return cls


class _LightGBMBase(Estimator, HasFeaturesCol, HasLabelCol, HasWeightCol):
    """Shared train plumbing (reference ``LightGBMBase.train:43``)."""

    _objective: str = "regression"

    def _gbdt_params(self, num_class: int = 1) -> GBDTParams:
        max_depth = self.get("max_depth")
        growth = self.get("growth")
        if growth == "auto" and max_depth and not self.is_set("num_leaves"):
            # max_depth ALONE selects level-wise growth; an explicitly set
            # num_leaves keeps leaf-wise growth with max_depth as its cap
            growth = "level"
        return GBDTParams(
            num_iterations=self.get("num_iterations"),
            learning_rate=self.get("learning_rate"),
            num_leaves=self.get("num_leaves"),
            max_depth=max_depth or 0,
            growth=growth,
            max_bin=self.get("max_bin"),
            objective=self._objective,
            num_class=num_class,
            boosting_type=self.get("boosting_type"),
            lambda_l1=self.get("lambda_l1"), lambda_l2=self.get("lambda_l2"),
            min_data_in_leaf=self.get("min_data_in_leaf"),
            min_sum_hessian_in_leaf=self.get("min_sum_hessian_in_leaf"),
            min_gain_to_split=self.get("min_gain_to_split"),
            bagging_fraction=self.get("bagging_fraction"),
            bagging_freq=self.get("bagging_freq"),
            feature_fraction=self.get("feature_fraction"),
            top_rate=self.get("top_rate"), other_rate=self.get("other_rate"),
            drop_rate=self.get("drop_rate"), max_drop=self.get("max_drop"),
            skip_drop=self.get("skip_drop"),
            max_delta_step=self.get("max_delta_step"),
            early_stopping_round=self.get("early_stopping_round"),
            metric=self.get("metric"), seed=self.get("seed"),
            categorical_features=tuple(self.get("categorical_features")
                                       or ()) or None,
            max_cat_to_onehot=self.get("max_cat_to_onehot"),
            cat_smooth=self.get("cat_smooth"), cat_l2=self.get("cat_l2"),
            max_cat_threshold=self.get("max_cat_threshold"),
            voting_k=self.get("top_k")
            if self.get("parallelism") == "voting_parallel" else 0,
            use_quantized_grad=self.get("use_quantized_grad"),
            num_grad_quant_bins=self.get("num_grad_quant_bins"))

    def _collect_xyw(self, df: DataFrame):
        data = df.collect()
        X = stack_vector_column(data[self.get("features_col")])
        y = np.asarray(data[self.get("label_col")], np.float64)
        w_col = self.get("weight_col")
        w = np.asarray(data[w_col], np.float64) if w_col else None
        return X, y, w, data

    def _split_valid(self, X, y, w, data):
        vcol = self.get("validation_indicator_col")
        if not vcol:
            return X, y, w, None
        mask = np.asarray(data[vcol], bool)
        keep = ~mask
        return X[keep], y[keep], (w[keep] if w is not None else None), \
            (X[mask], y[mask])

    def _train_booster(self, X, y, w, valid, num_class=1, params=None,
                       group_ptr=None, batched=True):
        params = params or self._gbdt_params(num_class)
        ms = self.get("model_string")
        init_booster = GBDTBooster.from_string(ms) if ms else None
        kw = dict(valid=valid, shard_rows=self.get("shard_rows"),
                  checkpoint_dir=self.get("checkpoint_dir"),
                  checkpoint_every=self.get("checkpoint_every"),
                  monitor_port=self.get("monitor_port"),
                  monitor_stall_timeout_s=self.get("monitor_stall_timeout_s"),
                  device=self.get("device"))
        num_batches = (self.get("num_batches") or 0) if batched else 0
        if num_batches <= 1:
            return gbdt_core.train(X, y, params, sample_weight=w,
                                   group_ptr=group_ptr,
                                   init_booster=init_booster, **kw)
        if group_ptr is not None:
            raise ValueError("num_batches does not split query groups: "
                             "the ranker trains in one batch")
        # sequential batch training with warm start between batches, the
        # reference's bounds and per-batch iteration count
        bounds = np.linspace(0, len(y), num_batches + 1).astype(int)
        batch_params = dataclasses.replace(
            params,
            num_iterations=max(1, params.num_iterations // num_batches))
        result = None
        base_dir = kw["checkpoint_dir"]
        for i in range(num_batches):
            sl = slice(bounds[i], bounds[i + 1])
            if base_dir:
                # batches sharing one directory would resume each other's
                # snapshots: the batch index namespaces them
                kw["checkpoint_dir"] = f"{base_dir}/batch_{i:04d}"
            result = gbdt_core.train(
                X[sl], y[sl], batch_params,
                sample_weight=None if w is None else w[sl],
                init_booster=init_booster, **kw)
            init_booster = result.booster
        return result


class _LightGBMModelBase(Model, HasFeaturesCol, HasPredictionCol):
    """Shared predict helpers (reference ``LightGBMModelMethods``)."""

    booster_param = ComplexParam("booster", "fitted GBDTBooster")
    device = Param("device", "where scoring runs: unset = the CUDA card, "
                   "'cpu' = the plain PyTorch walk", "string", None)

    @property
    def booster(self) -> GBDTBooster:
        return self.get_or_fail("booster")

    def get_model_string(self) -> str:
        return self.booster.to_string()

    def save_native_model(self, path: str) -> None:
        """Reference ``saveNativeModel`` (LightGBMBooster.scala:454)."""
        with open(path, "w") as f:
            f.write(self.booster.to_string())

    def get_feature_importances(self, importance_type: str = "split"):
        return self.booster.feature_importance(importance_type)

    def predict_leaf(self, df: DataFrame) -> DataFrame:
        fc = self.get("features_col")

        def per_part(p):
            X = stack_vector_column(p[fc])
            leaves = self.booster.predict_leaf(X, device=self.get("device"))
            col = np.empty(len(leaves), dtype=object)
            for i in range(len(leaves)):
                col[i] = leaves[i].astype(np.float64)
            return {**p, "leaf_prediction": col}
        return df.map_partitions(per_part)

    def predict_contrib(self, df: DataFrame,
                        method: str = "tree_shap") -> DataFrame:
        """Per-row feature contributions in a ``features_shap`` column
        (the booster's ``predict_contrib``; ``saabas`` walks on the
        model's ``device``)."""
        fc = self.get("features_col")

        def per_part(p):
            X = stack_vector_column(p[fc])
            contrib = self.booster.predict_contrib(
                X, method=method, device=self.get("device"))
            col = np.empty(len(contrib), dtype=object)
            for i in range(len(contrib)):
                col[i] = contrib[i]
            return {**p, "features_shap": col}
        return df.map_partitions(per_part)


# ---------------------------------------------------------------------------
# Classifier
# ---------------------------------------------------------------------------

@_shared_params
class LightGBMClassifier(_LightGBMBase, HasPredictionCol, HasProbabilityCol,
                         HasRawPredictionCol):
    """Binary/multiclass GBDT classifier (ref ``LightGBMClassifier.scala``):
    more than two labels train ``multiclass``, one tree per class per
    iteration."""

    objective = Param("objective", "binary|multiclass (auto from labels if "
                      "unset)", "string", None)
    is_unbalance = Param("is_unbalance",
                         "reweight classes by inverse frequency", "bool",
                         False)

    def _fit(self, df: DataFrame) -> "LightGBMClassificationModel":
        X, y, w, data = self._collect_xyw(df)
        classes = np.unique(y[~np.isnan(y)])
        num_class = len(classes)
        obj = self.get("objective") or ("binary" if num_class <= 2
                                        else "multiclass")
        self._objective = obj
        y_idx = np.searchsorted(classes, y).astype(np.float64)
        if self.get("is_unbalance"):
            counts = np.bincount(y_idx.astype(int),
                                 minlength=num_class).astype(np.float64)
            cw = counts.sum() / np.maximum(counts, 1) / num_class
            w = (w if w is not None else np.ones_like(y_idx)) \
                * cw[y_idx.astype(int)]
        Xt, yt, wt, valid = self._split_valid(X, y_idx, w, data)
        result = self._train_booster(
            Xt, yt, wt, valid,
            num_class=num_class if obj == "multiclass" else 1)
        model = LightGBMClassificationModel()
        model.set("booster", result.booster)
        model.set("classes", classes.tolist())
        for pcol in ("features_col", "prediction_col", "probability_col",
                     "raw_prediction_col", "device"):
            model.set(pcol, self.get(pcol))
        return model


class LightGBMClassificationModel(_LightGBMModelBase, HasProbabilityCol,
                                  HasRawPredictionCol):
    classes = Param("classes", "label values in index order", "list")

    def _transform(self, df: DataFrame) -> DataFrame:
        fc = self.get("features_col")
        classes = np.asarray(self.get("classes"))
        booster = self.booster
        device = self.get("device")

        def per_part(p):
            X = stack_vector_column(p[fc])
            raw = booster.raw_scores(X, device=device)
            if booster.objective == "binary":
                p1 = 1.0 / (1.0 + np.exp(-booster.sigmoid * raw[:, 0]))
                prob = np.stack([1 - p1, p1], axis=1)
            else:
                z = raw - raw.max(axis=1, keepdims=True)
                e = np.exp(z)
                prob = e / e.sum(axis=1, keepdims=True)
            pred = classes[prob.argmax(axis=1)].astype(np.float64)
            prob_col = np.empty(len(X), dtype=object)
            raw_col = np.empty(len(X), dtype=object)
            for i in range(len(X)):
                prob_col[i] = prob[i]
                raw_col[i] = raw[i]
            return {**p, self.get("prediction_col"): pred,
                    self.get("probability_col"): prob_col,
                    self.get("raw_prediction_col"): raw_col}

        return df.map_partitions(per_part)

    def transform_schema(self, schema):
        schema.require(self.get("features_col"))
        s = schema.add(self.get("prediction_col"), ColumnType.DOUBLE)
        s = s.add(self.get("probability_col"), ColumnType.VECTOR)
        return s.add(self.get("raw_prediction_col"), ColumnType.VECTOR)


# ---------------------------------------------------------------------------
# Regressor
# ---------------------------------------------------------------------------

@_shared_params
class LightGBMRegressor(_LightGBMBase, HasPredictionCol):
    """GBDT regressor (ref ``LightGBMRegressor.scala``); objectives:
    regression (L2), regression_l1, huber, quantile, poisson, tweedie and
    gamma (log-link count, compound-Poisson and positive targets)."""

    objective = Param("objective", "regression|regression_l1|huber|quantile"
                      "|poisson|tweedie|gamma", "string", "regression")
    alpha = Param("alpha", "huber delta / quantile level", "float", 0.9)
    tweedie_variance_power = Param("tweedie_variance_power",
                                   "tweedie variance power in (1, 2)",
                                   "float", 1.5)

    def _fit(self, df: DataFrame) -> "LightGBMRegressionModel":
        self._objective = self.get("objective")
        X, y, w, data = self._collect_xyw(df)
        Xt, yt, wt, valid = self._split_valid(X, y, w, data)
        params = dataclasses.replace(
            self._gbdt_params(1), alpha=self.get("alpha"),
            tweedie_variance_power=self.get("tweedie_variance_power"))
        # the JAX package's regressor calls train() once: num_batches is
        # accepted and not used
        result = self._train_booster(Xt, yt, wt, valid, params=params,
                                     batched=False)
        model = LightGBMRegressionModel()
        model.set("booster", result.booster)
        for pcol in ("features_col", "prediction_col", "device"):
            model.set(pcol, self.get(pcol))
        return model


class LightGBMRegressionModel(_LightGBMModelBase):
    def _transform(self, df: DataFrame) -> DataFrame:
        fc = self.get("features_col")
        booster = self.booster
        device = self.get("device")

        def per_part(p):
            X = stack_vector_column(p[fc])
            return {**p, self.get("prediction_col"):
                    booster.predict(X, device=device)}

        return df.map_partitions(per_part)

    def transform_schema(self, schema):
        schema.require(self.get("features_col"))
        return schema.add(self.get("prediction_col"), ColumnType.DOUBLE)


# ---------------------------------------------------------------------------
# Ranker
# ---------------------------------------------------------------------------

@_shared_params
class LightGBMRanker(_LightGBMBase, HasPredictionCol):
    """LambdaRank ranker (ref ``LightGBMRanker.scala``); requires
    ``group_col``.  Rows are sorted stably by group and each group is one
    query.  ``max_position`` is accepted and not used, as in the JAX
    package: the lambdas weight every pair of a query by its full
    |ΔNDCG|."""

    group_col = Param("group_col", "query-group id column", "string",
                      "group")
    max_position = Param("max_position", "NDCG truncation (accepted, not "
                         "used)", "int", 30)

    def _fit(self, df: DataFrame) -> "LightGBMRankerModel":
        self._objective = "lambdarank"
        fc, lc = self.get("features_col"), self.get("label_col")
        data = df.collect()
        groups = np.asarray(data[self.get("group_col")])
        order = np.argsort(groups, kind="stable")
        X = stack_vector_column(data[fc])[order]
        y = np.asarray(data[lc], np.float64)[order]
        w_col = self.get("weight_col")
        w = np.asarray(data[w_col], np.float64)[order] if w_col else None
        sorted_groups = groups[order]
        change = np.nonzero(np.concatenate(
            [[True], sorted_groups[1:] != sorted_groups[:-1]]))[0]
        group_ptr = np.concatenate([change, [len(sorted_groups)]])
        result = self._train_booster(X, y, w, None, group_ptr=group_ptr)
        model = LightGBMRankerModel()
        model.set("booster", result.booster)
        for pcol in ("features_col", "prediction_col", "device"):
            model.set(pcol, self.get(pcol))
        return model


class LightGBMRankerModel(_LightGBMModelBase):
    def _transform(self, df: DataFrame) -> DataFrame:
        fc = self.get("features_col")
        booster = self.booster
        device = self.get("device")

        def per_part(p):
            X = stack_vector_column(p[fc])
            return {**p, self.get("prediction_col"):
                    booster.raw_scores(X, device=device)[:, 0]}

        return df.map_partitions(per_part)

    def transform_schema(self, schema):
        schema.require(self.get("features_col"))
        return schema.add(self.get("prediction_col"), ColumnType.DOUBLE)
