"""Hyperparameter search (the port's own copy of
``mmlspark_tpu/automl/tune.py``).

Reference: ``automl/TuneHyperparameters.scala:144`` (parallel random/grid
search with train/validation split and unified metric evaluation) plus the
``HyperparamBuilder``/``ParamSpace``/``RandomSpace`` DSL (``ParamSpace.scala``)
and ``DefaultHyperparams``.
"""
from __future__ import annotations

import concurrent.futures
import itertools
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core import (ComplexParam, DataFrame, Estimator, Model, Param)
from ..train.metrics import classification_metrics, regression_metrics


class RangeHyperParam:
    def __init__(self, low, high, is_int: bool = False):
        self.low, self.high, self.is_int = low, high, is_int

    def sample(self, rng):
        v = rng.uniform(self.low, self.high)
        return int(round(v)) if self.is_int else float(v)

    def grid(self, n: int = 3):
        vals = np.linspace(self.low, self.high, n)
        return [int(round(v)) if self.is_int else float(v) for v in vals]


class DiscreteHyperParam:
    def __init__(self, values: Sequence):
        self.values = list(values)

    def sample(self, rng):
        return self.values[int(rng.integers(0, len(self.values)))]

    def grid(self, n: int = 0):
        return list(self.values)


class HyperparamBuilder:
    """Reference HyperparamBuilder: accumulate (param, space) pairs."""

    def __init__(self):
        self._spaces: List[Tuple[str, Any]] = []

    def add_hyperparam(self, param_name: str, space) -> "HyperparamBuilder":
        self._spaces.append((param_name, space))
        return self

    def build(self):
        return list(self._spaces)


class GridSpace:
    def __init__(self, spaces, points_per_range: int = 3):
        self.spaces = spaces
        self.points = points_per_range

    def param_maps(self):
        names = [n for n, _ in self.spaces]
        grids = [s.grid(self.points) for _, s in self.spaces]
        for combo in itertools.product(*grids):
            yield dict(zip(names, combo))


class RandomSpace:
    def __init__(self, spaces, seed: int = 0):
        self.spaces = spaces
        self.rng = np.random.default_rng(seed)

    def param_maps(self):
        while True:
            yield {n: s.sample(self.rng) for n, s in self.spaces}


class DefaultHyperparams:
    """Reference DefaultHyperparams: sensible search spaces per learner."""

    @staticmethod
    def lightgbm_classifier():
        return HyperparamBuilder() \
            .add_hyperparam("num_leaves", DiscreteHyperParam([15, 31, 63])) \
            .add_hyperparam("learning_rate", RangeHyperParam(0.01, 0.3)) \
            .add_hyperparam("num_iterations", DiscreteHyperParam([50, 100])) \
            .build()

    @staticmethod
    def vw_classifier():
        return HyperparamBuilder() \
            .add_hyperparam("learning_rate", RangeHyperParam(0.05, 1.0)) \
            .add_hyperparam("num_passes", DiscreteHyperParam([1, 3, 5])) \
            .build()


def _metric_value(df: DataFrame, label_col: str, metric: str) -> Tuple[float, bool]:
    data = df.collect()
    y = np.asarray(data[label_col], np.float64)
    pred = np.asarray(data["prediction"], np.float64)
    cls = classification_metrics(y, pred)
    reg = regression_metrics(y, pred)
    table = {**cls, **reg}
    larger_better = metric not in ("mean_squared_error", "root_mean_squared_error",
                                   "mean_absolute_error")
    return float(table[metric]), larger_better


class TuneHyperparameters(Estimator):
    """Search over models x param spaces with parallel evaluation
    (reference fit :144 evaluates candidates on a thread pool)."""

    models = ComplexParam("models", "candidate estimators")
    param_space = ComplexParam("param_space", "GridSpace or RandomSpace")
    evaluation_metric = Param("evaluation_metric", "metric name", "string",
                              default="accuracy")
    number_of_runs = Param("number_of_runs", "candidates to evaluate (random "
                           "search)", "int", default=8)
    parallelism = Param("parallelism", "concurrent fits", "int", default=2)
    train_ratio = Param("train_ratio", "train fraction", "float", default=0.8)
    label_col = Param("label_col", "label column", "string", default="label")
    seed = Param("seed", "split seed", "int", default=0)

    def _fit(self, df: DataFrame) -> "TuneHyperparametersModel":
        models = self.get_or_fail("models")
        if not isinstance(models, list):
            models = [models]
        space = self.get_or_fail("param_space")
        metric = self.get("evaluation_metric")
        label_col = self.get("label_col")
        train, valid = df.random_split([self.get("train_ratio"),
                                        1 - self.get("train_ratio")],
                                       seed=self.get("seed"))

        gen = space.param_maps()
        if isinstance(space, GridSpace):
            candidates = [(m, pm) for m in models for pm in space.param_maps()]
        else:
            candidates = [(models[i % len(models)], next(gen))
                          for i in range(self.get("number_of_runs"))]

        def evaluate(cand):
            est, pm = cand
            est = est.copy()
            for k, v in pm.items():
                if k in type(est)._params:
                    est.set(k, v)
            model = est.fit(train)
            scored = model.transform(valid)
            value, larger_better = _metric_value(scored, label_col, metric)
            return model, pm, value, larger_better

        results = []
        with concurrent.futures.ThreadPoolExecutor(self.get("parallelism")) as ex:
            for res in ex.map(evaluate, candidates):
                results.append(res)
        larger_better = results[0][3]
        best = max(results, key=lambda r: r[2]) if larger_better else \
            min(results, key=lambda r: r[2])
        out = TuneHyperparametersModel()
        out.set("best_model", best[0])
        out.set("best_metric", best[2])
        out.set("best_params", best[1])
        out.set("all_metrics", [r[2] for r in results])
        return out


class TuneHyperparametersModel(Model):
    best_model = ComplexParam("best_model", "winning fitted model")
    best_metric = Param("best_metric", "winning metric value", "float")
    best_params = Param("best_params", "winning param map", "object")
    all_metrics = Param("all_metrics", "all candidate metrics", "list")

    def _transform(self, df: DataFrame) -> DataFrame:
        return self.get_or_fail("best_model").transform(df)

    def get_best_model_info(self) -> str:
        return f"metric={self.get('best_metric')} params={self.get('best_params')}"
