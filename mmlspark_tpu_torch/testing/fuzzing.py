"""Fuzzing harness — reflection-driven stage testing.

An own copy of the JAX package's ``testing/fuzzing.py``, verbatim.

Reference: ``core/src/test/.../core/test/fuzzing/Fuzzing.scala`` —
``ExperimentFuzzing`` (:192 run fit/transform on declared TestObjects),
``SerializationFuzzing`` (:222 save/load stage + fitted model, assert
identical transforms), and the global sweep ``FuzzingTest.scala:18`` that
reflects over every stage and enforces coverage by construction.
"""
from __future__ import annotations

import dataclasses
import tempfile
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ..core import DataFrame, Estimator, Params, Transformer
from ..core.serialize import load_stage, save_stage


def assert_frames_equal(a: DataFrame, b: DataFrame, atol: float = 1e-6) -> None:
    """DataFrameEquality analogue."""
    assert sorted(a.columns) == sorted(b.columns), (a.columns, b.columns)
    da, db = a.collect(), b.collect()
    for c in a.columns:
        ca, cb = da[c], db[c]
        assert len(ca) == len(cb), f"column {c}: {len(ca)} vs {len(cb)} rows"
        if ca.dtype == object or cb.dtype == object:
            for i, (x, y) in enumerate(zip(ca, cb)):
                if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
                    assert np.allclose(np.asarray(x, float), np.asarray(y, float),
                                       atol=atol), f"{c}[{i}]"
                else:
                    assert x == y, f"{c}[{i}]: {x!r} != {y!r}"
        else:
            assert np.allclose(ca.astype(float), cb.astype(float), atol=atol,
                               equal_nan=True), f"column {c}"


@dataclasses.dataclass
class TestObject:
    """A stage + the frames needed to exercise it (reference TestObject)."""
    __test__ = False  # not a pytest class
    stage: Params
    fit_df: Optional[DataFrame] = None          # estimators
    transform_df: Optional[DataFrame] = None    # transformers / fitted models

    @property
    def df(self) -> DataFrame:
        return self.transform_df if self.transform_df is not None else self.fit_df


class ExperimentFuzzing:
    """Run the declared experiments (reference ExperimentFuzzing:192)."""

    @staticmethod
    def run(obj: TestObject):
        stage = obj.stage
        if isinstance(stage, Estimator):
            model = stage.fit(obj.fit_df)
            out_df = obj.transform_df if obj.transform_df is not None else obj.fit_df
            return model, model.transform(out_df)
        assert isinstance(stage, Transformer), type(stage)
        return stage, stage.transform(obj.df)


class SerializationFuzzing:
    """save/load the raw stage AND the fitted model; assert the reloaded
    artifacts transform identically (reference SerializationFuzzing:222)."""

    @staticmethod
    def run(obj: TestObject, atol: float = 1e-5):
        stage = obj.stage
        with tempfile.TemporaryDirectory() as d:
            # raw stage roundtrip preserves params
            save_stage(stage, f"{d}/raw")
            reloaded = load_stage(f"{d}/raw")
            assert type(reloaded) is type(stage)
            assert reloaded.uid == stage.uid
            if isinstance(stage, Estimator):
                model = stage.fit(obj.fit_df)
                out_df = obj.transform_df if obj.transform_df is not None else obj.fit_df
                expected = model.transform(out_df)
                save_stage(model, f"{d}/model")
                model2 = load_stage(f"{d}/model")
                got = model2.transform(out_df)
            else:
                out_df = obj.df
                expected = stage.transform(out_df)
                got = reloaded.transform(out_df)
            assert_frames_equal(expected, got, atol=atol)
