"""Pipeline contract: Estimator / Transformer / Model / Pipeline.

Reference: the SparkML pipeline contract that every mmlspark stage implements
(SURVEY.md §1 — L3 stages expose ``Estimator.fit``/``Transformer.transform``),
plus mmlspark's ``BasicLogging`` telemetry wrapper (``logging/
BasicLogging.scala:25-70``) which logs every ctor/fit/transform.
"""
from __future__ import annotations

from typing import Any, List, Optional, Sequence, Union

from .dataframe import DataFrame
from .params import ComplexParam, Params
from .schema import Schema
from .logging import log_verb


class PipelineStage(Params):
    """Base of all stages.  Subclasses implement ``transform_schema`` for
    schema validation without data movement (Spark's transformSchema)."""

    def transform_schema(self, schema: Schema) -> Schema:
        return schema


class Transformer(PipelineStage):
    def transform(self, df: DataFrame) -> DataFrame:
        with log_verb(self, "transform"):
            self.transform_schema(df.schema)
            return self._transform(df)

    def _transform(self, df: DataFrame) -> DataFrame:
        raise NotImplementedError

    def __call__(self, df: DataFrame) -> DataFrame:
        return self.transform(df)


class Model(Transformer):
    """A fitted Transformer, usually produced by an Estimator."""
    pass


class Estimator(PipelineStage):
    def fit(self, df: DataFrame) -> Model:
        with log_verb(self, "fit"):
            self.transform_schema(df.schema)
            return self._fit(df)

    def _fit(self, df: DataFrame) -> Model:
        raise NotImplementedError


class Evaluator(Params):
    def evaluate(self, df: DataFrame) -> float:
        raise NotImplementedError

    @property
    def is_larger_better(self) -> bool:
        return True


class Pipeline(Estimator):
    """Chain of stages; fit() fits estimators in order, transforming through."""

    stages_param = ComplexParam("stages", "ordered pipeline stages")

    def __init__(self, stages: Optional[Sequence[PipelineStage]] = None, uid: Optional[str] = None):
        super().__init__(uid)
        if stages is not None:
            self.set("stages", list(stages))

    @property
    def stages(self) -> List[PipelineStage]:
        return self.get("stages") or []

    def set_stages(self, stages: Sequence[PipelineStage]) -> "Pipeline":
        self.set("stages", list(stages))
        return self

    def transform_schema(self, schema: Schema) -> Schema:
        for s in self.stages:
            schema = s.transform_schema(schema)
        return schema

    def _fit(self, df: DataFrame) -> "PipelineModel":
        fitted: List[Transformer] = []
        cur = df
        stages = self.stages
        for i, stage in enumerate(stages):
            if isinstance(stage, Estimator):
                model = stage.fit(cur)
                fitted.append(model)
                if i < len(stages) - 1:
                    cur = model.transform(cur)
            elif isinstance(stage, Transformer):
                fitted.append(stage)
                if i < len(stages) - 1:
                    cur = stage.transform(cur)
            else:
                raise TypeError(f"stage {stage} is neither Estimator nor Transformer")
        return PipelineModel(fitted)


class PipelineModel(Model):
    stages_param = ComplexParam("stages", "fitted pipeline stages")

    def __init__(self, stages: Optional[Sequence[Transformer]] = None, uid: Optional[str] = None):
        super().__init__(uid)
        if stages is not None:
            self.set("stages", list(stages))

    @property
    def stages(self) -> List[Transformer]:
        return self.get("stages") or []

    def transform_schema(self, schema: Schema) -> Schema:
        for s in self.stages:
            schema = s.transform_schema(schema)
        return schema

    def _transform(self, df: DataFrame) -> DataFrame:
        for s in self.stages:
            df = s.transform(df)
        return df


class UnaryTransformer(Transformer):
    """Convenience base: one input column -> one output column."""

    def _transform(self, df: DataFrame) -> DataFrame:
        in_col = self.get_or_fail("input_col")
        out_col = self.get_or_fail("output_col")
        return df.with_column(out_col, lambda p: self._apply(p[in_col]))

    def _apply(self, col):
        raise NotImplementedError
