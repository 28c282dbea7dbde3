from .dataframe import DataFrame, GroupedFrame, Row
from .schema import Schema, ColumnType, Binding, infer_schema, vector_column, \
    stack_vector_column, find_unused_column_name
from .params import (Param, ComplexParam, ServiceParam, ServiceValue, Params,
                     HasInputCol, HasInputCols, HasOutputCol, HasFeaturesCol,
                     HasLabelCol, HasWeightCol, HasPredictionCol,
                     HasProbabilityCol, HasRawPredictionCol)
from .pipeline import (PipelineStage, Transformer, Model, Estimator, Evaluator,
                       Pipeline, PipelineModel, UnaryTransformer)
from .serialize import save, load, save_stage, load_stage, save_dataframe, \
    load_dataframe, Saveable

__all__ = [
    "DataFrame", "GroupedFrame", "Row", "Schema", "ColumnType", "Binding",
    "infer_schema", "vector_column", "stack_vector_column",
    "find_unused_column_name", "Param", "ComplexParam", "ServiceParam",
    "ServiceValue", "Params", "HasInputCol", "HasInputCols", "HasOutputCol",
    "HasFeaturesCol", "HasLabelCol", "HasWeightCol", "HasPredictionCol",
    "HasProbabilityCol", "HasRawPredictionCol", "PipelineStage", "Transformer",
    "Model", "Estimator", "Evaluator", "Pipeline", "PipelineModel",
    "UnaryTransformer", "save", "load", "save_stage", "load_stage",
    "save_dataframe", "load_dataframe", "Saveable",
]
