"""Hyperparameter search and model selection (the port's own copy of
``mmlspark_tpu/automl``)."""
from .tune import (TuneHyperparameters, TuneHyperparametersModel,
                   HyperparamBuilder, GridSpace, RandomSpace, RangeHyperParam,
                   DiscreteHyperParam, DefaultHyperparams)
from .best import FindBestModel, BestModel

__all__ = ["TuneHyperparameters", "TuneHyperparametersModel",
           "HyperparamBuilder", "GridSpace", "RandomSpace", "RangeHyperParam",
           "DiscreteHyperParam", "DefaultHyperparams", "FindBestModel",
           "BestModel"]
