from .binning import BinMapper
from .core import GBDTParams, TrainResult, train
from .estimators import (LightGBMClassificationModel, LightGBMClassifier,
                         LightGBMRankerModel, LightGBMRanker,
                         LightGBMRegressionModel, LightGBMRegressor)

__all__ = ["BinMapper", "GBDTParams", "train", "TrainResult",
           "LightGBMClassifier", "LightGBMClassificationModel",
           "LightGBMRegressor", "LightGBMRegressionModel",
           "LightGBMRanker", "LightGBMRankerModel"]
