from .binning import BinMapper
from .core import GBDTParams, TrainResult, train, train_streamed
from .estimators import (LightGBMClassificationModel, LightGBMClassifier,
                         LightGBMRankerModel, LightGBMRanker,
                         LightGBMRegressionModel, LightGBMRegressor)

__all__ = ["BinMapper", "GBDTParams", "train", "train_streamed",
           "TrainResult",
           "LightGBMClassifier", "LightGBMClassificationModel",
           "LightGBMRegressor", "LightGBMRegressionModel",
           "LightGBMRanker", "LightGBMRankerModel"]
