from .binning import BinMapper, StreamingQuantileSketch
from .core import GBDTParams, TrainResult, train, train_streamed
from .estimators import (LightGBMClassificationModel, LightGBMClassifier,
                         LightGBMRankerModel, LightGBMRanker,
                         LightGBMRegressionModel, LightGBMRegressor)

__all__ = ["BinMapper", "StreamingQuantileSketch", "GBDTParams", "train",
           "train_streamed", "TrainResult",
           "LightGBMClassifier", "LightGBMClassificationModel",
           "LightGBMRegressor", "LightGBMRegressionModel",
           "LightGBMRanker", "LightGBMRankerModel"]
