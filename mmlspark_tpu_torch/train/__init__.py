"""Training wrappers and model evaluation (the port's ``train/``): own
copies of ``TrainClassifier``/``TrainRegressor`` and their models,
``ComputeModelStatistics``, ``ComputePerInstanceStatistics`` and
``MetricConstants``."""
from .trainers import (TrainClassifier, TrainedClassifierModel, TrainRegressor,
                       TrainedRegressorModel)
from .metrics import (ComputeModelStatistics, ComputePerInstanceStatistics,
                      MetricConstants, classification_metrics,
                      regression_metrics)

__all__ = ["TrainClassifier", "TrainedClassifierModel", "TrainRegressor",
           "TrainedRegressorModel", "ComputeModelStatistics",
           "ComputePerInstanceStatistics", "MetricConstants",
           "classification_metrics", "regression_metrics"]
