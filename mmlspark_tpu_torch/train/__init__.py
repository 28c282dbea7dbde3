"""Model evaluation (the port's ``train/``): own copies of
``ComputeModelStatistics``, ``ComputePerInstanceStatistics`` and
``MetricConstants``.  ``TrainClassifier`` and ``TrainRegressor`` are not
ported yet (ROADMAP.md §1 item 12)."""
from .metrics import (ComputeModelStatistics, ComputePerInstanceStatistics,
                      MetricConstants, classification_metrics,
                      regression_metrics)

__all__ = ["ComputeModelStatistics", "ComputePerInstanceStatistics",
           "MetricConstants", "classification_metrics",
           "regression_metrics"]
