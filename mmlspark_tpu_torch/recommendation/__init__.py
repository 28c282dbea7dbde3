"""Recommendation (the port of ``mmlspark_tpu/recommendation``): SAR's
matmuls on the card; the indexer and the ranking stages on the host."""
from .sar import SAR, SARModel
from .indexer import RecommendationIndexer, RecommendationIndexerModel
from .ranking import (RankingAdapter, RankingAdapterModel, RankingEvaluator,
                      RankingTrainValidationSplit)

__all__ = ["SAR", "SARModel", "RecommendationIndexer",
           "RecommendationIndexerModel", "RankingAdapter",
           "RankingAdapterModel", "RankingEvaluator",
           "RankingTrainValidationSplit"]
