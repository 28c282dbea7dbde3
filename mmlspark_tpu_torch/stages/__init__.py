"""Plumbing stages of the port: own copies of the JAX package's
``stages/batchers.py``, ``stages/minibatch.py`` (the minibatch transformers
``io/http.py`` batches requests with) and ``stages/transforms.py``."""
from .minibatch import (FixedMiniBatchTransformer, DynamicMiniBatchTransformer,
                        TimeIntervalMiniBatchTransformer, FlattenBatch)
from .transforms import (Lambda, UDFTransformer, Timer, Cacher, DropColumns,
                         SelectColumns, RenameColumn, Repartition,
                         PartitionConsolidator, Explode, EnsembleByKey,
                         ClassBalancer, ClassBalancerModel,
                         StratifiedRepartition, TextPreprocessor,
                         UnicodeNormalize, SummarizeData)

__all__ = ["FixedMiniBatchTransformer", "DynamicMiniBatchTransformer",
           "TimeIntervalMiniBatchTransformer", "FlattenBatch", "Lambda",
           "UDFTransformer", "Timer", "Cacher", "DropColumns", "SelectColumns",
           "RenameColumn", "Repartition", "PartitionConsolidator", "Explode",
           "EnsembleByKey", "ClassBalancer", "ClassBalancerModel",
           "StratifiedRepartition", "TextPreprocessor", "UnicodeNormalize",
           "SummarizeData"]
