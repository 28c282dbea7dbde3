"""VowpalWabbit on the card (the port of ``mmlspark_tpu/vw``): the murmur
featurizer and interactions (own copies; hashing stays on the host), the
online SGD/AdaGrad learners and ``--bfgs`` on tensors, and the contextual
bandit."""
from .murmur import murmur3_bytes, murmur3_ints, StringHashCache
from .featurizer import VowpalWabbitFeaturizer, VowpalWabbitInteractions
from .learners import (VowpalWabbitClassifier, VowpalWabbitClassificationModel,
                       VowpalWabbitRegressor, VowpalWabbitRegressionModel,
                       VowpalWabbitContextualBandit,
                       VowpalWabbitContextualBanditModel, TrainingStats,
                       pack_sparse_column)

__all__ = ["murmur3_bytes", "murmur3_ints", "StringHashCache",
           "VowpalWabbitFeaturizer", "VowpalWabbitInteractions",
           "VowpalWabbitClassifier", "VowpalWabbitClassificationModel",
           "VowpalWabbitRegressor", "VowpalWabbitRegressionModel",
           "VowpalWabbitContextualBandit", "VowpalWabbitContextualBanditModel",
           "TrainingStats", "pack_sparse_column"]
