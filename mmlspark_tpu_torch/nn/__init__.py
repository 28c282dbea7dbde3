"""Nearest neighbours (the port of ``mmlspark_tpu/nn``): ball trees on the
host, the KNN matmul query on the card."""
from .balltree import BallTree, ConditionalBallTree
from .knn import KNN, KNNModel, ConditionalKNN, ConditionalKNNModel

__all__ = ["BallTree", "ConditionalBallTree", "KNN", "KNNModel",
           "ConditionalKNN", "ConditionalKNNModel"]
