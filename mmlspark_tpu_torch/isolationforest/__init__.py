"""The isolation forest (the port of ``mmlspark_tpu/isolationforest``):
trees grown on the host, walked on the card."""
from .iforest import IsolationForest, IsolationForestModel

__all__ = ["IsolationForest", "IsolationForestModel"]
