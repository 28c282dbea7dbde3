"""Row-batching stages of the port: own copies of the JAX package's
``stages/batchers.py`` and ``stages/minibatch.py`` (the minibatch
transformers ``io/http.py`` batches requests with).  The rest of the
reference's ``stages`` package (``transforms``) is not ported."""
from .minibatch import (FixedMiniBatchTransformer, DynamicMiniBatchTransformer,
                        TimeIntervalMiniBatchTransformer, FlattenBatch)

__all__ = ["FixedMiniBatchTransformer", "DynamicMiniBatchTransformer",
           "TimeIntervalMiniBatchTransformer", "FlattenBatch"]
