"""MiniBatch transformers — rows <-> batched rows.

An own copy of the JAX package's ``stages/minibatch.py``, verbatim apart from module
paths.

Reference: ``stages/MiniBatchTransformer.scala:45-181``.  A "batched" frame
has one row per minibatch, each cell an array of the original cells; models
consume whole minibatches on device.  ``FlattenBatch`` inverts.
"""
from __future__ import annotations

import numpy as np

from ..core import DataFrame, Param, Transformer
from ..core.dataframe import _as_column, _part_len
from . import batchers


class _BatchingTransformer(Transformer):
    def _batches(self, indices):
        raise NotImplementedError

    def _transform(self, df: DataFrame) -> DataFrame:
        def per_part(p):
            n = _part_len(p)
            out = {k: [] for k in p}
            for batch_idx in self._batches(range(n)):
                idx = np.asarray(batch_idx, dtype=int)
                for k in p:
                    out[k].append(p[k][idx])
            return {k: _as_column(v) for k, v in out.items()}
        return df.map_partitions(per_part)


class FixedMiniBatchTransformer(_BatchingTransformer):
    """Reference ``FixedMiniBatchTransformer`` (MiniBatchTransformer.scala:45);
    the default CNTKModel batcher (CNTKModel.scala:378, batch=10)."""

    batch_size = Param("batch_size", "rows per minibatch", "int", default=10,
                       validator=lambda v: v > 0)
    max_buffer_size = Param("max_buffer_size", "max rows buffered", "int", default=2 ** 31)

    def _batches(self, indices):
        return batchers.fixed_batches(indices, self.get("batch_size"))


class DynamicMiniBatchTransformer(_BatchingTransformer):
    max_batch_size = Param("max_batch_size", "max rows per minibatch", "int", default=2 ** 31)

    def _batches(self, indices):
        return batchers.dynamic_batches(indices, self.get("max_batch_size"))


class TimeIntervalMiniBatchTransformer(_BatchingTransformer):
    millis_to_wait = Param("millis_to_wait", "flush interval ms", "int", default=1000)
    max_batch_size = Param("max_batch_size", "max rows per minibatch", "int", default=2 ** 31)

    def _batches(self, indices):
        return batchers.time_interval_batches(indices, self.get("millis_to_wait"),
                                              self.get("max_batch_size"))


class FlattenBatch(Transformer):
    """Invert minibatching: explode array cells back to rows
    (reference ``FlattenBatch``, MiniBatchTransformer.scala:139)."""

    def _transform(self, df: DataFrame) -> DataFrame:
        def per_part(p):
            out = {k: [] for k in p}
            n = _part_len(p)
            for i in range(n):
                lens = {k: len(p[k][i]) for k in p}
                m = max(lens.values()) if lens else 0
                for k in p:
                    cell = p[k][i]
                    for j in range(m):
                        out[k].append(cell[j] if j < len(cell) else None)
            return {k: _as_column(v) for k, v in out.items()}
        return df.map_partitions(per_part)
