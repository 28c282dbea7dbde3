"""VowpalWabbitFeaturizer — hash any columns into sparse vectors.

Reference: ``vw/.../VowpalWabbitFeaturizer.scala:25`` with per-type dispatch
(``:67-82``) to 11 typed featurizers (Numeric/String/StringSplit/Map*/Seq/
Struct/Vector) plus ``VowpalWabbitInteractions`` (namespace cross products)
and ``VectorUtils`` sorted sparse merge.  Hashing stays host-side
(``docs/vw.md:29-30``); the device consumes the (indices, values) arrays.
The port's own copy of ``mmlspark_tpu/vw/featurizer.py``.

Output column cells are dicts {"indices": int32[], "values": float32[]} with
indices already masked to 2^num_bits (VW's -b).
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..core import (DataFrame, HasInputCols, HasOutputCol, Param, Transformer)
from ..core.schema import ColumnType
from .murmur import StringHashCache, murmur3_ints

VW_DEFAULT_SEED = 0


def _sorted_merge(idx_list, val_list):
    """Merge sparse (idx, val) pairs, summing duplicates (VectorUtils)."""
    if not idx_list:
        return np.empty(0, np.int32), np.empty(0, np.float32)
    idx = np.concatenate(idx_list)
    val = np.concatenate(val_list)
    order = np.argsort(idx, kind="stable")
    idx, val = idx[order], val[order]
    uniq, start = np.unique(idx, return_index=True)
    sums = np.add.reduceat(val, start) if len(val) else val
    return uniq.astype(np.int32), sums.astype(np.float32)


class VowpalWabbitFeaturizer(Transformer, HasInputCols, HasOutputCol):
    num_bits = Param("num_bits", "hash space bits (VW -b)", "int", default=18)
    seed = Param("seed", "murmur seed", "int", default=VW_DEFAULT_SEED)
    string_split_cols = Param("string_split_cols", "string columns to tokenize "
                              "on whitespace (StringSplitFeaturizer)", "list", default=[])
    prefix_strings_with_column_name = Param("prefix_strings_with_column_name",
                                            "namespace the hashes by column", "bool",
                                            default=True)
    sum_collisions = Param("sum_collisions", "sum colliding hash values", "bool",
                           default=True)

    def __init__(self, uid: Optional[str] = None, **kwargs):
        super().__init__(uid)
        if kwargs:
            self.set_params(**kwargs)

    def _hash_column(self, name: str, col: np.ndarray, mask: int,
                     hasher: StringHashCache, split: bool):
        """Returns per-row (idx_arrays, val_arrays) lists."""
        n = len(col)
        prefix = name if self.get("prefix_strings_with_column_name") else ""
        ns_seed = hasher(prefix) if prefix else self.get("seed")
        out_idx: List[np.ndarray] = [None] * n
        out_val: List[np.ndarray] = [None] * n
        first = next((v for v in col if v is not None), None)

        if first is None:
            z = np.empty(0, np.int32)
            zv = np.empty(0, np.float32)
            return [z] * n, [zv] * n

        if isinstance(first, str) and split:
            # StringSplitFeaturizer: bag of tokens
            for i, v in enumerate(col):
                toks = (v or "").split()
                hashes = np.asarray([hasher(prefix + t) for t in toks], np.uint32)
                out_idx[i] = (hashes & mask).astype(np.int32)
                out_val[i] = np.ones(len(toks), np.float32)
        elif isinstance(first, str):
            # StringFeaturizer: categorical one-hot at hash(col+value)
            hashed = hasher.hash_array(np.asarray([prefix + (v or "") for v in col]))
            for i in range(n):
                out_idx[i] = np.asarray([hashed[i] & mask], np.int32)
                out_val[i] = np.ones(1, np.float32)
        elif isinstance(first, dict):
            # Map featurizer: key -> numeric/string value
            for i, v in enumerate(col):
                v = v or {}
                idxs, vals = [], []
                for k, x in v.items():
                    if isinstance(x, str):
                        idxs.append(hasher(prefix + str(k) + "^" + x))
                        vals.append(1.0)
                    else:
                        idxs.append(hasher(prefix + str(k)))
                        vals.append(float(x))
                out_idx[i] = (np.asarray(idxs, np.uint32) & mask).astype(np.int32)
                out_val[i] = np.asarray(vals, np.float32)
        elif isinstance(first, (list, tuple, np.ndarray)):
            # Vector/Seq featurizer: index-hashed dense values
            for i, v in enumerate(col):
                arr = np.asarray(v, np.float32)
                nz = np.nonzero(arr)[0]
                hashes = murmur3_ints(nz.astype(np.uint32), ns_seed)
                out_idx[i] = (hashes & mask).astype(np.int32)
                out_val[i] = arr[nz]
        else:
            # NumericFeaturizer: single weight at hash(column name)
            base = np.int32(hasher(prefix or name) & mask)
            vals = np.asarray(col, np.float32)
            for i in range(n):
                out_idx[i] = np.asarray([base], np.int32)
                out_val[i] = np.asarray([vals[i]], np.float32)
        return out_idx, out_val

    def _transform(self, df: DataFrame) -> DataFrame:
        cols = self.get_or_fail("input_cols")
        mask = (1 << self.get("num_bits")) - 1
        hasher = StringHashCache(self.get("seed"))
        split_cols = set(self.get("string_split_cols") or [])
        out_col = self.get_or_fail("output_col")

        def per_part(p):
            n = len(next(iter(p.values()))) if p else 0
            per_col = [self._hash_column(c, p[c], mask, hasher, c in split_cols)
                       for c in cols]
            out = np.empty(n, dtype=object)
            for i in range(n):
                idx, val = _sorted_merge([pc[0][i] for pc in per_col],
                                         [pc[1][i] for pc in per_col])
                out[i] = {"indices": idx, "values": val}
            return {**p, out_col: out}

        return df.map_partitions(per_part)

    def transform_schema(self, schema):
        for c in self.get_or_fail("input_cols"):
            schema.require(c)
        return schema.add(self.get_or_fail("output_col"), ColumnType.STRUCT)


class VowpalWabbitInteractions(Transformer, HasInputCols, HasOutputCol):
    """Namespace cross-products (quadratic features).

    Reference: ``vw/.../VowpalWabbitInteractions.scala`` — VW's ``-q``:
    hash of the pair = interaction of the two namespaces' hashes.
    """

    num_bits = Param("num_bits", "hash space bits", "int", default=18)

    def __init__(self, uid: Optional[str] = None, **kwargs):
        super().__init__(uid)
        if kwargs:
            self.set_params(**kwargs)

    def _transform(self, df: DataFrame) -> DataFrame:
        cols = self.get_or_fail("input_cols")
        mask = (1 << self.get("num_bits")) - 1
        out_col = self.get_or_fail("output_col")

        def cross(a, b):
            # VW pair hash: h = h_a * prime + h_b
            prime = np.uint32(16777619)
            ia = a["indices"].astype(np.uint32)
            ib = b["indices"].astype(np.uint32)
            with np.errstate(over="ignore"):
                hh = (ia[:, None] * prime + ib[None, :]).reshape(-1)
            vv = (a["values"][:, None] * b["values"][None, :]).reshape(-1)
            return (hh & mask).astype(np.int32), vv.astype(np.float32)

        def per_part(p):
            n = len(next(iter(p.values()))) if p else 0
            out = np.empty(n, dtype=object)
            for i in range(n):
                idx_list, val_list = [], []
                for ci in range(len(cols)):
                    for cj in range(ci + 1, len(cols)):
                        idx, val = cross(p[cols[ci]][i], p[cols[cj]][i])
                        idx_list.append(idx)
                        val_list.append(val)
                idx, val = _sorted_merge(idx_list, val_list)
                out[i] = {"indices": idx, "values": val}
            return {**p, out_col: out}

        return df.map_partitions(per_part)

    def transform_schema(self, schema):
        return schema.add(self.get_or_fail("output_col"), ColumnType.STRUCT)
