"""Automatic featurization pipeline (the port's own copy of
``mmlspark_tpu/featurize/featurize.py``; host numpy, the hash kind through
the port's ``vw.murmur.StringHashCache``).

Reference: ``core/.../featurize/`` (~1.6k LoC): ``Featurize`` assembles an
impute -> index -> one-hot/hash -> assemble pipeline from column types
(column-state machine ``Featurize.scala:82-110``); ``CleanMissingData``;
``ValueIndexer``/``ValueIndexerModel``/``IndexToValue``; ``CountSelector``;
``DataConversion``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from ..core import (DataFrame, Estimator, HasInputCol, HasInputCols,
                    HasOutputCol, Model, Param, Transformer)
from ..core.dataframe import _as_column
from ..core.schema import ColumnType, vector_column


def assemble_vector_column(parts: List[np.ndarray]) -> np.ndarray:
    """FastVectorAssembler equivalent: concat numeric/vector columns row-wise."""
    n = len(parts[0])
    out = np.empty(n, dtype=object)
    for i in range(n):
        pieces = []
        for col in parts:
            v = col[i]
            if isinstance(v, (list, tuple, np.ndarray)):
                pieces.append(np.asarray(v, np.float64).ravel())
            else:
                pieces.append(np.asarray([0.0 if v is None else float(v)]))
        out[i] = np.concatenate(pieces)
    return out


class CleanMissingData(Estimator, HasInputCols):
    """Impute missing numerics (reference ``CleanMissingData.scala``)."""
    cleaning_mode = Param("cleaning_mode", "Mean|Median|Custom", "string", default="Mean")
    custom_value = Param("custom_value", "fill value for Custom mode", "float")
    output_cols = Param("output_cols", "output columns (default in-place)", "list")

    def _fit(self, df):
        cols = self.get_or_fail("input_cols")
        mode = self.get("cleaning_mode")
        whole = df.collect()
        fills: Dict[str, float] = {}
        for c in cols:
            v = whole[c].astype(float)
            if mode == "Mean":
                fills[c] = float(np.nanmean(v)) if np.isfinite(np.nanmean(v)) else 0.0
            elif mode == "Median":
                fills[c] = float(np.nanmedian(v))
            else:
                fills[c] = float(self.get_or_fail("custom_value"))
        m = CleanMissingDataModel()
        m.set("input_cols", cols)
        m.set("output_cols", self.get("output_cols") or cols)
        m.set("fill_values", fills)
        return m


class CleanMissingDataModel(Model, HasInputCols):
    output_cols = Param("output_cols", "output columns", "list")
    fill_values = Param("fill_values", "column -> fill value", "object")

    def _transform(self, df):
        fills = self.get_or_fail("fill_values")
        out = df
        for c, o in zip(self.get_or_fail("input_cols"), self.get_or_fail("output_cols")):
            fill = fills[c]
            out = out.with_column(o, lambda p, c=c, fill=fill:
                                  np.nan_to_num(p[c].astype(float), nan=fill))
        return out


class ValueIndexer(Estimator, HasInputCol, HasOutputCol):
    """Index categorical values with deterministic ordering
    (reference ``ValueIndexer.scala``)."""

    def _fit(self, df):
        col = df.collect()[self.get_or_fail("input_col")]
        non_null = [v for v in col if v is not None]
        levels = sorted(set(str(v) for v in non_null))
        m = ValueIndexerModel()
        m.set("input_col", self.get("input_col"))
        m.set("output_col", self.get("output_col"))
        m.set("levels", levels)
        return m


class ValueIndexerModel(Model, HasInputCol, HasOutputCol):
    levels = Param("levels", "ordered category values", "list")

    def _transform(self, df):
        levels = {v: i for i, v in enumerate(self.get_or_fail("levels"))}
        in_col = self.get_or_fail("input_col")
        unknown = len(levels)
        return df.with_column(
            self.get_or_fail("output_col"),
            lambda p: np.asarray([levels.get(str(v), unknown) if v is not None else unknown
                                  for v in p[in_col]], np.float64))


class IndexToValue(Transformer, HasInputCol, HasOutputCol):
    """Inverse of ValueIndexerModel (reference ``IndexToValue.scala``)."""
    levels = Param("levels", "ordered category values", "list")

    def _transform(self, df):
        levels = self.get_or_fail("levels")
        in_col = self.get_or_fail("input_col")

        def decode(p):
            out = np.empty(len(p[in_col]), dtype=object)
            for i, v in enumerate(p[in_col]):
                iv = int(v)
                out[i] = levels[iv] if 0 <= iv < len(levels) else None
            return out

        return df.with_column(self.get_or_fail("output_col"), decode)


class CountSelector(Estimator, HasInputCol, HasOutputCol):
    """Drop all-zero vector slots (reference ``CountSelector.scala``)."""

    def _fit(self, df):
        col = df.collect()[self.get_or_fail("input_col")]
        mat = np.stack([np.asarray(v, float) for v in col]) if len(col) else np.zeros((0, 0))
        keep = np.nonzero((mat != 0).any(axis=0))[0] if mat.size else np.empty(0, int)
        m = CountSelectorModel()
        m.set("input_col", self.get("input_col"))
        m.set("output_col", self.get("output_col"))
        m.set("indices", keep.tolist())
        return m


class CountSelectorModel(Model, HasInputCol, HasOutputCol):
    indices = Param("indices", "kept slot indices", "list")

    def _transform(self, df):
        keep = np.asarray(self.get_or_fail("indices"), int)
        in_col = self.get_or_fail("input_col")

        def select(p):
            out = np.empty(len(p[in_col]), dtype=object)
            for i, v in enumerate(p[in_col]):
                out[i] = np.asarray(v, float)[keep]
            return out

        return df.with_column(self.get_or_fail("output_col"), select)


class DataConversion(Transformer):
    """Column dtype conversion (reference ``DataConversion.scala``),
    including ``toCategorical`` (string/value column -> stable integer
    codes, sorted-distinct order — the Spark categorical-metadata
    analogue) and ``clearCategorical`` (codes stay plain doubles)."""
    cols = Param("cols", "columns to convert", "list")
    convert_to = Param("convert_to", "boolean|byte|short|integer|long|float|"
                                     "double|string|date|toCategorical|"
                                     "clearCategorical", "string",
                       default="double")

    _CASTS = {"boolean": bool, "byte": np.int8, "short": np.int16,
              "integer": np.int32, "long": np.int64, "float": np.float32,
              "double": np.float64}

    def _transform(self, df):
        to = self.get("convert_to")
        out = df
        for c in self.get_or_fail("cols"):
            if to == "string":
                out = out.with_column(c, lambda p, c=c: _as_column([str(v) for v in p[c]]))
            elif to == "date":
                import datetime
                out = out.with_column(c, lambda p, c=c: _as_column(
                    [datetime.datetime.fromisoformat(str(v)) for v in p[c]]))
            elif to == "toCategorical":
                # frame-global code table (sorted distinct values) so every
                # partition recodes identically
                levels = sorted({str(v) for v in out.collect()[c]})
                table = {v: float(i) for i, v in enumerate(levels)}
                out = out.with_column(c, lambda p, c=c, t=table: np.asarray(
                    [t[str(v)] for v in p[c]], np.float64))
            elif to == "clearCategorical":
                out = out.with_column(
                    c, lambda p, c=c: _cast_coerce(np.asarray(p[c]),
                                                   np.float64))
            else:
                cast = self._CASTS[to]
                out = out.with_column(
                    c, lambda p, c=c, cast=cast: _cast_coerce(p[c], cast))
        return out


def _cast_coerce(col: np.ndarray, cast) -> np.ndarray:
    """Spark cast semantics (reference DataConversion.scala): values that
    cannot be parsed become null (NaN here), they do not fail the job —
    '?'-style missing markers in imported CSVs rely on this."""
    try:
        return col.astype(cast)
    except (ValueError, TypeError):
        if not np.issubdtype(np.dtype(cast), np.floating):
            raise  # int/bool have no NaN; surface the bad value
        out = np.empty(len(col), np.dtype(cast))
        for i, v in enumerate(col):
            try:
                out[i] = cast(v)
            except (ValueError, TypeError):
                out[i] = np.nan
        return out


class Featurize(Estimator, HasOutputCol):
    """Auto-assemble a feature vector from mixed-type columns
    (reference ``Featurize.scala:36``: impute -> index/one-hot or hash ->
    assemble; ``one_hot_encode_categoricals`` and ``num_features`` mirror the
    reference params)."""

    input_cols = Param("input_cols", "columns to featurize", "list")
    one_hot_encode_categoricals = Param("one_hot_encode_categoricals",
                                        "one-hot instead of index", "bool", default=True)
    num_features = Param("num_features", "hash dims for text columns", "int", default=2 ** 8)
    impute_missing = Param("impute_missing", "mean-impute numerics", "bool", default=True)

    def _fit(self, df):
        cols = self.get("input_cols") or [c for c in df.columns]
        whole = df.collect()
        plan: List[Dict[str, Any]] = []
        for c in cols:
            col = whole[c]
            kind = ColumnType.of(col)
            if kind in (ColumnType.DOUBLE, ColumnType.LONG, ColumnType.BOOL):
                fill = float(np.nanmean(col.astype(float))) if self.get("impute_missing") else 0.0
                plan.append({"col": c, "kind": "numeric", "width": 1,
                             "fill": 0.0 if not np.isfinite(fill) else fill})
            elif kind == ColumnType.VECTOR:
                plan.append({"col": c, "kind": "vector",
                             "width": int(np.asarray(col[0]).size) if len(col) else 0})
            else:
                values = [str(v) for v in col if v is not None]
                levels = sorted(set(values))
                if len(levels) > 64:  # high-cardinality: feature hashing
                    plan.append({"col": c, "kind": "hash",
                                 "dims": self.get("num_features")})
                elif self.get("one_hot_encode_categoricals"):
                    plan.append({"col": c, "kind": "onehot", "width": len(levels),
                                 "levels": levels})
                else:
                    plan.append({"col": c, "kind": "index", "width": 1,
                                 "levels": levels})
        m = FeaturizeModel()
        m.set("plan", plan)
        m.set("output_col", self.get("output_col") or "features")
        return m


class FeaturizeModel(Model, HasOutputCol):
    plan = Param("plan", "per-column featurization plan", "list")

    def categorical_slots(self):
        """Assembled-vector slot indices holding CATEGORY CODES (the
        ``index``-kind plan entries) — the schema metadata the reference's
        ``getCategoricalIndexes`` (LightGBMBase.scala:168) reads off the
        assembled vector, used to auto-wire LightGBM categorical splits."""
        slots, pos = [], 0
        for spec in self.get_or_fail("plan"):
            if spec["kind"] == "index":
                slots.append(pos)
            pos += spec.get("width", spec.get("dims", 1))
        return slots

    def _transform(self, df):
        plan = self.get_or_fail("plan")
        out_col = self.get_or_fail("output_col")
        from ..vw.murmur import StringHashCache
        hasher = StringHashCache()

        def per_part(p):
            pieces: List[np.ndarray] = []
            n = len(next(iter(p.values()))) if p else 0
            for spec in plan:
                col = p[spec["col"]]
                kind = spec["kind"]
                if kind == "numeric":
                    v = np.nan_to_num(col.astype(float), nan=spec["fill"])
                    pieces.append(v[:, None])
                elif kind == "vector":
                    pieces.append(np.stack([np.asarray(x, float) for x in col]))
                elif kind == "onehot":
                    levels = {v: i for i, v in enumerate(spec["levels"])}
                    mat = np.zeros((n, len(levels)), float)
                    for i, v in enumerate(col):
                        j = levels.get(str(v))
                        if j is not None:
                            mat[i, j] = 1.0
                    pieces.append(mat)
                elif kind == "index":
                    levels = {v: i for i, v in enumerate(spec["levels"])}
                    pieces.append(np.asarray(
                        [levels.get(str(v), len(levels)) for v in col], float)[:, None])
                elif kind == "hash":
                    dims = spec["dims"]
                    mat = np.zeros((n, dims), float)
                    for i, v in enumerate(col):
                        mat[i, hasher(str(v)) % dims] = 1.0
                    pieces.append(mat)
            feats = np.concatenate(pieces, axis=1) if pieces else np.zeros((n, 0))
            return {**p, out_col: vector_column(list(feats))}

        return df.map_partitions(per_part)
