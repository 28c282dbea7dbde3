"""Generic plumbing transformers (the port's own copy of
``mmlspark_tpu/stages/transforms.py``; host).

Reference: ``core/.../stages/`` (~2.1k LoC, SURVEY.md §2.5): Lambda,
UDFTransformer, Timer, Cacher, Explode, EnsembleByKey, ClassBalancer,
StratifiedRepartition, PartitionConsolidator, TextPreprocessor,
UnicodeNormalize, SummarizeData, DropColumns/SelectColumns/RenameColumn,
DynamicMiniBatch* (see ``minibatch.py``).
"""
from __future__ import annotations

import time
import unicodedata
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ..core import (ComplexParam, DataFrame, Estimator, HasInputCol,
                    HasOutputCol, HasLabelCol, Model, Param, Transformer)
from ..core.dataframe import _as_column, _part_len
from ..core.schema import ColumnType


class Lambda(Transformer):
    """Arbitrary frame->frame function (reference ``Lambda.scala``)."""
    transform_fn = ComplexParam("transform_fn", "DataFrame -> DataFrame function")
    transform_schema_fn = ComplexParam("transform_schema_fn", "Schema -> Schema function")

    def __init__(self, fn: Optional[Callable] = None, uid=None):
        super().__init__(uid)
        if fn is not None:
            self.set("transform_fn", fn)

    def _transform(self, df):
        return self.get_or_fail("transform_fn")(df)

    def transform_schema(self, schema):
        fn = self.get("transform_schema_fn")
        return fn(schema) if fn else schema


class UDFTransformer(Transformer, HasInputCol, HasOutputCol):
    """Apply a per-cell function (reference ``UDFTransformer.scala``)."""
    udf = ComplexParam("udf", "cell -> cell function")

    def __init__(self, uid=None, **kwargs):
        super().__init__(uid)
        if kwargs:
            self.set_params(**kwargs)

    def _transform(self, df):
        fn = self.get_or_fail("udf")
        in_col, out_col = self.get_or_fail("input_col"), self.get_or_fail("output_col")

        def per_part(p):
            col = p[in_col]
            out = np.empty(len(col), dtype=object)
            for i, v in enumerate(col):
                out[i] = fn(v)
            return {**p, out_col: _as_column(list(out))}

        return df.map_partitions(per_part)


class Timer(Transformer):
    """Time a wrapped stage (reference ``Timer.scala``)."""
    stage = ComplexParam("stage", "stage to time")
    log_to_scala = Param("log_to_scala", "print timing", "bool", default=False)

    def __init__(self, stage=None, uid=None):
        super().__init__(uid)
        if stage is not None:
            self.set("stage", stage)
        self.last_seconds: Optional[float] = None

    def _transform(self, df):
        stage = self.get_or_fail("stage")
        t0 = time.perf_counter()
        out = stage.transform(df)
        self.last_seconds = time.perf_counter() - t0
        if self.get("log_to_scala"):
            print(f"[Timer] {type(stage).__name__}: {self.last_seconds:.4f}s")
        return out

    def fit_timed(self, df):
        stage = self.get_or_fail("stage")
        t0 = time.perf_counter()
        model = stage.fit(df)
        self.last_seconds = time.perf_counter() - t0
        return model


class Cacher(Transformer):
    """Materialize (no-op: frames are eager; kept for pipeline parity)."""
    def _transform(self, df):
        return df.cache()


class DropColumns(Transformer):
    cols = Param("cols", "columns to drop", "list")

    def __init__(self, *cols, uid=None):
        super().__init__(uid)
        if cols:
            self.set("cols", list(cols))

    def _transform(self, df):
        return df.drop(*self.get_or_fail("cols"))


class SelectColumns(Transformer):
    cols = Param("cols", "columns to keep", "list")

    def __init__(self, *cols, uid=None):
        super().__init__(uid)
        if cols:
            self.set("cols", list(cols))

    def _transform(self, df):
        return df.select(*self.get_or_fail("cols"))


class RenameColumn(Transformer, HasInputCol, HasOutputCol):
    def _transform(self, df):
        return df.with_column_renamed(self.get_or_fail("input_col"),
                                      self.get_or_fail("output_col"))


class Repartition(Transformer):
    n = Param("n", "partition count", "int", validator=lambda v: v > 0)
    disable = Param("disable", "pass through unchanged", "bool", default=False)

    def _transform(self, df):
        return df if self.get("disable") else df.repartition(self.get_or_fail("n"))


class PartitionConsolidator(Transformer):
    """Funnel all rows into one partition per process — the reference funnels
    partitions into one worker per JVM for rate-limited resources
    (``PartitionConsolidator.scala:22-49``; used by cognitive throttling)."""

    def _transform(self, df):
        return df.coalesce(1)


class Explode(Transformer, HasInputCol, HasOutputCol):
    """Explode an array column into one row per element."""

    def _transform(self, df):
        in_col = self.get_or_fail("input_col")
        out_col = self.get("output_col") or in_col

        def per_part(p):
            n = _part_len(p)
            cols = list(p.keys()) + ([out_col] if out_col not in p else [])
            out: Dict[str, list] = {k: [] for k in cols}
            for i in range(n):
                vals = p[in_col][i]
                vals = vals if isinstance(vals, (list, tuple, np.ndarray)) else [vals]
                for v in vals:
                    for k in cols:
                        if k == out_col:
                            out[k].append(v)
                        else:
                            out[k].append(p[k][i])
            return {k: _as_column(v) for k, v in out.items()}

        return df.map_partitions(per_part)


class EnsembleByKey(Transformer):
    """Average vector/scalar columns grouped by key columns
    (reference ``EnsembleByKey.scala``)."""
    keys = Param("keys", "group-by key columns", "list")
    cols = Param("cols", "columns to average", "list")
    col_names = Param("col_names", "output names (default mean(col))", "list")
    collapse_group = Param("collapse_group", "one row per group", "bool", default=True)

    def _transform(self, df):
        keys, cols = self.get_or_fail("keys"), self.get_or_fail("cols")
        names = self.get("col_names") or [f"mean({c})" for c in cols]
        agg = {}
        grouped = df.group_by(*keys)
        whole, groups = grouped._groups()
        out: Dict[str, list] = {k: [] for k in keys}
        for nm in names:
            out[nm] = []
        for key, idx in groups.items():
            idx = np.asarray(idx)
            for k in keys:
                out[k].append(whole[k][idx[0]])
            for c, nm in zip(cols, names):
                vals = whole[c][idx]
                if vals.dtype == object:
                    out[nm].append(np.mean([np.asarray(v) for v in vals], axis=0))
                else:
                    out[nm].append(float(np.mean(vals)))
        return DataFrame.from_dict({k: _as_column(v) for k, v in out.items()})


class ClassBalancer(Estimator, HasInputCol, HasOutputCol):
    """Weight column balancing classes (reference ``ClassBalancer.scala``)."""
    broadcast_join = Param("broadcast_join", "parity param", "bool", default=True)

    def _fit(self, df):
        col = df.collect()[self.get_or_fail("input_col")]
        vals, counts = np.unique(col.astype(str), return_counts=True)
        weights = counts.max() / counts
        m = ClassBalancerModel()
        m.set("input_col", self.get("input_col"))
        m.set("output_col", self.get("output_col") or "weight")
        m.set("mapping", {str(v): float(w) for v, w in zip(vals, weights)})
        return m


class ClassBalancerModel(Model, HasInputCol, HasOutputCol):
    mapping = Param("mapping", "class -> weight", "object")

    def _transform(self, df):
        mapping = self.get_or_fail("mapping")
        in_col = self.get_or_fail("input_col")
        return df.with_column(self.get_or_fail("output_col"),
                              lambda p: np.asarray([mapping.get(str(v), 1.0)
                                                    for v in p[in_col]]))


class StratifiedRepartition(Transformer, HasLabelCol):
    """Redistribute so every partition sees all classes (reference
    ``StratifiedRepartition.scala:31`` — needed for distributed multiclass
    training where a shard missing a class breaks the ring)."""
    mode = Param("mode", "equal|original|mixed", "string", default="mixed")

    def _transform(self, df):
        n_parts = df.num_partitions
        whole = df.collect()
        label = whole[self.get_or_fail("label_col")]
        order = np.argsort(label.astype(str), kind="stable")
        # deal classes round-robin across partitions
        assignments = np.empty(len(order), dtype=int)
        assignments[order] = np.arange(len(order)) % n_parts
        parts = []
        for pid in range(n_parts):
            mask = assignments == pid
            parts.append({k: v[mask] for k, v in whole.items()})
        return DataFrame(parts)


class TextPreprocessor(Transformer, HasInputCol, HasOutputCol):
    """Normalize + map text via a translation dict (reference
    ``TextPreprocessor.scala``)."""
    map = Param("map", "substring -> replacement dict", "object", default=None)
    normalize_case = Param("normalize_case", "lowercase text", "bool", default=True)

    def _transform(self, df):
        mapping = self.get("map") or {}
        lower = self.get("normalize_case")
        in_col, out_col = self.get_or_fail("input_col"), self.get_or_fail("output_col")

        def per_part(p):
            out = np.empty(len(p[in_col]), dtype=object)
            for i, v in enumerate(p[in_col]):
                s = str(v)
                if lower:
                    s = s.lower()
                for a, b in mapping.items():
                    s = s.replace(a, b)
                out[i] = s
            return {**p, out_col: out}

        return df.map_partitions(per_part)


class UnicodeNormalize(Transformer, HasInputCol, HasOutputCol):
    form = Param("form", "NFC|NFD|NFKC|NFKD", "string", default="NFKD")
    lower = Param("lower", "lowercase", "bool", default=True)

    def _transform(self, df):
        form = self.get("form")
        lower = self.get("lower")
        in_col, out_col = self.get_or_fail("input_col"), self.get_or_fail("output_col")

        def per_part(p):
            out = np.empty(len(p[in_col]), dtype=object)
            for i, v in enumerate(p[in_col]):
                s = unicodedata.normalize(form, str(v))
                out[i] = s.lower() if lower else s
            return {**p, out_col: out}

        return df.map_partitions(per_part)


class SummarizeData(Transformer):
    """Column statistics frame (reference ``SummarizeData.scala``):
    counts, basic stats, percentiles, missing counts."""
    basic = Param("basic", "include basic stats", "bool", default=True)
    counts = Param("counts", "include counts", "bool", default=True)
    percentiles = Param("percentiles", "include percentiles", "bool", default=True)
    error_threshold = Param("error_threshold", "parity param", "float", default=0.0)

    def _transform(self, df):
        rows = []
        whole = df.collect()
        n = df.count()
        for c in df.columns:
            col = whole[c]
            row: Dict[str, Any] = {"Feature": c}
            numeric = col.dtype != object
            if self.get("counts"):
                row["Count"] = float(n)
                row["Unique Value Count"] = float(len(set(col.astype(str).tolist())))
                if numeric:
                    row["Missing Value Count"] = float(np.isnan(col.astype(float)).sum())
                else:
                    row["Missing Value Count"] = float(sum(v is None for v in col))
            if self.get("basic") and numeric:
                f = col.astype(float)
                row.update({"Min": float(np.nanmin(f)), "Max": float(np.nanmax(f)),
                            "Mean": float(np.nanmean(f)), "Variance": float(np.nanvar(f, ddof=1)) if n > 1 else 0.0})
            if self.get("percentiles") and numeric:
                f = col.astype(float)
                for q, nm in [(0.005, "P0.5"), (0.01, "P1"), (0.05, "P5"), (0.25, "P25"),
                              (0.5, "Median"), (0.75, "P75"), (0.95, "P95"), (0.99, "P99"),
                              (0.995, "P99.5")]:
                    row[nm] = float(np.nanquantile(f, q))
            rows.append(row)
        return DataFrame.from_rows(rows)
