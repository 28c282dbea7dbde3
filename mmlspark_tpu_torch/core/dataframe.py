"""Partitioned columnar DataFrame — the data substrate of mmlspark_tpu_torch.

The reference operates on Spark DataFrames (row-oriented JVM iterators which
the hot paths painstakingly re-columnarise into native chunked arrays, see
reference ``lightgbm/.../dataset/DatasetAggregator.scala:69-459``).  On TPU the
natural layout is columnar from the start: a partition is a dict of numpy
arrays, ready for zero-ish-copy transfer to device HBM.  This class keeps the
Spark surface the rest of the framework expects (select / withColumn /
mapPartitions / repartition / coalesce / union / filter / groupBy-agg / join)
while staying eager and in-process: multi-host execution shards *partitions*
over executors, each pinned to one TPU chip (SURVEY.md §7 design stance).
"""
from __future__ import annotations

import numpy as np
from typing import Any, Callable, Dict, Iterable, List, Mapping, Optional, Sequence, Union

from .schema import Schema, infer_schema, unify_schemas

Partition = Dict[str, np.ndarray]


def _as_column(values: Any, n: Optional[int] = None) -> np.ndarray:
    """Coerce python values to a numpy column; object dtype for ragged/str."""
    if isinstance(values, np.ndarray):
        return values
    if values is None and n is not None:
        arr = np.empty(n, dtype=object)
        arr[:] = None
        return arr
    if np.isscalar(values) and n is not None:
        arr = np.empty(n, dtype=object) if isinstance(values, (str, bytes)) else None
        if arr is None:
            return np.full(n, values)
        arr[:] = values
        return arr
    values = list(values)
    if values and isinstance(values[0], (list, tuple, np.ndarray, dict)):
        # Ragged / nested columns are stored as object arrays unless rectangular numeric.
        try:
            arr = np.asarray(values)
            if arr.dtype.kind in "fiub" and arr.ndim >= 2:
                return arr
        except (ValueError, TypeError):
            pass
        arr = np.empty(len(values), dtype=object)
        for i, v in enumerate(values):
            arr[i] = v
        return arr
    arr = np.asarray(values)
    if arr.dtype.kind in ("U", "S"):
        out = np.empty(len(values), dtype=object)
        out[:] = values
        return out
    return arr


def _part_len(part: Partition) -> int:
    for v in part.values():
        return len(v)
    return 0


def _slice_part(part: Partition, sl) -> Partition:
    return {k: v[sl] for k, v in part.items()}


def _concat_parts(parts: Sequence[Partition], columns: Sequence[str]) -> Partition:
    if not parts:
        return {c: np.empty(0) for c in columns}
    out = {}
    for c in columns:
        cols = [p[c] for p in parts]
        if any(col.dtype == object for col in cols):
            merged = np.empty(sum(len(c_) for c_ in cols), dtype=object)
            i = 0
            for col in cols:
                merged[i:i + len(col)] = col
                i += len(col)
            out[c] = merged
        else:
            out[c] = np.concatenate(cols) if len(cols) > 1 else cols[0]
    return out


class Row(dict):
    """Dict-backed row with attribute access, for row-wise UDF convenience."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e


class DataFrame:
    """Eager, partitioned, columnar DataFrame.

    Mirrors the subset of the Spark DataFrame API the reference framework
    relies on.  Columns are numpy arrays (object dtype for strings / nested
    values); partitions model executor-local shards.
    """

    def __init__(self, partitions: Sequence[Partition], schema: Optional[Schema] = None):
        parts = [dict(p) for p in partitions]
        if not parts:
            parts = [{}]
        cols = list(parts[0].keys())
        for p in parts:
            if list(p.keys()) != cols:
                raise ValueError(f"partition column mismatch: {list(p.keys())} vs {cols}")
            n = _part_len(p)
            for k, v in p.items():
                if len(v) != n:
                    raise ValueError(f"column {k} length {len(v)} != partition length {n}")
        self._parts: List[Partition] = parts
        self._schema = schema or infer_schema(parts)

    # ---------------------------------------------------------------- factory
    @staticmethod
    def from_dict(data: Mapping[str, Any], num_partitions: int = 1) -> "DataFrame":
        cols = {k: _as_column(v) for k, v in data.items()}
        n = len(next(iter(cols.values()))) if cols else 0
        for k, v in cols.items():
            if len(v) != n:
                raise ValueError(f"column {k} has length {len(v)}, expected {n}")
        df = DataFrame([cols])
        return df.repartition(num_partitions) if num_partitions > 1 else df

    @staticmethod
    def from_rows(rows: Iterable[Mapping[str, Any]], num_partitions: int = 1) -> "DataFrame":
        rows = list(rows)
        if not rows:
            return DataFrame([{}])
        cols = {k: _as_column([r.get(k) for r in rows]) for k in rows[0].keys()}
        return DataFrame.from_dict(cols, num_partitions)

    @staticmethod
    def from_pandas(pdf, num_partitions: int = 1) -> "DataFrame":
        return DataFrame.from_dict({c: pdf[c].to_numpy() for c in pdf.columns}, num_partitions)

    # ---------------------------------------------------------------- schema
    @property
    def columns(self) -> List[str]:
        return list(self._parts[0].keys())

    @property
    def schema(self) -> Schema:
        return self._schema

    @property
    def num_partitions(self) -> int:
        return len(self._parts)

    def partition(self, i: int) -> Partition:
        return self._parts[i]

    @property
    def partitions(self) -> List[Partition]:
        return self._parts

    def count(self) -> int:
        return sum(_part_len(p) for p in self._parts)

    def __len__(self) -> int:
        return self.count()

    def is_empty(self) -> bool:
        return self.count() == 0

    # ---------------------------------------------------------------- columnar ops
    def select(self, *cols: str) -> "DataFrame":
        names = [c for group in cols for c in (group if isinstance(group, (list, tuple)) else [group])]
        missing = [c for c in names if c not in self.columns]
        if missing:
            raise KeyError(f"columns not found: {missing}; have {self.columns}")
        return DataFrame([{c: p[c] for c in names} for p in self._parts],
                         schema=Schema({c: self._schema[c] for c in names if c in self._schema}))

    def drop(self, *cols: str) -> "DataFrame":
        keep = [c for c in self.columns if c not in cols]
        return self.select(*keep)

    def with_column(self, name: str, value: Union[np.ndarray, Callable[[Partition], np.ndarray], Any]) -> "DataFrame":
        """Add/replace a column.  `value` may be a full-length array, a scalar,
        or a function mapping a partition dict to a new column array."""
        new_parts = []
        if callable(value) and not isinstance(value, np.ndarray):
            for p in self._parts:
                col = _as_column(value(p), _part_len(p))
                q = dict(p)
                q[name] = col
                new_parts.append(q)
        elif isinstance(value, np.ndarray) or isinstance(value, (list, tuple)):
            arr = _as_column(value)
            if len(arr) != self.count():
                raise ValueError(f"column length {len(arr)} != frame length {self.count()}")
            i = 0
            for p in self._parts:
                n = _part_len(p)
                q = dict(p)
                q[name] = arr[i:i + n]
                new_parts.append(q)
                i += n
        else:  # scalar
            for p in self._parts:
                q = dict(p)
                q[name] = _as_column(value, _part_len(p))
                new_parts.append(q)
        new_schema = Schema(self._schema)
        new_schema[name] = infer_schema([q for q in new_parts if len(q[name])] or new_parts[:1]).get(name, "object")
        return DataFrame(new_parts, schema=new_schema)

    def with_column_renamed(self, old: str, new: str) -> "DataFrame":
        return DataFrame([{(new if k == old else k): v for k, v in p.items()} for p in self._parts])

    def with_columns(self, mapping: Mapping[str, Any]) -> "DataFrame":
        df = self
        for k, v in mapping.items():
            df = df.with_column(k, v)
        return df

    # ---------------------------------------------------------------- row-ish ops
    def filter(self, predicate: Union[Callable[[Partition], np.ndarray], np.ndarray]) -> "DataFrame":
        """Keep rows where the boolean mask (per-partition fn or full array) is True."""
        new_parts = []
        if callable(predicate):
            for p in self._parts:
                mask = np.asarray(predicate(p), dtype=bool)
                new_parts.append(_slice_part(p, mask))
        else:
            mask = np.asarray(predicate, dtype=bool)
            if len(mask) != self.count():
                raise ValueError(f"mask length {len(mask)} != frame length {self.count()}")
            i = 0
            for p in self._parts:
                n = _part_len(p)
                new_parts.append(_slice_part(p, mask[i:i + n]))
                i += n
        return DataFrame(new_parts, schema=self._schema)

    def map_partitions(self, fn: Callable[[Partition], Partition]) -> "DataFrame":
        """Apply fn to every partition; fn returns a new partition dict.
        The TPU-side analogue of Spark's ``mapPartitions`` hot path."""
        outs = [fn(p) for p in self._parts]
        outs = [{k: _as_column(v) for k, v in o.items()} for o in outs]
        return DataFrame(outs)

    def map_rows(self, fn: Callable[[Row], Mapping[str, Any]]) -> "DataFrame":
        def part_fn(p: Partition) -> Partition:
            n = _part_len(p)
            rows_out = [fn(Row({k: p[k][i] for k in p})) for i in range(n)]
            if not rows_out:
                return {k: np.empty(0, dtype=object) for k in p}
            keys = rows_out[0].keys()
            return {k: _as_column([r[k] for r in rows_out]) for k in keys}
        return self.map_partitions(part_fn)

    def iter_rows(self) -> Iterable[Row]:
        for p in self._parts:
            for i in range(_part_len(p)):
                yield Row({k: p[k][i] for k in p})

    # ---------------------------------------------------------------- partitioning
    def repartition(self, n: int) -> "DataFrame":
        """Even row redistribution into n partitions (Spark: full shuffle)."""
        if n <= 0:
            raise ValueError("num partitions must be positive")
        whole = self.collect()
        total = len(next(iter(whole.values()))) if whole else 0
        bounds = np.linspace(0, total, n + 1).astype(int)
        parts = [_slice_part(whole, slice(bounds[i], bounds[i + 1])) for i in range(n)]
        return DataFrame(parts, schema=self._schema) if self.columns else DataFrame([{}])

    def coalesce(self, n: int) -> "DataFrame":
        """Merge adjacent partitions down to n without a full shuffle."""
        if n >= self.num_partitions:
            return self
        groups = np.array_split(np.arange(self.num_partitions), n)
        cols = self.columns
        parts = [_concat_parts([self._parts[i] for i in g], cols) for g in groups if len(g)]
        return DataFrame(parts, schema=self._schema)

    def collect(self) -> Partition:
        """Concatenate all partitions into one columnar dict (driver-side)."""
        return _concat_parts(self._parts, self.columns)

    def to_pandas(self):
        import pandas as pd
        data = self.collect()
        return pd.DataFrame({k: list(v) if v.dtype == object else v for k, v in data.items()})

    def cache(self) -> "DataFrame":
        return self  # eager: already materialised

    def limit(self, n: int) -> "DataFrame":
        out, remaining = [], n
        for p in self._parts:
            if remaining <= 0:
                break
            take = min(remaining, _part_len(p))
            out.append(_slice_part(p, slice(0, take)))
            remaining -= take
        return DataFrame(out if out else [{c: p[c][:0] for c in self.columns} for p in self._parts[:1]])

    def head(self, n: int = 5) -> List[Row]:
        return list(self.limit(n).iter_rows())

    # ---------------------------------------------------------------- set ops
    def union(self, other: "DataFrame") -> "DataFrame":
        if set(self.columns) != set(other.columns):
            raise ValueError(f"union column mismatch: {self.columns} vs {other.columns}")
        other_parts = [{c: p[c] for c in self.columns} for p in other._parts]
        return DataFrame(self._parts + other_parts)

    def distinct(self, subset: Optional[Sequence[str]] = None) -> "DataFrame":
        cols = list(subset) if subset else self.columns
        whole = self.collect()
        seen, keep = set(), []
        n = len(next(iter(whole.values()))) if whole else 0
        for i in range(n):
            key = tuple(_hashable(whole[c][i]) for c in cols)
            if key not in seen:
                seen.add(key)
                keep.append(i)
        return DataFrame([_slice_part(whole, np.asarray(keep, dtype=int))])

    def sort(self, *cols: str, ascending: bool = True) -> "DataFrame":
        whole = self.collect()
        keys = [whole[c] for c in reversed(cols)]
        order = np.lexsort([k.astype("U") if k.dtype == object else k for k in keys])
        if not ascending:
            order = order[::-1]
        return DataFrame([_slice_part(whole, order)])

    def sample(self, fraction: float, seed: int = 0) -> "DataFrame":
        rng = np.random.default_rng(seed)
        return self.filter(lambda p: rng.random(_part_len(p)) < fraction)

    def random_split(self, weights: Sequence[float], seed: int = 0) -> List["DataFrame"]:
        w = np.asarray(weights, dtype=float)
        w = w / w.sum()
        rng = np.random.default_rng(seed)
        whole = self.collect()
        n = len(next(iter(whole.values()))) if whole else 0
        draws = rng.random(n)
        edges = np.concatenate([[0.0], np.cumsum(w)])
        outs = []
        for i in range(len(w)):
            mask = (draws >= edges[i]) & (draws < edges[i + 1])
            outs.append(DataFrame([_slice_part(whole, mask)]))
        return outs

    # ---------------------------------------------------------------- relational
    def group_by(self, *cols: str) -> "GroupedFrame":
        return GroupedFrame(self, list(cols))

    def join(self, other: "DataFrame", on: Union[str, Sequence[str]], how: str = "inner") -> "DataFrame":
        on = [on] if isinstance(on, str) else list(on)
        left, right = self.collect(), other.collect()
        n_l = len(next(iter(left.values()))) if left else 0
        n_r = len(next(iter(right.values()))) if right else 0
        index: Dict[tuple, List[int]] = {}
        for j in range(n_r):
            index.setdefault(tuple(_hashable(right[c][j]) for c in on), []).append(j)
        li, ri = [], []
        matched_r = np.zeros(n_r, dtype=bool)
        for i in range(n_l):
            key = tuple(_hashable(left[c][i]) for c in on)
            js = index.get(key)
            if js:
                for j in js:
                    li.append(i)
                    ri.append(j)
                    matched_r[j] = True
            elif how in ("left", "outer", "left_outer"):
                li.append(i)
                ri.append(-1)
        li, ri = np.asarray(li, dtype=int), np.asarray(ri, dtype=int)
        out: Partition = {}
        right_only = [c for c in other.columns if c not in on and c not in self.columns]
        right_dup = [c for c in other.columns if c not in on and c in self.columns]
        for c in self.columns:
            out[c] = left[c][li] if n_l else left[c][:0]
        for c in right_only + right_dup:
            name = c if c in right_only else f"{c}_right"
            src = right[c]
            col = np.empty(len(ri), dtype=src.dtype if src.dtype != object else object)
            valid = ri >= 0
            if src.dtype.kind in "iu" and not valid.all():
                col = col.astype(float)
            col[valid] = src[ri[valid]]
            if not valid.all():
                if col.dtype == object:
                    col[~valid] = None
                else:
                    col = col.astype(float)
                    col[~valid] = np.nan
            out[name] = col
        df = DataFrame([out])
        if how in ("outer", "right", "right_outer"):
            # append unmatched right rows
            extra_idx = np.nonzero(~matched_r)[0]
            if len(extra_idx):
                extra: Partition = {}
                for c in self.columns:
                    if c in on:
                        extra[c] = right[c][extra_idx]
                    else:
                        src = left[c]
                        if src.dtype == object:
                            e = np.empty(len(extra_idx), dtype=object)
                            e[:] = None
                        else:
                            e = np.full(len(extra_idx), np.nan)
                        extra[c] = e
                for c in right_only + right_dup:
                    name = c if c in right_only else f"{c}_right"
                    extra[name] = right[c][extra_idx]
                df = df.union(DataFrame([extra]))
        return df

    # ---------------------------------------------------------------- misc
    def __repr__(self) -> str:
        return f"DataFrame(columns={self.columns}, rows={self.count()}, partitions={self.num_partitions})"

    def show(self, n: int = 10) -> None:
        rows = self.head(n)
        print(" | ".join(self.columns))
        for r in rows:
            print(" | ".join(str(r[c]) for c in self.columns))


def _hashable(v):
    if isinstance(v, np.ndarray):
        return (v.shape, v.tobytes())
    if isinstance(v, (list, dict)):
        return repr(v)
    if isinstance(v, (np.floating, np.integer)):
        return v.item()
    return v


_AGGS = {
    "sum": np.sum,
    "mean": np.mean,
    "min": np.min,
    "max": np.max,
    "count": len,
    "first": lambda a: a[0],
    "collect_list": lambda a: list(a),
}


class GroupedFrame:
    """Minimal groupBy-agg, enough for SAR / ranking eval / class balancing."""

    def __init__(self, df: DataFrame, keys: List[str]):
        self._df = df
        self._keys = keys

    def _groups(self):
        whole = self._df.collect()
        n = len(next(iter(whole.values()))) if whole else 0
        groups: Dict[tuple, List[int]] = {}
        for i in range(n):
            groups.setdefault(tuple(_hashable(whole[k][i]) for k in self._keys), []).append(i)
        return whole, groups

    def agg(self, **aggs: str) -> DataFrame:
        """agg(out_name=("col", "sum"), n=("col", "count"), ...)"""
        whole, groups = self._groups()
        out: Dict[str, list] = {k: [] for k in self._keys}
        for name in aggs:
            out[name] = []
        for key, idx in groups.items():
            idx = np.asarray(idx, dtype=int)
            for k_i, k in enumerate(self._keys):
                out[k].append(whole[k][idx[0]])
            for name, (col, how) in aggs.items():
                out[name].append(_AGGS[how](whole[col][idx]))
        return DataFrame.from_dict({k: _as_column(v) for k, v in out.items()})

    def count(self, name: str = "count") -> DataFrame:
        whole, groups = self._groups()
        out: Dict[str, list] = {k: [] for k in self._keys}
        out[name] = []
        for key, idx in groups.items():
            for k in self._keys:
                out[k].append(whole[k][idx[0]])
            out[name].append(len(idx))
        return DataFrame.from_dict({k: _as_column(v) for k, v in out.items()})

    def apply(self, fn: Callable[[Partition], Mapping[str, Any]]) -> DataFrame:
        """mapGroups: fn(sub-partition) -> single dict of columns (reference
        ``LIMEBase.transform`` uses groupByKey.mapGroups, ``LIMEBase.scala:67``)."""
        whole, groups = self._groups()
        rows = []
        for key, idx in groups.items():
            sub = _slice_part(whole, np.asarray(idx, dtype=int))
            res = fn(sub)
            if res is not None:
                rows.append(res)
        return DataFrame.from_rows(rows)
