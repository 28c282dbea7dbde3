"""Schema & binding codecs — the SparkBindings equivalent.

Reference: ``core/src/main/scala/com/microsoft/ml/spark/core/schema/SparkBindings.scala:14-46``
converts case classes <-> Spark Rows so typed payloads (HTTP requests, service
responses) ride inside DataFrames.  Here the analogue is dataclass <-> columnar
codec: a ``Binding`` turns a list of dataclass instances into object columns
and back, and ``Schema`` records per-column dtypes for validation in
``transformSchema``-style checks.
"""
from __future__ import annotations

import dataclasses
import numpy as np
from typing import Any, Dict, List, Mapping, Optional, Sequence, Type, TypeVar

T = TypeVar("T")


class ColumnType:
    """Logical column types (numpy-backed)."""
    FLOAT = "float"
    DOUBLE = "double"
    INT = "int"
    LONG = "long"
    BOOL = "bool"
    STRING = "string"
    BINARY = "binary"
    VECTOR = "vector"    # fixed or ragged numeric vectors (object or 2-d)
    STRUCT = "struct"    # dicts / dataclasses
    ARRAY = "array"      # nested lists
    OBJECT = "object"

    _KIND_MAP = {"f": DOUBLE, "i": LONG, "u": LONG, "b": BOOL}

    @staticmethod
    def of(arr: np.ndarray) -> str:
        if arr.dtype == object:
            for v in arr:
                if v is None:
                    continue
                if isinstance(v, str):
                    return ColumnType.STRING
                if isinstance(v, (bytes, bytearray)):
                    return ColumnType.BINARY
                if isinstance(v, (list, tuple, np.ndarray)):
                    return ColumnType.VECTOR
                if isinstance(v, Mapping) or dataclasses.is_dataclass(v):
                    return ColumnType.STRUCT
                return ColumnType.OBJECT
            return ColumnType.OBJECT
        if arr.ndim >= 2:
            return ColumnType.VECTOR
        return ColumnType._KIND_MAP.get(arr.dtype.kind, ColumnType.OBJECT)


class Schema(dict):
    """column name -> logical type.  Dict subclass so it stays JSON-friendly."""

    def require(self, col: str, *types: str) -> None:
        if col not in self:
            raise ValueError(f"required column '{col}' missing; schema has {list(self)}")
        if types and self[col] not in types:
            raise ValueError(f"column '{col}' has type {self[col]}, expected one of {types}")

    def add(self, col: str, typ: str) -> "Schema":
        s = Schema(self)
        s[col] = typ
        return s


def infer_schema(partitions: Sequence[Mapping[str, np.ndarray]]) -> Schema:
    s = Schema()
    for p in partitions:
        for k, v in p.items():
            if k not in s and len(v):
                s[k] = ColumnType.of(v)
            elif k not in s:
                s[k] = ColumnType.OBJECT
        break
    # refine OBJECT columns using later partitions that have data
    for p in partitions:
        for k, v in p.items():
            if s.get(k) == ColumnType.OBJECT and len(v):
                s[k] = ColumnType.of(v)
    return s


def unify_schemas(a: Schema, b: Schema) -> Schema:
    out = Schema(a)
    for k, v in b.items():
        if k in out and out[k] != v and ColumnType.OBJECT not in (out[k], v):
            raise ValueError(f"schema conflict on '{k}': {out[k]} vs {v}")
        out.setdefault(k, v)
    return out


class Binding:
    """dataclass <-> object-column codec (SparkBindings analogue)."""

    def __init__(self, cls: Type[T]):
        if not dataclasses.is_dataclass(cls):
            raise TypeError(f"{cls} is not a dataclass")
        self.cls = cls
        self.fields = [f.name for f in dataclasses.fields(cls)]

    def to_column(self, items: Sequence[Optional[T]]) -> np.ndarray:
        out = np.empty(len(items), dtype=object)
        for i, it in enumerate(items):
            out[i] = None if it is None else dataclasses.asdict(it)
        return out

    def from_column(self, col: np.ndarray) -> List[Optional[T]]:
        return [None if v is None else self._decode(self.cls, v) for v in col]

    def _decode(self, cls, value):
        if dataclasses.is_dataclass(cls) and isinstance(value, Mapping):
            kwargs = {}
            for f in dataclasses.fields(cls):
                v = value.get(f.name)
                sub = f.type
                if isinstance(sub, str):
                    sub = None  # forward-ref strings: pass through raw
                if sub is not None and dataclasses.is_dataclass(sub) and isinstance(v, Mapping):
                    v = self._decode(sub, v)
                kwargs[f.name] = v
            return cls(**kwargs)
        return value


def vector_column(vectors: Sequence[Any]) -> np.ndarray:
    """Pack possibly-ragged numeric vectors into a column.  Rectangular input
    becomes a dense 2-d float array (device-transfer friendly); ragged input
    falls back to object dtype."""
    try:
        arr = np.asarray([np.asarray(v, dtype=np.float64) for v in vectors])
        if arr.dtype != object and arr.ndim == 2:
            return arr
    except (ValueError, TypeError):
        pass
    out = np.empty(len(vectors), dtype=object)
    for i, v in enumerate(vectors):
        out[i] = np.asarray(v, dtype=np.float64)
    return out


def stack_vector_column(col: np.ndarray) -> np.ndarray:
    """Object column of equal-length vectors -> dense (n, d) float array."""
    if col.dtype != object:
        return np.asarray(col, dtype=np.float64)
    if len(col) == 0:
        return np.zeros((0, 0))
    return np.stack([np.asarray(v, dtype=np.float64) for v in col])


def find_unused_column_name(base: str, schema: Mapping[str, Any]) -> str:
    """Reference ``DatasetExtensions.findUnusedColumnName`` (core/schema/)."""
    name = base
    i = 0
    while name in schema:
        i += 1
        name = f"{base}_{i}"
    return name
