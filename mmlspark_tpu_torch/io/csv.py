"""CSV ingest — native fast path with numpy fallback.

An own copy of the JAX package's ``io/csv.py``, verbatim apart from module
paths.

Reference ingest hot loop: rows are streamed into native chunked arrays
(``DatasetAggregator.scala:87-95``).  Here whole numeric CSVs parse in C++
(``native/mmlspark_native.cpp``) straight into a columnar float32 matrix;
mixed-type files fall back to a python reader that keeps string columns.
"""
from __future__ import annotations

import csv as _csv
import io as _io
from typing import List, Optional

import numpy as np

from ..core import DataFrame
from ..core.dataframe import _as_column


def read_csv(path: str, num_partitions: int = 1, header: bool = True,
             numeric_only: bool = False) -> DataFrame:
    with open(path, "rb") as f:
        raw = f.read()
    names: Optional[List[str]] = None
    if header:
        first_line = raw.split(b"\n", 1)[0].decode("utf-8").strip("\r")
        names = next(_csv.reader([first_line]))
    if numeric_only:
        from ..utils.native_loader import csv_to_matrix_native
        mat = csv_to_matrix_native(raw, skip_header=header)
        if mat is not None:
            cols = names or [f"c{i}" for i in range(mat.shape[1])]
            return DataFrame.from_dict(
                {c: mat[:, i].astype(np.float64) for i, c in enumerate(cols)},
                num_partitions)
    # general path: python csv module, per-column type inference
    text = raw.decode("utf-8", "replace")
    reader = _csv.reader(_io.StringIO(text))
    rows = [r for r in reader if r]
    if header:
        names = rows[0]
        rows = rows[1:]
    if not rows:
        return DataFrame([{}])
    ncols = len(rows[0])
    names = names or [f"c{i}" for i in range(ncols)]
    cols = {}
    for i, name in enumerate(names):
        vals = [r[i] if i < len(r) else "" for r in rows]
        try:
            cols[name] = np.asarray([float(v) if v != "" else np.nan for v in vals])
        except ValueError:
            cols[name] = _as_column(vals)
    return DataFrame.from_dict(cols, num_partitions)
