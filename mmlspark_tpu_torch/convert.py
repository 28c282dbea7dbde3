"""Carry state from the JAX package into the port — as plain data (dicts
and numpy arrays), so this module imports nothing of ``mmlspark_tpu``.

- ``params_from_jax`` — a ``GBDTParams`` field dict
  (``dataclasses.asdict`` of the JAX dataclass) -> the port's dataclass;
- ``booster_from_arrays`` — a JAX booster's ``_ARRAYS`` + ``_META``
  -> the port's ``GBDTBooster`` (``GBDTBooster.from_string`` also reads the
  JAX package's ``to_string`` output unchanged);
- ``bin_mapper_from_edges`` — fitted bin edges -> the port's ``BinMapper``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np

from .lightgbm.binning import BinMapper
from .lightgbm.core import GBDTParams
from .models.gbdt import GBDTBooster


def params_from_jax(fields: Dict) -> GBDTParams:
    """Map a JAX ``GBDTParams`` field dict to the port's dataclass; a field
    the port does not know raises, so nothing is dropped silently."""
    known = {f.name for f in dataclasses.fields(GBDTParams)}
    unknown = sorted(set(fields) - known)
    if unknown:
        raise ValueError(f"GBDTParams fields not in the port: {unknown}")
    return GBDTParams(**fields)


def booster_from_arrays(arrays: Dict[str, np.ndarray],
                        meta: Dict) -> GBDTBooster:
    """The port's booster from the JAX booster's arrays
    (``GBDTBooster._ARRAYS`` / ``_OPT_ARRAYS``) and meta
    (``GBDTBooster._META``)."""
    return GBDTBooster(**{k: np.asarray(v) for k, v in arrays.items()},
                       **meta)


def bin_mapper_from_edges(edges: np.ndarray, max_bin: int,
                          categorical_features: Optional[Sequence[int]]
                          = None) -> BinMapper:
    """A fitted ``BinMapper`` holding the given ``(F, max_bin - 1)`` edges."""
    edges = np.asarray(edges, np.float32)
    if edges.ndim != 2 or edges.shape[1] != max_bin - 1:
        raise ValueError(f"edges must be (F, {max_bin - 1}), got "
                         f"{edges.shape}")
    mapper = BinMapper(max_bin, categorical_features=categorical_features)
    mapper.edges = edges.copy()
    return mapper
