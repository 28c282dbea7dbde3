"""The host binning plane's ctypes bindings — the port's copy of
``mmlspark_tpu/utils/native_loader.py::bin_edges_native`` and
``bin_apply_native``, over ``csrc/binning.cpp`` (built by
``kernels._build.build_host``).

Unlike the JAX package's loader, these never return None: when the caller
has chosen the C++ route, a missing ``g++`` or a failed build raises with
the compiler's message.  Falling back to numpy would give edges that can
differ from the reference's by one ulp (``csrc/binning.cpp``'s note).
"""
from __future__ import annotations

import ctypes

import numpy as np


def _lib():
    from ..kernels._build import load_host_library
    return load_host_library()


def bin_edges_native(X, max_bin: int, n_threads: int = 0) -> np.ndarray:
    """(n, F) float32 -> (F, max_bin-1) quantile edges via the threaded C++
    loop (``BinMapper.fit``'s C++ route)."""
    X = np.ascontiguousarray(X, np.float32)
    n, F = X.shape
    if not 2 <= max_bin <= 256:
        raise ValueError(f"max_bin must be in [2, 256], got {max_bin}")
    lib = _lib()
    edges = np.empty((F, max_bin - 1), np.float32)
    lib.mm_bin_edges(X.ctypes.data_as(ctypes.c_void_p),
                     ctypes.c_int64(n), ctypes.c_int64(F),
                     ctypes.c_int(max_bin),
                     edges.ctypes.data_as(ctypes.c_void_p),
                     ctypes.c_int(n_threads))
    return edges


def bin_apply_native(X, edges, max_bin: int, n_threads: int = 0
                     ) -> np.ndarray:
    """(n, F) raw -> (n, F) uint8 bins via the threaded C++ binary search
    (``BinMapper.transform``'s C++ route)."""
    X = np.ascontiguousarray(X, np.float32)
    edges = np.ascontiguousarray(edges, np.float32)
    n, F = X.shape
    if edges.shape != (F, max_bin - 1):
        raise ValueError(f"edges must be ({F}, {max_bin - 1}), got "
                         f"{edges.shape}")
    lib = _lib()
    out = np.empty((n, F), np.uint8)
    lib.mm_bin_apply(X.ctypes.data_as(ctypes.c_void_p),
                     ctypes.c_int64(n), ctypes.c_int64(F),
                     edges.ctypes.data_as(ctypes.c_void_p),
                     ctypes.c_int(max_bin),
                     out.ctypes.data_as(ctypes.c_void_p),
                     ctypes.c_int(n_threads))
    return out
