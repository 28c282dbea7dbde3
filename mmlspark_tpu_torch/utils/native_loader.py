"""The host plane's ctypes bindings — the port's copy of
``mmlspark_tpu/utils/native_loader.py::bin_edges_native``,
``bin_apply_native``, ``murmur3_batch_native``, ``csv_to_matrix_native``
and ``ChunkedArray``, over ``csrc/binning.cpp``, ``csrc/murmur.cpp`` and
``csrc/csv.cpp`` (built by ``kernels._build.build_host``).

Unlike the JAX package's loader, these never return None: when the caller
has chosen the C++ route, a missing ``g++`` or a failed build raises with
the compiler's message.  Falling back to numpy would give edges that can
differ from the reference's by one ulp (``csrc/binning.cpp``'s note); a
CSV too large for its counted shape raises too, where the reference's
parser returns None.
"""
from __future__ import annotations

import ctypes

import numpy as np


def load_native() -> ctypes.CDLL:
    """The host plane's library, built at first use (the reference's
    ``load_native``).  Never None: a missing ``g++`` or a failed build
    raises."""
    from ..kernels._build import load_host_library
    return load_host_library()


def bin_edges_native(X, max_bin: int, n_threads: int = 0) -> np.ndarray:
    """(n, F) float32 -> (F, max_bin-1) quantile edges via the threaded C++
    loop (``BinMapper.fit``'s C++ route)."""
    X = np.ascontiguousarray(X, np.float32)
    n, F = X.shape
    if not 2 <= max_bin <= 256:
        raise ValueError(f"max_bin must be in [2, 256], got {max_bin}")
    lib = load_native()
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
    lib = load_native()
    out = np.empty((n, F), np.uint8)
    lib.mm_bin_apply(X.ctypes.data_as(ctypes.c_void_p),
                     ctypes.c_int64(n), ctypes.c_int64(F),
                     edges.ctypes.data_as(ctypes.c_void_p),
                     ctypes.c_int(max_bin),
                     out.ctypes.data_as(ctypes.c_void_p),
                     ctypes.c_int(n_threads))
    return out


def murmur3_batch_native(strings, seed: int = 0) -> np.ndarray:
    """Hash a list of str/bytes through the C++ batch loop -> ``(n,)``
    uint32, equal to ``vw.murmur.murmur3_bytes`` of each, bit for bit."""
    lib = load_native()
    blobs = [s.encode("utf-8") if isinstance(s, str) else bytes(s)
             for s in strings]
    offsets = np.zeros(len(blobs) + 1, np.int64)
    np.cumsum([len(b) for b in blobs], out=offsets[1:])
    data = np.frombuffer(b"".join(blobs) or b"\0", np.uint8)
    out = np.zeros(len(blobs), np.uint32)
    lib.mm_murmur3_batch(data.ctypes.data_as(ctypes.c_void_p),
                         offsets.ctypes.data_as(ctypes.c_void_p),
                         ctypes.c_int64(len(blobs)), ctypes.c_uint32(seed),
                         out.ctypes.data_as(ctypes.c_void_p))
    return out


def csv_to_matrix_native(text: bytes, skip_header: bool = True
                         ) -> np.ndarray:
    """CSV bytes -> ``(n, F)`` float32 matrix via the C++ parser (NaN for an
    empty or unparsable cell; no quoting)."""
    lib = load_native()
    text = bytes(text)
    nrows, ncols = ctypes.c_int64(), ctypes.c_int64()
    lib.mm_csv_shape(text, len(text), ctypes.byref(nrows),
                     ctypes.byref(ncols))
    cap = nrows.value
    out = np.empty((max(cap, 1), ncols.value), np.float32)
    got = lib.mm_csv_parse_f32(text, len(text), ncols.value,
                               out.ctypes.data_as(ctypes.c_void_p), cap,
                               1 if skip_header else 0)
    if got < 0:
        raise ValueError(f"CSV holds more rows than the {cap} counted")
    return out[:got]


class ChunkedArray:
    """Growable native float32 buffer (reference SWIG ChunkedArray analogue,
    ``swig/SwigUtils.scala:23-100``), over ``csrc/csv.cpp``'s
    ``mm_chunked_*``."""

    def __init__(self, initial_cap: int = 1 << 16):
        self._lib = load_native()
        self._handle = ctypes.c_void_p(self._lib.mm_chunked_new(initial_cap))

    def add(self, values) -> None:
        arr = np.ascontiguousarray(values, np.float32)
        self._lib.mm_chunked_add(self._handle,
                                 arr.ctypes.data_as(ctypes.c_void_p),
                                 arr.size)

    @property
    def size(self) -> int:
        return int(self._lib.mm_chunked_size(self._handle))

    def coalesce(self) -> np.ndarray:
        out = np.empty(self.size, np.float32)
        self._lib.mm_chunked_coalesce(self._handle,
                                      out.ctypes.data_as(ctypes.c_void_p))
        return out

    def close(self) -> None:
        if self._handle is not None:
            self._lib.mm_chunked_free(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass
