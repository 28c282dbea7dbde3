"""Build and load the port's native code.

- Every ``.cu`` file under ``mmlspark_tpu_torch/csrc`` is compiled by
  ``nvcc`` for Hopper (``sm_90a``) into one shared library with a plain C
  interface (``load_library``).  Each C entry point launches on the stream
  it is given and returns ``cudaGetLastError()``; the wrappers in
  ``ops.cuda_histogram`` raise when it is not 0.
- ``csrc/binning.cpp``, the host binning data plane, is compiled by the
  system ``g++`` with the JAX package's own Makefile flags
  (``native/Makefile``), so its float arithmetic is the reference's
  (``load_host_library``).

Each build runs at first use, into ``mmlspark_tpu_torch/_build/<hash>/``
(listed in ``.gitignore``), where the hash covers the sources and the
flags, so an edited source rebuilds and an unchanged one is loaded as it
is.  A compiler that is missing or fails raises with its message.

Nothing here runs at import: the CPU tests import every module, and a
machine without a card has no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(_PKG, "_build")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-fmad=false",
              "-Xptxas", "-v"]

#: the JAX package's native/Makefile flags: no -march, so no FMA
#: contraction, and the edges' double arithmetic rounds as the reference's
GXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared"]
HOST_SOURCE = os.path.join(CSRC, "binning.cpp")

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
_SIGNATURES = {
    "hist_accumulate_launch": [_P, _L, _L, _P, _P, _P, _P, _I, _I, _I, _I,
                               _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "frontier_finish_launch": [_P, _I, _I, _I, _I, _I, _I,
                               _P, _I, _P, _P, _P, _I, _P, _P,
                               _P, _P, _P, _P, _F, _F, _F, _F,
                               _P, _P, _P, _P, _P, _P, _P, _I, _P],
}

_HOST_SIGNATURES = {
    "mm_bin_edges": [_P, ctypes.c_int64, ctypes.c_int64, _I, _P, _I],
    "mm_bin_apply": [_P, ctypes.c_int64, ctypes.c_int64, _P, _I, _P, _I],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_host_lib: Optional[ctypes.CDLL] = None


def _sources() -> list:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu"))
                  + glob.glob(os.path.join(CSRC, "*.cuh")))


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc") or "",
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the port's CUDA kernels")


def _gxx() -> str:
    cxx = shutil.which(os.environ.get("CXX") or "g++")
    if not cxx:
        raise RuntimeError("g++ not found: set CXX or put g++ on PATH to "
                           "build the port's host binning plane "
                           "(csrc/binning.cpp)")
    return cxx


def _digest(sources: list, flags: list = NVCC_FLAGS) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for path in sources:
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _compile(compiler: str, flags: list, sources: list, out_dir: str,
             name: str) -> str:
    """Compile ``sources`` into ``out_dir/name`` unless it exists (the
    compiler's output in ``<compiler>.log`` beside it).  The ``.so``
    appears by an atomic rename, so a concurrent or interrupted build never
    leaves a half-written library."""
    lib = os.path.join(out_dir, name)
    if os.path.isfile(lib):
        return lib
    os.makedirs(out_dir, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = [compiler, *flags, "-o", tmp, *sources]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    tool = os.path.basename(compiler)
    with open(os.path.join(out_dir, f"{tool}.log"), "w") as f:
        f.write(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"{tool} failed ({proc.returncode}):\n"
                           f"{proc.stderr[-4000:]}")
    os.replace(tmp, lib)
    return lib


def build() -> str:
    """Compile the CUDA sources unless a library for their hash exists;
    returns the library path (its ``nvcc.log`` sits beside it)."""
    sources = [s for s in _sources() if s.endswith(".cu")]
    return _compile(_nvcc(), NVCC_FLAGS, sources,
                    os.path.join(BUILD_ROOT, _digest(_sources())),
                    "libmmlspark_kernels.so")


def build_host() -> str:
    """Compile ``csrc/binning.cpp`` with g++ unless a library for its hash
    exists; returns the library path."""
    return _compile(_gxx(), GXX_FLAGS, [HOST_SOURCE],
                    os.path.join(BUILD_ROOT, "host-" + _digest(
                        [HOST_SOURCE], GXX_FLAGS)),
                    "libmmlspark_binning.so")


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built at first use and loaded once."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.frontier_error_string.argtypes = [ctypes.c_int]
            lib.frontier_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def load_host_library() -> ctypes.CDLL:
    """The host binning library, built at first use and loaded once."""
    global _host_lib
    with _lock:
        if _host_lib is None:
            lib = ctypes.CDLL(build_host())
            for name, argtypes in _HOST_SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = None
            _host_lib = lib
        return _host_lib
