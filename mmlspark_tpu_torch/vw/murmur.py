"""MurmurHash3 (x86 32-bit) — VW-compatible feature hashing (the port's own
copy of ``mmlspark_tpu/vw/murmur.py``; the batch of cold strings goes
through the port's C++ ``csrc/murmur.cpp``).

Reference: VW's hashing reimplemented JVM-side for speed
(``VowpalWabbitMurmurWithPrefix``, ``vw/.../featurizer/``; ``docs/vw.md:29-30``
notes hashing host-side beat hashing through JNI — the same argument applies
here: hash on host CPU in vectorized numpy, ship only (indices, values) to
the device).  Matches the canonical MurmurHash3_x86_32 bit-for-bit.
"""
from __future__ import annotations

import numpy as np

_C1 = np.uint32(0xCC9E2D51)
_C2 = np.uint32(0x1B873593)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def _fmix(h: np.ndarray) -> np.ndarray:
    h ^= h >> np.uint32(16)
    h *= np.uint32(0x85EBCA6B)
    h ^= h >> np.uint32(13)
    h *= np.uint32(0xC2B2AE35)
    h ^= h >> np.uint32(16)
    return h


def murmur3_bytes(data: bytes, seed: int = 0) -> int:
    """Scalar reference implementation over a byte string."""
    with np.errstate(over="ignore"):
        h = np.uint32(seed)
        n = len(data)
        nblocks = n // 4
        blocks = np.frombuffer(data[: nblocks * 4], dtype="<u4").copy()
        for k in blocks:
            k = np.uint32(k) * _C1
            k = _rotl(k, 15) * _C2
            h = (_rotl(h ^ k, 13) * np.uint32(5)) + np.uint32(0xE6546B64)
        k = np.uint32(0)
        tail = data[nblocks * 4:]
        if len(tail) >= 3:
            k ^= np.uint32(tail[2]) << np.uint32(16)
        if len(tail) >= 2:
            k ^= np.uint32(tail[1]) << np.uint32(8)
        if len(tail) >= 1:
            k ^= np.uint32(tail[0])
            k = _rotl(k * _C1, 15) * _C2
            h ^= k
        return int(_fmix(h ^ np.uint32(n)))


def murmur3_ints(values: np.ndarray, seed: int = 0) -> np.ndarray:
    """Vectorized murmur3 of 4-byte little-endian ints (VW hashes numeric
    feature indices this way).  values: (n,) uint32 -> (n,) uint32."""
    with np.errstate(over="ignore"):
        k = values.astype(np.uint32) * _C1
        k = _rotl(k, 15) * _C2
        h = np.uint32(seed) ^ k
        h = (_rotl(h, 13) * np.uint32(5)) + np.uint32(0xE6546B64)
        return _fmix(h ^ np.uint32(4))


class StringHashCache:
    """Memoized string hashing (feature names repeat across rows)."""

    def __init__(self, seed: int = 0):
        self.seed = seed
        self._cache: dict = {}

    def __call__(self, s: str) -> int:
        v = self._cache.get(s)
        if v is None:
            v = murmur3_bytes(s.encode("utf-8"), self.seed)
            self._cache[s] = v
        return v

    def hash_array(self, arr: np.ndarray) -> np.ndarray:
        uniq, inv = np.unique(arr.astype(str), return_inverse=True)
        misses = [u for u in uniq if u not in self._cache]
        if len(misses) > 32:  # batch the cold strings through the C++ kernel
            from ..utils.native_loader import murmur3_batch_native
            hashed = murmur3_batch_native(misses, self.seed)
            for u, h in zip(misses, hashed):
                self._cache[u] = int(h)
        hashes = np.asarray([self(u) for u in uniq], dtype=np.uint32)
        return hashes[inv]
