"""Host-side I/O of the port: out-of-core tiles (``chunked``) and atomic
booster snapshots (``checkpoint``), own copies of the JAX package's
jax-free modules of the same names."""
from .checkpoint import (CheckpointManager, atomic_write, check_resume_arg,
                         snapshot_steps)
from .chunked import (ChunkedDataset, TilePrefetcher, pad_tile,
                      resolve_tile_rows)

__all__ = ["CheckpointManager", "atomic_write", "check_resume_arg",
           "snapshot_steps", "ChunkedDataset", "TilePrefetcher", "pad_tile",
           "resolve_tile_rows"]
