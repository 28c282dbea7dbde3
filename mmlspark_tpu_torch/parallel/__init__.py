"""Parallelism of the port on ``torch.distributed`` (port of
``mmlspark_tpu/parallel``): the mesh of ranks and its process groups
(``mesh``), placements (``sharding``), the collectives with the quantized
histograms' packed allreduce (``collectives``), a world of spawned ranks on
one host (``world``), and the single-device half of ring attention
(``ring_attention.blockwise_attention``).  The partition rules, the
executor, the trainer and ring/sequence/pipeline parallel wait for
ROADMAP.md §1 item 10."""
from .mesh import (AXIS_DATA, AXIS_MODEL, AXIS_SEQ, AXIS_PIPE, AXIS_EXPERT,
                   make_mesh, data_parallel_mesh, get_active_mesh,
                   set_active_mesh, active_mesh, initialize_distributed)
from .sharding import (named_sharding, replicated, batch_sharded, shard_batch,
                       replicate, pad_to_multiple)
from .collectives import (psum, pmean, pmax, all_gather, ppermute, ring_perm,
                          axis_index, shard_mapped)

__all__ = [
    "AXIS_DATA", "AXIS_MODEL", "AXIS_SEQ", "AXIS_PIPE", "AXIS_EXPERT",
    "make_mesh", "data_parallel_mesh", "get_active_mesh", "set_active_mesh",
    "active_mesh", "initialize_distributed", "named_sharding", "replicated",
    "batch_sharded", "shard_batch", "replicate", "pad_to_multiple", "psum",
    "pmean", "pmax", "all_gather", "ppermute", "ring_perm", "axis_index",
    "shard_mapped",
]
