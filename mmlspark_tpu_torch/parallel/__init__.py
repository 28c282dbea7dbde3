"""Parallelism of the port on ``torch.distributed`` (port of
``mmlspark_tpu/parallel``): the mesh of ranks and its process groups
(``mesh``), placements (``sharding``), the collectives with the quantized
histograms' packed allreduce and their autograd (``collectives``), the
partition rules (``partition``), a world of spawned ranks on one host
(``world``, the port's own), executor processes and sharded inference
(``executor``), the data x model trainer with its checkpoints
(``trainer``, ``checkpoint``), ring attention (``ring_attention``), and
sequence, pipeline and expert parallelism (``seq_parallel``,
``pipeline_parallel``, ``moe``)."""
from .mesh import (AXIS_DATA, AXIS_MODEL, AXIS_SEQ, AXIS_PIPE, AXIS_EXPERT,
                   make_mesh, data_parallel_mesh, get_active_mesh,
                   set_active_mesh, active_mesh, initialize_distributed)
from .sharding import (named_sharding, replicated, batch_sharded, shard_batch,
                       replicate, pad_to_multiple)
from .collectives import (psum, pmean, pmax, all_gather, ppermute, ring_perm,
                          axis_index, shard_mapped)
from .partition import (match_partition_rules, replace_on_mesh,
                        tree_path_names)

__all__ = [
    "AXIS_DATA", "AXIS_MODEL", "AXIS_SEQ", "AXIS_PIPE", "AXIS_EXPERT",
    "make_mesh", "data_parallel_mesh", "get_active_mesh", "set_active_mesh",
    "active_mesh", "initialize_distributed", "named_sharding", "replicated",
    "batch_sharded", "shard_batch", "replicate", "pad_to_multiple", "psum",
    "pmean", "pmax", "all_gather", "ppermute", "ring_perm", "axis_index",
    "shard_mapped", "match_partition_rules", "replace_on_mesh",
    "tree_path_names",
]
