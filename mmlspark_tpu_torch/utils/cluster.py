"""ClusterUtil — device/cluster topology oracle, the port's twin of
``mmlspark_tpu/utils/cluster.py``.

Reference: ``core/utils/ClusterUtil.scala:20-145`` derives executor count,
tasks-per-executor and driver host so LightGBM/VW can size their allreduce
rings.  Here the topology is the CUDA device set: ``torch.cuda``'s visible
cards on this host and, once ``torch.distributed`` is initialised, the
process group's world size and rank (one process per card, so the world
is the global card count and the rank the host index, as the JAX
package's one process per host reports).  It is a query: it reports what
is there and starts nothing.
"""
from __future__ import annotations

import os
import socket
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class Topology:
    num_devices: int          # global card count (ring size equivalent)
    num_local_devices: int    # cards on this host (tasks-per-executor analogue)
    num_hosts: int            # executor count analogue
    host_index: int           # this executor's index
    platform: str             # 'gpu' | 'cpu'
    coordinator: str          # driver host:port analogue


def _distributed():
    """(world size, rank) of an initialised process group, else None."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return None


class ClusterUtil:
    """Static topology queries (mirrors reference ClusterUtil's static API)."""

    _override: Optional[Topology] = None

    @staticmethod
    def get_topology() -> Topology:
        if ClusterUtil._override is not None:
            return ClusterUtil._override
        import torch
        local = torch.cuda.device_count() if torch.cuda.is_available() else 0
        world = _distributed()
        if world is None:
            # one process: every card it sees (the host itself without one)
            num_devices, num_hosts, host_index = max(local, 1), 1, 0
        else:
            num_devices, host_index = world
            num_hosts = world[0]
        return Topology(
            num_devices=num_devices,
            num_local_devices=max(local, 1),
            num_hosts=num_hosts,
            host_index=host_index,
            platform="gpu" if local else "cpu",
            coordinator=os.environ.get("MMLSPARK_TPU_COORDINATOR",
                                       f"{socket.gethostname()}:0"),
        )

    @staticmethod
    def set_topology_override(topo: Optional[Topology]) -> None:
        """Tests inject synthetic topologies (reference tests spoof executor
        counts through local[*] task settings)."""
        ClusterUtil._override = topo

    @staticmethod
    def get_num_devices() -> int:
        return ClusterUtil.get_topology().num_devices

    @staticmethod
    def get_num_hosts() -> int:
        return ClusterUtil.get_topology().num_hosts

    @staticmethod
    def get_num_tasks_per_executor() -> int:
        return ClusterUtil.get_topology().num_local_devices

    @staticmethod
    def get_driver_host() -> str:
        return ClusterUtil.get_topology().coordinator.split(":")[0]

    @staticmethod
    def default_parallelism(df_partitions: int, requested: Optional[int] = None) -> int:
        """How many data shards to train over: min(partitions, devices) unless
        the caller pins a count (reference prepareDataframe repartition logic,
        ``LightGBMBase.scala:110-145``)."""
        n = requested or ClusterUtil.get_num_devices()
        return max(1, min(n, df_partitions if df_partitions > 0 else n))
