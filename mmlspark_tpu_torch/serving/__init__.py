"""Serving of the port — own copies of the JAX package's
``serving/server.py`` (``PipelineServer``, ``DistributedPipelineServer``:
N local servers, ``ServingStats``), ``serving/distributed.py`` (the
fleet: ``TopologyService``, ``WorkerServer``, ``RoutingClient``,
``MembershipWatcher``), ``serving/streaming.py`` and
``serving/loadgen.py``."""
from .server import (PipelineServer, DistributedPipelineServer, ServingStats)
from .distributed import (MembershipWatcher, RoutingClient, TopologyService,
                          WorkerServer)
from .streaming import HTTPStreamSource, StreamingQuery, read_stream
from .loadgen import check_gates, sustained_load, mixed_load

__all__ = ["PipelineServer", "DistributedPipelineServer", "ServingStats",
           "TopologyService", "WorkerServer", "RoutingClient",
           "MembershipWatcher",
           "HTTPStreamSource", "StreamingQuery", "read_stream",
           "sustained_load", "mixed_load", "check_gates"]
