"""Serving of the port — own copies of the JAX package's
``serving/server.py`` (``PipelineServer``, ``DistributedPipelineServer``:
N local servers, ``ServingStats``), ``serving/streaming.py`` and
``serving/loadgen.py``.  The serving fleet (``TopologyService``,
``RoutingClient``, ``MembershipWatcher``, ``WorkerServer``:
``serving/distributed.py``) is not ported yet; those names raise
``NotImplementedError`` naming ROADMAP.md §1 item 9(c)."""
from .server import (PipelineServer, DistributedPipelineServer, ServingStats)
from .streaming import HTTPStreamSource, StreamingQuery, read_stream
from .loadgen import check_gates, sustained_load, mixed_load

_FLEET_NOT_PORTED = (
    "the serving fleet (serving/distributed.py, observability/federation.py,"
    " observability/autoscale.py) is not ported yet (ROADMAP.md §1 item "
    "9(c): the serving fleet, after io/http.py)")


class _FleetNotPorted:
    """A name of the serving fleet: raises on use."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(_FLEET_NOT_PORTED)


class TopologyService(_FleetNotPorted):
    pass


class WorkerServer(_FleetNotPorted):
    pass


class RoutingClient(_FleetNotPorted):
    pass


class MembershipWatcher(_FleetNotPorted):
    pass


__all__ = ["PipelineServer", "DistributedPipelineServer", "ServingStats",
           "TopologyService", "WorkerServer", "RoutingClient",
           "MembershipWatcher",
           "HTTPStreamSource", "StreamingQuery", "read_stream",
           "sustained_load", "mixed_load", "check_gates"]
