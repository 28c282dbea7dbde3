"""Published peaks of one NVIDIA H100 SXM (the data sheet's dense rates,
at its 700 W limit): the roofline's ceilings."""
from __future__ import annotations

#: HBM3 bandwidth, bytes per second
HBM_BYTES_PER_S = 3.35e12
#: float32 outside the tensor cores, operations per second; an int32 add
#: is counted at the same rate
SCALAR_OPS_PER_S = 67e12


def least_s(nbytes: float, ops: float) -> float:
    """The least time the chip could take: the larger of the bytes over
    the bandwidth and the operations over the peak."""
    return max(nbytes / HBM_BYTES_PER_S, ops / SCALAR_OPS_PER_S)
