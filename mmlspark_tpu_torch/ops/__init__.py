"""Tensor ops of the port: histogram builds and the Hopper frontier kernels,
and the NHWC image ops (``ops.image``)."""
