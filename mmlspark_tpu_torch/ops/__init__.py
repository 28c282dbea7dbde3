"""Tensor ops of the port: histogram builds and the Hopper frontier kernels."""
