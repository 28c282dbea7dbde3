"""Observability of the port.  So far only ``metrics`` (the registry with
Counter/Gauge/Histogram families), an own copy of the JAX package's
jax-free module; spans, the compute plane and the training monitor are
still to be ported (ROADMAP.md §1 item 13)."""
