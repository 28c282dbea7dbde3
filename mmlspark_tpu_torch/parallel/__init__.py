"""Parallelism of the port.  So far only the single-device half of
``parallel/ring_attention.py`` (``blockwise_attention``); the mesh,
sharding, the trainer and ring/sequence/pipeline parallel wait for
ROADMAP.md §1 item 10."""
