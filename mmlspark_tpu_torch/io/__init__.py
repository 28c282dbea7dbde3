"""Host-side I/O of the port: HTTP requests and responses as typed columns
behind a breaker- and deadline-aware client (``http``), out-of-core tiles
(``chunked``) and atomic booster snapshots (``checkpoint``), own copies of
the JAX package's jax-free modules of the same names."""
from .http import (HTTPRequestData, HTTPResponseData, HTTPClient,
                   AsyncHTTPClient, HTTPTransformer, SimpleHTTPTransformer,
                   REQUEST_BINDING, RESPONSE_BINDING)
from .checkpoint import (CheckpointManager, atomic_write, check_resume_arg,
                         snapshot_steps)
from .chunked import (ChunkedDataset, TilePrefetcher, pad_tile,
                      resolve_tile_rows)

__all__ = ["HTTPRequestData", "HTTPResponseData", "HTTPClient",
           "AsyncHTTPClient", "HTTPTransformer", "SimpleHTTPTransformer",
           "REQUEST_BINDING", "RESPONSE_BINDING",
           "CheckpointManager", "atomic_write", "check_resume_arg",
           "snapshot_steps", "ChunkedDataset", "TilePrefetcher", "pad_tile",
           "resolve_tile_rows"]
