"""Host-side I/O of the port: HTTP requests and responses as typed columns
behind a breaker- and deadline-aware client (``http``) with its parsers
(``parsers``), out-of-core tiles (``chunked``), atomic booster snapshots
(``checkpoint``), directories of files and images as frames (``binary``,
``image``), CSV ingest through the native parser (``csv``), audio pull
streams and log-mel features (``audio``), the PowerBI writer, process-wide
singletons and SSH port forwarding — own copies of the JAX package's
jax-free modules of the same names."""
from .http import (HTTPRequestData, HTTPResponseData, HTTPClient,
                   AsyncHTTPClient, HTTPTransformer, SimpleHTTPTransformer,
                   REQUEST_BINDING, RESPONSE_BINDING)
from .binary import read_binary_files, list_files, BinaryFileStream
from .checkpoint import (CheckpointManager, atomic_write, check_resume_arg,
                         snapshot_steps)
from .chunked import (ChunkedDataset, TilePrefetcher, pad_tile,
                      resolve_tile_rows)
from .image import read_images, decode_image, images_to_bytes_column
from . import powerbi

__all__ = ["HTTPRequestData", "HTTPResponseData", "HTTPClient",
           "AsyncHTTPClient", "HTTPTransformer", "SimpleHTTPTransformer",
           "REQUEST_BINDING", "RESPONSE_BINDING", "read_binary_files",
           "BinaryFileStream", "list_files", "read_images", "decode_image",
           "images_to_bytes_column", "powerbi",
           "CheckpointManager", "atomic_write", "check_resume_arg",
           "snapshot_steps", "ChunkedDataset", "TilePrefetcher", "pad_tile",
           "resolve_tile_rows"]
