"""Constants (reference ``LightGBMConstants.scala``).

An own copy of the JAX package's ``lightgbm/constants.py``, verbatim.

Most of the reference's constants govern its socket rendezvous (ports,
retries, timeouts) which the mesh bootstrap replaces; the training-semantics
constants survive with the same names.
"""

DEFAULT_LISTEN_TIMEOUT_S = 600.0      # reference DefaultListenTimeout
NETWORK_RETRIES = 3                   # reference NetworkRetries (mesh init retry)
INITIAL_DELAY_MS = 100
DEFAULT_LOCAL_LISTEN_PORT = 12400     # kept for API parity; unused on mesh
MAX_PORT = 65535

DATA_PARALLEL = "data_parallel"
VOTING_PARALLEL = "voting_parallel"
FEATURE_PARALLEL = "feature_parallel"
SERIAL = "serial"

IGNORE_STATUS = "ignore"              # driver rendezvous line protocol tokens
FINISHED_STATUS = "finished"          # (bootstrap-era; documented for parity)
