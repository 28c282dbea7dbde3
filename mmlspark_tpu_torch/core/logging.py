"""BasicLogging equivalent — per-stage structured telemetry.

Reference: ``core/src/main/scala/com/microsoft/ml/spark/logging/
BasicLogging.scala:25-70``: every ctor/fit/transform/predict emits JSON
``{uid, className, method, buildVersion}``; errors are logged with the verb.
Here the transport is the stdlib ``logging`` module under the
``mmlspark_tpu_torch.telemetry`` logger; a ring buffer keeps recent events for tests.
"""
from __future__ import annotations

import contextlib
import json
import logging
import time
from collections import deque
from typing import Any, Dict

logger = logging.getLogger("mmlspark_tpu_torch.telemetry")

_RECENT: deque = deque(maxlen=512)


def build_version() -> str:
    from mmlspark_tpu_torch import __version__
    return __version__


def log_event(payload: Dict[str, Any]) -> None:
    _RECENT.append(payload)
    # serialize only when a debug handler will actually see it: with span
    # events riding every request, an unconditional json.dumps would tax
    # the serving hot path for output nobody receives
    if logger.isEnabledFor(logging.DEBUG):
        logger.debug(json.dumps(payload, default=str))


def recent_events():
    return list(_RECENT)


@contextlib.contextmanager
def log_verb(stage, method: str):
    """Wrap a verb (fit/transform/...) with telemetry incl. errors + wall time.

    The port has no tracing layer yet (compute-plane telemetry is a later
    slice), so a verb is an event in the ring and nothing more.
    """
    payload = {
        "uid": getattr(stage, "uid", "?"),
        "className": type(stage).__name__,
        "method": method,
        "buildVersion": build_version(),
    }
    t0 = time.perf_counter()
    try:
        yield
        payload["seconds"] = round(time.perf_counter() - t0, 6)
        log_event(payload)
    except Exception as e:
        payload["seconds"] = round(time.perf_counter() - t0, 6)
        payload["error"] = f"{type(e).__name__}: {e}"
        log_event(payload)
        raise
