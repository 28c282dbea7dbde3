"""Resource management helpers (reference ``core/env/StreamUtilities.scala``).

An own copy of the JAX package's ``utils/streams.py``, verbatim."""
from __future__ import annotations

import contextlib
from typing import Callable, Iterable, TypeVar

T = TypeVar("T")
R = TypeVar("R")


def using(resource, fn: Callable[..., R]) -> R:
    """StreamUtilities.using: apply fn to resource, always closing it."""
    with contextlib.closing(resource) as r:
        return fn(r)


def using_many(resources: Iterable, fn: Callable[..., R]) -> R:
    resources = list(resources)
    try:
        return fn(resources)
    finally:
        for r in resources:
            with contextlib.suppress(Exception):
                r.close()
