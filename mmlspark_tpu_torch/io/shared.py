"""Shared per-process lazy singletons.

An own copy of the JAX package's ``io/shared.py``, verbatim apart from
module paths.

Reference: ``io/http/SharedVariable.scala:18,:37`` — lazily-constructed
objects shared across tasks in one executor JVM (used for non-serializable
state captured in closures: clients, native handles, servers).  Here the
scope is the executor process.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, Generic, Optional, TypeVar

T = TypeVar("T")


class SharedVariable(Generic[T]):
    """Lazily constructed, process-shared value."""

    def __init__(self, factory: Callable[[], T]):
        self._factory = factory
        self._lock = threading.Lock()
        self._value: Optional[T] = None
        self._built = False

    def get(self) -> T:
        if not self._built:
            with self._lock:
                if not self._built:
                    self._value = self._factory()
                    self._built = True
        return self._value


class SharedSingleton:
    """Keyed process-wide singletons (reference SharedSingleton:37 keyed by
    constructor; used by LightGBM SharedState per executor)."""

    _instances: Dict[str, SharedVariable] = {}
    _lock = threading.Lock()

    @classmethod
    def get_or_create(cls, key: str, factory: Callable[[], T]) -> T:
        with cls._lock:
            if key not in cls._instances:
                cls._instances[key] = SharedVariable(factory)
        return cls._instances[key].get()

    @classmethod
    def reset(cls) -> None:
        with cls._lock:
            cls._instances.clear()
