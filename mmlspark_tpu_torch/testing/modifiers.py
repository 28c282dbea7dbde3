"""Test modifiers — retry/flaky/time-limit decorators.

An own copy of the JAX package's ``testing/modifiers.py``, verbatim.

Reference: ``TestBase.scala`` modifiers ``tryWithRetries`` (:95 area),
``LinuxOnly`` (:60), ``Flaky`` (:65), ``TimeLimitedFlaky`` (:77) — the
reference's approximation of fault injection (SURVEY.md §5.3).
"""
from __future__ import annotations

import functools
import platform
import time
from typing import Callable, Tuple


def try_with_retries(times: Tuple[int, ...] = (0, 100, 500), exceptions=(AssertionError, Exception)):
    """Retry the wrapped callable with the given sleep schedule (ms)."""
    def deco(fn: Callable):
        @functools.wraps(fn)
        def wrapper(*a, **k):
            last = None
            for i, delay_ms in enumerate(times):
                if delay_ms:
                    time.sleep(delay_ms / 1000.0)
                try:
                    return fn(*a, **k)
                except exceptions as e:  # noqa: BLE001
                    last = e
            raise last
        return wrapper
    return deco


def flaky(retries: int = 3):
    """pytest-friendly Flaky modifier: rerun up to `retries` times."""
    return try_with_retries(times=tuple([0] + [200] * (retries - 1)))


def time_limited_flaky(seconds: float = 60.0, retries: int = 3):
    """Retry; fail if any attempt exceeds the time limit (reference
    TimeLimitedFlaky)."""
    def deco(fn: Callable):
        @functools.wraps(fn)
        def wrapper(*a, **k):
            last = None
            for _ in range(retries):
                t0 = time.perf_counter()
                try:
                    out = fn(*a, **k)
                    if time.perf_counter() - t0 > seconds:
                        raise TimeoutError(
                            f"{fn.__name__} took {time.perf_counter() - t0:.1f}s "
                            f"> {seconds}s")
                    return out
                except Exception as e:  # noqa: BLE001
                    last = e
            raise last
        return wrapper
    return deco


def linux_only(fn: Callable):
    """Skip outside Linux (reference LinuxOnly)."""
    import pytest
    return pytest.mark.skipif(platform.system() != "Linux",
                              reason="LinuxOnly")(fn)
