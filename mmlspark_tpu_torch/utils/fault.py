"""Fault tolerance — compatibility facade over ``utils/resilience.py``.

An own copy of the JAX package's ``utils/fault.py``, verbatim apart from
module paths.

The original 49-line retry/timeout wrappers (reference:
``core/utils/FaultToleranceUtils.scala`` ``retryWithTimeout`` at
``TrainUtils.scala:339`` / ``VowpalWabbitBase.scala:347``, and the
exponential-backoff loop in ``TrainUtils.networkInit``,
``TrainUtils.scala:279-295``) grew into the full resilience subsystem —
circuit breakers, deadline propagation, budget-aware retries.  Existing
imports of ``utils.fault`` keep working; new code should import from
``mmlspark_tpu_torch.utils.resilience`` directly.
"""
from .resilience import (CircuitBreaker, CircuitOpenError, Deadline,
                         DeadlineExceeded, FakeClock, current_deadline,
                         deadline_scope, retry_with_timeout, with_retries)

__all__ = ["retry_with_timeout", "with_retries", "CircuitBreaker",
           "CircuitOpenError", "Deadline", "DeadlineExceeded", "FakeClock",
           "current_deadline", "deadline_scope"]
