from .cluster import ClusterUtil
from .concurrency import (LockOrderRegistry, LockOrderViolation, OrderedLock,
                          make_condition, make_lock, make_rlock,
                          sanitizer_mode, validate_lock_order)
from .stopwatch import StopWatch
from .resilience import (CircuitBreaker, CircuitOpenError, Deadline,
                         DeadlineExceeded, FakeClock, current_deadline,
                         deadline_scope, retry_with_timeout, with_retries)
from .streams import using

__all__ = ["ClusterUtil", "StopWatch", "retry_with_timeout", "with_retries",
           "using", "CircuitBreaker", "CircuitOpenError", "Deadline",
           "DeadlineExceeded", "FakeClock", "current_deadline",
           "deadline_scope", "LockOrderRegistry", "LockOrderViolation",
           "OrderedLock", "make_condition", "make_lock", "make_rlock",
           "sanitizer_mode", "validate_lock_order"]
