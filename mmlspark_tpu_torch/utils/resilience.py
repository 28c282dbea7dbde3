"""Resilience primitives the port's data plane and drivers need: deadlines,
transient-vs-fatal I/O classification and preemption-aware shutdown.

An own copy of the JAX package's ``utils/resilience.py``, verbatim apart
from module paths, holding only the parts the port calls: ``FakeClock``,
``Deadline`` with ``current_deadline``/``deadline_scope`` (the tile
prefetcher's retries clip to the ambient deadline), ``is_transient_io``
(the prefetcher's retry classification) and ``PreemptionToken``,
``preemption_scope`` and ``request_preemption`` with their hooks (the
training drivers' checkpoint-and-exit).  The circuit breaker, watchdog
and retry budgets are not copied: nothing in the port calls them yet.

Every primitive takes an injectable ``clock`` (and ``sleep`` where it
waits), so tests drive all state transitions deterministically — no
wall-clock sleeps, no flakes.
"""
from __future__ import annotations

import signal as _signal
import threading
import time
from contextlib import contextmanager
from contextvars import ContextVar
from typing import Callable, Optional, Tuple, Type


# ---------------------------------------------------------------------------
# clocks
# ---------------------------------------------------------------------------

class FakeClock:
    """Deterministic manual clock for tests: ``now()``/``__call__`` read the
    time, ``sleep``/``advance`` move it.  Thread-safe so server threads and
    the test driver can share one instance."""

    def __init__(self, start: float = 0.0):
        self._t = float(start)
        self._lock = threading.Lock()

    def __call__(self) -> float:
        with self._lock:
            return self._t

    now = __call__

    def sleep(self, seconds: float) -> None:
        with self._lock:
            self._t += max(0.0, float(seconds))

    advance = sleep


# ---------------------------------------------------------------------------
# deadlines
# ---------------------------------------------------------------------------

class DeadlineExceeded(TimeoutError):
    """The caller's remaining budget reached zero."""


class Deadline:
    """An absolute point (on an injectable monotonic clock) after which work
    on behalf of this request is pointless.  Carried through call stacks via
    ``deadline_scope`` so retries/timeouts anywhere below clip themselves to
    ``remaining()`` instead of their own configured maxima."""

    __slots__ = ("expires_at", "clock")

    def __init__(self, expires_at: float, clock: Callable[[], float] = time.monotonic):
        self.expires_at = float(expires_at)
        self.clock = clock

    @classmethod
    def after(cls, seconds: float,
              clock: Callable[[], float] = time.monotonic) -> "Deadline":
        return cls(clock() + float(seconds), clock)

    def remaining(self) -> float:
        return self.expires_at - self.clock()

    def expired(self) -> bool:
        return self.remaining() <= 0.0

    def clip(self, timeout_s: float) -> float:
        """A timeout that never overshoots the remaining budget (>= 0)."""
        return max(0.0, min(float(timeout_s), self.remaining()))

    def check(self) -> None:
        if self.expired():
            raise DeadlineExceeded(f"deadline overdue by {-self.remaining():.3f}s")

    # wire format: remaining budget in milliseconds (relative, so it survives
    # hosts with unsynchronized clocks — the receiver re-anchors on arrival)
    HEADER = "X-MMLSpark-Deadline-Ms"

    def to_header(self) -> str:
        return str(max(0, int(self.remaining() * 1000)))

    @staticmethod
    def parse_budget_s(value) -> Optional[float]:
        """Header value -> remaining budget in seconds (None if malformed).
        The single parser for the wire format — servers clipping a raw float
        budget and ``from_header`` both go through it."""
        try:
            return max(0.0, float(value)) / 1000.0
        except (TypeError, ValueError):
            return None

    @classmethod
    def from_header(cls, value: str,
                    clock: Callable[[], float] = time.monotonic) -> "Deadline":
        budget = cls.parse_budget_s(value)
        if budget is None:
            raise ValueError(f"malformed {cls.HEADER} value: {value!r}")
        return cls.after(budget, clock)

    def __repr__(self):
        return f"Deadline(remaining={self.remaining():.3f}s)"


_current_deadline: ContextVar[Optional[Deadline]] = \
    ContextVar("mmlspark_tpu_torch_deadline", default=None)


def current_deadline() -> Optional[Deadline]:
    """The innermost active deadline in this context, or None."""
    return _current_deadline.get()


@contextmanager
def deadline_scope(deadline_or_seconds,
                   clock: Callable[[], float] = time.monotonic):
    """Install a deadline for the duration of the block.  Nested scopes keep
    the TIGHTER bound — a caller's budget can only shrink downstream."""
    if isinstance(deadline_or_seconds, Deadline):
        d = deadline_or_seconds
    else:
        d = Deadline.after(float(deadline_or_seconds), clock)
    outer = _current_deadline.get()
    if outer is not None and outer.expires_at < d.expires_at \
            and outer.clock is d.clock:
        d = outer
    token = _current_deadline.set(d)
    try:
        yield d
    finally:
        _current_deadline.reset(token)


# ---------------------------------------------------------------------------
# transient-vs-fatal classification for data-plane I/O
# ---------------------------------------------------------------------------

#: failure shapes a retry can plausibly outwait: flaky storage/NFS, a
#: wedged device relay, a reset transfer.  ``OSError`` is deliberately in —
#: EIO/EAGAIN from a shared filesystem is the canonical transient — with
#: the *specifically hopeless* OSErrors carved out below.
TRANSIENT_IO_ERRORS: Tuple[Type[BaseException], ...] = (
    ConnectionError, TimeoutError, InterruptedError, OSError)

#: failure shapes a retry can never fix: the path/permissions are wrong,
#: not the weather.  Checked FIRST (they are OSError subclasses).
FATAL_IO_ERRORS: Tuple[Type[BaseException], ...] = (
    FileNotFoundError, PermissionError, IsADirectoryError,
    NotADirectoryError)


def is_transient_io(exc: BaseException) -> bool:
    """Transient-vs-fatal classification for load/transfer failures
    (prefetch retry): fatal subclasses win over the transient
    families; anything outside both (TypeError, ValueError, ...) is a
    bug, not weather — fatal."""
    if isinstance(exc, FATAL_IO_ERRORS):
        return False
    return isinstance(exc, TRANSIENT_IO_ERRORS)


# ---------------------------------------------------------------------------
# preemption-aware shutdown
# ---------------------------------------------------------------------------

class PreemptionToken:
    """Cooperative shutdown flag set by SIGTERM/SIGINT inside a
    :func:`preemption_scope` — or programmatically via
    :func:`request_preemption` (a fleet-membership watcher observing a
    shrink).  Training loops poll :attr:`requested` at
    iteration boundaries: a set token means "write a final checkpoint and
    return cleanly" — the preempted worker resumes instead of restarting.
    ``armed`` is False when the scope could not install handlers (not the
    main thread); signals then never fire it, but programmatic requests
    still do.  ``reason`` records what fired it (``"signal"`` or the
    string a programmatic requester passed)."""

    __slots__ = ("requested", "signum", "count", "armed", "reason")

    def __init__(self, armed: bool = False):
        self.requested = False
        self.signum: Optional[int] = None
        self.count = 0
        self.armed = armed
        self.reason: Optional[str] = None

    def fire(self, signum: int) -> None:
        self.requested = True
        self.signum = signum
        self.reason = "signal"
        self.count += 1

    def fire_event(self, reason: str) -> None:
        """Programmatic preemption (no signal): membership shrink,
        operator drain, test harness."""
        self.requested = True
        self.reason = str(reason)
        self.count += 1


#: tokens of every entered preemption_scope, innermost last — the target
#: set of request_preemption().  Guarded by _TOKEN_LOCK; scopes push on
#: entry and pop on exit even when signal installation degraded, so a
#: membership watcher can preempt a loop running off the main thread.
_TOKEN_STACK: list = []
_TOKEN_LOCK = threading.Lock()

#: observers fired once per preemption event (signal landing in a scope,
#: or a programmatic request that reached at least one token) — the
#: flight recorder registers here so a preempted process dumps
#: its black box BEFORE the final checkpoint-and-exit.  Guarded by
#: _TOKEN_LOCK for registration; fired from a snapshot outside it.
_PREEMPTION_HOOKS: list = []


def register_preemption_hook(fn) -> None:
    """Register ``fn(reason)`` to run on every preemption event.  A
    raising hook is swallowed — observers must never break the shutdown
    path they observe.  Idempotent per callable."""
    with _TOKEN_LOCK:
        if fn not in _PREEMPTION_HOOKS:
            _PREEMPTION_HOOKS.append(fn)


def unregister_preemption_hook(fn) -> None:
    with _TOKEN_LOCK:
        try:
            _PREEMPTION_HOOKS.remove(fn)
        except ValueError:
            pass


def _fire_preemption_hooks(reason: str) -> None:
    with _TOKEN_LOCK:
        hooks = list(_PREEMPTION_HOOKS)
    for fn in hooks:
        try:
            fn(reason)
        except Exception:  # noqa: BLE001 — see register_preemption_hook
            pass


def request_preemption(reason: str = "requested") -> int:
    """Fire every active :class:`preemption_scope` token programmatically
    — the non-signal preemption path: a fleet-membership
    watcher that sees the training fleet shrink calls this so the loop
    checkpoints and exits instead of riding a dead collective.  Returns
    the number of tokens fired; books one ``preemption_requested`` ring
    event when any was."""
    with _TOKEN_LOCK:
        tokens = list(_TOKEN_STACK)
    for token in tokens:
        token.fire_event(reason)
    if tokens:
        from ..core.logging import log_event
        log_event({"event": "preemption_requested", "reason": str(reason)})
        # observers (flight recorder) AFTER the ring event so the dump's
        # ring tail includes the preemption it is recording
        _fire_preemption_hooks(str(reason))
    return len(tokens)


@contextmanager
def preemption_scope(signals: Tuple[int, ...] = None, watcher=None):
    """Install SIGTERM/SIGINT handlers for the duration of a training
    loop, yielding a :class:`PreemptionToken`.

    First signal: sets the token (and books a ``preemption_requested``
    ring event) — the loop finishes the current iteration, checkpoints,
    and exits cleanly.  A SECOND SIGINT falls through to the previous
    handler (normally ``KeyboardInterrupt``): a user hammering ctrl-C
    still gets the hard stop.  Handlers are restored on exit.  Off the
    main thread signal installation is impossible; the scope degrades to
    an inert (``armed=False``) token rather than failing the run — the
    token still fires via :func:`request_preemption`, which reaches
    every active scope (the stack makes an OUTER watcher preempt an
    inner driver loop's token).

    ``watcher`` is an optional membership watcher — anything
    with ``start()``/``stop()`` (e.g. ``serving.distributed.
    MembershipWatcher``, whose default on-shrink action is
    ``request_preemption``): started on entry, stopped on exit, so a
    fleet shrink triggers checkpoint-and-exit instead of a collective
    that hangs on dead peers."""
    if signals is None:
        signals = (_signal.SIGTERM, _signal.SIGINT)
    token = PreemptionToken()
    previous = {}
    try:
        for signum in signals:
            def _handler(sn, frame, _token=token, _signals=signals):
                if _token.signum is not None and sn == _signal.SIGINT:
                    # second ctrl-C: the user wants a hard stop, not
                    # patience.  Gate on signum (a prior REAL signal),
                    # not requested — a programmatic fire_event (e.g. a
                    # membership-shrink request_preemption) sets
                    # requested too, and the FIRST ctrl-C after it must
                    # still take the graceful path, not interrupt the
                    # final checkpoint.  Chain to the previous handler,
                    # honouring
                    # SIG_DFL (reinstall + re-raise so the default
                    # terminate semantics apply) and SIG_IGN
                    prev = previous.get(sn)
                    if callable(prev):
                        prev(sn, frame)
                    elif prev == _signal.SIG_DFL:
                        _signal.signal(sn, prev)
                        _signal.raise_signal(sn)
                    return
                _token.fire(sn)
                from ..core.logging import log_event
                log_event({"event": "preemption_requested",
                           "signal": int(sn)})
                # flight-recorder dump while the process is still whole:
                # the handler runs on the main thread at a bytecode
                # boundary, so file I/O here is ordinary code, and hooks
                # swallow their own failures
                _fire_preemption_hooks(f"signal:{int(sn)}")
            previous[signum] = _signal.signal(signum, _handler)
        token.armed = True
    except ValueError:
        # not the main thread: nothing was actually installed (the FIRST
        # signal() call is what raises there), so there is nothing to
        # restore — degrade to an inert token
        previous = {}
    with _TOKEN_LOCK:
        _TOKEN_STACK.append(token)
    try:
        # watcher start INSIDE the try: a start() that raises must still
        # restore the handlers and pop the token, or the process keeps
        # hijacked signals and a dead stack entry forever
        if watcher is not None:
            watcher.start()
        yield token
    finally:
        if watcher is not None:
            try:
                watcher.stop()
            except Exception:  # noqa: BLE001 — teardown must not mask
                pass
        with _TOKEN_LOCK:
            try:
                _TOKEN_STACK.remove(token)
            except ValueError:
                pass
        for signum, prev in previous.items():
            try:
                _signal.signal(signum, prev)
            except ValueError:
                pass
