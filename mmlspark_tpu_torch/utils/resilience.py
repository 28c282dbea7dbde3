"""Resilience primitives — circuit breakers, deadlines, budget-aware retries.

An own copy of the JAX package's ``utils/resilience.py``, verbatim apart
from module paths: the serving front (breakers, retry budgets), the
continuous decode engine (the stall ``Watchdog`` and the
``RestartSupervisor`` behind its supervised rebuilds), the tile
prefetcher (deadlines, ``is_transient_io``) and the training drivers
(preemption) all use it.

Grown out of ``utils/fault.py`` (reference:
``core/utils/FaultToleranceUtils.scala`` ``retryWithTimeout`` guarding
native/network init, and the exponential-backoff loop in
``TrainUtils.networkInit``).  The MMLSpark papers frame serving and the
cognitive layer as production web services; this module supplies the failure
machinery those boundaries need:

- ``CircuitBreaker`` — closed/open/half-open with a rolling failure window,
  so a dead dependency is rejected fast instead of timing out per call;
- ``Deadline`` — a request budget carried via contextvar from admission
  through batch scoring, HTTP fan-out, and retries, so no retry loop ever
  overshoots what the caller is still willing to wait for;
- budget-aware ``with_retries`` / ``retry_with_timeout`` (the fault.py
  originals, now deadline-clipped);
- ``Watchdog`` — arm/heartbeat stall detection around device dispatches
  that can hang forever (a wedged device runtime), so a *slow* failure is
  surfaced and recovered like a crash instead of wedging a worker;
- ``RetryBudget`` — token-bucket bound on retry amplification, so a full
  outage degrades to sheds instead of a fleet-wide retry storm.

Every primitive takes an injectable ``clock`` (and ``sleep`` where it
waits), so tests drive all state transitions deterministically — no
wall-clock sleeps, no flakes.
"""
from __future__ import annotations

import collections
import concurrent.futures
import signal as _signal
import threading
import time
from contextlib import contextmanager
from contextvars import ContextVar
from typing import Callable, Deque, Optional, Tuple, Type, TypeVar

T = TypeVar("T")


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
# circuit breaker
# ---------------------------------------------------------------------------

class CircuitOpenError(ConnectionError):
    """Raised (or mapped to a synthetic 503) when the breaker rejects a call
    without attempting it."""

    def __init__(self, name: str, retry_after_s: float):
        self.retry_after_s = max(0.0, retry_after_s)
        super().__init__(
            f"circuit breaker {name or '<anon>'} is open; "
            f"retry after {self.retry_after_s:.1f}s")


class CircuitBreaker:
    """Classic three-state breaker over a rolling failure window.

    - ``closed``: calls flow; failures older than ``window_s`` are forgotten;
      ``failure_threshold`` failures inside the window trip it open.
    - ``open``: every call is rejected until ``cooldown_s`` has elapsed.
    - ``half_open``: up to ``half_open_max_calls`` probe calls are admitted;
      one success closes the breaker (window cleared), one failure reopens it
      (cooldown restarts).

    All transitions run on the injectable ``clock``, so tests step them
    deterministically.  Thread-safe; shared freely across client instances
    guarding the same dependency.

    Observability: ``add_listener(fn)`` registers a transition callback
    ``fn(breaker, old_state, new_state)`` (fired outside the lock —
    ``observability.instruments.instrument_breaker`` turns it into
    counters/gauges), and ``failure_rate()`` reports failures/outcomes over
    the rolling window (successes are sampled into a bounded deque so the
    hot path stays O(1); under extreme QPS the rate is approximate).
    """

    _OUTCOME_CAP = 4096  # per-deque bound on the rolling-rate samples

    def __init__(self, failure_threshold: int = 5, window_s: float = 30.0,
                 cooldown_s: float = 10.0, half_open_max_calls: int = 1,
                 clock: Callable[[], float] = time.monotonic, name: str = ""):
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        self.failure_threshold = failure_threshold
        self.window_s = float(window_s)
        self.cooldown_s = float(cooldown_s)
        self.half_open_max_calls = max(1, half_open_max_calls)
        self.clock = clock
        self.name = name
        self._lock = threading.Lock()
        self._failures: Deque[float] = collections.deque()
        self._state = "closed"
        self._opened_at = 0.0
        self._half_open_inflight = 0
        # observability counters (aggregated into serving /stats)
        self.rejected = 0
        self.opened_count = 0
        self.consecutive_failures = 0
        # rolling failure-rate window: tripping clears _failures (state
        # machine bookkeeping), so the rate keeps its own timestamp deques
        self._rate_failures: Deque[float] = \
            collections.deque(maxlen=self._OUTCOME_CAP)
        self._rate_successes: Deque[float] = \
            collections.deque(maxlen=self._OUTCOME_CAP)
        self._listeners: list = []
        self._pending_notifications: list = []

    # ------------------------------------------------------------- queries
    @property
    def state(self) -> str:
        with self._lock:
            self._maybe_half_open()
            state = self._state
        self._notify()
        return state

    def retry_after_s(self) -> float:
        """Seconds until an open breaker will admit a probe (0 if not open)."""
        with self._lock:
            if self._state != "open":
                return 0.0
            return max(0.0, self._opened_at + self.cooldown_s - self.clock())

    def failure_rate(self) -> float:
        """failures / (failures + successes) recorded inside ``window_s``
        (0.0 with no outcomes in the window)."""
        now = self.clock()
        with self._lock:
            for dq in (self._rate_failures, self._rate_successes):
                while dq and now - dq[0] > self.window_s:
                    dq.popleft()
            f, s = len(self._rate_failures), len(self._rate_successes)
        return f / (f + s) if f + s else 0.0

    def add_listener(self, fn: Callable[["CircuitBreaker", str, str], None]
                     ) -> None:
        """Register fn(breaker, old_state, new_state); fired outside the
        lock after every state transition."""
        self._listeners.append(fn)

    def remove_listener(self, fn) -> None:
        """Detach a listener previously registered with ``add_listener``
        (no-op if absent) — re-instrumenting a breaker must not leave the
        old listener double-counting transitions."""
        try:
            self._listeners.remove(fn)
        except ValueError:
            pass

    def _transition(self, new_state: str) -> None:
        # caller holds the lock; notification drains after release
        if self._state != new_state:
            self._pending_notifications.append((self._state, new_state))
            self._state = new_state

    def _notify(self) -> None:
        # drain transitions recorded under the lock; listeners run unlocked
        # so they may freely query the breaker.  Each item is popped under
        # the lock — concurrent drainers must not race check-then-pop.
        while True:
            with self._lock:
                if not self._pending_notifications:
                    return
                old, new = self._pending_notifications.pop(0)
            for fn in self._listeners:
                try:
                    fn(self, old, new)
                except Exception:  # noqa: BLE001 — telemetry must not break
                    pass

    def _maybe_half_open(self) -> None:
        # caller holds the lock
        if self._state == "open" and \
                self.clock() - self._opened_at >= self.cooldown_s:
            self._transition("half_open")
            self._half_open_inflight = 0

    # ------------------------------------------------------------- protocol
    def allow(self) -> bool:
        """Admission check; half-open admits a bounded number of probes.
        Callers that take an admission MUST report the outcome via
        ``record_success``/``record_failure`` (or use ``call``)."""
        try:
            with self._lock:
                self._maybe_half_open()
                if self._state == "closed":
                    return True
                if self._state == "half_open":
                    if self._half_open_inflight < self.half_open_max_calls:
                        self._half_open_inflight += 1
                        return True
                self.rejected += 1
                return False
        finally:
            self._notify()

    def record_success(self) -> None:
        with self._lock:
            self._rate_successes.append(self.clock())
            self.consecutive_failures = 0
            if self._state == "half_open" and self._half_open_inflight > 0:
                # an allow()-admitted probe succeeded: close, start fresh.
                # The inflight check matters: a state read may have flipped
                # open->half_open lazily, and a straggler success from a
                # pre-trip call must not close the breaker then — only a
                # call that actually took a probe slot is evidence.
                self._transition("closed")
                self._failures.clear()
                self._half_open_inflight = 0
            # closed: successes do NOT clear the window — a dependency
            # failing half its calls must still trip; old failures age out
            # of the rolling window on their own.  OPEN stays open (even
            # past cooldown): a straggler success from a call admitted
            # before the trip must neither cancel the cooldown nor close
            # the breaker without an allow()-admitted half-open probe.
        self._notify()

    def record_failure(self) -> None:
        with self._lock:
            now = self.clock()
            self._rate_failures.append(now)
            self.consecutive_failures += 1
            if self._state == "half_open":
                self._trip(now)
            else:
                self._failures.append(now)
                while self._failures and now - self._failures[0] > self.window_s:
                    self._failures.popleft()
                if self._state == "closed" and \
                        len(self._failures) >= self.failure_threshold:
                    self._trip(now)
        self._notify()

    def _trip(self, now: float) -> None:
        # caller holds the lock
        self._transition("open")
        self._opened_at = now
        self._failures.clear()
        self._half_open_inflight = 0
        self.opened_count += 1

    def call(self, fn: Callable[[], T]) -> T:
        """Run fn under the breaker: rejected-fast when open, outcome
        recorded otherwise.  Exceptions from fn count as failures and
        propagate."""
        if not self.allow():
            raise CircuitOpenError(self.name, self.retry_after_s())
        try:
            result = fn()
        except Exception:
            self.record_failure()
            raise
        self.record_success()
        return result

    def as_dict(self) -> dict:
        rate = self.failure_rate()  # prunes + computes outside the state lock
        with self._lock:
            return {"state": self._state,
                    "failures_in_window": len(self._failures),
                    "consecutive_failures": self.consecutive_failures,
                    "failure_rate": round(rate, 4),
                    "rejected": self.rejected, "opened_count": self.opened_count}


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


# ---------------------------------------------------------------------------
# budget-aware retries (the fault.py originals, deadline-clipped)
# ---------------------------------------------------------------------------

def retry_with_timeout(fn: Callable[[], T], timeout_s: float,
                       retries: int = 3,
                       deadline: Optional[Deadline] = None) -> T:
    """Run fn with a wall-clock timeout, retrying on timeout or error.
    Honors the ambient ``deadline_scope`` (or an explicit ``deadline``):
    each attempt's timeout is clipped to the remaining budget and no attempt
    starts once the budget is gone."""
    deadline = deadline or current_deadline()
    last: Exception = RuntimeError("no attempts made")
    for _ in range(max(1, retries)):
        attempt_timeout = timeout_s
        if deadline is not None:
            if deadline.expired():
                raise DeadlineExceeded(
                    f"budget exhausted before attempt; last: {last}")
            attempt_timeout = deadline.clip(timeout_s)
        ex = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        fut = ex.submit(fn)
        try:
            return fut.result(timeout=attempt_timeout)
        except concurrent.futures.TimeoutError:
            last = TimeoutError(f"operation exceeded {attempt_timeout}s")
        except Exception as e:  # noqa: BLE001 — retried, re-raised at end
            last = e
        finally:
            # wait=False so a hung fn doesn't block the caller past timeout_s;
            # the worker thread is daemonic-ish leaked but control returns.
            ex.shutdown(wait=False)
    raise last


# ---------------------------------------------------------------------------
# dispatch hang watchdog
# ---------------------------------------------------------------------------

class Watchdog:
    """Stall detector for device dispatches that can hang forever.

    The thread doing the dispatch cannot observe its own hang — it is stuck
    inside the blocked call — so detection is split: the *working* thread
    brackets each potentially-hanging section with :meth:`arm` /
    :meth:`disarm` (or the :meth:`section` context manager) and may
    :meth:`heartbeat` mid-section to restart the clock; a *monitor* (either
    the daemon thread from :meth:`start`, or a test calling :meth:`check`
    directly on a :class:`FakeClock`) observes an armed section exceeding
    ``stall_timeout_s`` and fires ``on_stall(label, elapsed_s)`` exactly
    once per armed section (re-arming resets the latch).

    ``on_stall`` runs on the monitor thread, outside the watchdog lock, and
    must therefore be safe to run concurrently with the stalled worker —
    the decode-engine integration uses it to poison-abort the engine, which
    is exactly a cross-thread teardown.  A raising callback is swallowed:
    the detector must keep detecting.
    """

    def __init__(self, stall_timeout_s: float,
                 clock: Callable[[], float] = time.monotonic,
                 on_stall: Optional[Callable[[str, float], None]] = None,
                 name: str = ""):
        if stall_timeout_s <= 0:
            raise ValueError("stall_timeout_s must be > 0")
        self.stall_timeout_s = float(stall_timeout_s)
        self.clock = clock
        self.on_stall = on_stall
        self.name = name
        self._lock = threading.Lock()
        self._armed_at: Optional[float] = None
        self._label = ""
        self._generation = 0       # bumped per arm(); the trip latch key
        self._tripped_generation = -1
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.trips = 0             # sections that exceeded the timeout

    # ---------------------------------------------------------- worker side
    def arm(self, label: str = "dispatch") -> None:
        """Mark the start of a section that may hang.  Resets the
        once-per-section trip latch."""
        with self._lock:
            self._armed_at = self.clock()
            self._label = str(label)
            self._generation += 1

    def heartbeat(self) -> None:
        """Restart the stall clock without ending the section (a decode
        loop that made progress mid-section).  No-op when disarmed."""
        with self._lock:
            if self._armed_at is not None:
                self._armed_at = self.clock()

    def disarm(self) -> None:
        """Mark the end of the section — the dispatch returned."""
        with self._lock:
            self._armed_at = None

    @contextmanager
    def section(self, label: str = "dispatch"):
        self.arm(label)
        try:
            yield self
        finally:
            self.disarm()

    # --------------------------------------------------------- monitor side
    def stalled_for(self) -> float:
        """Seconds the current armed section has run (0.0 when disarmed)."""
        with self._lock:
            if self._armed_at is None:
                return 0.0
            return max(0.0, self.clock() - self._armed_at)

    def expired(self) -> bool:
        return self.stalled_for() > self.stall_timeout_s

    def check(self) -> bool:
        """One monitor poll: True when the armed section has overrun
        ``stall_timeout_s``.  Fires ``on_stall`` the FIRST time an armed
        section is seen overrun; later polls of the same section return
        True without re-firing."""
        with self._lock:
            if self._armed_at is None:
                return False
            elapsed = self.clock() - self._armed_at
            if elapsed <= self.stall_timeout_s:
                return False
            already = self._tripped_generation == self._generation
            if not already:
                self._tripped_generation = self._generation
                self.trips += 1
            label = self._label
        if not already and self.on_stall is not None:
            try:
                self.on_stall(label, elapsed)
            except Exception:  # noqa: BLE001 — detector must keep detecting
                pass
        return True

    def start(self, poll_interval_s: Optional[float] = None) -> "Watchdog":
        """Start the daemon monitor thread (idempotent).  Polls at
        ``poll_interval_s`` (default: a quarter of the stall timeout,
        floored at 10ms) using real ``time.sleep`` — tests on a FakeClock
        skip the thread and call :meth:`check` directly."""
        with self._lock:
            if self._thread is not None:
                return self
            self._stop.clear()
            interval = poll_interval_s if poll_interval_s is not None \
                else max(0.01, self.stall_timeout_s / 4.0)
            thread = threading.Thread(
                target=self._monitor, args=(float(interval),),
                name=f"mmlspark-watchdog-{self.name or 'anon'}", daemon=True)
            self._thread = thread
        thread.start()
        return self

    def stop(self) -> None:
        with self._lock:
            thread, self._thread = self._thread, None
        self._stop.set()
        # an on_stall callback tearing its engine down reaches stop() ON
        # the monitor thread itself — it cannot join itself; the set event
        # ends the loop at the next poll
        if thread is not None and thread is not threading.current_thread():
            thread.join(timeout=5.0)

    def _monitor(self, interval: float) -> None:
        while not self._stop.wait(interval):
            self.check()

    def as_dict(self) -> dict:
        with self._lock:
            armed = self._armed_at is not None
            label = self._label if armed else ""
        return {"armed": armed, "label": label, "trips": self.trips,
                "stall_timeout_s": self.stall_timeout_s}


# ---------------------------------------------------------------------------
# retry budget
# ---------------------------------------------------------------------------

class RetryBudget:
    """Token bucket bounding retry amplification fleet-wide.

    Every FIRST attempt deposits ``ratio`` tokens; every retry must
    withdraw a whole token or be denied.  Under a full outage the math is
    the invariant: attempted exchanges <= (1 + ratio) * offered + initial
    — retries can never amplify offered load into a storm, no matter how
    many clients fail over at once.  ``initial`` (default: ``cap``) is the
    cold-start burst: a freshly built client can still fail over its first
    few requests before any deposits accrue; pass ``initial=0.0`` to prove
    the asymptotic bound exactly.

    Thread-safe; ``granted``/``denied`` counters are the observability
    surface (`RoutingClient` mirrors them into
    ``mmlspark_retry_budget_{granted,denied}_total``).
    """

    def __init__(self, ratio: float = 0.1, cap: float = 100.0,
                 initial: Optional[float] = None):
        if ratio < 0:
            raise ValueError("ratio must be >= 0")
        if cap <= 0:
            raise ValueError("cap must be > 0")
        self.ratio = float(ratio)
        self.cap = float(cap)
        self._tokens = self.cap if initial is None \
            else min(self.cap, max(0.0, float(initial)))
        self._lock = threading.Lock()
        self.granted = 0
        self.denied = 0

    def deposit(self) -> None:
        """Book one first-try request: the bucket earns ``ratio`` tokens."""
        with self._lock:
            self._tokens = min(self.cap, self._tokens + self.ratio)

    def try_withdraw(self) -> bool:
        """Spend one whole token for a retry; False (denied) when the
        bucket holds less than one.  The epsilon absorbs float summation
        of repeated ``ratio`` deposits (10 x 0.1 sums below 1.0), so the
        documented "1/ratio offered requests earn one retry" holds
        exactly."""
        with self._lock:
            if self._tokens >= 1.0 - 1e-9:
                self._tokens = max(0.0, self._tokens - 1.0)
                self.granted += 1
                return True
            self.denied += 1
            return False

    def tokens(self) -> float:
        with self._lock:
            return self._tokens

    def as_dict(self) -> dict:
        with self._lock:
            return {"tokens": round(self._tokens, 4), "ratio": self.ratio,
                    "cap": self.cap, "granted": self.granted,
                    "denied": self.denied}


class RestartSupervisor:
    """Supervised-restart policy for a crash/stall-prone engine.

    The owner reports each engine death via :meth:`note_failure(reason)`;
    the supervisor gates the rebuild behind capped exponential backoff
    (:meth:`retry_after_s` > 0 while backing off) and QUARANTINES after
    ``quarantine_stalls`` stall-deaths inside ``quarantine_window_s`` — a
    runner stalling over and over is wedged hardware or a dead relay, and
    the right move is to flip health unhealthy so the fleet's probes evict
    the worker, not to burn restarts forever.

    The consecutive-failure count (the backoff exponent) resets once the
    engine stays up longer than ``quarantine_window_s`` past the last
    death, or explicitly via :meth:`note_success` (a clean close).
    Quarantine never lifts on its own — the worker is replaced, not
    healed.  Injectable clock; thread-safe.
    """

    def __init__(self, initial_backoff_s: float = 0.5,
                 backoff_cap_s: float = 30.0, quarantine_stalls: int = 3,
                 quarantine_window_s: float = 300.0,
                 clock: Callable[[], float] = time.monotonic):
        self.initial_backoff_s = float(initial_backoff_s)
        self.backoff_cap_s = float(backoff_cap_s)
        self.quarantine_stalls = max(1, int(quarantine_stalls))
        self.quarantine_window_s = float(quarantine_window_s)
        self.clock = clock
        self._lock = threading.Lock()
        self._stalls: Deque[float] = collections.deque()
        self._consecutive = 0
        self._last_failure_at: Optional[float] = None
        self._not_before: Optional[float] = None
        self.quarantined = False
        self.failures = 0
        self.restarts = 0

    def note_failure(self, reason: str = "error") -> float:
        """Record one engine death; returns the backoff applied to the
        next rebuild.  ``reason == "stall"`` feeds the quarantine window."""
        with self._lock:
            now = self.clock()
            if self._last_failure_at is not None and \
                    now - self._last_failure_at > self.quarantine_window_s:
                self._consecutive = 0
            self._last_failure_at = now
            self.failures += 1
            self._consecutive += 1
            backoff = min(self.backoff_cap_s,
                          self.initial_backoff_s
                          * (2.0 ** (self._consecutive - 1)))
            self._not_before = now + backoff
            if reason == "stall":
                self._stalls.append(now)
                while self._stalls and \
                        now - self._stalls[0] > self.quarantine_window_s:
                    self._stalls.popleft()
                if len(self._stalls) >= self.quarantine_stalls:
                    self.quarantined = True
            return backoff

    def retry_after_s(self) -> float:
        """Seconds until a rebuild is admissible: 0.0 = go now;
        ``backoff_cap_s`` forever while quarantined (the header-friendly
        stand-in for never — the worker is being evicted)."""
        with self._lock:
            if self.quarantined:
                return self.backoff_cap_s
            if self._not_before is None:
                return 0.0
            return max(0.0, self._not_before - self.clock())

    def note_restart(self) -> None:
        """A supervised rebuild actually happened (observability)."""
        with self._lock:
            self.restarts += 1

    def note_success(self) -> None:
        """The engine proved healthy (clean close, sustained uptime): the
        backoff exponent resets.  Quarantine does NOT lift — see class
        docstring."""
        with self._lock:
            self._consecutive = 0
            self._not_before = None

    def as_dict(self) -> dict:
        with self._lock:
            return {"quarantined": self.quarantined,
                    "failures": self.failures, "restarts": self.restarts,
                    "consecutive": self._consecutive,
                    "stalls_in_window": len(self._stalls)}


def with_retries(fn: Callable[[], T], retries: int = 3,
                 initial_delay_s: float = 0.1, backoff: float = 2.0,
                 exceptions: Tuple[Type[BaseException], ...] = (Exception,),
                 deadline: Optional[Deadline] = None,
                 sleep: Callable[[float], None] = time.sleep) -> T:
    """Exponential-backoff retry (reference networkInit retry pattern),
    clipped to the ambient/explicit deadline: backoff sleeps never overshoot
    the remaining budget, and once the budget is spent the last error is
    raised instead of burning further attempts."""
    retries = max(1, retries)
    deadline = deadline or current_deadline()
    delay = initial_delay_s
    for attempt in range(retries):
        if deadline is not None and deadline.expired():
            raise DeadlineExceeded("budget exhausted before attempt")
        try:
            return fn()
        except exceptions:
            if attempt == retries - 1:
                raise
            if deadline is not None:
                remaining = deadline.remaining()
                if remaining <= 0:
                    raise
                sleep(min(delay, remaining))
            else:
                sleep(delay)
            delay *= backoff
