"""Runtime lock-order sanitizer — the dynamic half of the CCY plane.

The static CCY pass (``analysis/concurrency.py``) proves properties of the
lock-acquisition-order graph it can SEE in source; this module watches the
orders that actually happen.  Every lock the threaded modules create through
:func:`make_lock` / :func:`make_condition` becomes, in debug mode, an
:class:`OrderedLock` that records per-thread acquisition stacks into a
process-wide :class:`LockOrderRegistry`:

- acquiring B while holding A books the directed edge ``A -> B`` (with the
  acquiring site, first observation wins);
- an acquisition whose reverse edge ``B -> A`` has already been observed —
  by ANY thread, at any earlier time — is a **lock-order inversion**: the
  two orders can interleave into a deadlock even if this run got lucky.
  The violation is booked *before* the blocking acquire, so in strict mode
  the sanitizer trips where the deadlock would otherwise hang;
- :func:`validate_lock_order` additionally runs cycle detection over the
  accumulated graph, catching multi-lock cycles (A->B, B->C, C->A) no
  single acquisition pre-check pairs up — the cycles the AST cannot see
  (orders established through data flow, callbacks, or timing).

Every violation is booked to the
``mmlspark_lock_order_violations_total{kind}`` counter family and to the
event ring (``core.logging.log_event``), which the flight recorder dumps —
a violation under a chaos drill leaves a debuggable artifact even when the
process dies next.

Enabling: ``MMLSPARK_TPU_LOCK_SANITIZER=1`` (record + book violations),
``=strict`` (additionally raise :class:`LockOrderViolation` at the
offending acquire — how the tier-1 inversion drill proves the trip happens
before the hang), ``=0``/unset (off: :func:`make_lock` returns a plain
``threading.Lock`` — zero overhead in production).  The tier-1 conftest
exports ``=1`` by default so every threaded test doubles as a deadlock
drill.  Measured overhead of the wrapper: an uncontended acquire/release
pair goes from ~0.17 us to ~1.4 us (~8x relative, ~1.2 us absolute) —
noise against the batch-/IO-scale work the package holds these locks
around, and tier-1 wall time is unchanged within run-to-run variance
(see docs/STATIC_ANALYSIS.md for the measurement).

The env knob is read at LOCK CREATION time: modules built before the knob
flips keep the locks they were built with, so a long-lived server never
changes behaviour mid-flight.
"""
from __future__ import annotations

import os
import threading
import traceback
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

__all__ = ["LockOrderRegistry", "LockOrderViolation", "OrderedLock",
           "SANITIZER_ENV", "get_lock_registry", "make_condition",
           "make_lock", "make_rlock", "sanitizer_mode",
           "validate_lock_order"]

#: env knob: "" / "0" = off, "1"/"true"/"on" = record, "strict" = raise
SANITIZER_ENV = "MMLSPARK_TPU_LOCK_SANITIZER"

#: violations kept per registry (bounded: a pathological loop must not OOM
#: the process it is diagnosing); the counter family keeps exact totals
_MAX_VIOLATIONS = 256

#: acquiring-site frames kept per edge/violation (wrapper frames skipped)
_STACK_FRAMES = 3


def sanitizer_mode() -> str:
    """-> "off" | "record" | "strict" from the env knob."""
    raw = os.environ.get(SANITIZER_ENV, "").strip().lower()
    if raw in ("", "0", "false", "off", "no"):
        return "off"
    if raw == "strict":
        return "strict"
    return "record"


class LockOrderViolation(RuntimeError):
    """Raised (strict mode only) at an acquire whose order inverts an
    already-observed order — the point where the deadlock would form."""


def _site(skip: int = 3) -> List[str]:
    """Short acquiring-site stack: ``file:line in fn`` rows, innermost
    last, wrapper/registry frames skipped."""
    rows = []
    for f in traceback.extract_stack()[:-skip][-_STACK_FRAMES:]:
        rows.append(f"{f.filename.rsplit(os.sep, 1)[-1]}:{f.lineno} "
                    f"in {f.name}")
    return rows


class _Violation:
    __slots__ = ("kind", "chain", "thread", "stack", "message")

    def __init__(self, kind: str, chain: Sequence[str], thread: str,
                 stack: Sequence[str], message: str):
        self.kind = kind          # "inversion" | "cycle"
        self.chain = list(chain)  # the locks in conflict, in order
        self.thread = thread
        self.stack = list(stack)
        self.message = message

    def as_dict(self) -> Dict[str, object]:
        return {"kind": self.kind, "chain": self.chain,
                "thread": self.thread, "stack": self.stack,
                "message": self.message}

    def __repr__(self) -> str:  # pragma: no cover - diagnostics only
        return f"<LockOrder {self.kind} {' -> '.join(self.chain)}>"


class LockOrderRegistry:
    """Process-wide observed-order graph + per-thread held-lock stacks.

    One default instance backs :func:`make_lock`; tests that deliberately
    invert orders construct their own so the global tier-1 registry stays
    clean (the suite asserts zero violations on it).
    """

    def __init__(self, strict: Optional[bool] = None,
                 book: bool = True):
        self._strict = strict
        self._book = book
        self._mu = threading.Lock()   # guards the graph; never held while
        #                               booking or raising (no I/O under it)
        #: (holder, acquired) -> first-observed acquiring site
        self._edges: Dict[Tuple[str, str], Dict[str, object]] = {}
        self._violations: List[_Violation] = []
        self._total = 0
        #: per-thread dedup: a (pair) booked once per thread, not per call
        self._tls = threading.local()

    # ------------------------------------------------------------ per-thread
    def _stack(self) -> List[str]:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def _reported(self) -> Set[frozenset]:
        rep = getattr(self._tls, "reported", None)
        if rep is None:
            rep = self._tls.reported = set()
        return rep

    def held(self) -> List[str]:
        """Lock names held by the calling thread, outermost first."""
        return list(self._stack())

    # --------------------------------------------------------------- events
    def note_acquiring(self, name: str) -> None:
        """Pre-acquire check: books (and in strict mode raises) on an
        inversion BEFORE the caller blocks on the inner lock — the drill
        trips where the deadlock would otherwise hang."""
        held = self._stack()
        if not held or name in held:   # re-entrant RLock hold: no new edge
            return
        inverted: List[Tuple[str, Dict[str, object]]] = []
        with self._mu:
            for h in held:
                rev = self._edges.get((name, h))
                if rev is not None:
                    inverted.append((h, rev))
        for h, rev in inverted:
            pair = frozenset((h, name))
            if pair in self._reported():
                continue               # once per (pair, thread)
            self._reported().add(pair)
            v = _Violation(
                kind="inversion", chain=[h, name],
                thread=threading.current_thread().name, stack=_site(),
                message=(
                    f"lock-order inversion: acquiring {name!r} while "
                    f"holding {h!r}, but the opposite order "
                    f"{name!r} -> {h!r} was observed at "
                    f"{rev.get('stack', ['?'])[-1]} "
                    f"(thread {rev.get('thread', '?')}) — the two "
                    "interleavings deadlock"))
            self._record(v)
            strict = self._strict if self._strict is not None \
                else sanitizer_mode() == "strict"
            if strict:
                raise LockOrderViolation(v.message)

    def note_acquired(self, name: str) -> None:
        """Post-acquire: push the hold and book the order edges."""
        held = self._stack()
        if held and name not in held:
            site = None
            with self._mu:
                for h in held:
                    if (h, name) not in self._edges:
                        if site is None:
                            site = {
                                "stack": _site(),
                                "thread": threading.current_thread().name,
                            }
                        self._edges[(h, name)] = site
        held.append(name)

    def note_released(self, name: str) -> None:
        """Pop the (most recent) hold of ``name`` — releases may legally
        happen out of LIFO order (Condition.wait releases mid-block)."""
        held = self._stack()
        for i in range(len(held) - 1, -1, -1):
            if held[i] == name:
                del held[i]
                return

    # ------------------------------------------------------------- booking
    def _record(self, v: _Violation) -> None:
        with self._mu:
            self._total += 1
            if len(self._violations) < _MAX_VIOLATIONS:
                self._violations.append(v)
        if not self._book:
            return
        # lazy, guarded imports: utils must stay importable without the
        # observability plane, and booking must never mask the violation
        try:
            from ..observability.metrics import get_registry
            get_registry().counter(
                "mmlspark_lock_order_violations_total",
                "lock-order sanitizer violations by kind "
                "(inversion = pre-acquire pair trip, cycle = "
                "validate_lock_order graph cycle)",
                labels=("kind",)).inc(kind=v.kind)
        except Exception:  # noqa: BLE001 — diagnostics never take the path down
            pass
        try:
            from ..core.logging import log_event
            log_event({"event": "lock_order_violation", **v.as_dict()})
        except Exception:  # noqa: BLE001
            pass

    # ------------------------------------------------------------ inspection
    def edges(self) -> Dict[Tuple[str, str], Dict[str, object]]:
        with self._mu:
            return dict(self._edges)

    def violations(self) -> List[_Violation]:
        with self._mu:
            return list(self._violations)

    @property
    def total_violations(self) -> int:
        with self._mu:
            return self._total

    def validate(self, static_edges: Optional[Sequence[Tuple[str, str]]]
                 = None) -> List[_Violation]:
        """Cycle-check the observed graph (optionally merged with the
        static CCY001 edge set) and return NEW violations found.

        A cycle here means a set of locks whose observed acquisition
        orders cannot be serialized — a deadlock waiting for the right
        interleaving.  Pair inversions are already booked at acquire time;
        this pass catches the longer cycles (and the static x dynamic
        composites neither half sees alone)."""
        with self._mu:
            graph: Dict[str, Set[str]] = {}
            for (a, b) in self._edges:
                graph.setdefault(a, set()).add(b)
        for (a, b) in static_edges or ():
            graph.setdefault(a, set()).add(b)
        new: List[_Violation] = []
        for cycle in _find_cycles(graph):
            v = _Violation(
                kind="cycle", chain=cycle,
                thread=threading.current_thread().name, stack=_site(skip=2),
                message="lock-order cycle over observed acquisitions: "
                        + " -> ".join(cycle + cycle[:1]))
            self._record(v)
            new.append(v)
        return new


def _find_cycles(graph: Dict[str, Set[str]]) -> List[List[str]]:
    """Elementary cycles via SCC decomposition (iterative Tarjan): every
    non-trivial SCC is reported once, as its sorted member list — stable
    output for tests and dedup, without enumerating each rotation."""
    index: Dict[str, int] = {}
    low: Dict[str, int] = {}
    on_stack: Set[str] = set()
    stack: List[str] = []
    counter = [0]
    sccs: List[List[str]] = []

    for root in sorted(graph):
        if root in index:
            continue
        work = [(root, iter(sorted(graph.get(root, ()))))]
        index[root] = low[root] = counter[0]
        counter[0] += 1
        stack.append(root)
        on_stack.add(root)
        while work:
            node, it = work[-1]
            advanced = False
            for nxt in it:
                if nxt not in index:
                    index[nxt] = low[nxt] = counter[0]
                    counter[0] += 1
                    stack.append(nxt)
                    on_stack.add(nxt)
                    work.append((nxt, iter(sorted(graph.get(nxt, ())))))
                    advanced = True
                    break
                if nxt in on_stack:
                    low[node] = min(low[node], index[nxt])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])
            if low[node] == index[node]:
                comp = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    comp.append(w)
                    if w == node:
                        break
                if len(comp) > 1:
                    sccs.append(sorted(comp))
    return sccs


class OrderedLock:
    """Drop-in ``threading.Lock``/``RLock`` wrapper that reports every
    acquire/release to a :class:`LockOrderRegistry` under a stable NAME
    (the identity the order graph speaks — ``"Owner._attr"`` by
    convention, matching the static CCY node naming)."""

    __slots__ = ("name", "_inner", "_registry")

    def __init__(self, name: str, registry: LockOrderRegistry,
                 reentrant: bool = False):
        self.name = name
        self._inner = threading.RLock() if reentrant else threading.Lock()
        self._registry = registry

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        self._registry.note_acquiring(self.name)
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            self._registry.note_acquired(self.name)
        return ok

    def release(self) -> None:
        self._inner.release()
        self._registry.note_released(self.name)

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:  # pragma: no cover - diagnostics only
        return f"<OrderedLock {self.name} {self._inner!r}>"


_default_registry: Optional[LockOrderRegistry] = None
_default_registry_mu = threading.Lock()


def get_lock_registry() -> LockOrderRegistry:
    """The process-wide registry behind :func:`make_lock` (created on
    first use; strictness re-read from the env at each violation so a
    test can flip record->strict without rebuilding every lock)."""
    global _default_registry
    reg = _default_registry
    if reg is None:
        with _default_registry_mu:
            if _default_registry is None:
                _default_registry = LockOrderRegistry(strict=None)
            reg = _default_registry
    return reg


def make_lock(name: str,
              registry: Optional[LockOrderRegistry] = None):
    """A lock for ``with``/acquire/release use.  Sanitizer off: a plain
    ``threading.Lock`` (zero overhead).  On: an :class:`OrderedLock`
    reporting under ``name``."""
    if sanitizer_mode() == "off" and registry is None:
        return threading.Lock()
    return OrderedLock(name, registry or get_lock_registry())


def make_rlock(name: str,
               registry: Optional[LockOrderRegistry] = None):
    """Re-entrant variant of :func:`make_lock`."""
    if sanitizer_mode() == "off" and registry is None:
        return threading.RLock()
    return OrderedLock(name, registry or get_lock_registry(),
                       reentrant=True)


def make_condition(name: str,
                   registry: Optional[LockOrderRegistry] = None
                   ) -> threading.Condition:
    """A ``threading.Condition`` whose underlying lock is sanitized: the
    wait-time release/re-acquire cycles show up in the order graph exactly
    as they happen (a wait drops the hold; waking re-books it against
    whatever else the thread then holds)."""
    return threading.Condition(make_lock(name, registry))


def validate_lock_order(static_edges: Optional[Sequence[Tuple[str, str]]]
                        = None) -> List[_Violation]:
    """Cycle-check the default registry's observed graph (merged with an
    optional static edge set — pass the CCY001 graph to compose the two
    halves) and return newly found violations.  Call at drain/test
    teardown: an empty return means every observed order serializes."""
    return get_lock_registry().validate(static_edges)
