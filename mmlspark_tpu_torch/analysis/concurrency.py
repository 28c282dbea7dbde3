"""CCY — concurrency sanitizer, the static half.

The port's twin of the JAX package's ``analysis/concurrency.py``, the same
rules; the lock factories it resolves are ``<package>.utils.concurrency``'s.

The serving plane is deeply multi-threaded (decode engine threads, watchdog
monitors, restart supervisors, checkpoint writers, prefetchers, span
flushers, federation fan-outs, drain paths) and every recent review round
caught at least one check-then-act or callback-under-lock race by hand.
This checker makes the concurrency contracts machine-checked, the same way
STG made the stage contracts machine-checked:

- **CCY001 — lock-order cycle.**  A whole-repo lock-acquisition-order graph
  is built over the scanned scope: node = a lock attribute resolved per
  class (``PipelineServer._drain_lock``) or per module
  (``collector._collector_lock``), edge = lock B acquired while A is held —
  lexically, or THROUGH a call edge (holding A and calling a function that
  acquires B).  Call edges resolve like the TRC cross-module BFS: local
  short names, ``self.`` methods, and import-table dotted targets.  Any
  cycle in the graph is a potential deadlock: two threads entering the
  cycle from different edges can block each other forever.

- **CCY002 — shared state without a lock.**  An attribute mutated both
  inside a ``threading.Thread(target=...)``/``Timer`` callback call graph
  and on a public API path, with no common lock protecting both sides, is
  a data race (the check-then-act shape every review round kept catching).

- **CCY003 — condition discipline.**  ``Condition.wait()`` outside a
  predicate loop misses wakeups (spurious wakeup / stolen predicate), and
  ``notify()`` without the condition's lock held races the very predicate
  change it is signalling.  ``wait_for`` carries its own loop and never
  fires.

- **CCY004 — thread leak.**  A started thread with no bounded ``join()``
  (or ``Timer.cancel()``) reachable from a ``close()``/``stop()``/
  ``drain()``-shaped teardown path outlives its owner: drains that "time
  out" on invisible work, interpreter-shutdown tracebacks, and chaos
  drills that cannot tell a leak from a hang.

The runtime half (``mmlspark_tpu_torch/utils/concurrency.OrderedLock``)
validates the same graph dynamically;
``ConcurrencyChecker.lock_order_edges(engine)`` exports the static edges in
the runtime registry's naming, so ``validate_lock_order(static_edges=...)``
composes both halves.
"""
from __future__ import annotations

import ast
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

from .engine import PACKAGE, AnalysisEngine, Checker, Finding, ModuleContext

__all__ = ["ConcurrencyChecker"]

#: constructor targets that make a lock-like object; the package's own
#: ``utils.concurrency`` factories are added per checker (``package=``)
_LOCK_CTORS = {"threading.Lock", "threading.RLock", "Lock", "RLock",
               "make_lock", "make_rlock", "concurrency.make_lock",
               "concurrency.make_rlock"}
_COND_CTORS = {"threading.Condition", "Condition", "make_condition",
               "concurrency.make_condition"}
_THREAD_CTORS = {"threading.Thread", "Thread"}
_TIMER_CTORS = {"threading.Timer", "Timer"}

#: teardown-shaped method names that root the CCY004 reachability walk
_STOP_NAMES = {"close", "stop", "drain", "shutdown", "cancel", "join",
               "stop_all", "terminate", "uninstall", "__exit__", "__del__",
               "abort"}

#: mutation targets CCY002 ignores: write-once identity fields assigned in
#: start()-shaped methods before the thread observes them would otherwise
#: dominate the findings (the thread handle itself, the httpd handle)
_CCY002_EXEMPT_SUFFIXES = ("_thread", "_httpd")


def _name_is_lock_like(name: str) -> bool:
    low = name.lower()
    return "lock" in low or "mutex" in low or "cond" in low


class _LockName:
    """Resolution of a lock expression to a stable graph-node name."""

    @staticmethod
    def resolve(expr: ast.AST, cls: Optional["_ClassRec"],
                module_tag: str) -> Optional[str]:
        target = expr
        if isinstance(target, ast.Call):        # with lock.acquire(...)
            target = target.func
        if isinstance(target, ast.Attribute) and \
                target.attr == "acquire":
            target = target.value
        if isinstance(target, ast.Attribute):
            owner = target.value
            if isinstance(owner, ast.Name) and owner.id in ("self", "cls") \
                    and cls is not None:
                if target.attr in cls.lock_attrs or \
                        target.attr in cls.cond_attrs or \
                        _name_is_lock_like(target.attr):
                    return f"{cls.name}.{target.attr}"
                return None
            if _name_is_lock_like(target.attr):
                # non-self attribute: deferred — finalize resolves the
                # owning class when exactly one class declares the attr
                return f"?.{target.attr}"
            return None
        if isinstance(target, ast.Name):
            if _name_is_lock_like(target.id):
                return f"{module_tag}.{target.id}"
            return None
        return None


class _FnRec:
    """Everything CCY needs to know about one function/method."""

    __slots__ = ("qualname", "cls", "name", "lineno",
                 "acquires", "edges", "held_calls", "calls", "ext_calls",
                 "attr_writes", "thread_targets", "thread_starts",
                 "joins", "cancels", "waits", "notifies", "handle_aliases")

    def __init__(self, qualname: str, cls: Optional[str], name: str,
                 lineno: int):
        self.qualname = qualname
        self.cls = cls                      # owning class name or None
        self.name = name                    # bare method/function name
        self.lineno = lineno
        #: lock names acquired lexically anywhere in this function
        self.acquires: List[Tuple[str, int]] = []
        #: (held, acquired, lineno) lexical order edges
        self.edges: List[Tuple[str, str, int]] = []
        #: (callee_key, held_names, lineno): call made while holding locks;
        #: callee_key is ("self", name) / ("local", name) / ("dotted", d)
        self.held_calls: List[Tuple[Tuple[str, str], Tuple[str, ...], int]] = []
        #: intra-module / intra-class call edges by bare name
        self.calls: Set[Tuple[str, str]] = set()   # (kind, name)
        self.ext_calls: Set[str] = set()
        #: (attr, locks_held, lineno, is_augmented_or_method_mutation)
        self.attr_writes: List[Tuple[str, FrozenSet[str], int]] = []
        #: method/function names passed as Thread target / Timer callback
        self.thread_targets: List[Tuple[str, str]] = []  # (kind, name)
        #: (handle, kind, daemon, lineno): handle = "self.X" / local name /
        #: "" for anonymous fire-and-forget
        self.thread_starts: List[Tuple[str, str, bool, int]] = []
        #: handle -> bounded? for .join(...) sites in this function
        self.joins: List[Tuple[str, bool, int]] = []
        self.cancels: Set[str] = set()
        #: (cond_name, inside_while, lineno)
        self.waits: List[Tuple[str, bool, int]] = []
        #: (cond_name, held_names, lineno)
        self.notifies: List[Tuple[str, Tuple[str, ...], int]] = []
        #: local name -> self attrs it aliases (``t = self._thread``,
        #: ``self._thread = t``, ``self._threads.append(t)``,
        #: ``for t in (self._a, self._b)``) — joins/cancels through an
        #: alias credit the attribute, and a start through an aliased
        #: local is owned by the attribute
        self.handle_aliases: Dict[str, Set[str]] = {}


class _ClassRec:
    __slots__ = ("name", "relpath", "lineno", "lock_attrs", "cond_attrs",
                 "methods", "bases")

    def __init__(self, name: str, relpath: str, lineno: int,
                 bases: Sequence[str]):
        self.name = name
        self.relpath = relpath
        self.lineno = lineno
        self.lock_attrs: Set[str] = set()
        self.cond_attrs: Set[str] = set()
        self.methods: Dict[str, _FnRec] = {}
        self.bases = list(bases)


class _ModRec:
    __slots__ = ("relpath", "tag", "classes", "functions", "imports")

    def __init__(self, relpath: str, tag: str, imports: Dict[str, str]):
        self.relpath = relpath
        self.tag = tag                      # last module path segment
        self.classes: Dict[str, _ClassRec] = {}
        self.functions: Dict[str, _FnRec] = {}   # module-level, by name
        self.imports = imports


def _call_dotted(ctx: ModuleContext, node: ast.Call) -> Optional[str]:
    return ctx.dotted_name(node.func)


class ConcurrencyChecker(Checker):
    """CCY001 lock-order cycle, CCY002 shared-state-without-lock,
    CCY003 condition discipline, CCY004 thread leak."""

    rules = {
        "CCY001": "lock-order cycle across the acquisition graph "
                  "(potential deadlock)",
        "CCY002": "attribute mutated on both a thread path and a public "
                  "path with no common lock",
        "CCY003": "Condition.wait() outside a predicate loop / notify() "
                  "without the condition's lock held",
        "CCY004": "started thread with no bounded join()/cancel() "
                  "reachable from a close()/stop()/drain() path",
    }

    def __init__(self, package: str = PACKAGE):
        factories = f"{package}.utils.concurrency"
        self._lock_ctors = _LOCK_CTORS | {f"{factories}.make_lock",
                                          f"{factories}.make_rlock"}
        self._cond_ctors = _COND_CTORS | {f"{factories}.make_condition"}
        self._mods: Dict[str, _ModRec] = {}

    def interested(self, relpath: str) -> bool:
        return True

    # ---------------------------------------------------------- collection
    def end_module(self, ctx: ModuleContext) -> None:
        tag = ctx.relpath.rsplit("/", 1)[-1]
        tag = tag[:-3] if tag.endswith(".py") else tag
        mod = _ModRec(ctx.relpath, tag, dict(ctx.imports))
        self._mods[ctx.relpath] = mod
        for node in ctx.tree.body:
            self._collect_top(node, ctx, mod)

    def _collect_top(self, node: ast.stmt, ctx: ModuleContext,
                     mod: _ModRec) -> None:
        if isinstance(node, ast.ClassDef):
            bases = []
            for b in node.bases:
                dotted = ctx.dotted_name(b)
                if dotted:
                    bases.append(dotted.split(".")[-1])
            cls = _ClassRec(node.name, ctx.relpath, node.lineno, bases)
            mod.classes[node.name] = cls
            # pre-pass: lock/cond attribute declarations anywhere in the
            # class body (usually __init__), so method walks can resolve
            for sub in ast.walk(node):
                self._collect_lock_decl(sub, ctx, cls)
            for stmt in node.body:
                if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    fn = _FnRec(f"{node.name}.{stmt.name}", node.name,
                                stmt.name, stmt.lineno)
                    cls.methods[stmt.name] = fn
                    _FnWalker(ctx, mod, cls, fn).walk_body(stmt)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            fn = _FnRec(node.name, None, node.name, node.lineno)
            mod.functions[node.name] = fn
            _FnWalker(ctx, mod, None, fn).walk_body(node)

    def _collect_lock_decl(self, node: ast.AST, ctx: ModuleContext,
                           cls: _ClassRec) -> None:
        if not (isinstance(node, ast.Assign) and
                isinstance(node.value, ast.Call)):
            return
        dotted = _call_dotted(ctx, node.value) or ""
        leaf = dotted.rsplit(".", 1)[-1]
        is_lock = dotted in self._lock_ctors or leaf in ("Lock", "RLock",
                                                    "make_lock",
                                                    "make_rlock")
        is_cond = dotted in self._cond_ctors or leaf in ("Condition",
                                                    "make_condition")
        if not (is_lock or is_cond):
            return
        for tgt in node.targets:
            if isinstance(tgt, ast.Attribute) and \
                    isinstance(tgt.value, ast.Name) and \
                    tgt.value.id == "self":
                (cls.cond_attrs if is_cond else cls.lock_attrs).add(tgt.attr)

    # ------------------------------------------------------------ finalize
    def finalize(self, engine: AnalysisEngine) -> List[Finding]:
        findings: List[Finding] = []
        resolver = _Resolver(self._mods)
        findings.extend(self._check_lock_order(resolver))
        for mod in self._mods.values():
            for cls in mod.classes.values():
                findings.extend(self._check_shared_state(mod, cls))
                findings.extend(self._check_conditions(mod, cls))
            findings.extend(self._check_thread_leaks(mod, resolver))
        return findings

    # ------------------------------------------------- CCY001: lock order
    def lock_order_edges(self, engine: Optional[AnalysisEngine] = None
                         ) -> List[Tuple[str, str]]:
        """The static acquisition-order edge set, in the runtime
        registry's node naming — feed to
        ``utils.concurrency.validate_lock_order(static_edges=...)``."""
        resolver = _Resolver(self._mods)
        return sorted({(a, b) for (a, b) in
                       self._edge_sites(resolver)})

    def _edge_sites(self, resolver: "_Resolver"
                    ) -> Dict[Tuple[str, str], Tuple[str, int, str]]:
        """(held, acquired) -> first (relpath, lineno, symbol) site,
        lexical edges plus call-propagated edges."""
        sites: Dict[Tuple[str, str], Tuple[str, int, str]] = {}
        disamb = resolver.disambiguate_lock
        # transitive acquires per function (call-graph fixpoint)
        acq: Dict[int, Set[str]] = {}
        fns = resolver.all_fns
        for key, (mod, fn) in fns.items():
            acq[key] = {disamb(a) for a, _ in fn.acquires
                        if disamb(a) is not None}
        changed = True
        while changed:
            changed = False
            for key, (mod, fn) in fns.items():
                for callee_key, _, _ in fn.held_calls:
                    tgt = resolver.resolve_call(mod, fn, callee_key)
                    if tgt is None:
                        continue
                    extra = acq.get(tgt, ())
                    if not set(extra) <= acq[key]:
                        acq[key] |= set(extra)
                        changed = True
                for kind_name in fn.calls:
                    tgt = resolver.resolve_call(mod, fn, kind_name)
                    if tgt is None:
                        continue
                    if not acq.get(tgt, set()) <= acq[key]:
                        acq[key] |= acq.get(tgt, set())
                        changed = True
        for key, (mod, fn) in fns.items():
            sym = fn.qualname
            for held, got, lineno in fn.edges:
                h, g = disamb(held), disamb(got)
                if h and g and h != g:
                    sites.setdefault((h, g), (mod.relpath, lineno, sym))
            for callee_key, held_names, lineno in fn.held_calls:
                tgt = resolver.resolve_call(mod, fn, callee_key)
                if tgt is None:
                    continue
                for h0 in held_names:
                    h = disamb(h0)
                    if h is None:
                        continue
                    for g in acq.get(tgt, ()):
                        if g != h:
                            sites.setdefault(
                                (h, g), (mod.relpath, lineno, sym))
        return sites

    def _check_lock_order(self, resolver: "_Resolver") -> List[Finding]:
        sites = self._edge_sites(resolver)
        graph: Dict[str, Set[str]] = {}
        for (a, b) in sites:
            graph.setdefault(a, set()).add(b)
        findings: List[Finding] = []
        for scc in _sccs(graph):
            # describe the cycle with its edges' first-observed sites
            cyc_edges = sorted((a, b) for (a, b) in sites
                               if a in scc and b in scc)
            detail = "; ".join(
                f"{a} -> {b} at {sites[(a, b)][0]}:{sites[(a, b)][1]}"
                for a, b in cyc_edges[:4])
            rel, lineno, sym = sites[cyc_edges[0]]
            findings.append(Finding(
                rule="CCY001", file=rel, line=lineno,
                message=f"lock-order cycle {' <-> '.join(scc)} — "
                        f"potential deadlock ({detail})",
                symbol=sym))
        return findings

    # --------------------------------------------- CCY002: shared state
    def _thread_reachable(self, cls: _ClassRec) -> Set[str]:
        """Method names reachable from this class's thread-entry points
        (targets of Thread/Timer constructions anywhere in the class)."""
        entries: Set[str] = set()
        for fn in cls.methods.values():
            for _, name in fn.thread_targets:
                if name in cls.methods:
                    entries.add(name)
        frontier = list(entries)
        while frontier:
            cur = frontier.pop()
            fn = cls.methods.get(cur)
            if fn is None:
                continue
            for kind, name in fn.calls:
                if kind == "self" and name in cls.methods \
                        and name not in entries:
                    entries.add(name)
                    frontier.append(name)
        return entries

    def _check_shared_state(self, mod: _ModRec,
                            cls: _ClassRec) -> List[Finding]:
        thread_side = self._thread_reachable(cls)
        if not thread_side:
            return []
        findings: List[Finding] = []
        #: attr -> [(method, locks, lineno, sides)]
        writes: Dict[str, List[Tuple[_FnRec, FrozenSet[str], int, str]]] = {}
        for mname, fn in cls.methods.items():
            if mname in ("__init__", "__new__"):
                continue   # construction happens-before every thread
            in_thread = mname in thread_side
            is_public = not mname.startswith("_") or mname in _STOP_NAMES
            if not (in_thread or is_public):
                continue
            side = ("thread" if in_thread else "") + \
                   ("+public" if is_public else "")
            for attr, locks, lineno in fn.attr_writes:
                if attr in cls.lock_attrs or attr in cls.cond_attrs or \
                        attr.endswith(_CCY002_EXEMPT_SUFFIXES):
                    continue
                writes.setdefault(attr, []).append((fn, locks, lineno, side))
        for attr, rows in sorted(writes.items()):
            t_rows = [r for r in rows if "thread" in r[3]]
            p_rows = [r for r in rows if "public" in r[3]]
            if not t_rows or not p_rows:
                continue
            hit = None
            for tfn, tlocks, tline, _ in t_rows:
                for pfn, plocks, pline, _ in p_rows:
                    if not (tlocks & plocks):
                        hit = (tfn, tlocks, tline, pfn, plocks, pline)
                        break
                if hit:
                    break
            if hit is None:
                continue
            tfn, tlocks, tline, pfn, plocks, pline = hit
            def _fmt(locks: FrozenSet[str]) -> str:
                return "{" + ", ".join(sorted(locks)) + "}" if locks \
                    else "no lock"
            findings.append(Finding(
                rule="CCY002", file=mod.relpath, line=pline,
                message=f"attribute '{attr}' mutated on a thread path "
                        f"({tfn.qualname}:{tline} under {_fmt(tlocks)}) "
                        f"and a public path ({pfn.qualname}:{pline} under "
                        f"{_fmt(plocks)}) with no common lock — data race",
                symbol=pfn.qualname))
        return findings

    # ---------------------------------------------- CCY003: conditions
    def _check_conditions(self, mod: _ModRec,
                          cls: _ClassRec) -> List[Finding]:
        findings: List[Finding] = []
        for fn in cls.methods.values():
            for cond, in_while, lineno in fn.waits:
                if not in_while:
                    findings.append(Finding(
                        rule="CCY003", file=mod.relpath, line=lineno,
                        message=f"{cond}.wait() outside a predicate loop "
                                "— a spurious wakeup or stolen predicate "
                                "proceeds on stale state (use `while not "
                                "pred: cond.wait()` or wait_for)",
                        symbol=fn.qualname))
            for cond, held, lineno in fn.notifies:
                if cond not in held:
                    findings.append(Finding(
                        rule="CCY003", file=mod.relpath, line=lineno,
                        message=f"{cond}.notify() without the condition's "
                                "lock held — the waiter can miss the "
                                "wakeup racing the predicate write",
                        symbol=fn.qualname))
        return findings

    # --------------------------------------------- CCY004: thread leaks
    def _stop_reachable(self, cls: _ClassRec) -> Set[str]:
        entries = {m for m in cls.methods if m in _STOP_NAMES}
        frontier = list(entries)
        while frontier:
            cur = frontier.pop()
            fn = cls.methods.get(cur)
            if fn is None:
                continue
            for kind, name in fn.calls:
                if kind == "self" and name in cls.methods \
                        and name not in entries:
                    entries.add(name)
                    frontier.append(name)
        return entries

    def _check_thread_leaks(self, mod: _ModRec,
                            resolver: "_Resolver") -> List[Finding]:
        findings: List[Finding] = []
        for cls in mod.classes.values():
            stop_side = self._stop_reachable(cls)
            # class-wide join/cancel inventory on self attributes
            attr_joined: Set[str] = set()
            attr_cancelled: Set[str] = set()
            for mname in stop_side:
                fn = cls.methods[mname]
                for handle, bounded, _ in fn.joins:
                    if handle.startswith("self.") and bounded:
                        attr_joined.add(handle[5:])
                attr_cancelled |= {h[5:] for h in fn.cancels
                                   if h.startswith("self.")}
            for fn in cls.methods.values():
                findings.extend(self._leaks_in_fn(
                    mod, fn, attr_joined, attr_cancelled))
        for fn in mod.functions.values():
            findings.extend(self._leaks_in_fn(mod, fn, set(), set()))
        return findings

    def _leaks_in_fn(self, mod: _ModRec, fn: _FnRec,
                     attr_joined: Set[str],
                     attr_cancelled: Set[str]) -> List[Finding]:
        findings: List[Finding] = []
        local_joined = {h for h, bounded, _ in fn.joins if bounded}
        for handle, kind, daemon, lineno in fn.thread_starts:
            ok = False
            if handle.startswith("self."):
                attr = handle[5:]
                ok = attr in attr_joined or \
                    (kind == "timer" and attr in attr_cancelled)
            elif handle:
                ok = handle in local_joined or \
                    (kind == "timer" and handle in fn.cancels)
                for a in fn.handle_aliases.get(handle, ()):
                    ok = ok or a in attr_joined or \
                        (kind == "timer" and a in attr_cancelled)
            if ok:
                continue
            what = "Timer" if kind == "timer" else "thread"
            where = f"{handle!r}" if handle else "anonymous handle"
            findings.append(Finding(
                rule="CCY004", file=mod.relpath, line=lineno,
                message=f"started {what} ({where}"
                        f"{', daemon' if daemon else ''}) with no bounded "
                        "join()/cancel() reachable from a close()/stop()/"
                        "drain() path — the thread outlives its owner "
                        "(invisible work during drain, shutdown "
                        "tracebacks, leaked sockets)",
                symbol=fn.qualname))
        return findings


# ---------------------------------------------------------------------------
# per-function AST walk
# ---------------------------------------------------------------------------

class _FnWalker:
    """Recursive walk of one function body tracking the lexical held-lock
    stack, while-loop depth, and local thread handles."""

    def __init__(self, ctx: ModuleContext, mod: _ModRec,
                 cls: Optional[_ClassRec], fn: _FnRec):
        self.ctx = ctx
        self.mod = mod
        self.cls = cls
        self.fn = fn
        self.held: List[str] = []
        self.while_depth = 0
        #: local name -> "thread"|"timer" for Thread()/Timer() assignments
        self.local_threads: Dict[str, str] = {}

    # -------------------------------------------------------------- utils
    def _lock_name(self, expr: ast.AST) -> Optional[str]:
        return _LockName.resolve(expr, self.cls, self.mod.tag)

    def _thread_ctor_kind(self, call: ast.Call) -> Optional[str]:
        dotted = self.ctx.dotted_name(call.func) or ""
        leaf = dotted.rsplit(".", 1)[-1]
        if dotted in _THREAD_CTORS or leaf == "Thread":
            return "thread"
        if dotted in _TIMER_CTORS or leaf == "Timer":
            return "timer"
        return None

    def _note_thread_target(self, call: ast.Call, kind: str) -> None:
        cand: List[ast.AST] = []
        for kw in call.keywords:
            if kw.arg in ("target", "function"):
                cand.append(kw.value)
        if kind == "timer" and len(call.args) >= 2:
            cand.append(call.args[1])
        for expr in cand:
            if isinstance(expr, ast.Attribute) and \
                    isinstance(expr.value, ast.Name) and \
                    expr.value.id in ("self", "cls"):
                self.fn.thread_targets.append((kind, expr.attr))
            elif isinstance(expr, ast.Name):
                self.fn.thread_targets.append((kind, expr.id))

    @staticmethod
    def _handle_of(expr: ast.AST) -> str:
        if isinstance(expr, ast.Attribute) and \
                isinstance(expr.value, ast.Name) and \
                expr.value.id == "self":
            return f"self.{expr.attr}"
        if isinstance(expr, ast.Name):
            return expr.id
        return ""

    # --------------------------------------------------------------- walk
    def walk_body(self, node: ast.AST) -> None:
        for child in ast.iter_child_nodes(node):
            self._walk(child)

    def _walk(self, node: ast.AST) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            # nested defs (thread bodies defined inline, callbacks): the
            # lexical lock stack does not cross the boundary — the nested
            # function runs later, possibly on another thread — but its
            # calls/acquires still belong to this record (the nested fn is
            # only reachable through us)
            saved_held, self.held = self.held, []
            saved_while, self.while_depth = self.while_depth, 0
            for child in ast.iter_child_nodes(node):
                self._walk(child)
            self.held, self.while_depth = saved_held, saved_while
            return
        if isinstance(node, ast.With):
            self._walk_with(node)
            return
        if isinstance(node, (ast.While, ast.For)):
            # a for-loop re-checks its iterator like a while re-checks its
            # predicate: both satisfy the wait-in-a-loop discipline
            if isinstance(node, ast.For):
                self._note_for_alias(node)
            self.while_depth += 1
            for child in ast.iter_child_nodes(node):
                self._walk(child)
            self.while_depth -= 1
            return
        if isinstance(node, (ast.Assign, ast.AugAssign)):
            self._note_assign(node)
        if isinstance(node, ast.Call):
            self._note_call(node)
        for child in ast.iter_child_nodes(node):
            self._walk(child)

    def _walk_with(self, node: ast.With) -> None:
        acquired: List[str] = []
        for item in node.items:
            name = self._lock_name(item.context_expr)
            if name is not None:
                for h in self.held:
                    if h != name:
                        self.fn.edges.append((h, name, node.lineno))
                self.fn.acquires.append((name, node.lineno))
                acquired.append(name)
            # the context expression itself may contain calls
            self._walk(item.context_expr)
            if item.optional_vars is not None:
                self._walk(item.optional_vars)
        self.held.extend(acquired)
        try:
            for stmt in node.body:
                self._walk(stmt)
        finally:
            for _ in acquired:
                self.held.pop()

    @staticmethod
    def _self_attr_of(expr: ast.AST) -> Optional[str]:
        if isinstance(expr, ast.Attribute) and \
                isinstance(expr.value, ast.Name) and \
                expr.value.id == "self":
            return expr.attr
        return None

    def _alias(self, local: str, attr: str) -> None:
        self.fn.handle_aliases.setdefault(local, set()).add(attr)

    def _note_alias_pair(self, tgt: ast.AST, value: ast.AST) -> None:
        """One (target, value) assignment pair, possibly inside a tuple
        unpack: ``t = self._thread`` and ``self._thread = t`` both tie
        the local to the attribute (the idiomatic hand-off in every
        stop(): ``thread, self._thread = self._thread, None``)."""
        attr = self._self_attr_of(value)
        if attr is not None and isinstance(tgt, ast.Name):
            self._alias(tgt.id, attr)
            return
        attr = self._self_attr_of(tgt)
        if attr is not None and isinstance(value, ast.Name) and \
                value.id in self.local_threads:
            self._alias(value.id, attr)
            self.local_threads[f"self.{attr}"] = \
                self.local_threads[value.id]

    def _note_for_alias(self, node: ast.For) -> None:
        """``for t in (self._a, self._b):`` / ``for t in self._threads:``
        — joins on the loop variable credit every attribute iterated."""
        if not isinstance(node.target, ast.Name):
            return
        items = node.iter.elts \
            if isinstance(node.iter, (ast.Tuple, ast.List)) else [node.iter]
        for item in items:
            attr = self._self_attr_of(item)
            if attr is not None:
                self._alias(node.target.id, attr)

    def _note_assign(self, node) -> None:
        targets = node.targets if isinstance(node, ast.Assign) \
            else [node.target]
        value = node.value
        # thread handle bookkeeping: self.X = Thread(...) / t = Thread(...)
        if isinstance(value, ast.Call):
            kind = self._thread_ctor_kind(value)
            if kind is not None:
                self._note_thread_target(value, kind)
                for tgt in targets:
                    handle = self._handle_of(tgt)
                    if handle and not handle.startswith("self."):
                        self.local_threads[handle] = kind
                    if handle.startswith("self.") and self.cls is not None:
                        # started separately via self.X.start()
                        self.local_threads[handle] = kind
        # alias bookkeeping, tuple unpack included
        for tgt in targets:
            if isinstance(tgt, ast.Tuple) and \
                    isinstance(value, ast.Tuple) and \
                    len(tgt.elts) == len(value.elts):
                for t_el, v_el in zip(tgt.elts, value.elts):
                    self._note_alias_pair(t_el, v_el)
            else:
                self._note_alias_pair(tgt, value)
        for tgt in targets:
            elts = tgt.elts if isinstance(tgt, ast.Tuple) else [tgt]
            for el in elts:
                attr = self._self_attr_of(el)
                if attr is not None:
                    self.fn.attr_writes.append(
                        (attr, frozenset(self.held), node.lineno))

    def _note_call(self, node: ast.Call) -> None:
        ctx = self.ctx
        func = node.func
        kind = self._thread_ctor_kind(node)
        if kind is not None:
            self._note_thread_target(node, kind)
            # anonymous Thread(...).start() has no handle to join
        dotted = ctx.dotted_name(func)
        if isinstance(func, ast.Attribute):
            attr = func.attr
            owner = func.value
            handle = self._handle_of(owner)
            if attr == "start":
                started = None
                if isinstance(owner, ast.Call):
                    k = self._thread_ctor_kind(owner)
                    if k is not None:
                        started = ("", k)
                elif handle and handle in self.local_threads:
                    started = (handle, self.local_threads[handle])
                elif handle.startswith("self.") and self.cls is not None:
                    # self.X.start(): treat as a thread start when some
                    # method assigned Thread()/Timer() to self.X
                    k = self._self_attr_thread_kind(handle[5:])
                    if k is not None:
                        started = (handle, k)
                if started is not None:
                    daemon = self._daemon_of(owner)
                    self.fn.thread_starts.append(
                        (started[0], started[1], daemon, node.lineno))
            elif attr == "join":
                bounded = bool(node.args) or \
                    any(kw.arg == "timeout" for kw in node.keywords)
                if handle:
                    self.fn.joins.append((handle, bounded, node.lineno))
                    for a in self.fn.handle_aliases.get(handle, ()):
                        self.fn.joins.append(
                            (f"self.{a}", bounded, node.lineno))
            elif attr == "cancel" and handle:
                self.fn.cancels.add(handle)
                self.fn.cancels |= {f"self.{a}" for a in
                                    self.fn.handle_aliases.get(handle, ())}
            elif attr == "append" and len(node.args) == 1 and \
                    isinstance(node.args[0], ast.Name) and \
                    node.args[0].id in self.local_threads:
                coll = self._self_attr_of(owner)
                if coll is not None:
                    # self._threads.append(t): joins iterated over the
                    # collection later credit this local's start
                    self._alias(node.args[0].id, coll)
            elif attr == "wait":
                cond = self._cond_of(owner)
                if cond is not None:
                    self.fn.waits.append(
                        (cond, self.while_depth > 0, node.lineno))
            elif attr in ("notify", "notify_all"):
                cond = self._cond_of(owner)
                if cond is not None:
                    self.fn.notifies.append(
                        (cond, tuple(self.held), node.lineno))
            elif attr == "acquire":
                name = self._lock_name(owner)
                if name is not None:
                    for h in self.held:
                        if h != name:
                            self.fn.edges.append((h, name, node.lineno))
                    self.fn.acquires.append((name, node.lineno))
            # call-graph edges
            if isinstance(owner, ast.Name) and owner.id in ("self", "cls"):
                self.fn.calls.add(("self", attr))
                if self.held:
                    self.fn.held_calls.append(
                        (("self", attr), tuple(self.held), node.lineno))
            elif dotted and "." in dotted:
                self.fn.ext_calls.add(dotted)
                self.fn.calls.add(("dotted", dotted))
                if self.held:
                    self.fn.held_calls.append(
                        (("dotted", dotted), tuple(self.held), node.lineno))
        elif isinstance(func, ast.Name):
            target = ctx.imports.get(func.id, func.id)
            if target != func.id and "." in target:
                self.fn.calls.add(("dotted", target))
                if self.held:
                    self.fn.held_calls.append(
                        (("dotted", target), tuple(self.held), node.lineno))
            else:
                self.fn.calls.add(("local", func.id))
                if self.held:
                    self.fn.held_calls.append(
                        (("local", func.id), tuple(self.held), node.lineno))

    def _self_attr_thread_kind(self, attr: str) -> Optional[str]:
        if self.cls is None:
            return None
        for m in self.cls.methods.values():
            for handle, kind, _, _ in m.thread_starts:
                if handle == f"self.{attr}":
                    return kind
        # assignment may not have been walked yet: look for the ctor
        # assignment pattern in the raw local_threads of this walker
        return self.local_threads.get(f"self.{attr}")

    @staticmethod
    def _daemon_of(expr: ast.AST) -> bool:
        if isinstance(expr, ast.Call):
            for kw in expr.keywords:
                if kw.arg == "daemon" and \
                        isinstance(kw.value, ast.Constant):
                    return bool(kw.value.value)
        return False

    def _cond_of(self, owner: ast.AST) -> Optional[str]:
        """Resolve ``X`` of ``X.wait()``/``X.notify()`` to a condition
        node name, only when X is statically known to be a Condition —
        Event.wait lookalikes must not fire."""
        if isinstance(owner, ast.Attribute) and \
                isinstance(owner.value, ast.Name) and \
                owner.value.id in ("self", "cls") and self.cls is not None:
            if owner.attr in self.cls.cond_attrs:
                return f"{self.cls.name}.{owner.attr}"
        if isinstance(owner, ast.Name) and self.cls is None:
            # module-level condition object
            return None
        return None


# ---------------------------------------------------------------------------
# cross-module resolution
# ---------------------------------------------------------------------------

class _Resolver:
    """Name resolution over every module's records: call targets (like the
    TRC BFS: self methods, module-local names, import-table dotted paths)
    and deferred ``?.attr`` lock owners (unique-declaring-class rule)."""

    def __init__(self, mods: Dict[str, _ModRec]):
        self.mods = mods
        self.all_fns: Dict[int, Tuple[_ModRec, _FnRec]] = {}
        self._fn_key: Dict[Tuple[str, str], int] = {}
        #: lock attr -> {class names declaring it}
        self._lock_owners: Dict[str, Set[str]] = {}
        #: class name -> (relpath, _ClassRec); last definition wins
        self._classes: Dict[str, Tuple[str, _ClassRec]] = {}
        self._by_dotted = {self._module_dotted(rel): rel for rel in mods}
        k = 0
        for rel, mod in mods.items():
            for fname, fn in mod.functions.items():
                self.all_fns[k] = (mod, fn)
                self._fn_key[(rel, fn.qualname)] = k
                k += 1
            for cname, cls in mod.classes.items():
                self._classes[cname] = (rel, cls)
                for attr in cls.lock_attrs | cls.cond_attrs:
                    self._lock_owners.setdefault(attr, set()).add(cname)
                for mname, fn in cls.methods.items():
                    self.all_fns[k] = (mod, fn)
                    self._fn_key[(rel, fn.qualname)] = k
                    k += 1

    @staticmethod
    def _module_dotted(relpath: str) -> str:
        path = relpath[:-3] if relpath.endswith(".py") else relpath
        if path.endswith("/__init__"):
            path = path[: -len("/__init__")]
        return path.replace("/", ".")

    def disambiguate_lock(self, name: str) -> Optional[str]:
        """``?.attr`` resolves to ``Cls.attr`` when exactly ONE scanned
        class declares a lock/cond attribute of that name; ambiguous or
        unknown owners are dropped (a merged node would invent edges
        between unrelated locks — false cycles)."""
        if not name.startswith("?."):
            return name
        attr = name[2:]
        owners = self._lock_owners.get(attr, set())
        if len(owners) == 1:
            return f"{next(iter(owners))}.{attr}"
        return None

    def resolve_call(self, mod: _ModRec, fn: _FnRec,
                     callee: Tuple[str, str]) -> Optional[int]:
        kind, name = callee
        if kind == "self" and fn.cls is not None:
            cls = mod.classes.get(fn.cls)
            hit = self._method_in_class(mod.relpath, cls, name)
            if hit is not None:
                return hit
            return None
        if kind == "local":
            if name in mod.functions:
                return self._fn_key.get((mod.relpath, name))
            dotted = mod.imports.get(name)
            if dotted and dotted != name:
                return self._resolve_dotted(dotted)
            return None
        if kind == "dotted":
            return self._resolve_dotted(name)
        return None

    def _method_in_class(self, relpath: str, cls: Optional[_ClassRec],
                         name: str) -> Optional[int]:
        seen: Set[str] = set()
        while cls is not None and cls.name not in seen:
            seen.add(cls.name)
            if name in cls.methods:
                return self._fn_key.get((relpath, f"{cls.name}.{name}"))
            # single static base resolution (bases by short name)
            nxt = None
            for b in cls.bases:
                hit = self._classes.get(b)
                if hit is not None:
                    relpath, nxt = hit
                    break
            cls = nxt
        return None

    def _resolve_dotted(self, dotted: str) -> Optional[int]:
        mod_path, _, leaf = dotted.rpartition(".")
        if not mod_path:
            return None
        for scanned, rel in self._by_dotted.items():
            if scanned == mod_path or scanned.endswith("." + mod_path):
                if leaf in self.mods[rel].functions:
                    return self._fn_key.get((rel, leaf))
        return None


def _sccs(graph: Dict[str, Set[str]]) -> List[List[str]]:
    """Non-trivial strongly connected components, each sorted — one
    CCY001 finding per cycle however many rotations it has."""
    index: Dict[str, int] = {}
    low: Dict[str, int] = {}
    on_stack: Set[str] = set()
    stack: List[str] = []
    counter = [0]
    out: List[List[str]] = []
    nodes = set(graph)
    for vs in graph.values():
        nodes |= vs
    for root in sorted(nodes):
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
                    out.append(sorted(comp))
    return out
