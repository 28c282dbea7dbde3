"""graft-lint checkers: TRC tracer safety, RES resilience coverage,
LCK lock discipline, HOT hot-path hygiene, CMP transfer discipline.

The port's twin of the JAX package's ``analysis/checkers.py``: the same rule
ids with the same meanings.  RES, LCK and HOT keep the reference's logic,
with every allow-list and exclusion spelled through ``package=``.  TRC and
CMP name torch's own tracing roots and host->device call shapes; see
``RULES.md`` beside this module for the catalog.
"""
from __future__ import annotations

import ast
import re
from typing import Dict, Iterable, List, Optional, Set, Tuple

from .engine import PACKAGE, Checker, Finding, ModuleContext, with_lock_items

__all__ = ["TracerSafetyChecker", "ResilienceCoverageChecker",
           "UndeadlinedRetryChecker", "CheckpointAtomicityChecker",
           "LockDisciplineChecker", "HotPathChecker",
           "TransferDisciplineChecker", "UnboundedBlockingChecker"]


# ---------------------------------------------------------------------------
# TRC — tracer safety
# ---------------------------------------------------------------------------

#: callables whose function argument torch traces or captures.  A host call
#: inside is either frozen into the captured graph (a CUDA graph replays the
#: kernels recorded at capture: a clock read or an RNG draw becomes a
#: constant), refused outright (a sync while a stream captures is an error;
#: TorchScript rejects the call) or a graph break and recompile under
#: ``torch.compile`` — every TRC rule applies
_TRACE_ROOTS = {
    "torch.compile",
    "torch.jit.script", "torch.jit.trace",
    "torch.cuda.make_graphed_callables",
    "torch.fx.symbolic_trace",
    # the port's compiled-program layer: a CUDA graph captured per
    # signature on the card (observability/compute.py)
    "instrumented_jit", "compute.instrumented_jit",
    "observability.compute.instrumented_jit",
    "mmlspark_tpu_torch.observability.compute.instrumented_jit",
    "InstrumentedJit", "compute.InstrumentedJit",
    "observability.compute.InstrumentedJit",
    "mmlspark_tpu_torch.observability.compute.InstrumentedJit",
    # its unbooked twin of a plain jax.jit, captured the same way
    "captured", "compute.captured", "observability.compute.captured",
    "mmlspark_tpu_torch.observability.compute.captured",
}

#: transforms that call their function on batched or gradient-tracking
#: wrappers: host code runs on every call as usual, but a host sync on a
#: wrapped tensor raises — TRC004 only
_BATCH_ROOTS = {"torch.vmap", "torch.func.vmap", "torch.func.grad"}

#: context managers whose ``with`` body is captured into a CUDA graph
_CAPTURE_BLOCKS = {"torch.cuda.graph", "torch.cuda.graphs.graph"}

_TRACE, _BATCH = "trace", "batch"

#: host-side calls that must never run under a tracer
_TRC_BANNED_PREFIXES = {
    "time.time": "reads the host clock (a constant in a captured graph)",
    "time.monotonic": "reads the host clock (a constant in a captured "
                      "graph)",
    "time.perf_counter": "reads the host clock (a constant in a captured "
                         "graph)",
    "datetime.datetime.now": "reads the host clock (a constant in a "
                             "captured graph)",
    "numpy.random": "host RNG (a constant in a captured graph; draw on the "
                    "device from a torch.Generator)",
    "uuid": "host entropy (a constant in a captured graph)",
    "os.urandom": "host entropy syscall (a constant in a captured graph)",
    "random.random": "host RNG (a constant in a captured graph)",
    "random.randint": "host RNG (a constant in a captured graph)",
    "threading.Lock": "host lock under a tracer",
    "threading.RLock": "host lock under a tracer",
}

#: tensor methods that copy device data to the host
_HOST_SYNC_METHODS = ("item", "tolist", "cpu", "numpy")


def _dotted_prefix_hit(dotted: str, table: Dict[str, str]) -> Optional[Tuple[str, str]]:
    for prefix, why in table.items():
        if dotted == prefix or dotted.startswith(prefix + "."):
            return prefix, why
    return None


def _param_names(node: Optional[ast.AST]) -> Set[str]:
    if node is None:
        return set()
    args = node.args
    return {a.arg for a in args.posonlyargs + args.args + args.kwonlyargs}


class _FnInfo:
    __slots__ = ("node", "qualname", "calls", "ext_calls", "banned",
                 "param_names")

    def __init__(self, node: ast.AST, qualname: str, param_names: Set[str]):
        #: the def, or the ``with torch.cuda.graph(...)`` block it stands for
        self.node = node
        self.qualname = qualname
        #: local names this function calls (intra-module edges)
        self.calls: Set[str] = set()
        #: dotted call targets resolved through the import table — the
        #: cross-module edge candidates (``transformer.decode_step``)
        self.ext_calls: Set[str] = set()
        #: (node, rule, message) banned sites found inside this function
        self.banned: List[Tuple[ast.AST, str, str]] = []
        self.param_names = param_names


class _ModRecord:
    """One scanned module's TRC state, held until the cross-module pass."""

    __slots__ = ("functions", "roots", "ext_roots", "imports")

    def __init__(self, functions, roots, ext_roots, imports):
        self.functions: Dict[str, _FnInfo] = functions
        #: (local name, root kind) and (dotted target, root kind)
        self.roots: Set[Tuple[str, str]] = roots
        self.ext_roots: Set[Tuple[str, str]] = ext_roots
        self.imports: Dict[str, str] = imports


def _module_dotted(relpath: str) -> str:
    """``mmlspark_tpu_torch/models/transformer.py`` -> the dotted module
    path the import table speaks (``__init__.py`` collapses to its
    package)."""
    path = relpath[:-3] if relpath.endswith(".py") else relpath
    if path.endswith("/__init__"):
        path = path[: -len("/__init__")]
    return path.replace("/", ".")


class TracerSafetyChecker(Checker):
    """TRC — code that torch traces or captures must stay traceable: no
    host clocks/RNG/entropy, no print, no locks, no host syncs
    (``.item()``/``.tolist()``/``.cpu()``/``.numpy()``, ``float()``/
    ``int()``/``bool()`` of a tensor argument).

    Roots are functions decorated with (or passed to) ``torch.compile``,
    ``torch.jit.script``/``trace``, ``torch.cuda.make_graphed_callables``,
    ``torch.fx.symbolic_trace`` or the port's ``instrumented_jit``/
    ``InstrumentedJit`` (``observability/compute.py``: a CUDA graph
    captured per signature on the card, as the reference roots its
    ``jax.jit`` wrapper), and the body of every ``with
    torch.cuda.graph(...)`` block.  ``torch.vmap``/``torch.func.vmap``/
    ``torch.func.grad`` root TRC004 only: their functions run as ordinary
    host code on every call, so a clock or a print is harmless there, but
    a host sync on a batched tensor raises.

    ``instrumented_call``/``InstrumentedCall``, the same booking around a
    call that is never captured (the ``parallel/`` steps, whose gloo
    collectives run host code), is not a root.  The reference's Pallas
    roots have no counterpart: the port's kernels are CUDA C++ launched
    through ``ctypes``.

    Reachability is cross-module over the scanned scope: roots include
    imported functions, resolved through each module's import table, and
    edges are calls by name, local or through an import.
    """

    rules = {
        "TRC001": "host clock/RNG/entropy call inside traced code",
        "TRC002": "print() inside traced code",
        "TRC003": "lock acquisition inside traced code",
        "TRC004": "host sync (.item()/.tolist()/.cpu()/.numpy(), or "
                  "float()/int()/bool() of a traced arg) inside traced code",
    }

    SCOPE_DIRS = ("parallel/", "ops/", "models/", "lightgbm/")
    #: the port's own package only: the directories whose programs it
    #: captures beyond the reference's scope (the reference runs them as
    #: plain ``jax.jit``), so the checkers run on the JAX package keep its
    #: findings
    PORT_SCOPE_DIRS = ("featurize/", "vw/", "cognitive/", "explainers/")

    def __init__(self):
        #: relpath -> _ModRecord, consumed by the finalize cross-module BFS
        self._records: Dict[str, _ModRecord] = {}

    def interested(self, relpath: str) -> bool:
        path = f"/{relpath}"
        return any(f"/{d}" in path for d in self.SCOPE_DIRS) or any(
            f"/{PACKAGE}/{d}" in path for d in self.PORT_SCOPE_DIRS)

    def begin_module(self, ctx: ModuleContext) -> None:
        ctx._trc_functions: Dict[str, _FnInfo] = {}
        ctx._trc_roots: Set[Tuple[str, str]] = set()
        ctx._trc_ext_roots: Set[Tuple[str, str]] = set()

    # ------------------------------------------------------------- helpers
    @staticmethod
    def _root_kind(dotted: Optional[str]) -> Optional[str]:
        if dotted in _TRACE_ROOTS:
            return _TRACE
        if dotted in _BATCH_ROOTS:
            return _BATCH
        return None

    def _tracing_call_kind(self, node: ast.Call,
                           ctx: ModuleContext) -> Optional[str]:
        dotted = ctx.dotted_name(node.func)
        # functools.partial(torch.compile, ...) used as a decorator factory
        if dotted in ("functools.partial", "partial") and node.args:
            return self._root_kind(ctx.dotted_name(node.args[0]))
        return self._root_kind(dotted)

    def _mark_function_args(self, args: Iterable[ast.AST], kind: str,
                            ctx: ModuleContext) -> None:
        """Names passed into a tracing entry point become roots — local
        short names AND, when the name resolves through the import table,
        the dotted target in its defining module (cross-module roots)."""
        for arg in args:
            if isinstance(arg, ast.Name):
                ctx._trc_roots.add((arg.id, kind))
                dotted = ctx.imports.get(arg.id)
                if dotted and dotted != arg.id:
                    ctx._trc_ext_roots.add((dotted, kind))
            elif isinstance(arg, ast.Attribute):
                # self._step / cls.step — root by attribute name; an
                # imported-module attribute (transformer.decode_step) also
                # roots the target module's function
                ctx._trc_roots.add((arg.attr, kind))
                dotted = ctx.dotted_name(arg)
                if dotted and "." in dotted:
                    ctx._trc_ext_roots.add((dotted, kind))
            elif isinstance(arg, (ast.Tuple, ast.List)):
                # make_graphed_callables((fn_a, fn_b), samples)
                self._mark_function_args(arg.elts, kind, ctx)
            elif isinstance(arg, ast.Call) and ctx.dotted_name(arg.func) in \
                    ("functools.partial", "partial"):
                # torch.compile(partial(step, cfg)) — the partial's
                # function argument is what gets traced
                self._mark_function_args(arg.args, kind, ctx)

    # ------------------------------------------------------------- events
    def visit(self, node: ast.AST, ctx: ModuleContext) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            qn = (ctx.scope_qualname() + "." if ctx.scope_stack else "") \
                + node.name
            # last short-name definition wins; module-local resolution
            ctx._trc_functions[node.name] = _FnInfo(node, qn,
                                                    _param_names(node))
            for dec in node.decorator_list:
                dec_target = dec.func if isinstance(dec, ast.Call) else dec
                kind = self._root_kind(ctx.dotted_name(dec_target))
                if kind is None and isinstance(dec, ast.Call):
                    kind = self._tracing_call_kind(dec, ctx)
                if kind is not None:
                    ctx._trc_roots.add((node.name, kind))
            return
        if isinstance(node, ast.Call):
            kind = self._tracing_call_kind(node, ctx)
            if kind is not None:
                # torch.compile(f) / make_graphed_callables((f,), ...) at
                # ANY scope roots its function arguments, including
                # module-level `step = torch.compile(fn)`
                self._mark_function_args(
                    list(node.args) + [kw.value for kw in node.keywords],
                    kind, ctx)
                return
        fn = self._enclosing(ctx)
        if fn is not None:
            self._note(node, ctx, fn)

    def _note(self, node: ast.AST, ctx: ModuleContext, fn: _FnInfo) -> None:
        """Book ``node``'s banned calls and call edges on ``fn``."""
        if isinstance(node, ast.With):
            if with_lock_items(node):
                fn.banned.append((node, "TRC003",
                                  "lock held inside traced code"))
            return
        if not isinstance(node, ast.Call):
            return
        dotted = ctx.dotted_name(node.func)
        if dotted is not None:
            hit = _dotted_prefix_hit(dotted, _TRC_BANNED_PREFIXES)
            if hit is not None:
                fn.banned.append((node, "TRC001",
                                  f"{dotted}() — {hit[1]}"))
                return
            if dotted == "print":
                fn.banned.append((node, "TRC002",
                                  "print() runs at trace/capture time only "
                                  "(a graph break under torch.compile)"))
                return
            if dotted in ("float", "int", "bool") and node.args and \
                    isinstance(node.args[0], ast.Name) and \
                    node.args[0].id in fn.param_names:
                fn.banned.append((
                    node, "TRC004",
                    f"{dotted}({node.args[0].id}) copies a traced tensor "
                    "argument to the host (a sync: refused under CUDA-graph "
                    "capture, an error under vmap/grad)"))
                return
        if isinstance(node.func, ast.Attribute):
            if node.func.attr in _HOST_SYNC_METHODS and not node.args:
                fn.banned.append((
                    node, "TRC004",
                    f".{node.func.attr}() forces a device->host sync "
                    "(refused under CUDA-graph capture, a graph break under "
                    "torch.compile, an error under vmap/grad)"))
            elif node.func.attr == "acquire":
                fn.banned.append((node, "TRC003",
                                  "lock.acquire() inside traced code"))
            elif isinstance(node.func.value, ast.Name):
                fn.calls.add(node.func.attr)  # self.method / mod.func edge
                if dotted and "." in dotted:
                    fn.ext_calls.add(dotted)  # imported-module call edge
        elif isinstance(node.func, ast.Name):
            fn.calls.add(node.func.id)
            imported = ctx.imports.get(node.func.id)
            if imported and imported != node.func.id:
                fn.ext_calls.add(imported)  # from-imported call edge

    def _enclosing(self, ctx: ModuleContext) -> Optional[_FnInfo]:
        fnode = ctx.enclosing_function()
        if fnode is None:
            return None
        for info in ctx._trc_functions.values():
            if info.node is fnode:
                return info
        return None

    def end_module(self, ctx: ModuleContext) -> None:
        self._find_captures(ctx.tree, ctx, [])
        # emission moves to finalize: the reachability walk is global, so a
        # module's verdict isn't known until every module has been parsed
        self._records[ctx.relpath] = _ModRecord(
            ctx._trc_functions, ctx._trc_roots, ctx._trc_ext_roots,
            dict(ctx.imports))

    # ------------------------------------------------ CUDA-graph captures
    # A `with torch.cuda.graph(g):` body is a root of a different AST shape
    # from a decorator, and the engine walk has no scope-exit hook to tell
    # where the body ends, so a private walk finds each block and books its
    # body as a rooted pseudo-function keyed by the block's line.
    def _find_captures(self, node: ast.AST, ctx: ModuleContext,
                       scopes: List[ast.AST]) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef, ast.Lambda)):
                self._find_captures(child, ctx, scopes + [child])
            elif isinstance(child, ast.With) and any(
                    isinstance(item.context_expr, ast.Call) and
                    ctx.dotted_name(item.context_expr.func) in
                    _CAPTURE_BLOCKS for item in child.items):
                fnode = next((n for n in reversed(scopes) if isinstance(
                    n, (ast.FunctionDef, ast.AsyncFunctionDef))), None)
                info = _FnInfo(child, ".".join(
                    getattr(n, "name", "<lambda>") for n in scopes),
                    _param_names(fnode))
                key = f"<capture:{child.lineno}>"
                ctx._trc_functions[key] = info
                ctx._trc_roots.add((key, _TRACE))
                for stmt in child.body:
                    self._capture_walk(stmt, ctx, info)
            else:
                self._find_captures(child, ctx, scopes)

    def _capture_walk(self, node: ast.AST, ctx: ModuleContext,
                      info: _FnInfo) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef, ast.Lambda)):
            return  # defined under the capture, run later: not captured
        self._note(node, ctx, info)
        for child in ast.iter_child_nodes(node):
            self._capture_walk(child, ctx, info)

    # --------------------------------------------------- cross-module pass
    def _resolve(self, dotted: str, by_dotted: Dict[str, str]
                 ) -> Optional[Tuple[str, str]]:
        """``models.transformer.decode_step`` -> (relpath, fn name) when the
        defining module is in the scanned set.  Relative imports drop their
        leading package segments, so modules match by dotted-path suffix."""
        mod_path, _, leaf = dotted.rpartition(".")
        if not mod_path:
            return None
        for scanned, relpath in by_dotted.items():
            if scanned == mod_path or scanned.endswith("." + mod_path):
                if leaf in self._records[relpath].functions:
                    return relpath, leaf
        return None

    def _reach(self, frontier: List[Tuple[str, str]],
               by_dotted: Dict[str, str]) -> Set[Tuple[str, str]]:
        """BFS over local short-name edges + import-resolved edges."""
        traced: Set[Tuple[str, str]] = set()
        while frontier:
            node = frontier.pop()
            if node in traced:
                continue
            traced.add(node)
            rel, name = node
            rec = self._records[rel]
            info = rec.functions[name]
            for callee in info.calls:
                if callee in rec.functions:
                    frontier.append((rel, callee))
                else:
                    # a from-imported short name: resolve via the table
                    dotted = rec.imports.get(callee)
                    if dotted and dotted != callee:
                        target = self._resolve(dotted, by_dotted)
                        if target is not None:
                            frontier.append(target)
            for dotted in info.ext_calls:
                target = self._resolve(dotted, by_dotted)
                if target is not None:
                    frontier.append(target)
        return traced

    def finalize(self, engine) -> List[Finding]:
        by_dotted = {_module_dotted(rel): rel for rel in self._records}
        # roots: locally rooted names + imported names rooted elsewhere
        starts: Dict[str, List[Tuple[str, str]]] = {_TRACE: [], _BATCH: []}
        for rel, rec in self._records.items():
            for name, kind in rec.roots:
                if name in rec.functions:
                    starts[kind].append((rel, name))
            for dotted, kind in rec.ext_roots:
                target = self._resolve(dotted, by_dotted)
                if target is not None:
                    starts[kind].append(target)
        traced = self._reach(starts[_TRACE], by_dotted)
        batched = self._reach(starts[_BATCH], by_dotted) - traced
        findings: List[Finding] = []
        seen: Set[Tuple[str, str, int]] = set()
        for rel, name in sorted(traced | batched):
            info = self._records[rel].functions[name]
            for node, rule, message in info.banned:
                if (rel, name) in batched and rule != "TRC004":
                    continue  # vmap/grad bodies run as host code
                # a capture block's sites also sit in its enclosing
                # function's record: report each site once
                if (rule, rel, node.lineno) in seen:
                    continue
                seen.add((rule, rel, node.lineno))
                findings.append(Finding(
                    rule=rule, file=rel, line=node.lineno,
                    message=message, symbol=info.qualname))
        return findings


# ---------------------------------------------------------------------------
# RES — resilience coverage
# ---------------------------------------------------------------------------

_RES_BANNED = {
    "urllib.request.urlopen": "raw urlopen bypasses breaker + deadline "
                              "clipping (route through io/http.py clients)",
    "urllib.request.Request": "raw urllib request construction outside the "
                              "resilient clients",
    "urllib.request.build_opener": "raw urllib opener outside the resilient "
                                   "clients",
    "http.client.HTTPConnection": "raw http.client bypasses the resilient "
                                  "clients",
    "http.client.HTTPSConnection": "raw http.client bypasses the resilient "
                                   "clients",
    "requests.get": "requests bypasses breaker + deadline clipping",
    "requests.post": "requests bypasses breaker + deadline clipping",
    "requests.put": "requests bypasses breaker + deadline clipping",
    "requests.delete": "requests bypasses breaker + deadline clipping",
    "requests.request": "requests bypasses breaker + deadline clipping",
    "requests.Session": "requests bypasses breaker + deadline clipping",
    "socket.socket": "raw socket outside the resilient clients",
    "socket.create_connection": "raw socket connection outside the "
                                "resilient clients",
}


class ResilienceCoverageChecker(Checker):
    """RES — every remote call outside ``io/http.py`` and ``serving/``
    internals must route through the breaker/deadline-aware clients
    (raw urllib has no budget and no circuit)."""

    rules = {"RES001": "raw urllib/requests/socket outside the resilient "
                       "HTTP clients"}

    #: modules allowed to touch raw transports: the resilient clients
    #: themselves and the serving internals that ARE the server side
    ALLOWED = ("io/http.py", "serving/", "testing/chaos.py")

    def __init__(self, package: str = PACKAGE):
        self.package = package

    def interested(self, relpath: str) -> bool:
        norm = f"/{relpath}"
        return not any(f"/{a}" in norm or norm.endswith(f"/{a}")
                       for a in (f"{self.package}/{p}"
                                 for p in self.ALLOWED))

    def visit(self, node: ast.AST, ctx: ModuleContext) -> None:
        if not isinstance(node, ast.Call):
            return
        dotted = ctx.dotted_name(node.func)
        if dotted is None:
            return
        hit = _dotted_prefix_hit(dotted, _RES_BANNED)
        if hit is not None:
            ctx.report("RES001", node, f"{dotted}() — {hit[1]}")


#: retry helpers whose backoff loops are unbounded without a budget
_RETRY_HELPERS = {"with_retries", "retry_with_timeout"}

#: with-items that install an ambient Deadline for their block
_DEADLINE_SCOPES = {"deadline_scope"}


class UndeadlinedRetryChecker(Checker):
    """RES002 — a ``with_retries``/``retry_with_timeout`` call site with no
    deadline in scope retries on its own configured schedule, unbounded by
    any caller budget (the contract: budgets clip every retry loop).
    Statically visible evidence of a budget, any one of which passes:

    - an explicit ``deadline=`` argument;
    - the call sits lexically inside ``with deadline_scope(...)`` or
      ``with trace_span(..., deadline_s=...)``;
    - the enclosing function declares a ``deadline`` parameter (it is the
      documented convention for threading an explicit budget through).

    A site whose budget is installed by a *caller* (runtime-ambient, not
    lexically visible) is a known false positive — pragma it with the
    reason, or baseline it, exactly like RES001 local-socket sites.
    """

    rules = {"RES002": "with_retries/retry_with_timeout call site with no "
                       "ambient Deadline/deadline_scope in scope"}

    #: the primitives' own modules (definitions + facade) are exempt
    EXCLUDED = ("utils/resilience.py", "utils/fault.py", "testing/")

    def __init__(self, package: str = PACKAGE):
        self.package = package

    def interested(self, relpath: str) -> bool:
        norm = f"/{relpath}"
        return not any(f"/{self.package}/{e}" in norm for e in self.EXCLUDED)

    # The engine walk has no scope-exit hook, so ambient-deadline depth is
    # tracked by a private recursive pass over the module tree instead.
    def end_module(self, ctx: ModuleContext) -> None:
        self._walk(ctx.tree, ctx, depth=0, fn_stack=[])

    def _installs_deadline(self, node: ast.With, ctx: ModuleContext) -> bool:
        for item in node.items:
            expr = item.context_expr
            if not isinstance(expr, ast.Call):
                continue
            dotted = ctx.dotted_name(expr.func) or ""
            leaf = dotted.rsplit(".", 1)[-1]
            if leaf in _DEADLINE_SCOPES:
                return True
            if leaf == "trace_span" and any(kw.arg == "deadline_s"
                                            for kw in expr.keywords):
                return True
        return False

    def _walk(self, node: ast.AST, ctx: ModuleContext, depth: int,
              fn_stack: List[ast.AST]) -> None:
        if isinstance(node, ast.With) and self._installs_deadline(node, ctx):
            depth += 1
        is_fn = isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda))
        if is_fn:
            fn_stack = fn_stack + [node]
            # a def/lambda under a deadline_scope block runs LATER, when
            # the scope is gone — the lexical With above it is no budget
            # for the body, so the depth resets at the function boundary
            depth = 0
        if isinstance(node, ast.Call):
            dotted = ctx.dotted_name(node.func) or ""
            if dotted.rsplit(".", 1)[-1] in _RETRY_HELPERS and depth == 0 \
                    and not any(kw.arg == "deadline" for kw in node.keywords) \
                    and not self._fn_threads_deadline(fn_stack):
                ctx._findings.append(Finding(
                    rule="RES002", file=ctx.relpath, line=node.lineno,
                    message=f"{dotted.rsplit('.', 1)[-1]}() without an "
                            "ambient deadline — retries/backoff are "
                            "unbounded by any caller budget (wrap in "
                            "deadline_scope or pass deadline=)",
                    symbol=".".join(getattr(f, "name", "<lambda>")
                                    for f in fn_stack)))
        for child in ast.iter_child_nodes(node):
            self._walk(child, ctx, depth, fn_stack)

    @staticmethod
    def _fn_threads_deadline(fn_stack: List[ast.AST]) -> bool:
        for fn in reversed(fn_stack):
            args = fn.args
            if any(a.arg == "deadline" for a in
                   args.posonlyargs + args.args + args.kwonlyargs):
                return True
        return False


#: open() modes that create/modify the target — the torn-write hazard
_WRITE_MODE_CHARS = set("wax+")


class CheckpointAtomicityChecker(Checker):
    """RES003 — a direct ``open(..., "w"/"wb"/"a"/...)`` write inside a
    checkpoint module bypasses the atomic temp-file + ``os.replace``
    publish contract (``io/checkpoint.atomic_write``): a crash mid-write
    tears the very snapshot the module exists to protect, and resume then
    has nothing valid to fall back to.  Route every checkpoint-path write
    through the atomic writer; reads are fine."""

    rules = {"RES003": "direct open(..., 'w'/'wb'/'a') write in a "
                       "checkpoint module — route through "
                       "io.checkpoint.atomic_write"}

    # io/checkpoint.py itself is scanned too: only the one
    # raw open INSIDE atomic_write is sanctioned, via its inline pragma —
    # a whole-file exclusion would let a new writer (e.g. a topology-
    # stanza sidecar) land unatomically in the very module that defines
    # the contract.  The flight recorder is held to the same
    # contract: a postmortem dump racing the crash that triggered it must
    # publish whole or not at all, so its writes go through atomic_write
    # only.
    def interested(self, relpath: str) -> bool:
        name = relpath.rsplit("/", 1)[-1]
        return "checkpoint" in name or "flightrecorder" in name

    def visit(self, node: ast.AST, ctx: ModuleContext) -> None:
        if not isinstance(node, ast.Call):
            return
        dotted = ctx.dotted_name(node.func)
        if dotted not in ("open", "io.open", "builtins.open"):
            return
        mode = None
        if len(node.args) >= 2:
            mode = node.args[1]
        for kw in node.keywords:
            if kw.arg == "mode":
                mode = kw.value
        if mode is None:
            return  # default "r": reads are fine
        if isinstance(mode, ast.Constant) and isinstance(mode.value, str):
            if not (_WRITE_MODE_CHARS & set(mode.value)):
                return  # read-only mode
        # non-constant modes are flagged too: the checker cannot prove
        # they are read-only, and checkpoint writes must be provably atomic
        shown = repr(mode.value) if isinstance(mode, ast.Constant) \
            else "<dynamic>"
        ctx.report("RES003", node,
                   f"{dotted}(..., mode={shown}) — checkpoint writes must "
                   "publish via io.checkpoint.atomic_write (temp file + "
                   "os.replace)")


# ---------------------------------------------------------------------------
# CMP — compute-plane transfer discipline
# ---------------------------------------------------------------------------

class TransferDisciplineChecker(Checker):
    """CMP — every explicit host->device placement must route through
    ``observability.compute.device_put`` so
    ``mmlspark_device_transfer_bytes_total{site}`` sees it.  The out-of-core
    streaming pipeline tunes tile sizes against those counters: a raw
    placement is a transfer that silently escapes the accounting, making
    the prefetch-overlap numbers lie exactly where they matter.

    torch's shapes of the reference's raw ``jax.device_put``: ``x.cuda(...)``,
    and ``x.to(...)`` / ``dst.copy_(...)`` with a ``non_blocking=`` keyword
    (the asynchronous staging copy the prefetchers make).  A plain
    ``.to(device)`` is not flagged: it is also how torch casts dtypes, and
    the rule cannot tell the two apart from source.  ``device_put(...,
    non_blocking=True)`` is the sanctioned route and never fires."""

    rules = {"CMP001": "raw host->device placement (.cuda(), or .to()/"
                       ".copy_() with non_blocking=) outside "
                       "observability/compute.py (bypasses the per-site "
                       "transfer counters)"}

    #: the instrumented wrapper itself is the one sanctioned call site
    ALLOWED = ("observability/compute.py",)

    def __init__(self, package: str = PACKAGE):
        self.package = package

    def interested(self, relpath: str) -> bool:
        norm = f"/{relpath}"
        return not any(norm.endswith(f"/{self.package}/{a}")
                       for a in self.ALLOWED)

    def visit(self, node: ast.AST, ctx: ModuleContext) -> None:
        if not isinstance(node, ast.Call) or \
                not isinstance(node.func, ast.Attribute):
            return
        attr = node.func.attr
        if attr == "cuda":
            shape = ".cuda()"
        elif attr in ("to", "copy_") and \
                any(kw.arg == "non_blocking" for kw in node.keywords):
            shape = f".{attr}(..., non_blocking=...)"
        else:
            return
        ctx.report(
            "CMP001", node,
            f"{shape} — untracked host->device transfer; route through "
            "observability.compute.device_put(site=...) so the transfer "
            "counters (and the out-of-core overlap tuning built on them) "
            "stay truthful")


# ---------------------------------------------------------------------------
# LCK — lock discipline
# ---------------------------------------------------------------------------

_LCK_IO_CALLS = {
    "open": "file I/O under a lock",
    "print": "console I/O under a lock",
    "json.dumps": "serialization under a lock (log_event now dumps "
                  "outside; check-then-serialize instead)",
    "json.dump": "serialization under a lock",
    "json.loads": "deserialization under a lock",
    "time.sleep": "sleeping under a lock",
    "urllib.request.urlopen": "network I/O under a lock",
    "socket.socket": "socket work under a lock",
    "subprocess.run": "subprocess under a lock",
}

_LCK_CALLBACK_NAME = re.compile(r"^(fn|cb|callback|listener|hook|prober|"
                                r"sampler)s?(_\w+)?$|^on_[a-z_]+$")


class LockDisciplineChecker(Checker):
    """LCK — nothing slow or re-entrant may run inside a ``with <lock>:``
    body in the observability layer or the resilience primitives: no I/O
    or serialization, no user-callback invocation (three review fixes
    were exactly this shape: drain under the lock, notify outside), and no
    nested lock acquisition (ordering deadlocks)."""

    rules = {
        "LCK001": "I/O or serialization under a lock",
        "LCK002": "callback invocation under a lock",
        "LCK003": "nested lock acquisition",
    }

    SCOPE = ("observability/", "utils/resilience.py")

    def interested(self, relpath: str) -> bool:
        return any(f"/{s}" in f"/{relpath}" for s in self.SCOPE)

    def visit(self, node: ast.AST, ctx: ModuleContext) -> None:
        if isinstance(node, ast.With) and ctx.lock_depth > 0 and \
                with_lock_items(node):
            ctx.report("LCK003", node,
                       "nested lock acquisition (lock-ordering deadlock "
                       "risk — copy state out, release, then lock)")
            return
        if ctx.lock_depth == 0 or not isinstance(node, ast.Call):
            return
        dotted = ctx.dotted_name(node.func)
        if dotted is not None:
            hit = _dotted_prefix_hit(dotted, _LCK_IO_CALLS)
            if hit is not None:
                ctx.report("LCK001", node, f"{dotted}() — {hit[1]}")
                return
        if isinstance(node.func, ast.Name) and \
                _LCK_CALLBACK_NAME.match(node.func.id):
            ctx.report(
                "LCK002", node,
                f"callback {node.func.id}() invoked under a lock — drain "
                "the work list under the lock, call outside it")
        elif isinstance(node.func, ast.Attribute) and \
                node.func.attr == "acquire":
            ctx.report("LCK003", node,
                       "lock.acquire() while already holding a lock")


# ---------------------------------------------------------------------------
# HOT — hot-path hygiene
# ---------------------------------------------------------------------------

_HOT_BANNED = {
    "uuid.uuid4": "per-call os.urandom syscall (~40us) in the serialized "
                  "hot path — use a counter + process prefix "
                  "(observability/tracing.py pattern)",
    "uuid.uuid1": "uuid in the hot path — use a counter + process prefix",
    "os.urandom": "entropy syscall in the hot path — amortize at module "
                  "scope (one prefix per process)",
}

_HOT_LOG_CALL = re.compile(r"(^|\.)(log\w*|debug|info|warning|error|"
                           r"exception|critical)$")


class HotPathChecker(Checker):
    """HOT — the serving score path and span creation must stay syscall-
    and allocation-lean: serving overhead was held to ~10% only after
    hand-removing uuid4/os.urandom from the serialized section and making
    log serialization conditional.  Module-level use is exempt (that IS
    the amortization pattern)."""

    rules = {
        "HOT001": "uuid4/os.urandom inside a hot-path function",
        "HOT002": "f-string eagerly formatted into a logging call on the "
                  "hot path",
    }

    SCOPE = ("serving/", "observability/tracing.py")

    def interested(self, relpath: str) -> bool:
        return any(f"/{s}" in f"/{relpath}" for s in self.SCOPE)

    def visit(self, node: ast.AST, ctx: ModuleContext) -> None:
        if not isinstance(node, ast.Call):
            return
        if ctx.enclosing_function() is None:
            return  # module-level amortization is the sanctioned pattern
        dotted = ctx.dotted_name(node.func)
        if dotted is not None:
            hit = _dotted_prefix_hit(dotted, _HOT_BANNED)
            if hit is not None:
                ctx.report("HOT001", node, f"{dotted}() — {hit[1]}")
                return
        name = dotted or (node.func.attr
                          if isinstance(node.func, ast.Attribute) else "")
        if name and _HOT_LOG_CALL.search(name):
            for arg in node.args:
                if isinstance(arg, ast.JoinedStr):
                    ctx.report(
                        "HOT002", node,
                        "f-string formatted before the logging call can "
                        "decide to drop it — pass structured fields and "
                        "format lazily (core/logging gates on listeners)")
                    return


# ---------------------------------------------------------------------------
# RES004 — unbounded blocking
# ---------------------------------------------------------------------------

#: blocking primitives whose zero-timeout form parks the calling thread
#: forever; the message names the canonical owner of each method
_RES_BLOCKING_ATTRS = {
    "join": "Thread.join",
    "get": "Queue.get",
    "wait": "Event.wait / Condition.wait",
}


class UnboundedBlockingChecker(Checker):
    """RES004 — ``Thread.join()`` / ``Queue.get()`` / ``Event.wait()``
    with no timeout inside the serving layer or the runner hot path is a
    latent hang: a hung device dispatch or a peer that accepts and never
    replies parks the thread forever — exactly the slow-failure class the
    dispatch watchdog exists for.  Pass a timeout (and handle
    expiry), or baseline the site with a justification for why it cannot
    hang (e.g. the waited-on event is set by a watchdog-guarded engine
    that resolves every handle on abort)."""

    rules = {
        "RES004": "unbounded blocking call (join/get/wait with no "
                  "timeout) on a serving/runner hot path",
    }

    SCOPE = ("serving/", "models/runner.py")

    def interested(self, relpath: str) -> bool:
        return any(f"/{s}" in f"/{relpath}" for s in self.SCOPE)

    def visit(self, node: ast.AST, ctx: ModuleContext) -> None:
        if not isinstance(node, ast.Call) or \
                not isinstance(node.func, ast.Attribute):
            return
        attr = node.func.attr
        owner = _RES_BLOCKING_ATTRS.get(attr)
        if owner is None:
            return
        # a positional arg is the timeout for all three primitives (and
        # excludes the str.join/dict.get false positives wholesale); a
        # `timeout=` keyword bounds the call explicitly
        if node.args or any(kw.arg == "timeout" for kw in node.keywords):
            return
        ctx.report(
            "RES004", node,
            f".{attr}() with no timeout ({owner} shape) — an unbounded "
            "block is a latent hang on this path: pass a timeout and "
            "handle expiry, or baseline the site with a justification")
