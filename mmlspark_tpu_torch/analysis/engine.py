"""graft-lint engine — one AST walk per module, events to registered checkers.

The port's twin of the JAX package's ``analysis/engine.py``, the same engine.
The repo's quality bar is a set of invariants that reviews kept re-enforcing
by hand (deadline clipping at remote boundaries, no work under registry/
breaker locks, no entropy syscalls in the serialized score path, tracer
safety under ``torch.compile`` and CUDA-graph capture).  This engine makes
them machine-checked: every
module is parsed ONCE, each AST node is dispatched to every registered
checker along with a :class:`ModuleContext` (import table, enclosing-function
stack, lock-nesting depth), and checkers emit :class:`Finding` records.
Cross-module checkers accumulate state per module and emit in ``finalize``.

No mmlspark_tpu_torch runtime module is imported by the engine — analysis is
pure source-level, so the tier-1 sweep costs one parse pass, not a torch
import.

Suppression is two-layer (see ``baseline.py`` for the repo baseline file):
an inline pragma on the offending line silences a rule at that site::

    x = uuid.uuid4()  # graft-lint: disable=HOT001

``# graft-lint: disable-file=RULE`` anywhere in a file silences the rule for
the whole file; ``all`` matches every rule.  Pragmas are for sites where the
violation is load-bearing and local; the baseline is for repo-wide curation.
"""
from __future__ import annotations

import ast
import dataclasses
import os
import re
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

__all__ = ["Finding", "Checker", "ModuleContext", "AnalysisEngine",
           "iter_python_files", "PACKAGE"]

#: the package graft-lint scans and gates by default; checkers whose rules
#: name module paths take it as ``package=`` (``"mmlspark_tpu"`` runs the
#: same rules over the JAX package)
PACKAGE = "mmlspark_tpu_torch"

_PRAGMA_RE = re.compile(r"#\s*graft-lint:\s*(disable(?:-file)?)\s*=\s*"
                        r"([A-Za-z0-9_,\s]+)")


@dataclasses.dataclass
class Finding:
    """One rule violation at a source location.

    ``key()`` is the baseline identity: rule + file + symbol (the enclosing
    function/class), deliberately excluding the line number so unrelated
    edits above a baselined site do not invalidate the baseline.
    """
    rule: str
    file: str          # repo-relative posix path
    line: int
    message: str
    severity: str = "error"
    symbol: str = ""   # enclosing def/class qualname ("" = module level)

    def key(self) -> Tuple[str, str, str]:
        return (self.rule, self.file, self.symbol)

    def render(self) -> str:
        sym = f" [{self.symbol}]" if self.symbol else ""
        return f"{self.file}:{self.line}: {self.rule} {self.message}{sym}"


class ModuleContext:
    """Per-module state handed to checkers with every node event."""

    def __init__(self, path: str, relpath: str, tree: ast.Module,
                 source_lines: Sequence[str]):
        self.path = path
        self.relpath = relpath.replace(os.sep, "/")
        self.tree = tree
        self.source_lines = source_lines
        #: alias -> fully qualified dotted name ("np" -> "numpy",
        #: "urlopen" -> "urllib.request.urlopen")
        self.imports: Dict[str, str] = {}
        #: stack of enclosing FunctionDef/AsyncFunctionDef/ClassDef nodes
        self.scope_stack: List[ast.AST] = []
        #: nesting depth of `with <lock>:` bodies at the current node
        self.lock_depth: int = 0
        self._findings: List[Finding] = []
        self._build_imports(tree)

    # ------------------------------------------------------------- imports
    def _build_imports(self, tree: ast.Module) -> None:
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    self.imports[a.asname or a.name.split(".")[0]] = \
                        a.name if a.asname else a.name.split(".")[0]
                    if a.asname:
                        self.imports[a.asname] = a.name
            elif isinstance(node, ast.ImportFrom) and node.module:
                for a in node.names:
                    self.imports[a.asname or a.name] = \
                        f"{node.module}.{a.name}"

    def dotted_name(self, node: ast.AST) -> Optional[str]:
        """Best-effort canonical dotted path of a Name/Attribute chain,
        resolving the leading segment through the import table:
        ``np.random.default_rng`` -> ``numpy.random.default_rng``."""
        parts: List[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if isinstance(node, ast.Name):
            parts.append(self.imports.get(node.id, node.id))
        elif isinstance(node, ast.Call):
            # foo().bar — resolve through the call's target
            inner = self.dotted_name(node.func)
            if inner is None:
                return None
            parts.append(inner)
        else:
            return None
        return ".".join(reversed(parts))

    # ------------------------------------------------------------- scope
    def scope_qualname(self) -> str:
        names = [getattr(n, "name", "<lambda>") for n in self.scope_stack]
        return ".".join(names)

    def enclosing_function(self) -> Optional[ast.AST]:
        for node in reversed(self.scope_stack):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return node
        return None

    # ------------------------------------------------------------- report
    def report(self, rule: str, node: ast.AST, message: str,
               severity: str = "error") -> None:
        self._findings.append(Finding(
            rule=rule, file=self.relpath,
            line=getattr(node, "lineno", 0), message=message,
            severity=severity, symbol=self.scope_qualname()))


class Checker:
    """Base checker: override the event hooks you need.

    ``visit`` fires for EVERY node of every interesting module, in source
    order, with scope/lock context already updated on ``ctx``.
    """

    #: rule id -> one-line description (drives the docs catalog + CLI help)
    rules: Dict[str, str] = {}

    def interested(self, relpath: str) -> bool:
        """Module filter; default: every scanned module."""
        return True

    def begin_module(self, ctx: ModuleContext) -> None:
        pass

    def visit(self, node: ast.AST, ctx: ModuleContext) -> None:
        pass

    def end_module(self, ctx: ModuleContext) -> None:
        pass

    def finalize(self, engine: "AnalysisEngine") -> List[Finding]:
        """Cross-module findings, after every module has been walked."""
        return []


def _looks_like_lock(node: ast.AST) -> bool:
    """Heuristic: the context expression of `with X:` names a lock
    (`self._lock`, `stats.lock`, `_global_lock`, `lock.acquire()`...)."""
    target = node
    if isinstance(target, ast.Call):   # with lock.acquire(...) / Lock()
        target = target.func
    name = None
    if isinstance(target, ast.Attribute):
        name = target.attr
    elif isinstance(target, ast.Name):
        name = target.id
    if name is None:
        return False
    if name == "acquire":
        inner = target.value if isinstance(target, ast.Attribute) else None
        return inner is not None and _looks_like_lock(inner)
    return "lock" in name.lower() or "mutex" in name.lower()


def with_lock_items(node: ast.With) -> List[ast.AST]:
    """The lock-like context expressions of a With statement."""
    return [item.context_expr for item in node.items
            if _looks_like_lock(item.context_expr)]


class _Walker:
    """Single recursive walk maintaining scope + lock depth on the ctx."""

    def __init__(self, checkers: Sequence[Checker], ctx: ModuleContext):
        self.checkers = checkers
        self.ctx = ctx

    def walk(self, node: ast.AST) -> None:
        ctx = self.ctx
        is_scope = isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                     ast.ClassDef, ast.Lambda))
        holds_lock = isinstance(node, ast.With) and bool(with_lock_items(node))
        for checker in self.checkers:
            checker.visit(node, ctx)
        if is_scope:
            ctx.scope_stack.append(node)
        if holds_lock:
            ctx.lock_depth += 1
        try:
            for child in ast.iter_child_nodes(node):
                self.walk(child)
        finally:
            if holds_lock:
                ctx.lock_depth -= 1
            if is_scope:
                ctx.scope_stack.pop()


def _parse_pragmas(source_lines: Sequence[str]
                   ) -> Tuple[Dict[int, Set[str]], Set[str]]:
    """-> ({line_no: {rules}}, {file_wide_rules}); "all" matches any rule."""
    per_line: Dict[int, Set[str]] = {}
    file_wide: Set[str] = set()
    for i, line in enumerate(source_lines, start=1):
        for kind, rules in _PRAGMA_RE.findall(line):
            ids = {r.strip() for r in rules.split(",") if r.strip()}
            if kind == "disable-file":
                file_wide |= ids
            else:
                per_line.setdefault(i, set()).update(ids)
    return per_line, file_wide


def iter_python_files(root: str) -> Iterable[str]:
    """Every .py under root, skipping caches and generated trees."""
    if os.path.isfile(root):
        yield root
        return
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames
                             if d not in ("__pycache__", ".git"))
        for fname in sorted(filenames):
            if fname.endswith(".py"):
                yield os.path.join(dirpath, fname)


class AnalysisEngine:
    """Parse each module once; dispatch to checkers; collect findings.

    ``root`` anchors the repo-relative paths findings carry (and the path
    prefixes checkers filter on): scanning ``<repo>/mmlspark_tpu_torch``
    with ``root=<repo>`` yields paths like
    ``mmlspark_tpu_torch/serving/server.py``.
    """

    def __init__(self, checkers: Sequence[Checker], root: str):
        self.checkers = list(checkers)
        self.root = os.path.abspath(root)
        #: relpath -> ModuleContext, for cross-module finalize passes
        self.modules: Dict[str, ModuleContext] = {}
        self.parse_errors: List[Finding] = []

    def run(self, paths: Iterable[str]) -> List[Finding]:
        findings: List[Finding] = []
        for path in paths:
            findings.extend(self._run_module(os.path.abspath(path)))
        for checker in self.checkers:
            for f in checker.finalize(self):
                ctx = self.modules.get(f.file)
                if ctx is None or not _suppressed(f, ctx):
                    findings.append(f)
        findings.extend(self.parse_errors)
        findings.sort(key=lambda f: (f.file, f.line, f.rule))
        return findings

    def _run_module(self, path: str) -> List[Finding]:
        relpath = os.path.relpath(path, self.root)
        with open(path, encoding="utf-8") as fh:
            source = fh.read()
        try:
            tree = ast.parse(source, filename=path)
        except SyntaxError as e:
            self.parse_errors.append(Finding(
                rule="ENG001", file=relpath.replace(os.sep, "/"),
                line=e.lineno or 0, message=f"syntax error: {e.msg}"))
            return []
        ctx = ModuleContext(path, relpath, tree, source.splitlines())
        self.modules[ctx.relpath] = ctx
        active = [c for c in self.checkers if c.interested(ctx.relpath)]
        if not active:
            return []
        for c in active:
            c.begin_module(ctx)
        _Walker(active, ctx).walk(tree)
        for c in active:
            c.end_module(ctx)
        return [f for f in ctx._findings if not _suppressed(f, ctx)]


def _suppressed(finding: Finding, ctx: ModuleContext) -> bool:
    pragmas = getattr(ctx, "_pragmas", None)
    if pragmas is None:
        pragmas = ctx._pragmas = _parse_pragmas(ctx.source_lines)
    per_line, file_wide = pragmas
    if "all" in file_wide or finding.rule in file_wide:
        return True
    rules = per_line.get(finding.line, ())
    return "all" in rules or finding.rule in rules
