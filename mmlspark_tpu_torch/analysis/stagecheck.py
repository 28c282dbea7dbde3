"""STG — stage-contract checker: the static complement to testing/fuzzing.py.

The port's twin of the JAX package's ``analysis/stagecheck.py``; it reads
``SUBPACKAGES`` from ``<package>/codegen/registry.py``'s source.

The reflection harness (``codegen/registry.py`` + ``testing/fuzzing.py``)
enforces coverage at TEST time, but only over classes it can discover and
import.  A stage whose module sits outside the registry's ``SUBPACKAGES``
list, or whose ``Param`` attribute name drifts from the declared param name,
silently drops out of codegen, fuzzing, AND the generated bindings at once.
This checker re-derives the stage universe from source alone (no imports, no
torch) and cross-checks the three contracts.

The class graph is static and name-based: bases are resolved by final
segment against every class the scan saw, so `class Foo(Transformer)` and
`class Bar(base.CognitiveServicesBase)` both link.  Private classes
(``_``-prefixed) mirror the registry's own exclusion rule.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .engine import PACKAGE, AnalysisEngine, Checker, Finding, ModuleContext

__all__ = ["StageContractChecker"]

#: class names that root the Params/stage hierarchies (core/params.py and
#: core/pipeline.py); everything transitively derived is in scope.  The
#: framework bases are named explicitly so a fixture (or an out-of-tree
#: stage) subclassing `Transformer` links without scanning core itself.
_PARAMS_ROOTS = {"Params"}
_STAGE_ROOTS = {"PipelineStage", "Transformer", "Estimator", "Model",
                "UnaryTransformer"}

#: Param-declaring call targets
_PARAM_CALLS = {"Param", "ComplexParam", "ServiceParam"}

#: accessor names the Params base itself defines — not per-param accessors
_ACCESSOR_WHITELIST = {"set_params", "set_col", "get_param", "get_or_fail"}


class _ClassInfo:
    __slots__ = ("name", "relpath", "lineno", "bases", "param_names",
                 "param_attr_mismatches", "accessors", "is_private")

    def __init__(self, name: str, relpath: str, lineno: int,
                 bases: Sequence[str]):
        self.name = name
        self.relpath = relpath
        self.lineno = lineno
        self.bases = list(bases)
        #: declared param NAMES (first arg of Param(...) class attributes)
        self.param_names: Set[str] = set()
        #: (attr_name, param_name, lineno) where the two disagree
        self.param_attr_mismatches: List[Tuple[str, str, int]] = []
        #: manually defined set_x/get_x method names with linenos
        self.accessors: List[Tuple[str, int]] = []
        self.is_private = name.startswith("_")


class StageContractChecker(Checker):
    """STG001 param attribute/name drift, STG002 stage outside the codegen
    registry, STG003 manual accessor for an undeclared param."""

    rules = {
        "STG001": "Param attribute name != declared param name (breaks "
                  "set_/get_ synthesis and serialization)",
        "STG002": "stage class not discoverable by the codegen registry "
                  "(module outside SUBPACKAGES)",
        "STG003": "manual set_/get_ accessor without a declared param",
    }

    def __init__(self, subpackages: Optional[Sequence[str]] = None,
                 package: str = PACKAGE):
        #: explicit SUBPACKAGES override (fixtures); None = read it from
        #: the scanned codegen/registry.py source in finalize
        self.subpackages = tuple(subpackages) if subpackages else None
        self.package = package
        self._classes: Dict[str, _ClassInfo] = {}

    def interested(self, relpath: str) -> bool:
        return True

    # ------------------------------------------------------------- events
    def visit(self, node: ast.AST, ctx: ModuleContext) -> None:
        if not isinstance(node, ast.ClassDef):
            return
        bases = []
        for b in node.bases:
            dotted = ctx.dotted_name(b)
            if dotted:
                bases.append(dotted.split(".")[-1])
        info = _ClassInfo(node.name, ctx.relpath, node.lineno, bases)
        for stmt in node.body:
            self._collect_member(stmt, info)
        # last definition of a short name wins (names are unique in-tree)
        self._classes[node.name] = info

    def _collect_member(self, stmt: ast.stmt, info: _ClassInfo) -> None:
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 and \
                isinstance(stmt.targets[0], ast.Name) and \
                isinstance(stmt.value, ast.Call):
            func = stmt.value.func
            fname = func.id if isinstance(func, ast.Name) else \
                (func.attr if isinstance(func, ast.Attribute) else "")
            if fname in _PARAM_CALLS:
                attr = stmt.targets[0].id
                pname = self._param_name(stmt.value)
                if pname is None:
                    return  # dynamic name — nothing checkable statically
                info.param_names.add(pname)
                if pname != attr:
                    info.param_attr_mismatches.append(
                        (attr, pname, stmt.lineno))
        elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if (stmt.name.startswith("set_") or
                    stmt.name.startswith("get_")) and \
                    stmt.name not in _ACCESSOR_WHITELIST:
                info.accessors.append((stmt.name, stmt.lineno))

    @staticmethod
    def _param_name(call: ast.Call) -> Optional[str]:
        if call.args and isinstance(call.args[0], ast.Constant) and \
                isinstance(call.args[0].value, str):
            return call.args[0].value
        for kw in call.keywords:
            if kw.arg == "name" and isinstance(kw.value, ast.Constant) and \
                    isinstance(kw.value.value, str):
                return kw.value.value
        return None

    # ----------------------------------------------------------- finalize
    def _descendants(self, roots: Set[str]) -> Set[str]:
        """Transitive closure over the static base-name graph."""
        out = set(roots)
        changed = True
        while changed:
            changed = False
            for name, info in self._classes.items():
                if name not in out and any(b in out for b in info.bases):
                    out.add(name)
                    changed = True
        return out

    def _registry_subpackages(self, engine: AnalysisEngine
                              ) -> Optional[Tuple[str, ...]]:
        if self.subpackages is not None:
            return self.subpackages
        ctx = engine.modules.get(f"{self.package}/codegen/registry.py")
        if ctx is None:
            return None
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                    isinstance(node.targets[0], ast.Name) and \
                    node.targets[0].id == "SUBPACKAGES" and \
                    isinstance(node.value, ast.List):
                return tuple(e.value for e in node.value.elts
                             if isinstance(e, ast.Constant))
        return None

    def _ancestor_params(self, name: str) -> Set[str]:
        """Param names declared on the class or any static ancestor."""
        out: Set[str] = set()
        seen: Set[str] = set()
        stack = [name]
        while stack:
            cur = stack.pop()
            if cur in seen:
                continue
            seen.add(cur)
            info = self._classes.get(cur)
            if info is None:
                continue
            out |= info.param_names
            stack.extend(info.bases)
        return out

    def finalize(self, engine: AnalysisEngine) -> List[Finding]:
        findings: List[Finding] = []
        params_classes = self._descendants(_PARAMS_ROOTS | _STAGE_ROOTS)
        stage_classes = self._descendants(_STAGE_ROOTS)
        subpackages = self._registry_subpackages(engine)
        for name in sorted(params_classes):
            info = self._classes.get(name)
            if info is None:
                continue
            for attr, pname, lineno in info.param_attr_mismatches:
                findings.append(Finding(
                    rule="STG001", file=info.relpath, line=lineno,
                    message=f"class attribute '{attr}' declares param "
                            f"'{pname}' — the names must match for "
                            "set_/get_ synthesis and codegen",
                    symbol=f"{name}.{attr}"))
            if name in stage_classes and not info.is_private and \
                    name not in _STAGE_ROOTS:
                declared = self._ancestor_params(name)
                for acc, lineno in info.accessors:
                    pname = acc[4:]
                    if pname and pname not in declared:
                        findings.append(Finding(
                            rule="STG003", file=info.relpath, line=lineno,
                            message=f"manual accessor {acc}() has no "
                                    f"declared param '{pname}' — declare "
                                    "it via core/params or rename",
                            symbol=f"{name}.{acc}"))
                if subpackages is not None and \
                        self._outside_registry(info, subpackages):
                    findings.append(Finding(
                        rule="STG002", file=info.relpath, line=info.lineno,
                        message=f"stage {name} lives outside the codegen "
                                "registry SUBPACKAGES — codegen and the "
                                "fuzzing sweep cannot discover it",
                        symbol=name))
        return findings

    def _outside_registry(self, info: _ClassInfo,
                          subpackages: Sequence[str]) -> bool:
        parts = info.relpath.split("/")
        if parts[0] != self.package:
            return False  # fixtures and tools are out of registry scope
        return len(parts) < 3 or parts[1] not in subpackages
