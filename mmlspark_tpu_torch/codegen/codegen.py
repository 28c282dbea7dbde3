"""Binding/stub generation from Params metadata.

Reference: ``codegen/CodeGen.scala:26-42`` + ``Wrappable.scala`` — reflection
over every stage's Params emits PySpark and R wrapper classes at build time.
The TPU rebuild is already Python, so the generated artifacts become: typed
``.pyi`` stubs (IDE surface), a markdown API reference, and a JSON params
manifest (the single-source-of-truth contract the reference's wrappers
encode).  Params stay the only source of truth, as in the reference.

The port's twin of the JAX package's ``codegen/codegen.py``: the artifacts
name ``mmlspark_tpu_torch``, and ``generate_all`` writes into
``DEFAULT_OUT_DIR`` (``mmlspark_tpu_torch/_generated``, untracked) unless
given a directory; the JAX package's committed ``docs/api`` is its own
generators' output and is never written here.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Type

from .registry import all_stage_classes

#: where ``generate_all`` and ``python -m mmlspark_tpu_torch codegen`` write
DEFAULT_OUT_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_generated")

_PY_TYPES = {"int": "int", "float": "float", "string": "str", "bool": "bool",
             "list": "list", "object": "object", "complex": "object",
             "service": "object"}


def _params_of(cls: Type):
    return list(cls._params.values())


def generate_stub_file(out_path: str) -> str:
    """One .pyi covering every stage with typed set_/get_ accessors."""
    lines = ["# Auto-generated by mmlspark_tpu_torch.codegen — do not edit.",
             "from typing import Any, Optional", ""]
    for cls in all_stage_classes():
        lines.append(f"class {cls.__qualname__.replace('.', '_')}:")
        params = _params_of(cls)
        if not params:
            lines.append("    ...")
        for p in params:
            t = _PY_TYPES.get(p.dtype, "object")
            lines.append(f"    def set_{p.name}(self, value: {t}) -> "
                         f"'{cls.__qualname__.replace('.', '_')}': ...")
            lines.append(f"    get_{p.name}: {t}")
        lines.append("")
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    content = "\n".join(lines)
    with open(out_path, "w") as f:
        f.write(content)
    return content


def generate_docs(out_path: str) -> str:
    """Markdown API reference from params metadata."""
    lines = ["# mmlspark_tpu_torch API reference", "",
             "Auto-generated from Params metadata (codegen).", ""]
    current_mod = None
    for cls in all_stage_classes():
        mod = cls.__module__
        if mod != current_mod:
            lines.append(f"## `{mod}`")
            current_mod = mod
        lines.append(f"### {cls.__qualname__}")
        doc = (cls.__doc__ or "").strip().split("\n")[0]
        if doc:
            lines.append(doc)
        params = _params_of(cls)
        if params:
            lines.append("")
            lines.append("| param | type | default | doc |")
            lines.append("|---|---|---|---|")
            for p in params:
                doc = p.doc.replace("|", "\\|")  # '|' would split the cell
                default = repr(p.default).replace("|", "\\|")
                lines.append(f"| {p.name} | {p.dtype} | {default} | {doc} |")
        lines.append("")
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    content = "\n".join(lines)
    with open(out_path, "w") as f:
        f.write(content)
    return content


def generate_manifest(out_path: str) -> Dict:
    """JSON manifest of every stage + params (binding contract)."""
    manifest = {}
    for cls in all_stage_classes():
        manifest[f"{cls.__module__}.{cls.__qualname__}"] = {
            "params": [{"name": p.name, "dtype": p.dtype, "doc": p.doc,
                        "default": repr(p.default), "complex": p.is_complex}
                       for p in _params_of(cls)]}
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(manifest, f, indent=1)
    return manifest


def generate_all(out_dir: str = DEFAULT_OUT_DIR) -> None:
    from .rgen import generate_r_classes
    generate_stub_file(os.path.join(out_dir, "mmlspark_tpu_torch.pyi"))
    generate_docs(os.path.join(out_dir, "API.md"))
    generate_manifest(os.path.join(out_dir, "params_manifest.json"))
    generate_r_classes(os.path.join(out_dir, "R-package"))
