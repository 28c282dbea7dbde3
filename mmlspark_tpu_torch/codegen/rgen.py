"""R binding generation — the second-language wrapper surface.

Reference: ``RWrappable.rClass`` (``codegen/Wrappable.scala:473-508``) emits
one sparklyr-backed R function per stage; ``CodeGen.generateRClasses``
(``CodeGen.scala:34``) plus ``makeInitFiles`` assemble the package
(DESCRIPTION/NAMESPACE).  The engine there is JVM, reached via
``invoke_new``; here the engine is Python, reached via ``reticulate`` — the
same bridge sparklyr itself is to Spark.

Each generated ``R/<snake_name>.R`` exposes the stage as a roxygen-documented
constructor whose arguments are the stage's simple Params (defaults carried
over), plus ``ml_fit``/``ml_transform``/``ml_save``/``ml_load`` generics in
``R/mmlspark_tpu_torch_core.R``.  Param metadata comes from the same single
source of truth as every other binding (the live Params registry), so the
manifest equality generated tests guard this surface too.

The port's twin of the JAX package's ``codegen/rgen.py``: the package
(``mmlsparktputorch``) reaches ``mmlspark_tpu_torch`` through reticulate,
with the reference's constructor and verb names.
"""
from __future__ import annotations

import os
import re
from typing import List

from .registry import all_stage_classes

_R_DEFAULTS = {True: "TRUE", False: "FALSE", None: "NULL"}


def _snake(name: str) -> str:
    """CamelCase -> snake_case keeping acronym runs together
    (LightGBMClassifier -> light_gbm_classifier)."""
    s = re.sub(r"(?<=[a-z0-9])(?=[A-Z])|(?<=[A-Z])(?=[A-Z][a-z])", "_", name)
    return re.sub(r"__+", "_", s.replace(".", "_")).lower()


def _r_literal(v) -> str:
    if isinstance(v, bool) or v is None:
        return _R_DEFAULTS[v]
    if isinstance(v, (int, float)):
        return repr(v)
    if isinstance(v, str):
        return '"' + v.replace('"', '\\"') + '"'
    if isinstance(v, (list, tuple)):
        return "c(" + ", ".join(_r_literal(x) for x in v) + ")" if v else "NULL"
    return "NULL"


_CORE = '''# Auto-generated by mmlspark_tpu_torch.codegen.rgen - do not edit.
# Core bridge: every stage constructor returns a reticulate handle to the
# Python engine object; these generics mirror sparklyr's ml_* verbs.

.mmlspark_tpu_torch_env <- new.env(parent = emptyenv())

mmlspark_tpu_torch_engine <- function() {
  if (is.null(.mmlspark_tpu_torch_env$pkg)) {
    .mmlspark_tpu_torch_env$pkg <- reticulate::import("mmlspark_tpu_torch")
  }
  .mmlspark_tpu_torch_env$pkg
}

#' Fit an estimator on a DataFrame handle
#' @export
ml_fit <- function(stage, df) stage$fit(df)

#' Transform a DataFrame handle
#' @export
ml_transform <- function(stage, df) stage$transform(df)

#' Persist a stage/model directory
#' @export
ml_save <- function(stage, path, overwrite = TRUE) {
  mmlspark_tpu_torch_engine()$core$serialize$save(stage, path, overwrite)
}

#' Load a stage/model directory (trusted paths only; see safe mode docs)
#' @export
ml_load <- function(path, safe = FALSE) {
  mmlspark_tpu_torch_engine()$core$serialize$load(path, safe = safe)
}
'''

_DESCRIPTION = '''Package: mmlsparktputorch
Type: Package
Title: R bindings for the mmlspark_tpu_torch framework
Version: {version}
Description: Auto-generated reticulate-backed wrappers exposing every
    mmlspark_tpu_torch pipeline stage to R (one constructor per stage; params
    generated from the engine's Params metadata).
Imports: reticulate
License: MIT
Encoding: UTF-8
'''


def generate_r_classes(out_dir: str, version: str = "0.2.0") -> List[str]:
    """Emit the R package: R/<stage>.R per stage + DESCRIPTION + NAMESPACE.
    Returns the generated file paths."""
    r_dir = os.path.join(out_dir, "R")
    os.makedirs(r_dir, exist_ok=True)
    paths = []
    exports = ["ml_fit", "ml_transform", "ml_save", "ml_load"]
    core_path = os.path.join(r_dir, "mmlspark_tpu_torch_core.R")
    with open(core_path, "w") as f:
        f.write(_CORE)
    paths.append(core_path)
    for cls in all_stage_classes():
        fname = "mt_" + _snake(cls.__qualname__)
        simple = [p for p in cls.params() if not p.is_complex]
        args = ",\n".join(f"    {p.name} = {_r_literal(p.default)}"
                          for p in simple)
        setters = "\n".join(
            f'  if (!is.null({p.name})) stage$set("{p.name}", {p.name})'
            for p in simple)
        doc_params = "\n".join(f"#' @param {p.name} {p.doc}" for p in simple)
        module_path = cls.__module__.split(".", 1)[1]  # drop pkg root
        attr_chain = "$".join(["mmlspark_tpu_torch_engine()"]
                              + module_path.split(".") + [cls.__qualname__])
        body = f'''# Auto-generated by mmlspark_tpu_torch.codegen.rgen - do not edit.

#' {(cls.__doc__ or cls.__qualname__).strip().splitlines()[0]}
#'
{doc_params}
#' @return a reticulate handle to {cls.__qualname__}
#' @export
{fname} <- function(
{args}
) {{
  stage <- {attr_chain}()
{setters}
  stage
}}
'''
        path = os.path.join(r_dir, f"{fname}.R")
        with open(path, "w") as f:
            f.write(body)
        paths.append(path)
        exports.append(fname)
    with open(os.path.join(out_dir, "DESCRIPTION"), "w") as f:
        f.write(_DESCRIPTION.format(version=version))
    with open(os.path.join(out_dir, "NAMESPACE"), "w") as f:
        f.write("".join(f"export({e})\n" for e in sorted(exports)))
    return paths
