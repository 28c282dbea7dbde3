"""Stage registry — reflection over every pipeline stage in the package.

Reference: ``JarLoadingUtils`` (``core/utils/JarLoadingUtils.scala``) walks
the jars to find every ``PipelineStage``; the codegen driver and the global
``FuzzingTest`` sweep (``src/test/.../FuzzingTest.scala:18``) both consume it
so coverage is enforced by construction.

The port's twin of the JAX package's ``codegen/registry.py``: the same walk
over the same ``SUBPACKAGES``, of ``mmlspark_tpu_torch``.
"""
from __future__ import annotations

import importlib
import inspect
import pkgutil
from typing import Dict, List, Optional, Type

SUBPACKAGES = ["core", "stages", "featurize", "train", "lightgbm", "vw", "dl",
               "io", "serving", "cognitive", "nn", "recommendation",
               "isolationforest", "automl", "explainers", "opencv", "cyber"]


def _iter_modules():
    import mmlspark_tpu_torch  # noqa: F401
    for sub in SUBPACKAGES:
        pkg = importlib.import_module(f"mmlspark_tpu_torch.{sub}")
        yield pkg
        if hasattr(pkg, "__path__"):
            for info in pkgutil.iter_modules(pkg.__path__):
                try:
                    yield importlib.import_module(f"mmlspark_tpu_torch.{sub}.{info.name}")
                except ImportError:
                    continue


def all_stage_classes(concrete_only: bool = True) -> List[Type]:
    """Every PipelineStage subclass defined in mmlspark_tpu_torch."""
    from mmlspark_tpu_torch.core import PipelineStage
    seen: Dict[str, Type] = {}
    for mod in _iter_modules():
        for name, obj in vars(mod).items():
            if not inspect.isclass(obj) or not issubclass(obj, PipelineStage):
                continue
            if obj.__module__.split(".")[0] != "mmlspark_tpu_torch":
                continue
            if concrete_only and (name.startswith("_") or inspect.isabstract(obj)):
                continue
            seen[f"{obj.__module__}.{obj.__qualname__}"] = obj
    return [seen[k] for k in sorted(seen)]


def instantiate_default(cls: Type):
    """Try to construct a stage with no arguments (fuzzing entry point)."""
    try:
        return cls()
    except Exception:  # noqa: BLE001 — some stages need ctor args
        return None
