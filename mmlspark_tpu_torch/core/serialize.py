"""Stage persistence — save/load for all pipeline stages and models.

Reference: SparkML ``ComplexParamsWritable`` + mmlspark's ``ComplexParam``
save/load hooks (``core/serialize/ComplexParam.scala:13-24``) which let params
carry non-JSON payloads (native model strings, DataFrames, UDFs, ball trees).

Layout on disk::

    <path>/metadata.json          {"class": "mod.Cls", "uid": ..., "params": {...}}
    <path>/complex/<param>/...    payload-specific (see _save_complex)

Every complex payload kind gets a tagged directory so load() can dispatch
without pickle-by-default; arbitrary objects fall back to pickle (stdlib).
The JAX package writes the same layout: a class it names
(``mmlspark_tpu.<path>``) loads here as the twin at the same path under
``mmlspark_tpu_torch``, in ``metadata.json`` and inside pickled payloads
alike (``utils.pickling.load`` finds each pickled class's twin).

.. warning:: **Security.** ``load()`` imports the class named in
   ``metadata.json`` and, for closure-typed params (UDFs, Lambda stages),
   falls back to ``pickle`` — both execute code from the artifact.  Only
   load model/pipeline directories you trust, exactly as the reference's
   serializers (SparkML ``DefaultParamsReader`` class-forname + Java
   deserialization) and ``torch.load`` require.  For artifacts from
   untrusted sources, pass ``safe=True`` (or set env
   ``MMLSPARK_TPU_SAFE_LOAD=1``): class imports are then restricted to
   registered trusted prefixes (``mmlspark_tpu_torch.`` plus
   ``register_loadable_prefix(...)``) and pickle payloads refuse to load,
   ``Saveable`` payloads that pickle themselves too.
"""
from __future__ import annotations

import importlib
import json
import os
import shutil

from ..utils import pickling as pickle
import numpy as np
from typing import Any, Dict, Optional

from .params import Params, ServiceValue


class Saveable:
    """Protocol for payloads with their own persistence (boosters, trees)."""

    def save(self, path: str) -> None:
        raise NotImplementedError

    @classmethod
    def load(cls, path: str):
        raise NotImplementedError


def _qualname(obj) -> str:
    cls = obj if isinstance(obj, type) else type(obj)
    return f"{cls.__module__}.{cls.__qualname__}"


_TRUSTED_PREFIXES = {"mmlspark_tpu_torch."}


def register_loadable_prefix(prefix: str) -> None:
    """Allow classes under ``prefix`` (e.g. ``myproject.stages.``) to be
    instantiated by ``load(..., safe=True)``."""
    _TRUSTED_PREFIXES.add(prefix)


def _default_safe() -> bool:
    return os.environ.get("MMLSPARK_TPU_SAFE_LOAD", "0") not in ("0", "", "false")


def _import_qual(qual: str, safe: bool = False):
    # a class path the JAX package saved names the twin of that class in
    # this package (same relative path, same name), so an artifact the JAX
    # package saved loads as this package's object, and this package never
    # imports the JAX package; pickled payloads cross the same way
    # (``utils.pickling``)
    qual = pickle.port_module(qual)
    if safe and not any(qual.startswith(p) for p in _TRUSTED_PREFIXES):
        raise PermissionError(
            f"safe load: class {qual!r} is outside the trusted prefixes "
            f"{sorted(_TRUSTED_PREFIXES)}; call register_loadable_prefix() "
            f"for code you trust, or load with safe=False for trusted paths")
    mod, _, name = qual.rpartition(".")
    m = importlib.import_module(mod)
    obj = m
    for part in name.split("."):
        obj = getattr(obj, part)
    return obj


def _is_jsonable(v) -> bool:
    try:
        json.dumps(v)
        return True
    except (TypeError, ValueError):
        return False


def _save_complex(value: Any, path: str) -> Dict[str, Any]:
    os.makedirs(path, exist_ok=True)
    from .dataframe import DataFrame
    from .pipeline import PipelineStage
    if isinstance(value, Saveable) or (hasattr(value, "save") and hasattr(type(value), "load")
                                       and not isinstance(value, (DataFrame, PipelineStage))):
        value.save(os.path.join(path, "payload"))
        return {"kind": "saveable", "class": _qualname(value)}
    if isinstance(value, PipelineStage):
        save_stage(value, os.path.join(path, "stage"))
        return {"kind": "stage"}
    if isinstance(value, list) and value and all(isinstance(s, PipelineStage) for s in value):
        for i, s in enumerate(value):
            save_stage(s, os.path.join(path, f"stage_{i}"))
        return {"kind": "stage_list", "n": len(value)}
    if isinstance(value, DataFrame):
        save_dataframe(value, os.path.join(path, "frame"))
        return {"kind": "dataframe"}
    if isinstance(value, np.ndarray):
        np.save(os.path.join(path, "array.npy"), value, allow_pickle=value.dtype == object)
        return {"kind": "ndarray"}
    if isinstance(value, (bytes, bytearray)):
        with open(os.path.join(path, "payload.bin"), "wb") as f:
            f.write(value)
        return {"kind": "bytes"}
    if isinstance(value, dict) and all(isinstance(v, np.ndarray) for v in value.values()) and value:
        np.savez(os.path.join(path, "arrays.npz"), **value)
        return {"kind": "ndarray_dict"}
    with open(os.path.join(path, "payload.pkl"), "wb") as f:
        pickle.dump(value, f)
    return {"kind": "pickle"}


def _load_complex(tag: Dict[str, Any], path: str, safe: bool = False) -> Any:
    kind = tag["kind"]
    if kind == "saveable":
        cls = _import_qual(tag["class"], safe=safe)
        return cls.load(os.path.join(path, "payload"))
    if kind == "stage":
        return load_stage(os.path.join(path, "stage"), safe=safe)
    if kind == "stage_list":
        return [load_stage(os.path.join(path, f"stage_{i}"), safe=safe)
                for i in range(tag["n"])]
    if kind == "dataframe":
        return load_dataframe(os.path.join(path, "frame"), safe=safe)
    if kind == "ndarray":
        return np.load(os.path.join(path, "array.npy"), allow_pickle=not safe)
    if kind == "bytes":
        with open(os.path.join(path, "payload.bin"), "rb") as f:
            return f.read()
    if kind == "ndarray_dict":
        with np.load(os.path.join(path, "arrays.npz"), allow_pickle=not safe) as z:
            return {k: z[k] for k in z.files}
    if kind == "pickle":
        if safe:
            raise PermissionError(
                "safe load: refusing pickle payload at "
                f"{os.path.join(path, 'payload.pkl')!r} (pickle executes "
                "arbitrary code); load with safe=False only on trusted paths")
        with open(os.path.join(path, "payload.pkl"), "rb") as f:
            return pickle.load(f)
    raise ValueError(f"unknown complex payload kind {kind!r}")


def save_stage(stage: Params, path: str, overwrite: bool = True) -> None:
    if os.path.exists(path):
        if not overwrite:
            raise FileExistsError(path)
        shutil.rmtree(path)
    os.makedirs(path)
    meta: Dict[str, Any] = {"class": _qualname(stage), "uid": stage.uid,
                            "params": {}, "complex": {}, "service": {}}
    for name, value in stage._paramMap.items():
        if isinstance(value, ServiceValue):
            meta["service"][name] = value.to_json()
        elif _is_jsonable(value):
            meta["params"][name] = value
        else:
            tag = _save_complex(value, os.path.join(path, "complex", name))
            meta["complex"][name] = tag
    with open(os.path.join(path, "metadata.json"), "w") as f:
        json.dump(meta, f, indent=1, default=str)


def load_stage(path: str, safe: bool = None) -> Params:
    """Load a stage directory.  ``safe=True`` (default from env
    ``MMLSPARK_TPU_SAFE_LOAD``) restricts class imports to trusted prefixes
    and refuses pickle payloads — see the module security warning."""
    if safe is None:
        safe = _default_safe()
    with pickle.refusing(safe):
        return _load_stage(path, safe)


def _load_stage(path: str, safe: bool) -> Params:
    with open(os.path.join(path, "metadata.json")) as f:
        meta = json.load(f)
    cls = _import_qual(meta["class"], safe=safe)
    stage = cls.__new__(cls)
    Params.__init__(stage, uid=meta["uid"])
    for name, value in meta["params"].items():
        stage._paramMap[name] = value
    for name, d in meta.get("service", {}).items():
        stage._paramMap[name] = ServiceValue.from_json(d)
    for name, tag in meta.get("complex", {}).items():
        stage._paramMap[name] = _load_complex(tag, os.path.join(path, "complex", name),
                                              safe=safe)
    if hasattr(stage, "_post_load"):
        stage._post_load()
    return stage


def save_dataframe(df, path: str) -> None:
    os.makedirs(path, exist_ok=True)
    from .dataframe import DataFrame
    assert isinstance(df, DataFrame)
    manifest = {"num_partitions": df.num_partitions, "columns": df.columns,
                "schema": dict(df.schema)}
    for i, p in enumerate(df.partitions):
        np.savez(os.path.join(path, f"part_{i}.npz"),
                 **{k: v for k, v in p.items()})
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f)


def load_dataframe(path: str, safe: Optional[bool] = None):
    """``safe=True`` loads arrays with ``allow_pickle=False`` — object-dtype
    columns (sparse dicts, nested arrays) then raise instead of unpickling.
    Default resolves MMLSPARK_TPU_SAFE_LOAD like ``load_stage``/``load`` do,
    so the documented env opt-in covers direct calls too."""
    from .dataframe import DataFrame
    from .schema import Schema
    if safe is None:
        safe = _default_safe()
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    parts = []
    for i in range(manifest["num_partitions"]):
        with np.load(os.path.join(path, f"part_{i}.npz"),
                     allow_pickle=not safe) as z:
            parts.append({k: z[k] for k in manifest["columns"]})
    return DataFrame(parts, schema=Schema(manifest["schema"]))


# Convenience mixin-style functions attached to Params via monkey-free helpers
def save(stage: Params, path: str, overwrite: bool = True) -> None:
    save_stage(stage, path, overwrite)


def load(path: str, safe: bool = None) -> Params:
    return load_stage(path, safe=safe)
