"""JaxModel — the CNTKModel equivalent: a model held as a payload, scored
in minibatches on the device.  The port of ``mmlspark_tpu/dl/jax_model.py``
(the name is kept, as the port keeps every public name).

Reference: ``deep-learning/.../cntk/CNTKModel.scala`` — a SparkML Model
that broadcasts a serialized graph, coerces dtypes, runs minibatched
``model.evaluate`` per partition and unbatches (``applyCNTKFunction``
:34-73, ``applyModel`` :88-140, ``transform`` :500-545).

Here the "graph" is an ``nn.Module`` holding its weights (its
``state_dict`` is the payload's ``variables``), or any
``apply_fn(state, batch)`` callable with its state; ``JaxModel`` keeps the
column semantics and scores through a lazily built
``models.runner.ModelRunner`` (padding to power-of-two buckets, one eager
call per bucket under ``torch.inference_mode()``).  Every entry point
runs on the card unless the ``device`` param says ``"cpu"``.

Persistence: ``module.json`` (the module's class and constructor config,
for modules with ``config()``, as ``models.resnet.ResNet`` has) and
``variables.npz`` (the ``state_dict``, float32).  A module without
``config()``, or an ``apply_fn``, is pickled into ``module.pkl``, as the
reference pickles its flax module.  The reference's own ``module.pkl``
holds a flax module, which cannot be read without flax:
``dl.model_downloader.ModelRepo`` reads such a checkpoint from its
``variables.npz`` alone.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..core import (ComplexParam, DataFrame, HasInputCol, HasOutputCol, Model,
                    Param, Saveable)
from ..core.schema import ColumnType
from ..utils import pickling as pickle

DEVICE_DOC = ("where scoring runs: unset = the CUDA card (an error without "
              "one), 'cpu' = the host")


def _qualname(cls) -> str:
    return f"{cls.__module__}.{cls.__qualname__}"


class FlaxModelPayload(Saveable):
    """Serializable (module, variables, apply kwargs) bundle — the port
    keeps the reference's name for its ``nn.Module`` twin.

    ``module`` holds its weights; ``variables``, when given with it, is a
    ``state_dict`` loaded into it (strictly).  Without a module,
    ``apply_fn(state, batch)`` and its ``variables`` (a dict of arrays or
    tensors) stand in.  The analogue of the reference's
    ``SerializableFunction`` wrapper around CNTK JNI graphs.
    """

    def __init__(self, module: Optional[torch.nn.Module] = None,
                 variables=None, apply_fn: Optional[Callable] = None,
                 apply_kwargs: Optional[Dict[str, Any]] = None):
        if module is None and apply_fn is None:
            raise ValueError("need an nn.Module or an apply_fn")
        self.module = module
        self.apply_fn = apply_fn
        self.apply_kwargs = dict(apply_kwargs or {})
        if module is not None and apply_fn is None and variables is not None:
            module.load_state_dict(variables)
            variables = None
        self._variables = variables

    @property
    def variables(self):
        """The ``state_dict`` of the module, or the ``apply_fn``'s state."""
        if self.apply_fn is None:
            return self.module.state_dict()
        return self._variables

    def apply(self, batch):
        return self.pure_apply(self.variables, batch)

    @property
    def pure_apply(self) -> Callable:
        """(variables, batch) -> output."""
        if self.apply_fn is not None:
            return self.apply_fn
        module, kw = self.module, self.apply_kwargs

        def fn(variables, batch):
            return torch.func.functional_call(module, dict(variables),
                                              (batch,), kw)
        return fn

    # ------------------------------------------------------------ persistence
    def save(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        config = getattr(self.module, "config", None)
        meta: Dict[str, Any] = {"apply_kwargs": self.apply_kwargs,
                                "module": None, "pickled": False}
        if self.apply_fn is None and callable(config):
            meta["module"] = {"class": _qualname(type(self.module)),
                              "config": config()}
        else:
            meta["pickled"] = True
            with open(os.path.join(path, "module.pkl"), "wb") as f:
                pickle.dump({"module": self.module,
                             "apply_fn": self.apply_fn}, f)
        with open(os.path.join(path, "module.json"), "w") as f:
            json.dump(meta, f)
        variables = self.variables
        if variables is not None:
            np.savez(os.path.join(path, "variables.npz"),
                     **{k: _to_numpy(v) for k, v in variables.items()})

    @classmethod
    def load(cls, path: str) -> "FlaxModelPayload":
        from ..core.serialize import _import_qual
        with open(os.path.join(path, "module.json")) as f:
            meta = json.load(f)
        variables = None
        vpath = os.path.join(path, "variables.npz")
        if os.path.exists(vpath):
            with np.load(vpath, allow_pickle=False) as z:
                variables = {k: torch.from_numpy(z[k]) for k in z.files}
        if meta["pickled"]:
            with open(os.path.join(path, "module.pkl"), "rb") as f:
                obj = pickle.load(f)
            module, apply_fn = obj["module"], obj["apply_fn"]
        else:
            spec = meta["module"]
            module = _import_qual(spec["class"], safe=True).from_config(
                spec["config"])
            apply_fn = None
        return cls(module=module, variables=variables, apply_fn=apply_fn,
                   apply_kwargs=meta["apply_kwargs"])


def _to_numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        if v.is_floating_point() and v.dtype != torch.float64:
            v = v.float()
        return v.numpy()
    return np.asarray(v)


class JaxModel(Model, HasInputCol, HasOutputCol):
    """Minibatched on-device inference over a column of vectors/arrays."""

    model = ComplexParam("model", "FlaxModelPayload to evaluate")
    batch_size = Param("batch_size", "rows per device minibatch", "int",
                       default=64, validator=lambda v: v > 0)
    input_shape = Param("input_shape", "per-row input shape (list), e.g. "
                        "[32,32,3]; 1-d vectors inferred if unset", "list")
    input_dtype = Param("input_dtype", "numpy dtype name for model input",
                        "string", default="float32")
    output_mode = Param("output_mode", "'vector' (object column of arrays) "
                        "or 'dense' (2-d float column)", "string",
                        default="vector")
    device = Param("device", DEVICE_DOC, "string", None)

    def __init__(self, uid: Optional[str] = None, **kwargs):
        super().__init__(uid)
        self._runner = None
        if kwargs:
            self.set_params(**kwargs)

    def _post_load(self):
        # the runner holds the model on its device and never serializes; a
        # loaded model builds a fresh one on first use
        self._runner = None

    # ------------------------------------------------------------ helpers
    def set_model(self, module=None, variables=None, apply_fn=None,
                  apply_kwargs=None):
        self.set("model", FlaxModelPayload(module, variables, apply_fn,
                                           apply_kwargs))
        self._runner = None
        return self

    def runner(self):
        """The lazily built ``ModelRunner`` scoring this payload on the
        ``device`` param's device — built on first use (and after every
        load/set_model or a change of device), shared across transform
        calls, so the model is placed on the device once."""
        from ..models.runner import ModelRunner
        from .._device import resolve_device
        dev = resolve_device(self.get("device"))
        if self._runner is None or self._runner.device != dev:
            self._runner = ModelRunner(self.get_or_fail("model"),
                                       name="dl.jax_model",
                                       batch_size=self.get("batch_size"),
                                       device=dev)
        return self._runner

    def _stack_input(self, col: np.ndarray) -> np.ndarray:
        shape = self.get("input_shape")
        dtype = np.dtype(self.get("input_dtype"))
        if col.dtype == object:
            x = np.stack([np.asarray(v) for v in col])
        else:
            x = np.asarray(col)
        if x.ndim == 1:
            x = x[:, None]
        if shape:
            x = x.reshape((x.shape[0], *shape))
        return x.astype(dtype, copy=False)

    def _transform(self, df: DataFrame) -> DataFrame:
        bs = self.get("batch_size")
        in_col = self.get_or_fail("input_col")
        out_col = self.get_or_fail("output_col")
        runner = self.runner()

        def per_part(p):
            col = p[in_col]
            n = len(col)
            if n == 0:
                return {**p, out_col: np.empty(0, dtype=object)}
            t0 = time.perf_counter()
            x = self._stack_input(col)
            runner.phase_s["stack"] += time.perf_counter() - t0
            y = runner.apply_batch(x, front="transform", batch_size=bs)
            if self.get("output_mode") == "dense" and y.ndim == 2:
                out_val = y
            else:
                out_val = np.empty(n, dtype=object)
                for i in range(n):
                    out_val[i] = y[i]
            return {**p, out_col: out_val}

        return df.map_partitions(per_part)

    def transform_schema(self, schema):
        schema.require(self.get_or_fail("input_col"))
        return schema.add(self.get_or_fail("output_col"), ColumnType.VECTOR)
