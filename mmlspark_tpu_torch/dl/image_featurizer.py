"""ImageFeaturizer — transfer-learning featurization on the card.  The port
of ``mmlspark_tpu/dl/image_featurizer.py``.

Reference: ``deep-learning/.../cntk/ImageFeaturizer.scala:24-120`` —
composes ``ResizeImageTransformer`` + ``UnrollImage`` + ``CNTKModel`` with
``cutOutputLayers`` truncating the classifier head.  Here resize and
normalize run on the device in the same call as the backbone (one
``nn.Module``, ``_Featurize``, scored by the runner), and head truncation
is the model's ``features=True`` path.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..core import (ComplexParam, DataFrame, HasInputCol, HasOutputCol, Model,
                    Param)
from ..core.schema import ColumnType
from ..ops import image as image_ops
from .jax_model import DEVICE_DOC, FlaxModelPayload, JaxModel


class _Featurize(torch.nn.Module):
    """resize (when the batch is not ``height`` x ``width``) -> normalize
    (``auto_convert``) -> the backbone, its head cut by ``features``."""

    def __init__(self, backbone: torch.nn.Module, height: int, width: int,
                 normalize: bool, features: bool, apply_kwargs=None):
        super().__init__()
        self.backbone = backbone
        self.height, self.width = height, width
        self.normalize, self.features = normalize, features
        self.apply_kwargs = dict(apply_kwargs or {})

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _prepare(x, self.height, self.width, self.normalize)
        return self.backbone(x, features=self.features, **self.apply_kwargs)


def _prepare(x: torch.Tensor, h: int, w: int, norm: bool) -> torch.Tensor:
    if x.shape[1] != h or x.shape[2] != w:
        x = image_ops.resize(x, h, w)
    if norm:
        x = image_ops.normalize(x)
    return x


class ImageFeaturizer(Model, HasInputCol, HasOutputCol):
    model = ComplexParam("model", "FlaxModelPayload backbone (e.g. "
                         "models.resnet50) or OnnxModelPayload")
    cut_output_layers = Param("cut_output_layers", "how many head layers to "
                              "cut: 0 = logits, 1 = pooled features", "int",
                              default=1)
    height = Param("height", "input height fed to the backbone", "int",
                   default=224)
    width = Param("width", "input width fed to the backbone", "int",
                  default=224)
    channels = Param("channels", "input channels", "int", default=3)
    batch_size = Param("batch_size", "device minibatch size", "int",
                       default=32)
    auto_convert = Param("auto_convert", "normalize uint8 [0,255] to "
                         "imagenet stats", "bool", default=True)
    device = Param("device", DEVICE_DOC, "string", None)

    def __init__(self, uid: Optional[str] = None, **kwargs):
        super().__init__(uid)
        #: (config key, scoring JaxModel) — kept across transform calls so
        #: the backbone is placed on the device once, not per transform
        self._scorer_cache = None
        if kwargs:
            self.set_params(**kwargs)

    def _post_load(self):
        self._scorer_cache = None

    def set_model(self, module=None, variables=None, apply_fn=None,
                  apply_kwargs=None, payload=None):
        """Accepts an ``nn.Module`` / raw ``apply_fn`` (wrapped in
        ``FlaxModelPayload``) or a ready payload — including
        ``OnnxModelPayload`` for pretrained imported graphs (head truncation
        then happens at import time via ``cut_layers``, the
        ``cutOutputLayers`` analogue)."""
        if payload is None:
            payload = FlaxModelPayload(module, variables, apply_fn,
                                       apply_kwargs)
        self.set("model", payload)
        # the cache key uses id(payload): a freed payload's id can be reused
        # by a NEW payload, so replacement must invalidate explicitly
        self._scorer_cache = None
        return self

    def _build_runner(self) -> JaxModel:
        from .onnx_import import OnnxModelPayload
        payload = self.get_or_fail("model")
        h, w = self.get("height"), self.get("width")
        cut = self.get("cut_output_layers")
        norm = self.get("auto_convert")
        key = (id(payload), h, w, cut, norm, self.get("batch_size"),
               self.get_or_fail("input_col"), self.get_or_fail("output_col"),
               self.get("device"))
        if self._scorer_cache is not None and self._scorer_cache[0] == key:
            return self._scorer_cache[1]
        runner = JaxModel()
        if isinstance(payload, OnnxModelPayload):
            if cut > 0 and not payload.cut_layers \
                    and not payload.output_names:
                # honor cut_output_layers for uncut ONNX graphs by
                # re-importing with the head dropped (the payload's own
                # truncation wins when it was imported pre-cut)
                payload = OnnxModelPayload(payload.model_bytes,
                                           cut_layers=cut)
            base = payload.apply_fn

            def fused(variables, batch):
                # ONNX graphs run native NCHW
                x = _prepare(batch, h, w, norm).permute(0, 3, 1, 2)
                out = base(variables, x)
                if out.ndim > 2:
                    out = out.reshape(out.shape[0], -1)   # pooled maps
                return out

            runner.set_model(apply_fn=fused, variables=payload.variables)
        elif payload.module is None:
            base = payload.apply_fn

            def fused(variables, batch):
                return base(variables, _prepare(batch, h, w, norm))

            runner.set_model(apply_fn=fused, variables=payload.variables)
        else:
            runner.set_model(module=_Featurize(payload.module, h, w, norm,
                                               cut > 0,
                                               payload.apply_kwargs))
        runner.set("batch_size", self.get("batch_size"))
        runner.set("input_col", self.get_or_fail("input_col"))
        runner.set("output_col", self.get_or_fail("output_col"))
        runner.set("device", self.get("device"))
        self._scorer_cache = (key, runner)
        return runner

    def _transform(self, df: DataFrame) -> DataFrame:
        in_col = self.get_or_fail("input_col")
        c = self.get("channels")
        scorer = self._build_runner()
        phase_s = scorer.runner().phase_s

        def reshape_part(p):
            t0 = time.perf_counter()
            col = p[in_col]
            out = np.empty(len(col), dtype=object)
            for i, v in enumerate(col):
                arr = np.asarray(v)
                if arr.ndim == 1:  # unrolled image -> assume square HWC
                    side = int(round((arr.size / c) ** 0.5))
                    arr = arr.reshape(side, side, c)
                out[i] = arr.astype(np.float32)
            phase_s["stack"] += time.perf_counter() - t0
            return {**p, in_col: out}

        reshaped = df.map_partitions(reshape_part)
        return scorer.transform(reshaped)

    def transform_schema(self, schema):
        schema.require(self.get_or_fail("input_col"))
        return schema.add(self.get_or_fail("output_col"), ColumnType.VECTOR)
