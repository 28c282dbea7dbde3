"""ImageTransformer — chained image ops on the device.  The port of
``mmlspark_tpu/opencv/image_transformer.py``.

Reference: ``opencv/.../ImageTransformer.scala:42-220`` applies a pipeline of
JNI ``Mat`` stages (ResizeImage/CropImage/ColorFormat/Flip/Blur/Threshold/
GaussianKernel) per row.  Here the op chain runs as torch ops
(``ops.image``) over NHWC batches on the ``device`` param's device (the
card unless ``"cpu"``), one batch per distinct input shape of a
partition, instead of per-row native calls.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .._device import resolve_device
from ..core import DataFrame, HasInputCol, HasOutputCol, Param, Transformer
from ..core.schema import ColumnType
from ..ops import image as image_ops

DEVICE_DOC = ("where the op chain runs: unset = the CUDA card (an error "
              "without one), 'cpu' = the host")


class ImageTransformer(Transformer, HasInputCol, HasOutputCol):
    stages = Param("stages", "ordered list of op dicts", "list", default=[])
    device = Param("device", DEVICE_DOC, "string", None)

    def __init__(self, uid=None, **kwargs):
        super().__init__(uid)
        if kwargs:
            self.set_params(**kwargs)
        if not self.is_set("stages"):
            self.set("stages", [])

    # -- fluent builders mirroring the reference stage classes ---------------
    def _add(self, op: Dict[str, Any]) -> "ImageTransformer":
        self.set("stages", list(self.get("stages")) + [op])
        return self

    def resize(self, height: int, width: int) -> "ImageTransformer":
        return self._add({"op": "resize", "height": height, "width": width})

    def crop(self, x: int, y: int, height: int, width: int) -> "ImageTransformer":
        return self._add({"op": "crop", "x": x, "y": y, "height": height, "width": width})

    def center_crop(self, height: int, width: int) -> "ImageTransformer":
        return self._add({"op": "center_crop", "height": height, "width": width})

    def color_format(self, format: str) -> "ImageTransformer":
        return self._add({"op": "color_format", "format": format})

    def flip(self, flip_code: int = 1) -> "ImageTransformer":
        # reference flipCode: 1=horizontal, 0=vertical
        return self._add({"op": "flip", "horizontal": flip_code == 1})

    def blur(self, height: float = 5, width: float = 5, sigma: float = 1.0) -> "ImageTransformer":
        return self._add({"op": "blur", "kernel_size": int(height), "sigma": sigma})

    def threshold(self, threshold: float, max_val: float = 255.0,
                  threshold_type: str = "binary") -> "ImageTransformer":
        return self._add({"op": "threshold", "threshold": threshold,
                          "max_val": max_val, "kind": threshold_type})

    def gaussian_kernel(self, apperture_size: int, sigma: float) -> "ImageTransformer":
        return self._add({"op": "blur", "kernel_size": apperture_size, "sigma": sigma})

    def normalize(self, mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225),
                  scale: float = 1 / 255.0) -> "ImageTransformer":
        return self._add({"op": "normalize", "mean": list(mean), "std": list(std),
                          "scale": scale})

    def unroll(self) -> "ImageTransformer":
        return self._add({"op": "unroll"})

    # ------------------------------------------------------------------ run
    def _apply_chain(self, batch: torch.Tensor) -> torch.Tensor:
        x = batch
        for spec in self.get("stages"):
            op = spec["op"]
            if op == "resize":
                x = image_ops.resize(x, spec["height"], spec["width"])
            elif op == "crop":
                x = image_ops.crop(x, spec["x"], spec["y"], spec["height"], spec["width"])
            elif op == "center_crop":
                x = image_ops.center_crop(x, spec["height"], spec["width"])
            elif op == "flip":
                x = image_ops.flip(x, spec["horizontal"])
            elif op == "blur":
                x = image_ops.blur(x, spec["kernel_size"], spec["sigma"])
            elif op == "threshold":
                x = image_ops.threshold(x, spec["threshold"], spec["max_val"], spec["kind"])
            elif op == "color_format":
                if spec["format"] in ("gray", "grayscale"):
                    x = image_ops.to_grayscale(x)
            elif op == "normalize":
                x = image_ops.normalize(x, spec["mean"], spec["std"], spec["scale"])
            elif op == "unroll":
                x = image_ops.unroll(x)
            else:
                raise ValueError(f"unknown image op {op!r}")
        return x

    def _transform(self, df: DataFrame) -> DataFrame:
        in_col, out_col = self.get_or_fail("input_col"), self.get_or_fail("output_col")
        dev = resolve_device(self.get("device"))

        def chain(batch: np.ndarray) -> np.ndarray:
            with torch.inference_mode():
                x = self._apply_chain(torch.from_numpy(batch).to(dev))
                return x.float().cpu().numpy()

        def per_part(p):
            col = p[in_col]
            n = len(col)
            out = np.empty(n, dtype=object)
            # group by input shape: one device batch per unique shape
            by_shape: Dict[tuple, List[int]] = {}
            for i, v in enumerate(col):
                by_shape.setdefault(np.asarray(v).shape, []).append(i)
            for shape, idxs in by_shape.items():
                batch = np.stack([np.asarray(col[i], np.float32) for i in idxs])
                res = chain(batch)
                for j, i in enumerate(idxs):
                    out[i] = res[j]
            return {**p, out_col: out}

        return df.map_partitions(per_part)

    def transform_schema(self, schema):
        schema.require(self.get_or_fail("input_col"))
        return schema.add(self.get_or_fail("output_col"), ColumnType.VECTOR)


class ImageSetAugmenter(Transformer, HasInputCol, HasOutputCol):
    """Emit original + flipped copies (reference ``ImageSetAugmenter.scala``)."""

    flip_left_right = Param("flip_left_right", "add LR flips", "bool", default=True)
    flip_up_down = Param("flip_up_down", "add UD flips", "bool", default=False)
    device = Param("device", DEVICE_DOC, "string", None)

    def _transform(self, df: DataFrame) -> DataFrame:
        in_col = self.get_or_fail("input_col")
        out_col = self.get_or_fail("output_col")
        base = df.with_column(out_col, lambda p: p[in_col])
        outs = [base]
        if self.get("flip_left_right"):
            t = ImageTransformer().set_params(
                input_col=in_col, output_col=out_col,
                device=self.get("device")).flip(1)
            outs.append(t.transform(df))
        if self.get("flip_up_down"):
            t = ImageTransformer().set_params(
                input_col=in_col, output_col=out_col,
                device=self.get("device")).flip(0)
            outs.append(t.transform(df))
        result = outs[0]
        for o in outs[1:]:
            result = result.union(o.select(*result.columns))
        return result
