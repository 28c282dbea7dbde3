"""ImageTransformer — chained image ops on the device.  The port of
``mmlspark_tpu/opencv/image_transformer.py``.

Reference: ``opencv/.../ImageTransformer.scala:42-220`` applies a pipeline of
JNI ``Mat`` stages (ResizeImage/CropImage/ColorFormat/Flip/Blur/Threshold/
GaussianKernel) per row.  Here the op chain runs as torch ops
(``ops.image``) over NHWC batches on the ``device`` param's device (the
card unless ``"cpu"``), one batch per distinct input shape of a
partition, instead of per-row native calls.

The reference compiles the chain into one ``jax.jit`` program per batch
shape.  Here it is one unbooked program (``observability.compute.
captured``) per frozen stage list, kept on the transformer (so a stage
added after a transform gets a program of its own): on the card a CUDA
graph per (batch shape, device), float32 throughout (TF32 off); on the
CPU the chain runs eagerly.  A partition's images are grouped by shape and
each group goes through in slices of at most ``MAX_ROWS`` rows, each
slice padded with zero images to a power of two (``_row_bucket``), so
groups of every size share a few signatures; the padded rows' outputs are
dropped.  Every stage acts on each image alone, so the rows kept are
those of the unpadded call (ROADMAP fact 3.21).  A pickled transformer
drops its programs.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .._device import float32_exact, resolve_device
from ..core import DataFrame, HasInputCol, HasOutputCol, Param, Transformer
from ..core.schema import ColumnType
from ..observability.compute import captured
from ..ops import image as image_ops

DEVICE_DOC = ("where the op chain runs: unset = the CUDA card (an error "
              "without one), 'cpu' = the host")

#: the most rows of one shape a chain call takes
MAX_ROWS = 64


def _row_bucket(n: int) -> int:
    """The rows a slice of ``n`` (1..``MAX_ROWS``) images is padded to:
    the next power of two."""
    return 1 << (n - 1).bit_length()


def _freeze(value):
    """A stage list as a hashable key (dicts by sorted items, lists as
    tuples)."""
    if isinstance(value, dict):
        return tuple(sorted((k, _freeze(v)) for k, v in value.items()))
    if isinstance(value, (list, tuple)):
        return tuple(_freeze(v) for v in value)
    return value


def _apply_stages(stages: List[Dict[str, Any]], batch: torch.Tensor
                  ) -> torch.Tensor:
    """The op chain ``stages`` over one NHWC batch."""
    x = batch
    for spec in stages:
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
    def _chain_program(self):
        """The program of the current stage list (made at its first
        transform and kept; never pickled)."""
        stages = [dict(spec) for spec in self.get("stages")]
        key = _freeze(stages)
        programs = self.__dict__.setdefault("_programs", {})
        prog = programs.get(key)
        if prog is None:
            prog = programs[key] = captured(
                lambda batch: _apply_stages(stages, batch),
                name="opencv.image_chain")
        return prog

    def __getstate__(self):
        """Pickled and copied without its programs."""
        state = dict(self.__dict__)
        state.pop("_programs", None)
        return state

    def _transform(self, df: DataFrame) -> DataFrame:
        in_col, out_col = self.get_or_fail("input_col"), self.get_or_fail("output_col")
        dev = resolve_device(self.get("device"))
        chain = self._chain_program()

        def run(batch: np.ndarray) -> np.ndarray:
            with torch.inference_mode(), float32_exact(dev.type == "cuda"):
                x = chain(torch.from_numpy(batch).to(dev))
                return x.float().cpu().numpy()

        def per_part(p):
            col = p[in_col]
            n = len(col)
            out = np.empty(n, dtype=object)
            # group by input shape: one device batch per unique shape,
            # sliced and padded to a row bucket
            by_shape: Dict[tuple, List[int]] = {}
            for i, v in enumerate(col):
                by_shape.setdefault(np.asarray(v).shape, []).append(i)
            for shape, idxs in by_shape.items():
                for s in range(0, len(idxs), MAX_ROWS):
                    rows = idxs[s:s + MAX_ROWS]
                    batch = np.zeros((_row_bucket(len(rows)),) + shape,
                                     np.float32)
                    for j, i in enumerate(rows):
                        batch[j] = col[i]
                    res = run(batch)
                    for j, i in enumerate(rows):
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

    def _flipper(self, in_col: str, out_col: str, code: int
                 ) -> ImageTransformer:
        """The flip's ``ImageTransformer``, kept with its program across
        transforms (never pickled)."""
        flippers = self.__dict__.setdefault("_flippers", {})
        key = (in_col, out_col, self.get("device"), code)
        t = flippers.get(key)
        if t is None:
            t = flippers[key] = ImageTransformer().set_params(
                input_col=in_col, output_col=out_col,
                device=self.get("device")).flip(code)
        return t

    def __getstate__(self):
        """Pickled and copied without its flips' programs."""
        state = dict(self.__dict__)
        state.pop("_flippers", None)
        return state

    def _transform(self, df: DataFrame) -> DataFrame:
        in_col = self.get_or_fail("input_col")
        out_col = self.get_or_fail("output_col")
        base = df.with_column(out_col, lambda p: p[in_col])
        outs = [base]
        if self.get("flip_left_right"):
            outs.append(self._flipper(in_col, out_col, 1).transform(df))
        if self.get("flip_up_down"):
            outs.append(self._flipper(in_col, out_col, 0).transform(df))
        result = outs[0]
        for o in outs[1:]:
            result = result.union(o.select(*result.columns))
        return result
