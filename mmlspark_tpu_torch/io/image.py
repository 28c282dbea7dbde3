"""Image IO — decode image files/bytes into array columns.

An own copy of the JAX package's ``io/image.py``, verbatim apart from
module paths.

Reference: ``PatchedImageFileFormat`` (Spark image source) + ``ImageUtils``
(``io/image/ImageUtils.scala``).  Decode stays host-side (PIL); the decoded
NHWC arrays feed ``ops.image`` / ``dl.ImageFeaturizer`` on device.
"""
from __future__ import annotations

import io as _io
from typing import Optional

import numpy as np

from ..core import DataFrame
from .binary import read_binary_files


def decode_image(data: bytes, channels: int = 3) -> Optional[np.ndarray]:
    try:
        from PIL import Image
        img = Image.open(_io.BytesIO(data))
        img = img.convert("RGB" if channels == 3 else "L")
        return np.asarray(img, dtype=np.uint8)
    except Exception:  # noqa: BLE001 — unreadable images become None
        return None


def read_images(path: str, pattern: str = "*", recursive: bool = True,
                num_partitions: int = 1, drop_invalid: bool = True) -> DataFrame:
    """Directory -> frame with (path, image) columns; image is HWC uint8."""
    df = read_binary_files(path, pattern, recursive, num_partitions)
    def per_part(p):
        imgs = np.empty(len(p["path"]), dtype=object)
        for i, b in enumerate(p["bytes"]):
            imgs[i] = decode_image(b)
        return {"path": p["path"], "image": imgs}
    out = df.map_partitions(per_part)
    if drop_invalid:
        out = out.filter(lambda p: np.asarray([v is not None for v in p["image"]]))
    return out


def images_to_bytes_column(df: DataFrame, image_col: str = "image",
                           fmt: str = "PNG", out_col: str = "bytes") -> DataFrame:
    from PIL import Image

    def per_part(p):
        out = np.empty(len(p[image_col]), dtype=object)
        for i, arr in enumerate(p[image_col]):
            buf = _io.BytesIO()
            Image.fromarray(np.asarray(arr, np.uint8)).save(buf, fmt)
            out[i] = buf.getvalue()
        return {**p, out_col: out}

    return df.map_partitions(per_part)
