"""Device-side image ops on NHWC tensors — the port of
``mmlspark_tpu/ops/image.py``.

Reference: ``opencv/.../ImageTransformer.scala:42-220`` applies per-row JNI
``Mat`` ops (resize/crop/flip/blur/threshold/color).  Here they are batched
tensor ops on ``(N, H, W, C)`` batches, the JAX package's column layout,
on whatever device the batch lies on.  Decode (png/jpg bytes -> array)
stays on the host.

``resize`` matches ``jax.image.resize``: its ``"linear"`` method
antialiases when it shrinks (a triangle kernel widened by the scale), so a
shrinking dimension goes through ``F.interpolate(..., antialias=True)``,
which computes the same filter; growing, both are plain bilinear with
half-pixel centres.  ``"nearest"`` is ``"nearest-exact"`` (half-pixel
centres, as JAX samples).
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

_GRAY = (0.299, 0.587, 0.114)


def resize(images: torch.Tensor, height: int, width: int,
           method: str = "linear") -> torch.Tensor:
    """Batched resize, NHWC, float32 out."""
    x = images.float()
    _, h, w, _ = x.shape
    if (h, w) == (height, width):
        return x.clone() if x is images else x
    nchw = x.permute(0, 3, 1, 2)
    if method in ("linear", "bilinear"):
        out = F.interpolate(nchw, size=(height, width), mode="bilinear",
                            align_corners=False,
                            antialias=height < h or width < w)
    elif method == "nearest":
        out = F.interpolate(nchw, size=(height, width), mode="nearest-exact")
    else:
        raise NotImplementedError(
            f"resize method {method!r}: the port has 'linear' and "
            "'nearest' (jax.image.resize's other kernels have no torch twin)")
    return out.permute(0, 2, 3, 1)


def center_crop(images: torch.Tensor, height: int, width: int
                ) -> torch.Tensor:
    _, h, w, _ = images.shape
    top = max(0, (h - height) // 2)
    left = max(0, (w - width) // 2)
    return images[:, top:top + height, left:left + width, :]


def crop(images: torch.Tensor, x: int, y: int, height: int, width: int
         ) -> torch.Tensor:
    return images[:, y:y + height, x:x + width, :]


def flip(images: torch.Tensor, horizontal: bool = True) -> torch.Tensor:
    return torch.flip(images, dims=(2 if horizontal else 1,))


def normalize(images: torch.Tensor,
              mean: Sequence[float] = (0.485, 0.456, 0.406),
              std: Sequence[float] = (0.229, 0.224, 0.225),
              scale: float = 1.0 / 255.0) -> torch.Tensor:
    x = images.float() * scale
    m = torch.tensor(mean, dtype=torch.float32, device=x.device)
    s = torch.tensor(std, dtype=torch.float32, device=x.device)
    return (x - m) / s


def gaussian_kernel(size: int, sigma: float, device=None) -> torch.Tensor:
    ax = torch.arange(size, dtype=torch.float32, device=device) \
        - (size - 1) / 2.0
    g = torch.exp(-(ax ** 2) / (2.0 * sigma ** 2))
    k = torch.outer(g, g)
    return k / torch.sum(k)


def blur(images: torch.Tensor, kernel_size: int = 5, sigma: float = 1.0
         ) -> torch.Tensor:
    """Depthwise gaussian blur with ``SAME`` padding: one ``groups=C``
    convolution whose ``(C, 1, k, k)`` weight is the JAX package's HWIO
    depthwise kernel ``(k, k, 1, C)`` laid out as OIHW."""
    x = images.float()
    c = x.shape[-1]
    k = gaussian_kernel(kernel_size, sigma, device=x.device)
    weight = k[None, None].expand(c, 1, kernel_size, kernel_size)
    total = kernel_size - 1               # SAME at stride 1
    lo, hi = total // 2, total - total // 2
    nchw = F.pad(x.permute(0, 3, 1, 2), (lo, hi, lo, hi))
    return F.conv2d(nchw, weight, groups=c).permute(0, 2, 3, 1)


def threshold(images: torch.Tensor, thresh: float, max_val: float = 255.0,
              kind: str = "binary") -> torch.Tensor:
    x = images.float()
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    top = torch.full((), max_val, dtype=x.dtype, device=x.device)
    if kind == "binary":
        return torch.where(x > thresh, top, zero)
    if kind == "binary_inv":
        return torch.where(x > thresh, zero, top)
    if kind == "trunc":
        return torch.clamp(x, max=thresh)
    if kind == "tozero":
        return torch.where(x > thresh, x, zero)
    if kind == "tozero_inv":
        return torch.where(x > thresh, zero, x)
    raise ValueError(f"unknown threshold kind {kind!r}")


def to_grayscale(images: torch.Tensor) -> torch.Tensor:
    """RGB -> single-channel luminance (color-format op equivalent)."""
    x = images.float()
    w = torch.tensor(_GRAY, dtype=torch.float32, device=x.device)
    return torch.sum(x * w, dim=-1, keepdim=True)


def unroll(images: torch.Tensor) -> torch.Tensor:
    """(N,H,W,C) -> (N, H*W*C): reference ``UnrollImage`` (image/)."""
    return images.reshape(images.shape[0], -1)
