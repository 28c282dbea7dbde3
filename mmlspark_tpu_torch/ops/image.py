"""Device-side image ops on NHWC tensors — the port of
``mmlspark_tpu/ops/image.py``.

Reference: ``opencv/.../ImageTransformer.scala:42-220`` applies per-row JNI
``Mat`` ops (resize/crop/flip/blur/threshold/color).  Here they are batched
tensor ops on ``(N, H, W, C)`` batches, the JAX package's column layout,
on whatever device the batch lies on.  Decode (png/jpg bytes -> array)
stays on the host.

``resize`` matches ``jax.image.resize`` for every method it accepts.  Its
``"linear"`` method antialiases when it shrinks (a triangle kernel widened
by the scale), so a shrinking dimension goes through
``F.interpolate(..., antialias=True)``, which computes the same filter;
growing, both are plain bilinear with half-pixel centres.  ``"nearest"`` is
``"nearest-exact"`` (half-pixel centres, as JAX samples).  ``"cubic"`` (the
Keys kernel with a = -0.5; torch's bicubic has a = -0.75) and
``"lanczos3"`` / ``"lanczos5"`` have no ``F.interpolate`` mode: they build
the separable weight matrices of ``jax.image.scale_and_translate`` (the
kernel widened by the scale when shrinking, half-pixel centres, each
output pixel's weights normalised to sum to one) and apply them as two
small products on the batch's device.
"""
from __future__ import annotations

import math
from typing import Callable, Sequence

import torch
import torch.nn.functional as F

from .._device import float32_exact

_GRAY = (0.299, 0.587, 0.114)

#: per-device constant vectors (``normalize``'s mean and std, the gray
#: weights), made once per device and values.  A captured program's first
#: call is its eager warm-up, which makes them, so the capture itself
#: copies nothing from the host (a pageable copy cannot be captured)
_CONSTS: dict = {}


def _const(values: Sequence[float], device) -> torch.Tensor:
    key = (tuple(float(v) for v in values), str(device))
    t = _CONSTS.get(key)
    if t is None:
        with torch.inference_mode(False):
            t = _CONSTS[key] = torch.tensor(key[0], dtype=torch.float32,
                                            device=device)
    return t


def resize(images: torch.Tensor, height: int, width: int,
           method: str = "linear") -> torch.Tensor:
    """Batched resize, NHWC, float32 out."""
    x = images.float()
    _, h, w, _ = x.shape
    if (h, w) == (height, width):
        return x.clone() if x is images else x
    nchw = x.permute(0, 3, 1, 2)
    if method in ("linear", "bilinear", "trilinear", "triangle"):
        out = F.interpolate(nchw, size=(height, width), mode="bilinear",
                            align_corners=False,
                            antialias=height < h or width < w)
    elif method == "nearest":
        out = F.interpolate(nchw, size=(height, width), mode="nearest-exact")
    else:
        kernel = _KERNELS.get(method)
        if kernel is None:
            raise ValueError(f'Unknown resize method "{method}"')
        return _scale_resize(x, height, width, kernel)
    return out.permute(0, 2, 3, 1)


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    out = ((1.5 * x - 2.5) * x) * x + 1.
    out = torch.where(x >= 1., ((-0.5 * x + 2.5) * x - 4.) * x + 2., out)
    return torch.where(x >= 2., torch.zeros_like(x), out)


def _lanczos(radius: float) -> Callable[[torch.Tensor], torch.Tensor]:
    def kernel(x: torch.Tensor) -> torch.Tensor:
        y = radius * torch.sin(math.pi * x) * torch.sin(math.pi * x / radius)
        safe = torch.where(x != 0, math.pi ** 2 * x ** 2,
                           torch.ones_like(x))
        out = torch.where(x > 1e-3, y / safe, torch.ones_like(x))
        return torch.where(x > radius, torch.zeros_like(x), out)
    return kernel


#: the weighted methods by ``jax.image.ResizeMethod.from_string``'s names
_KERNELS = {"cubic": _keys_cubic, "bicubic": _keys_cubic,
            "tricubic": _keys_cubic, "lanczos3": _lanczos(3.),
            "lanczos5": _lanczos(5.)}


def _weights(in_size: int, out_size: int, kernel, device) -> torch.Tensor:
    """``(in_size, out_size)`` float32 weights of
    ``jax.image.scale_and_translate``'s ``compute_weight_mat`` at scale
    out/in, translation 0 and antialiasing on."""
    f32 = torch.float32
    # float32 scalars as Python floats (no host -> device copy): the same
    # values the float32 tensors held
    inv_scale = float(torch.tensor(in_size / out_size, dtype=f32))
    kernel_scale = max(inv_scale, 1.)
    sample_f = (torch.arange(out_size, dtype=f32, device=device) + 0.5) \
        * inv_scale - 0.5
    x = torch.abs(sample_f[None, :] - torch.arange(
        in_size, dtype=f32, device=device)[:, None]) / kernel_scale
    w = kernel(x)
    total = torch.sum(w, dim=0, keepdim=True)
    w = torch.where(torch.abs(total) > 1000. * float(torch.finfo(f32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def _scale_resize(x: torch.Tensor, height: int, width: int, kernel
                  ) -> torch.Tensor:
    """Separable resize of a float32 NHWC batch: one product per dimension
    whose size changes (float32 throughout, TF32 off on the card)."""
    _, h, w, _ = x.shape
    with float32_exact(x.is_cuda):
        if h != height:
            x = torch.einsum("nhwc,hH->nHwc", x,
                             _weights(h, height, kernel, x.device))
        if w != width:
            x = torch.einsum("nhwc,wW->nhWc", x,
                             _weights(w, width, kernel, x.device))
    return x.contiguous()


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
    return (x - _const(mean, x.device)) / _const(std, x.device)


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
    w = _const(_GRAY, x.device)
    return torch.sum(x * w, dim=-1, keepdim=True)


def unroll(images: torch.Tensor) -> torch.Tensor:
    """(N,H,W,C) -> (N, H*W*C): reference ``UnrollImage`` (image/)."""
    return images.reshape(images.shape[0], -1)
