"""Device policy of the port.

Entry points take an explicit ``device``.  ``None`` means the card: the port
exists to run on an NVIDIA GPU, so a missing GPU is an error, never a silent
move to the CPU.  Tests and host-only callers pass ``device="cpu"``, which
runs every kernel's plain PyTorch version instead.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda`` (raises without a GPU); anything else as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "mmlspark_tpu_torch runs on a CUDA device and none is "
                "available; pass device='cpu' to run the plain PyTorch "
                "versions on the host")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           "available")
    return dev


def default_quantized(device: torch.device,
                      use_quantized_grad: Optional[bool]) -> bool:
    """``use_quantized_grad=None`` resolves as the JAX package resolves it
    (``mmlspark_tpu/lightgbm/core.py:1550``): packed integer histograms on
    the accelerator, float histograms on the CPU."""
    if use_quantized_grad is None:
        return device.type != "cpu"
    return bool(use_quantized_grad)
