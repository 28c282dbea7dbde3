"""Device policy of the port.

Entry points take an explicit ``device``.  ``None`` means the card: the port
exists to run on an NVIDIA GPU, so a missing GPU is an error, never a silent
move to the CPU.  Tests and host-only callers pass ``device="cpu"``, which
runs every kernel's plain PyTorch version instead.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Iterator, Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> the current CUDA device (raises without a GPU); anything
    else as given.  A CUDA device always carries its index (``cuda`` ->
    ``cuda:0``), so it compares equal to the device of the tensors on it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "mmlspark_tpu_torch runs on a CUDA device and none is "
                "available; pass device='cpu' to run the plain PyTorch "
                "versions on the host")
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but CUDA is "
                               "not available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def default_quantized(device: torch.device,
                      use_quantized_grad: Optional[bool]) -> bool:
    """``use_quantized_grad=None`` resolves as the JAX package resolves it
    (``mmlspark_tpu/lightgbm/core.py:1550``): packed integer histograms on
    the accelerator, float histograms on the CPU."""
    if use_quantized_grad is None:
        return device.type != "cpu"
    return bool(use_quantized_grad)


_TF32_LOCK = threading.Lock()
_tf32_holders = 0
_tf32_saved = (True, False)


@contextlib.contextmanager
def float32_exact(enabled: bool = True) -> Iterator[None]:
    """Float32 convolutions and matrix products in float32 for the body:
    cuDNN's TF32 (on by default for convolutions) and cuBLAS's (off by
    default) are both switched off, and both flags are restored after, so
    nothing is left changed for the caller.  A float32 model of the port
    computes in float32 on the card, as it does on the CPU; bfloat16 is
    the fast path.

    The flags are process-wide in PyTorch, so bodies on several threads
    share one switch: the first to enter saves and clears the flags, the
    last to leave restores them, under a lock.  While any body runs, TF32
    is off for every thread."""
    global _tf32_holders, _tf32_saved
    if not enabled:
        yield
        return
    with _TF32_LOCK:
        if _tf32_holders == 0:
            _tf32_saved = (torch.backends.cudnn.allow_tf32,
                           torch.backends.cuda.matmul.allow_tf32)
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        _tf32_holders += 1
    try:
        yield
    finally:
        with _TF32_LOCK:
            _tf32_holders -= 1
            if _tf32_holders == 0:
                (torch.backends.cudnn.allow_tf32,
                 torch.backends.cuda.matmul.allow_tf32) = _tf32_saved
