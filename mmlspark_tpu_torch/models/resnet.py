"""ResNet family as ``torch.nn`` modules — the ImageFeaturizer backbone,
the port of ``mmlspark_tpu/models/resnet.py``.

Reference capability: ``deep-learning/.../ImageFeaturizer.scala`` featurizes
images with a pretrained CNN whose head is truncated (``cutOutputLayers``);
here "layer cutting" is ``forward(x, features=True)``, the pooled
penultimate embedding.

The modules compute what the flax modules compute, on the same weights
(``convert.resnet_state_dict_from_flax`` carries them across):

- **NHWC at the boundary**, the JAX package's column layout.  Inside, the
  batch is ``permute(0, 3, 1, 2)``-ed, which is already a ``channels_last``
  NCHW tensor, and the conv weights are kept ``channels_last``, so cuDNN
  takes its NHWC tensor-core path with no copy.
- **flax's ``SAME`` padding.**  flax ``nn.Conv`` pads ``SAME`` by default:
  total = max((ceil(n / s) - 1) * s + k - n, 0), the low side
  ``total // 2``.  At stride 2 on an even size that is (0, 1), which no
  symmetric torch ``padding`` gives; the pads are computed from each
  call's input size, and an asymmetric pair goes through ``F.pad``.  The
  stem's explicit ``(3, 3)`` / ``(1, 1)`` and the max-pool's ``(1, 1)``
  are symmetric torch padding.
- **BatchNorm in eval mode**, eps 1e-5, scale/bias/statistics in float32
  (flax normalizes in float32 and casts to the compute dtype after).
- ``dtype``: float32 or bfloat16 compute (conv and dense weights are held
  in it; flax casts its float32 kernels to it at each call, the same
  rounding), output float32.  Float32 on the card is float32: the forward
  runs with TF32 off (``_device.float32_exact``), restored after the call.

Weights are drawn from a ``torch.Generator`` (seed 0 unless one is given):
flax's initializers (``lecun_normal`` for kernels, zeros for biases, ones
for BN scales, the last BN of each block zero-initialised), not JAX's
random bits — the JAX package's weights for a seed cannot be reproduced
without JAX.  A freshly drawn net therefore never exercises the residual
branch; numerical checks load every BN parameter from a seed instead.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .._device import float32_exact


def same_pads(n: int, k: int, s: int) -> Tuple[int, int]:
    """flax/XLA ``SAME`` padding of one spatial dim: (low, high)."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """Bias-free 2-d convolution with flax's padding: ``SAME`` (computed
    from each input's size) or explicit symmetric ``padding``."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 padding: Optional[int] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.kernel, self.stride, self.padding = kernel, stride, padding
        self.weight = nn.Parameter(torch.empty(
            out_ch, in_ch, kernel, kernel, dtype=dtype).contiguous(
                memory_format=torch.channels_last))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.padding is not None:
            return F.conv2d(x, self.weight, stride=self.stride,
                            padding=self.padding)
        (top, bottom), (left, right) = (
            same_pads(n, self.kernel, self.stride) for n in x.shape[2:])
        if top == bottom and left == right:
            return F.conv2d(x, self.weight, stride=self.stride,
                            padding=(top, left))
        x = F.pad(x, (left, right, top, bottom))
        return F.conv2d(x, self.weight, stride=self.stride)


class BatchNorm(nn.Module):
    """Inference BatchNorm (flax ``use_running_average=True``): float32
    scale, bias and running statistics; the output in the input's dtype."""

    def __init__(self, ch: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))
        self.register_buffer("running_mean", torch.zeros(ch))
        self.register_buffer("running_var", torch.ones(ch))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, False, 0.0, self.eps)


class BottleneckBlock(nn.Module):
    expansion = 4

    def __init__(self, in_ch: int, filters: int, strides: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        out = filters * 4
        self.convs = nn.ModuleList([
            Conv(in_ch, filters, 1, dtype=dtype),
            Conv(filters, filters, 3, strides, dtype=dtype),
            Conv(filters, out, 1, dtype=dtype)])
        self.norms = nn.ModuleList([BatchNorm(filters), BatchNorm(filters),
                                    BatchNorm(out)])
        self.proj = in_ch != out or strides != 1
        if self.proj:
            self.conv_proj = Conv(in_ch, out, 1, strides, dtype=dtype)
            self.norm_proj = BatchNorm(out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x
        for i, (conv, norm) in enumerate(zip(self.convs, self.norms)):
            y = norm(conv(y))
            if i < 2:
                y = F.relu(y)
        residual = self.norm_proj(self.conv_proj(x)) if self.proj else x
        return F.relu(residual + y)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_ch: int, filters: int, strides: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.convs = nn.ModuleList([
            Conv(in_ch, filters, 3, strides, dtype=dtype),
            Conv(filters, filters, 3, dtype=dtype)])
        self.norms = nn.ModuleList([BatchNorm(filters), BatchNorm(filters)])
        self.proj = in_ch != filters or strides != 1
        if self.proj:
            self.conv_proj = Conv(in_ch, filters, 1, strides, dtype=dtype)
            self.norm_proj = BatchNorm(filters)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.norms[0](self.convs[0](x)))
        y = self.norms[1](self.convs[1](y))
        residual = self.norm_proj(self.conv_proj(x)) if self.proj else x
        return F.relu(residual + y)


class ResNet(nn.Module):
    """NHWC ResNet.  ``forward`` returns float32 logits; ``features=True``
    returns the pooled penultimate embedding (the featurizer path, =
    cutOutputLayers=1).  Blocks are numbered across stages as flax numbers
    them (``blocks.i`` is ``BasicBlock_i`` / ``BottleneckBlock_i``)."""

    def __init__(self, stage_sizes: Sequence[int], block_cls,
                 num_classes: int = 1000, num_filters: int = 64,
                 dtype: torch.dtype = torch.float32, cifar_stem: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"dtype must be float32 or bfloat16, got {dtype}")
        self.stage_sizes = [int(s) for s in stage_sizes]
        self.block_cls = block_cls
        self.num_classes = int(num_classes)
        self.num_filters = int(num_filters)
        self.dtype = dtype
        self.cifar_stem = bool(cifar_stem)
        if cifar_stem:
            self.conv_init = Conv(3, num_filters, 3, 1, padding=1, dtype=dtype)
        else:
            self.conv_init = Conv(3, num_filters, 7, 2, padding=3, dtype=dtype)
        self.bn_init = BatchNorm(num_filters)
        blocks, ch = [], num_filters
        for i, count in enumerate(self.stage_sizes):
            for j in range(count):
                filters = num_filters * 2 ** i
                blocks.append(block_cls(ch, filters,
                                        2 if i > 0 and j == 0 else 1, dtype))
                ch = filters * block_cls.expansion
        self.blocks = nn.ModuleList(blocks)
        self.head = nn.Linear(ch, num_classes, dtype=dtype)
        self.reset_parameters(generator)
        self.eval()

    def config(self) -> dict:
        """Constructor arguments, as ``dl.jax_model`` saves them."""
        return {"stage_sizes": self.stage_sizes,
                "block_cls": self.block_cls.__name__,
                "num_classes": self.num_classes,
                "num_filters": self.num_filters,
                "dtype": str(self.dtype).replace("torch.", ""),
                "cifar_stem": self.cifar_stem}

    @classmethod
    def from_config(cls, config: dict) -> "ResNet":
        cfg = dict(config)
        cfg["block_cls"] = {"BasicBlock": BasicBlock,
                            "BottleneckBlock": BottleneckBlock
                            }[cfg["block_cls"]]
        cfg["dtype"] = getattr(torch, cfg["dtype"])
        return cls(**cfg)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """flax's initializers, drawn from ``generator`` (seed 0 if None):
        truncated-normal ``lecun_normal`` kernels (std sqrt(1 / fan_in) /
        0.8796, cut at two standard deviations), zero biases, unit BN
        scales, the last BN of every block zeroed."""
        gen = generator if generator is not None else \
            torch.Generator().manual_seed(0)

        def lecun(w, fan_in):
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            t = torch.empty(w.shape, dtype=torch.float32)
            nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
            w.copy_(t * std)

        for m in self.modules():
            if isinstance(m, Conv):
                o, i, kh, kw = m.weight.shape
                lecun(m.weight, i * kh * kw)
            elif isinstance(m, BatchNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
        for block in self.blocks:
            block.norms[-1].weight.zero_()
        lecun(self.head.weight, self.head.in_features)
        self.head.bias.zero_()

    def forward(self, x: torch.Tensor, features: bool = False
                ) -> torch.Tensor:
        with float32_exact(self.dtype == torch.float32 and x.is_cuda):
            x = x.to(self.dtype).permute(0, 3, 1, 2)
            x = F.relu(self.bn_init(self.conv_init(x)))
            if not self.cifar_stem:
                x = F.max_pool2d(x, 3, 2, padding=1)
            for block in self.blocks:
                x = block(x)
            x = x.mean(dim=(2, 3), dtype=torch.float32).to(self.dtype)
            if features:
                return x.float()
            return self.head(x).float()


def resnet18(num_classes: int = 1000, dtype=torch.float32,
             generator: Optional[torch.Generator] = None) -> ResNet:
    return ResNet([2, 2, 2, 2], BasicBlock, num_classes, dtype=dtype,
                  generator=generator)


def resnet34(num_classes: int = 1000, dtype=torch.float32,
             generator: Optional[torch.Generator] = None) -> ResNet:
    return ResNet([3, 4, 6, 3], BasicBlock, num_classes, dtype=dtype,
                  generator=generator)


def resnet50(num_classes: int = 1000, dtype=torch.float32,
             generator: Optional[torch.Generator] = None) -> ResNet:
    return ResNet([3, 4, 6, 3], BottleneckBlock, num_classes, dtype=dtype,
                  generator=generator)


def resnet101(num_classes: int = 1000, dtype=torch.float32,
              generator: Optional[torch.Generator] = None) -> ResNet:
    return ResNet([3, 4, 23, 3], BottleneckBlock, num_classes, dtype=dtype,
                  generator=generator)


def cifar_resnet20(num_classes: int = 10, width: int = 32,
                   dtype=torch.float32,
                   generator: Optional[torch.Generator] = None) -> ResNet:
    """CIFAR-scale ResNet-20 (He et al. §4.2 topology: 3 stages x 3 basic
    blocks, 3x3 stem, no maxpool) — the backbone of the committed
    model-repo checkpoint ``artifacts/model_repo/ShapesResNet20``."""
    return ResNet([3, 3, 3], BasicBlock, num_classes, num_filters=width,
                  cifar_stem=True, dtype=dtype, generator=generator)
