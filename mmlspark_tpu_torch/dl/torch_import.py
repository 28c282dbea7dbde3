"""Torch model import — the port of ``mmlspark_tpu/dl/torch_import.py``.

Reference capability: CNTKModel loads externally trained graphs
(``CNTKModel.scala:34``).  The reference converts common torch modules into
pure apply functions by extracting their weights, so pretrained torch
checkpoints run under ``JaxModel``; the port keeps that contract and its
names (``torch_to_jax``, ``torch_to_jax_model``), with the apply function
written in torch ops.

Supported layers, as in the reference: Linear, Conv2d, BatchNorm2d (eval),
ReLU/GELU/Tanh/Sigmoid, MaxPool2d, AvgPool2d, AdaptiveAvgPool2d(1),
Flatten, Dropout/Identity (skipped), Sequential nesting; any other layer
raises ``NotImplementedError``.  The reference's semantics are kept where
they differ from the torch module's own forward:

- the input is NHWC for convolutional models (each convolution and pool
  runs on a ``channels_last`` view of it), ``(n, features)`` for MLPs;
- ``Flatten`` flattens NHWC, so (H, W, C) order; it agrees with the torch
  module only where the spatial size is 1 x 1 (after a global pool);
- GELU is the tanh form (``jax.nn.gelu``'s default), whatever the torch
  layer's ``approximate``;
- pools run ``VALID`` (the layer's padding is not read), their stride the
  layer's.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import torch
import torch.nn.functional as F

from .._device import float32_exact


def _pair(v) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def _weights(kind: str, child) -> Dict[str, torch.Tensor]:
    """The layer's weights as float32 CPU tensors, in the layout the apply
    function reads (dense kernels ``(in, out)``, conv kernels OIHW)."""
    def t(p):
        return p.detach().to("cpu", torch.float32).clone()

    if kind == "linear":
        out = {"kernel": t(child.weight).T.contiguous()}
    elif kind == "conv":
        out = {"kernel": t(child.weight)}
    else:                                              # batchnorm
        return {"scale": t(child.weight), "bias": t(child.bias),
                "mean": t(child.running_mean), "var": t(child.running_var)}
    if child.bias is not None:
        out["bias"] = t(child.bias)
    return out


def torch_to_jax(model) -> Tuple[Callable, Dict[str, torch.Tensor]]:
    """Returns ``(apply_fn(state, x), state)``: ``state`` maps
    ``"layer_i.<name>"`` to float32 CPU tensors (a ``ModelRunner`` moves
    them to its device once), and ``apply_fn`` runs on the state's device,
    moving ``x`` there (numpy or a tensor).  ``x`` is NHWC for
    convolutional models, ``(n, features)`` for MLPs."""
    import torch.nn as tnn

    model = model.eval()
    layers: List[Tuple[str, Dict[str, torch.Tensor], Dict[str, Any]]] = []

    def walk(m):
        for child in m.children():
            if isinstance(child, tnn.Sequential):
                walk(child)
            elif isinstance(child, tnn.Linear):
                layers.append(("linear", _weights("linear", child), {}))
            elif isinstance(child, tnn.Conv2d):
                layers.append(("conv", _weights("conv", child),
                               {"stride": child.stride,
                                "padding": child.padding}))
            elif isinstance(child, tnn.BatchNorm2d):
                layers.append(("batchnorm", _weights("batchnorm", child),
                               {"eps": child.eps}))
            elif isinstance(child, tnn.ReLU):
                layers.append(("relu", {}, {}))
            elif isinstance(child, tnn.GELU):
                layers.append(("gelu", {}, {}))
            elif isinstance(child, tnn.Tanh):
                layers.append(("tanh", {}, {}))
            elif isinstance(child, tnn.Sigmoid):
                layers.append(("sigmoid", {}, {}))
            elif isinstance(child, tnn.MaxPool2d):
                layers.append(("maxpool", {}, {"k": child.kernel_size,
                                               "s": child.stride}))
            elif isinstance(child, tnn.AvgPool2d):
                layers.append(("avgpool", {}, {"k": child.kernel_size,
                                               "s": child.stride}))
            elif isinstance(child, tnn.AdaptiveAvgPool2d):
                layers.append(("gap", {}, {}))
            elif isinstance(child, (tnn.Flatten,)):
                layers.append(("flatten", {}, {}))
            elif isinstance(child, (tnn.Dropout, tnn.Identity)):
                pass
            else:
                raise NotImplementedError(
                    f"torch layer {type(child).__name__} not supported")

    walk(model)
    state = {f"layer_{i}.{name}": w for i, (_, p, _) in enumerate(layers)
             for name, w in p.items()}
    specs = [(kind, f"layer_{i}.", cfg) for i, (kind, _, cfg)
             in enumerate(layers)]

    def apply_fn(state, x):
        dev = next(iter(state.values())).device if state else (
            x.device if isinstance(x, torch.Tensor) else torch.device("cpu"))
        x = torch.as_tensor(x, device=dev)
        with float32_exact(dev.type == "cuda"):
            for kind, key, cfg in specs:
                if kind == "linear":
                    x = x @ state[key + "kernel"]
                    if key + "bias" in state:
                        x = x + state[key + "bias"]
                elif kind == "conv":
                    y = F.conv2d(x.permute(0, 3, 1, 2), state[key + "kernel"],
                                 state.get(key + "bias"),
                                 stride=_pair(cfg["stride"]),
                                 padding=_pair(cfg["padding"]))
                    x = y.permute(0, 2, 3, 1)
                elif kind == "batchnorm":
                    x = (x - state[key + "mean"]) / torch.sqrt(
                        state[key + "var"] + cfg["eps"])
                    x = x * state[key + "scale"] + state[key + "bias"]
                elif kind == "relu":
                    x = F.relu(x)
                elif kind == "gelu":
                    x = F.gelu(x, approximate="tanh")
                elif kind == "tanh":
                    x = torch.tanh(x)
                elif kind == "sigmoid":
                    x = torch.sigmoid(x)
                elif kind in ("maxpool", "avgpool"):
                    k = _pair(cfg["k"])
                    s = _pair(cfg["s"] or k)
                    pool = F.max_pool2d if kind == "maxpool" else F.avg_pool2d
                    x = pool(x.permute(0, 3, 1, 2), k, s).permute(0, 2, 3, 1)
                elif kind == "gap":
                    x = x.mean(dim=(1, 2), keepdim=True)
                elif kind == "flatten":
                    x = x.reshape(x.shape[0], -1)
        return x

    return apply_fn, state


def torch_to_jax_model(model, input_col: str = "input",
                       output_col: str = "output", batch_size: int = 64,
                       device=None):
    """Torch module -> ready-to-use ``JaxModel`` transformer, scoring on
    ``device`` (the card unless ``"cpu"``)."""
    from .jax_model import JaxModel
    apply_fn, state = torch_to_jax(model)
    jm = JaxModel()
    jm.set_model(apply_fn=apply_fn, variables=state)
    jm.set_params(input_col=input_col, output_col=output_col,
                  batch_size=batch_size, device=device)
    return jm
