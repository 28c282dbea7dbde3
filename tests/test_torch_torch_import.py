"""Port parity for torch model import (``mmlspark_tpu_torch/dl/
torch_import.py``) against the JAX package's ``torch_to_jax`` on the same
torch modules and seeded inputs, on the CPU: every supported layer, the
unsupported-layer error, and ``torch_to_jax_model`` through ``JaxModel``.

Tolerance: float32 outputs within atol 1e-5 (measured up to ~5e-7: the
same convolutions through ``F.conv2d`` on a ``channels_last`` view against
XLA's NHWC convolution).
"""
import numpy as np
import pytest
import torch
import torch.nn as tnn

from mmlspark_tpu.dl.torch_import import torch_to_jax as jax_torch_to_jax
from mmlspark_tpu_torch.core import DataFrame
from mmlspark_tpu_torch.dl import torch_to_jax, torch_to_jax_model

ATOL = 1e-5


def _seeded(net: tnn.Module, seed: int) -> tnn.Module:
    torch.manual_seed(seed)
    for m in net.modules():
        if isinstance(m, tnn.BatchNorm2d):
            with torch.no_grad():
                m.weight.uniform_(0.5, 1.5)
                m.bias.normal_(0, 0.2)
                m.running_mean.normal_(0, 0.2)
                m.running_var.uniform_(0.5, 1.5)
    return net.eval()


NETS = {
    "mlp_relu": (lambda: tnn.Sequential(
        tnn.Linear(6, 8), tnn.ReLU(), tnn.Dropout(0.5), tnn.Linear(8, 3)),
        (5, 6)),
    "mlp_acts": (lambda: tnn.Sequential(
        tnn.Linear(6, 8), tnn.GELU(), tnn.Linear(8, 8, bias=False),
        tnn.Tanh(), tnn.Sequential(tnn.Linear(8, 2), tnn.Sigmoid()),
        tnn.Identity()), (5, 6)),
    "cnn_gap": (lambda: tnn.Sequential(
        tnn.Conv2d(3, 4, 3, padding=1), tnn.BatchNorm2d(4), tnn.ReLU(),
        tnn.MaxPool2d(2), tnn.Conv2d(4, 6, 3, stride=2, bias=False),
        tnn.GELU(), tnn.AdaptiveAvgPool2d(1), tnn.Flatten(),
        tnn.Linear(6, 3)), (2, 16, 16, 3)),
    "cnn_flatten": (lambda: tnn.Sequential(
        tnn.Conv2d(3, 5, (3, 1), stride=(1, 2), padding=(1, 0)),
        tnn.Sigmoid(), tnn.AvgPool2d(2, stride=1), tnn.Flatten(),
        tnn.Linear(5 * 7 * 3, 4)), (3, 8, 8, 3)),
}


@pytest.mark.parametrize("name", sorted(NETS))
def test_supported_layers_equal_the_reference(name):
    make, shape = NETS[name]
    net = _seeded(make(), seed=len(name))
    x = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    jfn, jvars = jax_torch_to_jax(net)
    want = np.asarray(jfn(jvars, x))
    fn, state = torch_to_jax(net)
    assert all(v.device.type == "cpu" and v.dtype == torch.float32
               for v in state.values())
    got = fn(state, x)
    assert isinstance(got, torch.Tensor) and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_where_the_reference_agrees_with_the_torch_module():
    """After a global pool the NHWC flatten is the module's own; so is a
    tanh GELU: the imported function computes the torch module."""
    net = _seeded(tnn.Sequential(
        tnn.Conv2d(3, 4, 3, padding=1), tnn.BatchNorm2d(4),
        tnn.GELU(approximate="tanh"), tnn.AdaptiveAvgPool2d(1),
        tnn.Flatten(), tnn.Linear(4, 2)), seed=3)
    x = np.random.default_rng(2).normal(size=(4, 10, 10, 3)).astype(
        np.float32)
    fn, state = torch_to_jax(net)
    with torch.no_grad():
        want = net(torch.from_numpy(x).permute(0, 3, 1, 2))
    torch.testing.assert_close(fn(state, x), want, rtol=ATOL, atol=ATOL)


def test_unsupported_layers_raise_as_in_the_reference():
    net = tnn.Sequential(tnn.Linear(3, 3), tnn.LayerNorm(3))
    for convert in (jax_torch_to_jax, torch_to_jax):
        with pytest.raises(NotImplementedError, match="LayerNorm"):
            convert(net)


def test_apply_runs_on_the_states_device_and_the_model_scores_columns():
    net = _seeded(NETS["mlp_relu"][0](), seed=4)
    fn, state = torch_to_jax(net)
    x = np.random.default_rng(3).normal(size=(7, 6)).astype(np.float32)
    meta = {k: v.to("meta") for k, v in state.items()}
    assert fn(meta, x).device.type == "meta"
    jm = torch_to_jax_model(net, input_col="x", output_col="y",
                            batch_size=4, device="cpu")
    col = np.empty(7, dtype=object)
    for i in range(7):
        col[i] = x[i]
    out = np.stack(list(jm.transform(DataFrame.from_dict({"x": col}))
                        .collect()["y"]))
    np.testing.assert_allclose(out, fn(state, x).numpy(), atol=0)
    assert jm.runner().bucket_calls == {4: 2}
