"""Port parity for ONNX export (``mmlspark_tpu_torch/dl/onnx_export.py``)
against the JAX package's exporter, on the CPU: for the same weights the
bytes are equal — GBDT boosters carried across as one model string
(regression with NaN routing, binary, multiclass, RF averaging,
categorical one-vs-rest and sorted-subset chains), a Dense stack, ResNets
from the port's own weights and from flax-layout variables — and the
exports round-trip through the port's ``onnx_import``.

Tolerances: bytes exactly; round trips within the reference's rtol/atol
1e-5 for boosters and 1e-5 for the ResNets' logits (measured ~2e-7: the
same convolutions through ``F.conv2d`` in NCHW and NHWC).
"""
import jax
import numpy as np
import pytest
import torch

from mmlspark_tpu.dl import onnx_export as jax_export
from mmlspark_tpu.lightgbm import core as jax_core
from mmlspark_tpu.lightgbm.core import GBDTParams
from mmlspark_tpu.models import resnet as jax_resnet
from mmlspark_tpu_torch.convert import resnet_state_dict_from_flax
from mmlspark_tpu_torch.dl import (export_gbdt, export_mlp, export_resnet,
                                   onnx_to_jax)
from mmlspark_tpu_torch.models import resnet
from mmlspark_tpu_torch.models.gbdt import GBDTBooster
from tests.test_torch_resnet import seeded_variables

TOL = 1e-5


def _train(objective="regression", n=600, seed=0, **over):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 4)).astype(np.float32)
    if objective == "regression":
        y = X[:, 0] * 2 + np.sin(X[:, 1]) + 0.1 * rng.normal(size=n)
    elif objective == "multiclass":
        y = np.clip((X[:, 0] + X[:, 1] > 0).astype(float)
                    + 2 * (X[:, 2] > 0.5).astype(float), 0, 2)
    else:
        y = (X[:, 0] + X[:, 1] > 0).astype(float)
    kw = dict(num_iterations=5, num_leaves=6, learning_rate=0.3,
              objective=objective, min_data_in_leaf=5)
    kw.update(over)
    return jax_core.train(X, y, GBDTParams(**kw)).booster, X


def _categorical(subset: bool):
    rng = np.random.default_rng(3 if subset else 4)
    n = 1000 if subset else 800
    k = 24 if subset else 4
    codes = rng.integers(0, k, n).astype(np.float32)
    y = (np.isin(codes, rng.choice(24, 12, replace=False)) if subset
         else codes == 2).astype(float)
    X = np.column_stack([codes, rng.normal(size=n).astype(np.float32)])
    booster = jax_core.train(X, y, GBDTParams(
        num_iterations=4 if subset else 3, num_leaves=6 if subset else 4,
        learning_rate=0.5 if subset else 0.1, objective="binary",
        min_data_in_leaf=5, categorical_features=(0,))).booster
    assert (booster.cat_bitset is not None) == subset
    X = X.copy()
    if subset:
        X[::9, 0] = np.nan
        X[1::9, 0] = 99.0                        # an unseen code
    return booster, X


BOOSTERS = {
    "regression": lambda: _train(),
    "binary": lambda: _train("binary"),
    "multiclass": lambda: _train("multiclass", num_class=3),
    "rf": lambda: _train(boosting_type="rf", bagging_fraction=0.8,
                         bagging_freq=1),
    "categorical_subset": lambda: _categorical(True),
    "categorical_onehot": lambda: _categorical(False),
}


@pytest.mark.parametrize("kind", sorted(BOOSTERS))
def test_gbdt_export_bytes_equal_the_reference_and_round_trip(kind):
    ref, X = BOOSTERS[kind]()
    port = GBDTBooster.from_string(ref.to_string())
    data = export_gbdt(port)
    assert data == jax_export.export_gbdt(ref)
    if kind == "regression":
        X = X.copy()
        X[::7, 0] = np.nan
    fn, weights = onnx_to_jax(data, device="cpu")
    out = fn(weights, torch.from_numpy(X))
    scores = (out[1] if isinstance(out, tuple) else out).numpy()
    raw = port.raw_scores(X, device="cpu")
    if scores.shape[1] == 2 and port.objective == "binary":
        np.testing.assert_allclose(scores[:, :1], -raw.reshape(-1, 1),
                                   rtol=TOL, atol=TOL)
        scores = scores[:, 1]
    np.testing.assert_allclose(scores.reshape(raw.shape), raw, rtol=TOL,
                               atol=TOL)


def test_mlp_export_bytes_equal_the_reference_and_round_trip():
    rng = np.random.default_rng(0)
    params = {f"Dense_{i}": {"kernel": rng.normal(size=s).astype(np.float32),
                             "bias": rng.normal(size=s[1]).astype(
                                 np.float32)}
              for i, s in enumerate([(10, 16), (16, 8), (8, 3)])}
    for act, final in (("relu", ""), ("tanh", "sigmoid")):
        data = export_mlp(params, input_dim=10, activation=act,
                          final_activation=final)
        assert data == jax_export.export_mlp(params, input_dim=10,
                                             activation=act,
                                             final_activation=final)
    # CPU tensors are taken as well
    as_tensors = {k: {n: torch.from_numpy(a) for n, a in v.items()}
                  for k, v in params.items()}
    assert export_mlp(as_tensors, input_dim=10) == \
        jax_export.export_mlp(params, input_dim=10)
    x = rng.normal(size=(5, 10)).astype(np.float32)
    h = x
    for i in range(3):
        h = h @ params[f"Dense_{i}"]["kernel"] + params[f"Dense_{i}"]["bias"]
        if i < 2:
            h = np.maximum(h, 0)
    fn, weights = onnx_to_jax(export_mlp(params, input_dim=10), device="cpu")
    np.testing.assert_allclose(fn(weights, torch.from_numpy(x)).numpy(), h,
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("features_only", [False, True])
@pytest.mark.parametrize("block", ["basic", "bottleneck"])
def test_resnet_export_bytes_equal_the_reference_and_round_trip(
        block, features_only):
    """A narrow ResNet with every weight and BN statistic seeded: the
    port's export from its own weights and from the flax variables are the
    reference's bytes; the graph, imported by the port, computes the
    port's ResNet (NCHW in, as the graph declares)."""
    jblock, pblock = {"basic": (jax_resnet.BasicBlock, resnet.BasicBlock),
                      "bottleneck": (jax_resnet.BottleneckBlock,
                                     resnet.BottleneckBlock)}[block]
    ref = jax_resnet.ResNet([1, 1, 1, 1], jblock, 7, num_filters=8)
    variables = seeded_variables(ref, (1, 32, 32, 3), seed=21)
    port = resnet.ResNet([1, 1, 1, 1], pblock, 7, num_filters=8)
    port.load_state_dict(resnet_state_dict_from_flax(variables, port))
    want = jax_export.export_resnet(ref, variables, input_hw=32,
                                    features_only=features_only)
    assert export_resnet(port, input_hw=32,
                         features_only=features_only) == want
    flax_layout = jax.tree_util.tree_map(np.asarray, variables)
    assert export_resnet(port, flax_layout, input_hw=32,
                         features_only=features_only) == want
    x = np.random.default_rng(22).normal(size=(2, 32, 32, 3)).astype(
        np.float32)
    fn, weights = onnx_to_jax(want, device="cpu")
    got = fn(weights, torch.from_numpy(x.transpose(0, 3, 1, 2)))
    with torch.no_grad():
        expect = port(torch.from_numpy(x), features=features_only)
    torch.testing.assert_close(got, expect, rtol=TOL, atol=TOL)


def test_resnet18_export_bytes_equal_the_reference():
    ref = jax_resnet.resnet18(num_classes=5)
    variables = ref.init(jax.random.PRNGKey(0), np.zeros((1, 32, 32, 3),
                                                         np.float32))
    port = resnet.resnet18(num_classes=5)
    port.load_state_dict(resnet_state_dict_from_flax(variables, port))
    assert export_resnet(port, input_hw=32) == \
        jax_export.export_resnet(ref, variables, input_hw=32)


def test_resnet_export_refuses_the_cifar_stem():
    net = resnet.cifar_resnet20(num_classes=3, width=4)
    with pytest.raises(ValueError, match="CIFAR stem"):
        export_resnet(net, input_hw=32)
