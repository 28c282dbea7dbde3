"""Port parity for ONNX import (``mmlspark_tpu_torch/dl/onnx_import.py``,
``dl/onnx_wire.py``): the op graphs of ``tests/test_onnx_import.py`` and
``tests/test_onnx_export.py`` go through both packages' ``onnx_to_jax``
on the same seeded inputs, on the CPU; the committed ``DigitsMLP`` graph
reaches its pinned held-out accuracy through the port's repository.

Tolerances: integer outputs and pooling identical; float outputs within
rtol 1e-5 / atol 1e-5 of the JAX package's (the same float32 arithmetic,
summed in another order), and, where the graph came from a torch module,
within the reference tests' rtol 1e-4 / atol 1e-4 of torch's forward;
tree-ensemble margins within 1e-5 (float32 sums of leaf weights over the
trees); DigitsMLP's accuracy within 0.01 of the pinned 0.9889, as
``tests/test_model_repo_artifact.py`` holds the JAX package's.
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as tnn

from mmlspark_tpu.core import DataFrame as JaxDataFrame
from mmlspark_tpu.dl import ImageFeaturizer as JaxFeaturizer
from mmlspark_tpu.dl import ModelDownloader as JaxDownloader
from mmlspark_tpu.dl import onnx_import as jax_onnx
from mmlspark_tpu.dl import onnx_wire as jax_wire
from mmlspark_tpu.dl.onnx_export import export_gbdt, export_resnet
from mmlspark_tpu.lightgbm import core as jax_gbdt
from mmlspark_tpu.lightgbm.core import GBDTParams as JaxParams
from mmlspark_tpu.models import resnet as jax_resnet
from mmlspark_tpu_torch.core import DataFrame
from mmlspark_tpu_torch.dl import (ImageFeaturizer, JaxModel,
                                   ModelDownloader, OnnxModelPayload,
                                   onnx_to_jax, onnx_to_jax_model)
from mmlspark_tpu_torch.dl.onnx_wire import (build_model, encode_node,
                                             parse_model)
from tests.test_torch_resnet import seeded_variables

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_DIR = os.path.join(ROOT, "artifacts", "model_repo")


def _t2n(t):
    return t.detach().numpy()


def _np(out):
    if isinstance(out, tuple):
        return tuple(_np(o) for o in out)
    if isinstance(out, torch.Tensor):
        return out.numpy()
    return np.asarray(out)


def both(data: bytes, *inputs, **kw):
    """(port outputs, JAX outputs) of one ONNX graph on the same inputs."""
    fn, variables = onnx_to_jax(data, **kw)
    jfn, jvars = jax_onnx.onnx_to_jax(data, **kw)
    got = _np(fn(variables, *(torch.from_numpy(x) for x in inputs)))
    want = _np(jfn(jvars, *inputs))
    return got, want


def assert_close(got, want, rtol=1e-5, atol=1e-5):
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            assert_close(g, w, rtol, atol)
        return
    assert got.shape == want.shape
    if want.dtype.kind in "iub":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def test_wire_codec_is_the_reference_codec():
    w = np.arange(12, dtype=np.float32).reshape(3, 4)
    nodes = [encode_node("Relu", ["x"], ["y"]),
             encode_node("Dummy", ["y"], ["z"], modes=[b"LEAF", b"BRANCH"],
                         alpha=0.5, k=3, ks=[1, 2], s="v")]
    data = build_model(nodes, {"w": w}, [("x", [2, 3])], [("z", [2, 3])])
    ref = jax_wire.build_model(
        [jax_wire.encode_node("Relu", ["x"], ["y"]),
         jax_wire.encode_node("Dummy", ["y"], ["z"],
                              modes=[b"LEAF", b"BRANCH"], alpha=0.5, k=3,
                              ks=[1, 2], s="v")],
        {"w": w}, [("x", [2, 3])], [("z", [2, 3])])
    assert data == ref
    g = parse_model(data)
    assert [n.op_type for n in g.nodes] == ["Relu", "Dummy"]
    np.testing.assert_array_equal(g.initializers["w"], w)
    assert g.inputs[0].name == "x" and g.inputs[0].shape == [2, 3]


def _cnn(seed, conv_ch=8, hw=32, classes=10):
    torch.manual_seed(seed)
    m = tnn.Sequential(tnn.Conv2d(3, conv_ch, 3, stride=2, padding=1),
                       tnn.BatchNorm2d(conv_ch), tnn.ReLU(), tnn.MaxPool2d(2),
                       tnn.Flatten(),
                       tnn.Linear(conv_ch * (hw // 4) ** 2, classes)).eval()
    with torch.no_grad():
        m[1].running_mean.uniform_(-0.5, 0.5)
        m[1].running_var.uniform_(0.5, 1.5)
    conv, bn, _relu, _pool, _flat, lin = m
    init = {
        "conv.w": _t2n(conv.weight), "conv.b": _t2n(conv.bias),
        "bn.s": _t2n(bn.weight), "bn.b": _t2n(bn.bias),
        "bn.m": _t2n(bn.running_mean), "bn.v": _t2n(bn.running_var),
        "fc.w": _t2n(lin.weight), "fc.b": _t2n(lin.bias),
    }
    nodes = [
        encode_node("Conv", ["x", "conv.w", "conv.b"], ["c1"],
                    kernel_shape=[3, 3], strides=[2, 2], pads=[1, 1, 1, 1]),
        encode_node("BatchNormalization",
                    ["c1", "bn.s", "bn.b", "bn.m", "bn.v"], ["b1"],
                    epsilon=float(bn.eps)),
        encode_node("Relu", ["b1"], ["r1"]),
        encode_node("MaxPool", ["r1"], ["p1"], kernel_shape=[2, 2],
                    strides=[2, 2]),
        encode_node("Flatten", ["p1"], ["f1"], axis=1),
        encode_node("Gemm", ["f1", "fc.w", "fc.b"], ["y"], transB=1),
    ]
    data = build_model(nodes, init, [("x", [2, 3, hw, hw])],
                       [("y", [2, classes])])
    return m, data


def test_cnn_equals_jax_and_torch():
    m, data = _cnn(0)
    x = torch.randn(2, 3, 32, 32, generator=torch.Generator().manual_seed(0))
    got, want = both(data, x.numpy())
    assert_close(got, want)
    with torch.no_grad():
        np.testing.assert_allclose(got, m(x).numpy(), rtol=1e-4, atol=1e-4)


def test_residual_block_and_gap_equal_jax():
    rng = np.random.default_rng(1)
    init = {"w1": rng.normal(size=(4, 4, 3, 3)).astype(np.float32) / 6,
            "w2": rng.normal(size=(4, 4, 3, 3)).astype(np.float32) / 6}
    nodes = [
        encode_node("Conv", ["x", "w1"], ["c1"], kernel_shape=[3, 3],
                    pads=[1, 1, 1, 1]),
        encode_node("Relu", ["c1"], ["r1"]),
        encode_node("Conv", ["r1", "w2"], ["c2"], kernel_shape=[3, 3],
                    pads=[1, 1, 1, 1]),
        encode_node("Add", ["x", "c2"], ["s"]),
        encode_node("GlobalAveragePool", ["s"], ["g"]),
        encode_node("Flatten", ["g"], ["y"], axis=1),
    ]
    data = build_model(nodes, init, [("x", [2, 4, 16, 16])], [("y", [2, 4])])
    x = rng.normal(size=(2, 4, 16, 16)).astype(np.float32)
    assert_close(*both(data, x))


POOLS = {
    "avg_exclude_pad": ("AveragePool", dict(kernel_shape=[3, 3],
                                            strides=[2, 2],
                                            pads=[1, 1, 1, 1]), (7, 7)),
    "avg_include_pad": ("AveragePool", dict(kernel_shape=[3, 3],
                                            strides=[2, 2],
                                            pads=[1, 1, 1, 1],
                                            count_include_pad=1), (7, 7)),
    "avg_ceil_include_pad": ("AveragePool", dict(kernel_shape=[2, 2],
                                                 strides=[2, 2], ceil_mode=1,
                                                 count_include_pad=1),
                             (3, 3)),
    "avg_ceil_pads": ("AveragePool", dict(kernel_shape=[3, 3],
                                          strides=[2, 2], ceil_mode=1,
                                          pads=[1, 0, 1, 0]), (8, 9)),
    "max_ceil": ("MaxPool", dict(kernel_shape=[3, 3], strides=[2, 2],
                                 ceil_mode=1), (8, 8)),
    "max_same_upper": ("MaxPool", dict(kernel_shape=[2, 2], strides=[2, 2],
                                       auto_pad="SAME_UPPER"), (5, 4)),
    "max_same_lower": ("MaxPool", dict(kernel_shape=[3, 3], strides=[2, 2],
                                       auto_pad="SAME_LOWER"), (6, 7)),
    "max_1d": ("MaxPool", dict(kernel_shape=[3], strides=[2],
                               pads=[1, 1]), (9,)),
}


@pytest.mark.parametrize("name", sorted(POOLS))
def test_pools_equal_jax(name):
    op, attrs, spatial = POOLS[name]
    x = np.random.default_rng(2).normal(size=(1, 2) + spatial).astype(
        np.float32)
    data = build_model([encode_node(op, ["x"], ["y"], **attrs)], {},
                       [("x", list(x.shape))], [("y", [1])])
    assert_close(*both(data, x))


@pytest.mark.parametrize("auto", ["SAME_UPPER", "SAME_LOWER", "VALID"])
@pytest.mark.parametrize("hw", [8, 9])
def test_conv_auto_pad_equals_jax(auto, hw):
    rng = np.random.default_rng(hw)
    w = rng.normal(size=(3, 2, 3, 3)).astype(np.float32)
    data = build_model([encode_node("Conv", ["x", "w"], ["y"],
                                    kernel_shape=[3, 3], strides=[2, 2],
                                    auto_pad=auto)],
                       {"w": w}, [("x", [1, 2, hw, hw])], [("y", [1])])
    x = rng.normal(size=(1, 2, hw, hw)).astype(np.float32)
    assert_close(*both(data, x))


def test_grouped_dilated_1d_conv_and_asymmetric_pads_equal_jax():
    rng = np.random.default_rng(7)
    w1 = rng.normal(size=(4, 2, 3)).astype(np.float32)
    w2 = rng.normal(size=(4, 4, 2, 2)).astype(np.float32)
    d1 = build_model([encode_node("Conv", ["x", "w"], ["y"],
                                  kernel_shape=[3], dilations=[2], group=2,
                                  pads=[2, 1])],
                     {"w": w1}, [("x", [1, 4, 11])], [("y", [1])])
    assert_close(*both(d1, rng.normal(size=(1, 4, 11)).astype(np.float32)))
    d2 = build_model([encode_node("Conv", ["x", "w"], ["y"],
                                  kernel_shape=[2, 2], pads=[0, 1, 1, 0])],
                     {"w": w2}, [("x", [1, 4, 5, 6])], [("y", [1])])
    assert_close(*both(d2, rng.normal(size=(1, 4, 5, 6)).astype(np.float32)))


ELEMENTWISE = {
    "Sigmoid": {}, "Tanh": {}, "Erf": {}, "Exp": {}, "Neg": {}, "Abs": {},
    "Relu": {}, "LeakyRelu": {"alpha": 0.2}, "Softmax": {"axis": 1},
    "Clip": {"min": -0.5, "max": 0.7}, "Dropout": {}, "Identity": {},
}


@pytest.mark.parametrize("op", sorted(ELEMENTWISE))
def test_unary_ops_equal_jax(op):
    x = np.random.default_rng(3).normal(size=(3, 5)).astype(np.float32)
    data = build_model([encode_node(op, ["x"], ["y"], **ELEMENTWISE[op])],
                       {}, [("x", [3, 5])], [("y", [3, 5])])
    assert_close(*both(data, x))


def test_arithmetic_and_shape_ops_equal_jax():
    """Positive-only ops on |x| + 0.5; the rest on x; host constants mixed
    with device tensors."""
    rng = np.random.default_rng(4)
    init = {"b": rng.normal(size=(5,)).astype(np.float32),
            "m": rng.normal(size=(5, 4)).astype(np.float32),
            "two": np.asarray(2.0, np.float32),
            "idx": np.asarray([2, 0, -1], np.int64),
            "starts": np.asarray([1, 0], np.int64),
            "ends": np.asarray([3, 5], np.int64),
            "axes": np.asarray([0, 1], np.int64),
            "steps": np.asarray([1, 2], np.int64),
            "pads": np.asarray([0, 1, 1, 0], np.int64)}
    nodes = [
        encode_node("Abs", ["x"], ["ax"]),
        encode_node("Constant", [], ["half"], value_float=0.5),
        encode_node("Add", ["ax", "half"], ["pos"]),
        encode_node("Sqrt", ["pos"], ["sq"]),
        encode_node("Reciprocal", ["sq"], ["rc"]),
        encode_node("Pow", ["pos", "two"], ["pw"]),
        encode_node("Sub", ["pw", "b"], ["sb"]),
        encode_node("Mul", ["sb", "rc"], ["ml"]),
        encode_node("Div", ["ml", "pos"], ["dv"]),
        encode_node("MatMul", ["dv", "m"], ["mm"]),
        encode_node("Transpose", ["mm"], ["tr"], perm=[1, 0]),
        encode_node("Gather", ["tr", "idx"], ["ga"], axis=1),
        encode_node("Slice", ["x", "starts", "ends", "axes", "steps"],
                    ["sl"]),
        encode_node("Pad", ["sl", "pads"], ["pd"]),
        encode_node("Unsqueeze", ["pd"], ["us"], axes=[0]),
        encode_node("Squeeze", ["us"], ["sqz"], axes=[0]),
        encode_node("Concat", ["sqz", "sqz"], ["cc"], axis=1),
        encode_node("ReduceMean", ["cc"], ["rm"], axes=[1], keepdims=0),
        encode_node("Cast", ["idx"], ["fidx"], to=1),
        encode_node("Mul", ["rm", "two"], ["out2"]),
    ]
    data = build_model(nodes, init, [("x", [3, 5])],
                       [("ga", [4, 3]), ("out2", [2]), ("fidx", [3])])
    x = rng.normal(size=(3, 5)).astype(np.float32)
    got, want = both(data, x)
    assert_close(got, want)
    np.testing.assert_array_equal(got[2], [2.0, 0.0, -1.0])


@pytest.mark.parametrize("bidi", [False, True])
def test_lstm_equals_jax_and_torch(bidi):
    torch.manual_seed(3)
    lstm = tnn.LSTM(input_size=5, hidden_size=7, bidirectional=bidi).eval()
    x = torch.randn(9, 2, 5)

    def reorder(w):                      # torch ifgo -> ONNX iofc
        i, f, g, o = np.split(w, 4, axis=0)
        return np.concatenate([i, o, f, g], axis=0)

    Ws, Rs, Bs = [], [], []
    for sfx in ("", "_reverse")[: 2 if bidi else 1]:
        Ws.append(reorder(_t2n(getattr(lstm, f"weight_ih_l0{sfx}"))))
        Rs.append(reorder(_t2n(getattr(lstm, f"weight_hh_l0{sfx}"))))
        Bs.append(np.concatenate([
            reorder(_t2n(getattr(lstm, f"bias_ih_l0{sfx}"))[:, None])[:, 0],
            reorder(_t2n(getattr(lstm, f"bias_hh_l0{sfx}"))[:, None])[:, 0]]))
    dirs = 2 if bidi else 1
    nodes = [encode_node("LSTM", ["x", "W", "R", "B"], ["Y", "Y_h", "Y_c"],
                         hidden_size=7,
                         direction="bidirectional" if bidi else "forward"),
             encode_node("Transpose", ["Y"], ["Yt"], perm=[0, 2, 1, 3]),
             encode_node("Reshape", ["Yt", "yshape"], ["out"])]
    init = {"W": np.stack(Ws), "R": np.stack(Rs), "B": np.stack(Bs),
            "yshape": np.asarray([9, 2, dirs * 7], np.int64)}
    data = build_model(nodes, init, [("x", [9, 2, 5])],
                       [("out", [9, 2, dirs * 7]), ("Y_h", [dirs, 2, 7]),
                        ("Y_c", [dirs, 2, 7])])
    got, want = both(data, x.numpy())
    assert_close(got, want)
    with torch.no_grad():
        y, (h, c) = lstm(x)
    for g, w in zip(got, (y, h, c)):
        np.testing.assert_allclose(g, w.numpy(), rtol=1e-4, atol=1e-5)


def test_shape_machinery_folds_on_host():
    """Shape -> Gather -> Unsqueeze -> Concat -> Reshape chains stay numpy
    on the host; only the data tensor runs as torch."""
    nodes = [
        encode_node("Shape", ["x"], ["sh"]),
        encode_node("Gather", ["sh", "zero"], ["n"], axis=0),
        encode_node("Unsqueeze", ["n"], ["n1"], axes=[0]),
        encode_node("Concat", ["n1", "minus1"], ["target"], axis=0),
        encode_node("ConstantOfShape", ["target2"], ["ones"],
                    value=np.ones(1, np.float32)),
        encode_node("Reshape", ["x", "target"], ["y"]),
    ]
    init = {"zero": np.asarray(0, np.int64),
            "minus1": np.asarray([-1], np.int64),
            "target2": np.asarray([2, 2], np.int64)}
    data = build_model(nodes, init, [("x", [3, 4, 5])],
                       [("y", [3, 20]), ("target", [2]), ("ones", [2, 2])])
    x = np.random.default_rng(0).normal(size=(3, 4, 5)).astype(np.float32)
    fn, variables = onnx_to_jax(data)
    y, target, ones = fn(variables, torch.from_numpy(x))
    assert isinstance(y, torch.Tensor)
    assert isinstance(target, np.ndarray) and isinstance(ones, np.ndarray)
    np.testing.assert_array_equal(target, [3, -1])
    np.testing.assert_array_equal(y.numpy(), x.reshape(3, 20))
    assert_close(_np((y, target, ones)), both(data, x)[1])


def test_onnx_jax_model_transformer_equals_jax():
    """ONNX bytes -> ``JaxModel`` -> a DataFrame transform, 5 images in
    batches of 4 (bucket 1 for the last)."""
    m, data = _cnn(4, conv_ch=4, hw=16, classes=6)
    raw = np.random.default_rng(1).normal(size=(5, 3, 16, 16)).astype(
        np.float32)
    imgs = np.empty(5, dtype=object)
    for i in range(5):
        imgs[i] = raw[i]
    jm = onnx_to_jax_model(data, batch_size=4, device="cpu")
    got = np.stack(list(jm.transform(DataFrame.from_dict({"input": imgs}))
                        .collect()["output"]))
    want = np.stack(list(jax_onnx.onnx_to_jax_model(data, batch_size=4)
                         .transform(JaxDataFrame.from_dict({"input": imgs}))
                         .collect()["output"]))
    assert_close(got, want)
    with torch.no_grad():
        np.testing.assert_allclose(got, m(torch.from_numpy(raw)).numpy(),
                                   rtol=1e-4, atol=1e-4)
    assert jm.runner().bucket_calls == {4: 1, 1: 1}


def _tiny_net():
    torch.manual_seed(5)
    m = tnn.Sequential(tnn.Conv2d(3, 6, 3, stride=2, padding=1),
                       tnn.ReLU(), tnn.AdaptiveAvgPool2d(1), tnn.Flatten(),
                       tnn.Linear(6, 4)).eval()
    conv, _r, _g, _f, lin = m
    init = {"w": _t2n(conv.weight), "b": _t2n(conv.bias),
            "fw": _t2n(lin.weight), "fb": _t2n(lin.bias)}
    nodes = [
        encode_node("Conv", ["x", "w", "b"], ["c"], kernel_shape=[3, 3],
                    strides=[2, 2], pads=[1, 1, 1, 1]),
        encode_node("Relu", ["c"], ["r"]),
        encode_node("GlobalAveragePool", ["r"], ["g"]),
        encode_node("Flatten", ["g"], ["feat"], axis=1),
        encode_node("Gemm", ["feat", "fw", "fb"], ["y"], transB=1),
    ]
    return m, build_model(nodes, init, [("x", [1, 3, 8, 8])], [("y", [1, 4])])


@pytest.mark.parametrize("cut_at_import", [True, False])
def test_pretrained_onnx_through_downloader_and_featurizer(tmp_path,
                                                            cut_at_import):
    """Register an ONNX artifact in the local repo, download it by name,
    featurize NHWC images with the head cut — at import (``cut_layers``)
    or by the featurizer (``cut_output_layers``) — and match the JAX
    package's featurizer and torch's truncated forward."""
    m, data = _tiny_net()
    cut = 1 if cut_at_import else 0
    dl = ModelDownloader(local_cache=str(tmp_path / "zoo"))
    dl.import_onnx("TinyNet", data, cut_layers=cut)
    payload = dl.download_by_name("TinyNet", device="cpu")
    assert isinstance(payload, OnnxModelPayload)
    np.testing.assert_array_equal(payload.variables["w"], _t2n(m[0].weight))
    jdl = JaxDownloader(local_cache=str(tmp_path / "jzoo"))
    jdl.import_onnx("TinyNet", data, cut_layers=cut)
    jpayload = jdl.download_by_name("TinyNet")

    raw = np.random.default_rng(2).uniform(0, 1, size=(4, 8, 8, 3)).astype(
        np.float32)
    imgs = np.empty(4, dtype=object)
    for i in range(4):
        imgs[i] = raw[i]
    params = dict(input_col="image", output_col="features", height=8,
                  width=8, auto_convert=False, batch_size=4)
    got = np.stack(list(ImageFeaturizer(device="cpu", **params)
                        .set_model(payload=payload)
                        .transform(DataFrame.from_dict({"image": imgs}))
                        .collect()["features"]))
    want = np.stack(list(JaxFeaturizer(**params).set_model(payload=jpayload)
                         .transform(JaxDataFrame.from_dict({"image": imgs}))
                         .collect()["features"]))
    assert_close(got, want)
    with torch.no_grad():
        trunc = tnn.Sequential(*list(m)[:4])
        np.testing.assert_allclose(
            got, trunc(torch.from_numpy(raw.transpose(0, 3, 1, 2))).numpy(),
            rtol=1e-4, atol=1e-5)


def test_exported_flax_resnet_equals_flax():
    """The JAX package's ``export_resnet`` graph of a narrow ResNet (explicit
    asymmetric SAME pads, BN, MaxPool, GAP, Gemm) through the port equals
    flax's ``apply``, with and without the head."""
    ref = jax_resnet.ResNet([1, 1], jax_resnet.BottleneckBlock, 5,
                            num_filters=4)
    variables = seeded_variables(ref, (1, 32, 32, 3), seed=6)
    x = np.random.default_rng(6).normal(size=(2, 32, 32, 3)).astype(
        np.float32)
    for features in (False, True):
        data = export_resnet(ref, variables, input_hw=32,
                             features_only=features)
        fn, weights = onnx_to_jax(data)
        got = fn(weights, torch.from_numpy(x.transpose(0, 3, 1, 2))).numpy()
        want = np.asarray(ref.apply(variables, jnp.asarray(x),
                                    features=features))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-5)


def _gbdt(objective, **over):
    rng = np.random.default_rng(0)
    X = rng.normal(size=(300, 4)).astype(np.float32)
    if objective == "multiclass":
        y = np.clip((X[:, 0] + X[:, 1] > 0).astype(float)
                    + 2 * (X[:, 2] > 0.5), 0, 2)
    elif objective == "binary":
        y = (X[:, 0] + X[:, 1] > 0).astype(float)
    else:
        y = X[:, 0] * 2 + np.sin(X[:, 1])
    p = JaxParams(num_iterations=4, num_leaves=6, learning_rate=0.3,
                  objective=objective, min_data_in_leaf=5, **over)
    X[::7, 0] = np.nan
    return jax_gbdt.train(X, y, p).booster, X


@pytest.mark.parametrize("objective,over", [
    ("regression", {}), ("binary", {}), ("multiclass", {"num_class": 3})],
    ids=["regression", "binary", "multiclass"])
def test_tree_ensembles_equal_jax(objective, over):
    """``export_gbdt`` graphs (BRANCH_LEQ with NaN routing, LEAF weights,
    base values): margins within 1e-5, labels identical, and the margins
    equal the booster's own."""
    booster, X = _gbdt(objective, **over)
    got, want = both(export_gbdt(booster), X)
    assert_close(got, want)
    scores = got[1] if isinstance(got, tuple) else got
    raw = booster.raw_scores(X)
    if objective == "binary":
        scores = scores[:, 1:]
    np.testing.assert_allclose(scores.reshape(raw.shape), raw, rtol=1e-5,
                               atol=1e-5)


def test_unsupported_ops_and_modes_raise():
    node = encode_node("Range", ["a", "b", "c"], ["y"])
    data = build_model([node], {"a": np.asarray(0), "b": np.asarray(3),
                                "c": np.asarray(1)}, [], [("y", [3])])
    fn, v = onnx_to_jax(data, device="cpu")
    with pytest.raises(NotImplementedError, match="Range"):
        fn(v)
    pad = build_model([encode_node("Pad", ["x"], ["y"], pads=[1, 1],
                                   mode="reflect")], {},
                      [("x", [3])], [("y", [5])])
    fn, v = onnx_to_jax(pad)
    with pytest.raises(NotImplementedError, match="reflect"):
        fn(v, torch.zeros(3))
    with pytest.raises(ValueError, match="either cut_layers"):
        onnx_to_jax(pad, output_names=["y"], cut_layers=1)


def _digits_split():
    pytest.importorskip("sklearn")
    from sklearn.datasets import load_digits
    d = load_digits()
    X = (d.data / 16.0).astype(np.float32)
    y = d.target.astype(np.int32)
    order = np.random.default_rng(0).permutation(len(y))
    cut = int(len(y) * 0.85)
    return X[order[cut:]], y[order[cut:]]


def test_digits_mlp_reaches_its_pinned_accuracy():
    """The committed ONNX ``DigitsMLP`` through the port's repository and
    ``JaxModel``: held-out accuracy 0.9889 +- 0.01 (the split of
    ``tools/train_zoo_checkpoint.py``), logits equal to the JAX
    package's."""
    with open(os.path.join(REPO_DIR, "DigitsMLP", "eval.json")) as f:
        pinned = json.load(f)["held_out_accuracy"]
    Xte, yte = _digits_split()
    payload = ModelDownloader(local_cache=REPO_DIR).download_by_name(
        "DigitsMLP", device="cpu")
    logits = payload.apply(torch.from_numpy(Xte)).numpy()
    acc = float((logits.argmax(1) == yte).mean())
    assert abs(acc - pinned) < 0.01, (acc, pinned)
    ref = JaxDownloader(local_cache=REPO_DIR).download_by_name("DigitsMLP")
    np.testing.assert_allclose(logits, np.asarray(ref.apply(Xte)),
                               rtol=1e-5, atol=1e-5)
    col = np.empty(len(Xte), dtype=object)
    for i, v in enumerate(Xte):
        col[i] = v
    jm = JaxModel(input_col="f", output_col="o", batch_size=128,
                  device="cpu")
    jm.set("model", payload)
    pred = np.stack(list(jm.transform(DataFrame.from_dict({"f": col}))
                         .collect()["o"])).argmax(1)
    assert float((pred == yte).mean()) == acc
