"""Port parity for deep-learning scoring: ``dl.JaxModel``,
``dl.ImageFeaturizer``, the model repository (``dl.model_downloader``,
the committed ``artifacts/model_repo/ShapesResNet20``) and the runner's
batch front (``models.runner``), against the JAX package on the same
seeded inputs, on the CPU.

Tolerances: float32 outputs through both packages within atol 2e-5 on
values of magnitude ~1-40 (the same layers, summed in another order;
measured ~1e-6 on the narrow nets, 1.5e-5 on ShapesResNet20's logits of
magnitude ~40); the featurizer's resize within the image ops' 1e-3 on
[0, 255] pixels, which normalize divides by ~58, so its features within
atol 1e-4; ShapesResNet20's accuracy on 2,000 holdout images within 0.005
of the JAX package's on the same images.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlspark_tpu.core import DataFrame as JaxDataFrame
from mmlspark_tpu.dl import ImageFeaturizer as JaxFeaturizer
from mmlspark_tpu.dl import JaxModel as JaxJaxModel
from mmlspark_tpu.dl import ModelDownloader as JaxDownloader
from mmlspark_tpu.dl.procedural_shapes import make_shapes as jax_make_shapes
from mmlspark_tpu.models import resnet as jax_resnet
from mmlspark_tpu_torch.convert import (bilstm_state_dict_from_flax,
                                        resnet_state_dict_from_flax)
from mmlspark_tpu_torch.core import DataFrame, load, save
from mmlspark_tpu_torch.dl import (FlaxModelPayload, ImageFeaturizer,
                                   JaxModel, ModelDownloader, ModelRepo)
from mmlspark_tpu_torch.dl.model_downloader import resnet_from_variables
from mmlspark_tpu_torch.dl.procedural_shapes import make_shapes
from mmlspark_tpu_torch.models import TransformerEncoder, resnet
from mmlspark_tpu_torch.models import runner as port_runner
from mmlspark_tpu_torch.observability.metrics import MetricsRegistry
from tests.test_torch_resnet import seeded_variables

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_DIR = os.path.join(ROOT, "artifacts", "model_repo")


def _column(arrays):
    col = np.empty(len(arrays), dtype=object)
    for i, a in enumerate(arrays):
        col[i] = a
    return col


@pytest.fixture(scope="module")
def narrow():
    """A narrow ResNet (basic blocks, 2 stages, 10 classes) in both
    packages holding the same seeded weights."""
    ref = jax_resnet.ResNet([1, 1], jax_resnet.BasicBlock, 10,
                            num_filters=8)
    variables = seeded_variables(ref, (1, 16, 16, 3), seed=9)
    model = resnet.ResNet([1, 1], resnet.BasicBlock, 10, num_filters=8)
    model.load_state_dict(resnet_state_dict_from_flax(variables, model))
    return ref, variables, model


@pytest.fixture(scope="module")
def shapes_resnet20():
    jax_payload = JaxDownloader(local_cache=REPO_DIR).download_by_name(
        "ShapesResNet20")
    payload = ModelDownloader(local_cache=REPO_DIR).download_by_name(
        "ShapesResNet20", device="cpu")
    return jax_payload, payload


def test_shapes_resnet20_loads_through_the_port_repo(shapes_resnet20):
    """The committed checkpoint (a pickled flax module beside
    ``variables.npz``) loads without flax: its ResNet-20 inferred from the
    variables, every weight carried across."""
    _, payload = shapes_resnet20
    with open(os.path.join(REPO_DIR, "ShapesResNet20", "eval.json")) as f:
        width = json.load(f)["width"]
    assert payload.module.config() == {
        "stage_sizes": [3, 3, 3], "block_cls": "BasicBlock",
        "num_classes": 10, "num_filters": width, "dtype": "float32",
        "cifar_stem": True}
    schemas = {s.name: s for s in ModelRepo(REPO_DIR).list_models()}
    assert schemas["ShapesResNet20"].input_shape == [32, 32, 3]
    assert schemas["DigitsMLP"].model_type == "onnx"


def test_shapes_resnet20_equals_flax_on_the_holdout(shapes_resnet20):
    """Logits on the trainer's holdout (``tools/train_backbone.py``:
    ``make_shapes(8000, seed=1)``, scored raw) equal the flax model's on
    512 images; accuracy on 2,000 within 0.005 of the JAX package's."""
    jax_payload, payload = shapes_resnet20
    X, y = make_shapes(2000, seed=1)
    Xj, yj = jax_make_shapes(2000, seed=1)
    np.testing.assert_array_equal(X, Xj)
    np.testing.assert_array_equal(y, yj)
    apply = jax.jit(jax_payload.module.apply)
    want = np.concatenate([np.asarray(apply(jax_payload.variables,
                                            jnp.asarray(X[a:a + 1000])))
                           for a in (0, 1000)])
    with torch.inference_mode():
        got = payload.module(torch.from_numpy(X)).numpy()
    np.testing.assert_allclose(got[:512], want[:512], rtol=0, atol=2e-5)
    acc, ref_acc = (float((z.argmax(1) == y).mean()) for z in (got, want))
    assert acc > 0.98, acc
    assert abs(acc - ref_acc) <= 0.005, (acc, ref_acc)


def test_jax_model_equals_jax_with_buckets_and_padding(narrow):
    """11 rows in 2 partitions at batch 4: chunks of 4 and 2 (bucket 2)
    and 4 and 1 (bucket 1), padded by repeating the last row, as the
    reference pads them; the outputs equal the reference's."""
    ref, variables, model = narrow
    rng = np.random.default_rng(3)
    images = rng.normal(size=(11, 16, 16, 3)).astype(np.float32)
    flat = _column([im.reshape(-1) for im in images])
    want = JaxJaxModel().set_model(module=ref, variables=variables) \
        .set_params(input_col="x", output_col="y", batch_size=4,
                    input_shape=[16, 16, 3]) \
        .transform(JaxDataFrame.from_dict({"x": flat}, 2)).collect()["y"]
    jm = JaxModel().set_model(module=model).set_params(
        input_col="x", output_col="y", batch_size=4, input_shape=[16, 16, 3],
        device="cpu")
    got = jm.transform(DataFrame.from_dict({"x": flat}, 2)).collect()["y"]
    assert len(got) == len(want) == 11
    np.testing.assert_allclose(np.stack(list(got)), np.stack(list(want)),
                               rtol=0, atol=2e-5)
    assert jm.runner().bucket_calls == {4: 2, 2: 1, 1: 1}
    dense = jm.set_params(output_mode="dense").transform(
        DataFrame.from_dict({"x": flat}, 2)).collect()["y"]
    np.testing.assert_allclose(np.stack(list(dense)), np.stack(list(got)))


def test_jax_model_single_row_uses_small_bucket():
    """A 1-row request pads to bucket 1, not ``batch_size`` (the
    reference's ``tests/test_dl.py::test_jax_model_single_row_uses_small_
    bucket``); 3 rows take bucket 4, and no call pads to 64."""
    jm = JaxModel()
    jm.set_model(apply_fn=lambda v, x: x * 2.0, variables={})
    jm.set_params(input_col="input", output_col="out", batch_size=64,
                  device="cpu")
    one = _column([np.asarray([1.0, 2.0], np.float32)])
    out = jm.transform(DataFrame.from_dict({"input": one})).collect()["out"]
    np.testing.assert_allclose(np.asarray(out[0]), [2.0, 4.0])
    assert set(jm.runner().bucket_calls) == {1}
    three = _column([np.asarray([float(i), 1.0], np.float32)
                     for i in range(3)])
    jm.transform(DataFrame.from_dict({"input": three}))
    assert set(jm.runner().bucket_calls) == {1, 4}


def test_runner_books_the_reference_counters():
    reg = MetricsRegistry()
    r = port_runner.ModelRunner(apply_fn=lambda s, x: x + s["b"],
                                variables={"b": np.ones(2, np.float32)},
                                name="t", batch_size=4, registry=reg,
                                device="cpu")
    x = np.arange(20, dtype=np.float32).reshape(10, 2)
    np.testing.assert_array_equal(r.apply_batch(x), x + 1)
    assert r.bucket_calls == {4: 2, 2: 1}
    text = reg.to_prometheus()
    assert 'mmlspark_runner_batches_total{runner="t",front="transform"} 3' \
        in text
    assert 'mmlspark_runner_rows_total{runner="t",front="transform"} 10' \
        in text
    assert 'mmlspark_runner_pad_rows_total{runner="t"} 0' in text
    r.apply_batch(x[:3])
    assert 'mmlspark_runner_pad_rows_total{runner="t"} 1' in reg.to_prometheus()
    assert r.apply_batch(x[:0]).shape == (0,)
    assert set(r.phase_s) == {"stack", "h2d", "device", "d2h"}
    assert port_runner.bucket_rows(1, 64) == 1
    assert port_runner.bucket_rows(33, 64) == 64
    assert port_runner.bucket_rows(100, 64) == 64


@pytest.mark.parametrize("call", [
    lambda r: r.scorer(),
    lambda r: r.decode(np.zeros((1, 2), np.int32), kv_layout="paged",
                       prefix_cache=True),
    lambda r: r.decode_stream(), lambda r: r.prefix_cache(),
    lambda r: r.stall_watchdog(1.0),
    lambda r: port_runner.ContinuousDecoder(r),
    lambda r: port_runner.StreamHandle(np.zeros(1, np.int32), 1, 1, None,
                                       None),
    lambda r: port_runner.ShedReply("x"),
], ids=["scorer", "decode", "decode_stream", "prefix_cache",
        "stall_watchdog", "ContinuousDecoder", "StreamHandle", "ShedReply"])
def test_serving_and_decode_names_raise(call):
    """The serving and continuous-decode side of the runner is ported
    (``tests/test_torch_continuous.py``, ``tests/test_torch_serving.py``):
    none of these names raises ``NotImplementedError`` any more; what the
    port still lacks of the runner, its jit cache, raises naming ROADMAP
    §2 item 6."""
    lm = TransformerEncoder(8, num_classes=8, embed_dim=8, num_heads=2,
                            num_layers=1, mlp_dim=8, max_len=64,
                            causal=True, pool="none")
    r = port_runner.ModelRunner(module=lm, device="cpu")
    assert call(r) is not None
    with pytest.raises(NotImplementedError, match="item 6"):
        r.executable(1, (2,))
    with pytest.raises(NotImplementedError, match="item 6"):
        r.compile_stats()


@pytest.mark.parametrize("cut", [1, 0])
def test_image_featurizer_equals_jax(narrow, cut):
    """The same 5 images (12 x 12, pixels in [0, 255]) resized to 16 x 16
    and normalized on the device, then the backbone with its head cut
    (``cut_output_layers=1``: 16-d features) or kept (0: 10 logits), in
    batches of 4 (bucket 1 for the last image)."""
    ref, variables, model = narrow
    rng = np.random.default_rng(cut)
    images = _column(list(rng.uniform(0, 255, (5, 12, 12, 3)).astype(
        np.float32)))
    params = dict(input_col="image", output_col="f", height=16, width=16,
                  batch_size=4, cut_output_layers=cut)
    want = JaxFeaturizer(**params).set_model(module=ref,
                                             variables=variables) \
        .transform(JaxDataFrame.from_dict({"image": images})) \
        .collect()["f"]
    feat = ImageFeaturizer(device="cpu", **params).set_model(module=model)
    got = feat.transform(DataFrame.from_dict({"image": images})) \
        .collect()["f"]
    assert got[0].shape == want[0].shape == ((16,) if cut else (10,))
    np.testing.assert_allclose(np.stack(list(got)), np.stack(list(want)),
                               rtol=0, atol=1e-4)
    runner = feat._build_runner().runner()
    assert runner.bucket_calls == {4: 1, 1: 1}
    assert runner.phase_s["stack"] > 0
    # the same features, unrolled rows (square HWC assumed)
    flat = _column([np.asarray(v).reshape(-1) for v in images])
    again = feat.transform(DataFrame.from_dict({"image": flat})) \
        .collect()["f"]
    np.testing.assert_allclose(np.stack(list(again)), np.stack(list(got)),
                               rtol=0, atol=1e-6)


def test_jax_model_save_load_round_trip(narrow, tmp_path):
    """``module.json`` + ``variables.npz`` for a module with ``config()``;
    ``module.pkl`` for an ``apply_fn``; the loaded stages score alike."""
    _, _, model = narrow
    x = _column(list(np.random.default_rng(5).normal(
        size=(3, 16, 16, 3)).astype(np.float32)))
    df = DataFrame.from_dict({"x": x})
    jm = JaxModel(input_col="x", output_col="y", device="cpu") \
        .set_model(module=model)
    save(jm, str(tmp_path / "m"))
    ckpt = tmp_path / "m" / "complex" / "model" / "payload"
    assert sorted(os.listdir(ckpt)) == ["module.json", "variables.npz"]
    back = load(str(tmp_path / "m"))
    np.testing.assert_array_equal(
        np.stack(list(back.transform(df).collect()["y"])),
        np.stack(list(jm.transform(df).collect()["y"])))
    fn = JaxModel(input_col="x", output_col="y", device="cpu").set_model(
        apply_fn=lambda s, b: b.reshape(b.shape[0], -1)[:, :4] * s["w"],
        variables={"w": np.full(4, 3.0, np.float32)})
    save(fn, str(tmp_path / "f"))
    out = load(str(tmp_path / "f")).transform(df).collect()["y"]
    np.testing.assert_allclose(np.stack(list(out)),
                               np.stack([v.reshape(-1)[:4] * 3 for v in x]))


def test_zoo_names_and_shapes_equal_the_reference(tmp_path):
    """Zoo weights are drawn from ``torch.Generator(seed)``, not the JAX
    package's PRNG, so only names and shapes are the reference's; a repo
    saves them and loads them back bit for bit."""
    dl = ModelDownloader(local_cache=str(tmp_path / "zoo"))
    payload = dl.download_by_name("ResNet18", seed=3, device="cpu",
                                  num_classes=10)
    shapes = jax.eval_shape(jax_resnet.resnet18(num_classes=10).init,
                            jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    ref = resnet_state_dict_from_flax(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes))
    state = payload.module.state_dict()
    assert {k: tuple(v.shape) for k, v in state.items()} == \
        {k: tuple(v.shape) for k, v in ref.items()}
    again = dl.download_by_name("ResNet18", device="cpu")   # from the repo
    for k, v in again.module.state_dict().items():
        assert torch.equal(v, state[k]), k
    fresh = ModelDownloader().download_by_name("ResNet18", seed=3,
                                               device="cpu", num_classes=10)
    for k, v in fresh.module.state_dict().items():
        assert torch.equal(v, state[k]), k
    # the zoo's tagger has the reference's names and shapes too
    tagger = ModelDownloader().download_by_name(
        "BiLSTM", device="cpu", vocab_size=40, num_tags=3).module
    jax_tagger = JaxDownloader().download_by_name(
        "BiLSTM", vocab_size=40, num_tags=3)
    ref = bilstm_state_dict_from_flax(jax_tagger.variables)
    assert {k: tuple(v.shape) for k, v in tagger.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in ref.items()}
    with pytest.raises(KeyError, match="unknown model"):
        ModelDownloader().download_by_name("VGG", device="cpu")


def test_architecture_is_inferred_from_bottleneck_variables():
    ref = jax_resnet.ResNet([2, 1], jax_resnet.BottleneckBlock, 7,
                            num_filters=4)
    variables = seeded_variables(ref, (1, 16, 16, 3), seed=2)
    model = resnet_from_variables(variables)
    assert model.config() == {
        "stage_sizes": [2, 1], "block_cls": "BottleneckBlock",
        "num_classes": 7, "num_filters": 4, "dtype": "float32",
        "cifar_stem": False}
    x = np.random.default_rng(4).normal(size=(2, 16, 16, 3)).astype(
        np.float32)
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(ref.apply(variables, x)),
                               rtol=0, atol=2e-5)


def test_payload_variables_and_apply():
    model = resnet.ResNet([1], resnet.BasicBlock, 3, num_filters=4,
                          cifar_stem=True)
    p = FlaxModelPayload(module=model)
    assert set(p.variables) == set(model.state_dict())
    x = torch.zeros(2, 8, 8, 3)
    with torch.inference_mode():
        np.testing.assert_array_equal(p.apply(x).numpy(), model(x).numpy())
        np.testing.assert_array_equal(
            p.pure_apply(p.variables, x).numpy(), model(x).numpy())
    with pytest.raises(ValueError, match="nn.Module or an apply_fn"):
        FlaxModelPayload()
