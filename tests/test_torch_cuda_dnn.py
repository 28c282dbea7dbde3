"""Deep-learning scoring on the card against the port on the CPU.  Marked
``cuda``: without a CUDA device every test skips (the CPU tier-1 run holds
the same modules against the JAX package in ``test_torch_resnet.py``,
``test_torch_dl.py``, ``test_torch_image_ops.py`` and
``test_torch_onnx_import.py``).  On the card:

    python -m pytest tests/test_torch_cuda_dnn.py -q -m cuda --noconftest

Tolerances, as ``chip_smoke.py``'s dnn phase states them: float32 on the
card (TF32 off) against the CPU within 1e-4 of the outputs' largest
magnitude (cuDNN sums in other orders than the CPU); bfloat16 against
float32 on the card within 2e-2 of it, and more than 1e-3 from it (a
bfloat16 path that computed in float32 would agree within 1e-4); the
image ops within atol 1e-3 on [0, 255] pixels.
"""
import os

import numpy as np
import pytest
import torch

from mmlspark_tpu_torch._device import float32_exact
from mmlspark_tpu_torch.core import DataFrame
from mmlspark_tpu_torch.dl import (ImageFeaturizer, JaxModel,
                                   ModelDownloader)
from mmlspark_tpu_torch.dl.procedural_shapes import make_shapes
from mmlspark_tpu_torch.models import resnet
from mmlspark_tpu_torch.opencv import ImageTransformer

pytestmark = pytest.mark.cuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_DIR = os.path.join(ROOT, "artifacts", "model_repo")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def rel(a, b) -> float:
    a, b = torch.as_tensor(a).float().cpu(), torch.as_tensor(b).float().cpu()
    return float((a - b).abs().max() / b.abs().max())


def seeded_net(block, cifar, seed=0):
    """A narrow ResNet with every BN parameter and statistic seeded."""
    gen = torch.Generator().manual_seed(seed)
    model = resnet.ResNet([1, 1, 1, 1], block, 10, num_filters=8,
                          cifar_stem=cifar, generator=gen)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, resnet.BatchNorm):
                c = m.weight.numel()
                m.weight.copy_(torch.empty(c).uniform_(0.5, 1.5,
                                                       generator=gen))
                m.bias.copy_(torch.randn(c, generator=gen) * 0.2)
                m.running_mean.copy_(torch.randn(c, generator=gen) * 0.2)
                m.running_var.copy_(torch.empty(c).uniform_(0.5, 1.5,
                                                            generator=gen))
    return model


@pytest.mark.parametrize("hw", [32, 35])
@pytest.mark.parametrize("block", [resnet.BasicBlock,
                                   resnet.BottleneckBlock],
                         ids=["basic", "bottleneck"])
def test_resnet_on_the_card_equals_cpu(dev, block, hw):
    cpu = seeded_net(block, cifar=hw == 35)
    card = resnet.ResNet.from_config(cpu.config())
    card.load_state_dict(cpu.state_dict())
    card16 = resnet.ResNet.from_config({**cpu.config(),
                                        "dtype": "bfloat16"})
    card16.load_state_dict(cpu.state_dict())
    card, card16 = card.to(dev), card16.to(dev)
    x = torch.randn(4, hw, hw, 3, generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        for features in (False, True):
            want = cpu(x, features=features)
            got = card(x.to(dev), features=features)
            got16 = card16(x.to(dev), features=features)
            assert got.dtype == got16.dtype == torch.float32
            assert rel(got, want) <= 1e-4
            assert 1e-3 < rel(got16, got) <= 2e-2


def test_float32_exact_restores_the_flags(dev):
    before = (torch.backends.cudnn.allow_tf32,
              torch.backends.cuda.matmul.allow_tf32)
    with float32_exact():
        assert not torch.backends.cudnn.allow_tf32
        assert not torch.backends.cuda.matmul.allow_tf32
    assert (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32) == before


def test_float32_forwards_on_two_threads_leave_the_flags(dev):
    """Float32 forwards on the card from two threads at once: each equals
    the forward run alone, and the TF32 flags end as they began."""
    import threading
    model = seeded_net(resnet.BasicBlock, cifar=True).to(dev)
    x = torch.randn(16, 32, 32, 3, generator=torch.Generator(
        ).manual_seed(2)).to(dev)
    before = (torch.backends.cudnn.allow_tf32,
              torch.backends.cuda.matmul.allow_tf32)
    with torch.inference_mode():
        alone = model(x)
    outs = [[] for _ in range(2)]

    def run(i):
        with torch.inference_mode():
            for _ in range(20):
                outs[i].append(model(x))
        torch.cuda.synchronize()

    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32) == before
    assert all(len(o) == 20 for o in outs)
    for out in outs[0] + outs[1]:
        assert rel(out, alone) <= 1e-4


def test_shapes_resnet20_on_the_card_equals_cpu(dev):
    X, y = make_shapes(512, seed=1)
    outs = {}
    for device in ("cuda", "cpu"):
        payload = ModelDownloader(local_cache=REPO_DIR).download_by_name(
            "ShapesResNet20", device=device)
        jm = JaxModel(input_col="image", output_col="logits", batch_size=256,
                      input_shape=[32, 32, 3], device=device)
        jm.set("model", payload)
        outs[device] = np.stack(list(jm.transform(
            DataFrame.from_dict({"image": X})).collect()["logits"]))
    assert rel(outs["cuda"], outs["cpu"]) <= 1e-4
    assert float((outs["cuda"].argmax(1) == y).mean()) > 0.98


def test_featurizer_on_the_card_equals_cpu(dev):
    model = seeded_net(resnet.BasicBlock, cifar=False, seed=3)
    images = np.random.default_rng(4).integers(0, 256, (9, 20, 20, 3),
                                               dtype=np.uint8)
    outs = {}
    for device in ("cuda", "cpu"):
        feat = ImageFeaturizer(input_col="image", output_col="f", height=40,
                               width=40, batch_size=4, device=device)
        feat.set_model(module=model)
        outs[device] = np.stack(list(feat.transform(
            DataFrame.from_dict({"image": images})).collect()["f"]))
        runner = feat._build_runner().runner()
        assert runner.device.type == device
        assert runner.bucket_calls == {4: 2, 1: 1}
    assert outs["cuda"].shape == (9, 64)
    assert rel(outs["cuda"], outs["cpu"]) <= 1e-4


def test_image_transformer_on_the_card_equals_cpu(dev):
    col = np.empty(3, dtype=object)
    rng = np.random.default_rng(5)
    for i, s in enumerate([(30, 28, 3), (30, 28, 3), (17, 40, 3)]):
        col[i] = rng.uniform(0, 255, s).astype(np.float32)
    outs = {}
    for device in ("cuda", "cpu"):
        t = ImageTransformer(input_col="image", output_col="o",
                             device=device).resize(24, 20).blur(5, 5, 1.0) \
            .threshold(90.0, 255.0, "trunc").normalize()
        outs[device] = t.transform(DataFrame.from_dict({"image": col})) \
            .collect()["o"]
    for a, b in zip(outs["cuda"], outs["cpu"]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-3)


def test_digits_mlp_on_the_card_equals_cpu(dev):
    x = np.random.default_rng(6).uniform(0, 1, (64, 64)).astype(np.float32)
    got, cpu = (ModelDownloader(local_cache=REPO_DIR).download_by_name(
        "DigitsMLP", device=d).apply(x) for d in ("cuda", "cpu"))
    assert got.device.type == "cuda" and cpu.device.type == "cpu"
    assert rel(got, cpu) <= 1e-4
