"""The port stands alone: ``mmlspark_tpu_torch`` and ``chip_smoke.py``
import neither ``jax`` nor the JAX package, and the port's entry points run
on the card unless the caller asks for the CPU."""
import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "mmlspark_tpu_torch")

_BLOCKED_IMPORT = r"""
import importlib, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "mmlspark_tpu")

def blocked(name):
    return any(name == b or name.startswith(b + ".") for b in BLOCKED)

for name in [m for m in sys.modules if blocked(m)]:
    del sys.modules[name]

class Block:
    def find_spec(self, name, path=None, target=None):
        if blocked(name):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
import mmlspark_tpu_torch
names = [m.name for m in pkgutil.walk_packages(mmlspark_tpu_torch.__path__,
                                                "mmlspark_tpu_torch.")]
for name in names:
    importlib.import_module(name)
assert not [m for m in sys.modules if blocked(m)]
print(len(names))
"""


def test_package_imports_with_jax_and_the_jax_package_blocked():
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT], cwd=ROOT,
                          capture_output=True, text=True, timeout=120,
                          env={**os.environ, "PYTHONPATH": ROOT})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert int(proc.stdout.split()[-1]) >= 15      # every submodule


def _port_sources():
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


@pytest.mark.parametrize("path", sorted(_port_sources()),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_sources_never_import_jax_or_the_jax_package(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            if top in ("jax", "jaxlib", "mmlspark_tpu"):
                bad.append(name)
    assert not bad, bad


def test_entry_points_need_the_card_unless_told_cpu(monkeypatch):
    from mmlspark_tpu_torch import resolve_device
    from mmlspark_tpu_torch.lightgbm import GBDTParams, train
    from mmlspark_tpu_torch.models.gbdt import GBDTBooster
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    X = np.random.default_rng(0).normal(size=(200, 3)).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train(X, y, GBDTParams(num_iterations=1, max_depth=2))
    from mmlspark_tpu_torch import train_streamed
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_streamed(X, y, GBDTParams(num_iterations=1, max_depth=2),
                       tile_rows=64)
    assert train_streamed(X, y, GBDTParams(num_iterations=1, max_depth=2),
                          tile_rows=64, device="cpu").booster.num_trees == 1
    booster = train(X, y, GBDTParams(num_iterations=1, max_depth=2),
                    device="cpu").booster
    assert isinstance(booster, GBDTBooster)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        booster.predict(X)
    assert resolve_device("cpu") == torch.device("cpu")

    # deep-learning scoring: the runner, JaxModel, ImageFeaturizer,
    # ImageTransformer and the model downloader
    from mmlspark_tpu_torch.core import DataFrame
    from mmlspark_tpu_torch.dl import (ImageFeaturizer, JaxModel,
                                       ModelDownloader)
    from mmlspark_tpu_torch.models import resnet
    from mmlspark_tpu_torch.models.runner import ModelRunner
    from mmlspark_tpu_torch.opencv import ImageTransformer
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ModelRunner(apply_fn=lambda s, b: b)
    runner = ModelRunner(apply_fn=lambda s, b: b * 2, device="cpu")
    np.testing.assert_array_equal(runner.apply_batch(X), X * 2)
    images = np.empty(2, dtype=object)
    for i in range(2):
        images[i] = np.zeros((8, 8, 3), np.float32)
    df = DataFrame.from_dict({"image": images})
    net = resnet.ResNet([1], resnet.BasicBlock, 3, num_filters=4,
                        cifar_stem=True)
    stages = [
        JaxModel(input_col="image", output_col="out").set_model(module=net),
        ImageFeaturizer(input_col="image", output_col="out", height=8,
                        width=8).set_model(module=net),
        ImageTransformer(input_col="image", output_col="out").flip(1),
    ]
    for stage in stages:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            stage.transform(df)
        out = stage.set_params(device="cpu").transform(df).collect()["out"]
        assert len(out) == 2 and np.isfinite(np.stack(list(out))).all()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ModelDownloader().download_by_name("ResNet18")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ModelDownloader().download_by_name("BiLSTM", vocab_size=8,
                                           num_tags=2)
    # torch import scores on the card unless told otherwise
    from mmlspark_tpu_torch.dl import torch_to_jax_model
    rows = np.empty(2, dtype=object)
    for i in range(2):
        rows[i] = np.zeros(3, np.float32)
    imported = torch_to_jax_model(torch.nn.Sequential(torch.nn.Linear(3, 2)),
                                  input_col="x", output_col="y")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        imported.transform(DataFrame.from_dict({"x": rows}))
    assert len(imported.set_params(device="cpu").transform(
        DataFrame.from_dict({"x": rows})).collect()["y"]) == 2
    payload = ModelDownloader().download_by_name("ResNet18", device="cpu")
    assert payload.module.conv_init.weight.device == torch.device("cpu")

    # ONNX: the payload, and a graph fed numpy, run on the card by default
    from mmlspark_tpu_torch.dl import OnnxModelPayload, onnx_to_jax
    with open(os.path.join(ROOT, "artifacts", "model_repo", "DigitsMLP",
                           "onnx", "model.onnx"), "rb") as f:
        data = f.read()
    digits = np.zeros((2, 64), np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        OnnxModelPayload(data).apply(digits)
    fn, weights = onnx_to_jax(data)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fn(weights, digits)
    out = OnnxModelPayload(data, device="cpu").apply(digits)
    assert out.device == torch.device("cpu") and out.shape == (2, 10)
    repo = os.path.join(ROOT, "artifacts", "model_repo")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ModelDownloader(local_cache=repo).download_by_name("DigitsMLP")
    assert ModelDownloader(local_cache=repo).download_by_name(
        "DigitsMLP", device="cpu").apply(digits).shape == (2, 10)

    # the decode/serving engine: every entry point goes through a runner
    # on the card unless it was built with device="cpu"
    from mmlspark_tpu_torch.models import TransformerEncoder
    from mmlspark_tpu_torch.serving import PipelineServer
    lm = TransformerEncoder(8, num_classes=8, embed_dim=8, num_heads=2,
                            num_layers=1, mlp_dim=8, max_len=32, causal=True,
                            pool="none")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ModelRunner(module=lm).decode_stream()
    cpu_runner = ModelRunner(module=lm, device="cpu")
    index = cpu_runner.prefix_cache(4)
    dec = cpu_runner.decode_stream(slots=2, prompt_bucket=4,
                                   max_new_tokens=2, page_size=4,
                                   prefix_cache=True)
    assert dec.index is index
    h = dec.submit(np.asarray([1, 2], np.int32))
    while dec._live or dec._arrivals:
        dec.step()
    assert h.status == "ok" and len(h.tokens) == 2
    dec.close()
    srv = PipelineServer(cpu_runner.scorer(mode="decode", continuous=True,
                                           slots=2, prompt_bucket=4,
                                           max_new_tokens=2, page_size=4),
                         port=0, mode="continuous").start()
    srv.stop()
