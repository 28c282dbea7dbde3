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
