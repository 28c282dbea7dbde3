"""Shared fixtures of the benchmark's CPU tests: a copy of the benchmark
whose cells are cut to a size a test run holds, runnable on the CPU."""
from __future__ import annotations

import json
import os
import shutil
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

#: every cell's configuration cut to seconds on the CPU
TINY_CONFIGS = {
    "higgs": dict(num_data=20000, num_leaves=15, max_bin=15,
                  num_iterations=3, published={"num_iterations": 20}),
    "mslr": dict(num_data=6000, num_queries=60, longest_query=300,
                 num_leaves=15, max_bin=15, num_iterations=3),
}
TINY_TRAFFIC = {"score": dict(rows_per_call=2000, pool=2, check_every=2,
                              trace_items=3),
                "fit": dict(raw_rows=500)}


def make_tiny(dst: str) -> str:
    """A copy of ``BENCHMARK.json`` and ``portbench/`` under ``dst`` with
    the cells cut to ``TINY_*``; returns ``dst``."""
    shutil.copytree(os.path.join(REPO, "portbench"),
                    os.path.join(dst, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for c in bench["configs"]:
        path = os.path.join(dst, c["file"])
        with open(path) as f:
            cfg = json.load(f)
        cfg.update(TINY_CONFIGS[c["name"]])
        with open(path, "w") as f:
            json.dump(cfg, f)
    for name, cut in TINY_TRAFFIC.items():
        path = os.path.join(dst, "portbench", "traffic", f"{name}.json")
        with open(path) as f:
            tr = json.load(f)
        tr.update(cut)
        with open(path, "w") as f:
            json.dump(tr, f)
    with open(os.path.join(dst, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return dst


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> str:
    return make_tiny(str(tmp_path_factory.mktemp("tiny")))


def run_in(root: str, module: str, argv, device="cpu"):
    """``portbench.<module>.main(argv, device)`` from the copy at ``root``
    in this process; returns (exit code, stdout lines)."""
    import contextlib
    import importlib
    import io
    saved = {k: v for k, v in sys.modules.items()
             if k == "portbench" or k.startswith("portbench.")}
    for k in saved:
        del sys.modules[k]
    sys.path.insert(0, root)
    out = io.StringIO()
    try:
        mod = importlib.import_module(f"portbench.{module}")
        with contextlib.redirect_stdout(out):
            rc = mod.main(list(argv), device=device)
    finally:
        sys.path.remove(root)
        for k in [k for k in sys.modules
                  if k == "portbench" or k.startswith("portbench.")]:
            del sys.modules[k]
        sys.modules.update(saved)
    return rc, out.getvalue().splitlines()


@pytest.fixture
def card():
    """The CUDA card, decided here and not at import: tests that need it
    skip without one."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)
