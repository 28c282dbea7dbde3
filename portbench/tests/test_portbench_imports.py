"""``run.py`` loads neither JAX nor the JAX package, and the reference
imports nothing of the program it judges."""
from __future__ import annotations

import ast
import glob
import os
import subprocess
import sys

from conftest import REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "mmlspark_tpu"}


def test_run_imports_no_jax_in_a_fresh_process():
    code = (
        "import sys, glob, os, importlib\n"
        "sys.path.insert(0, os.getcwd())\n"
        "import portbench.run\n"
        "from portbench.harness import bench\n"
        "s = bench.benchmark(os.getcwd())\n"
        "for w in s['workloads']:\n"
        "    tr = bench.traffic(w['traffic'])\n"
        "    bench.module('drivers', tr['driver'])\n"
        "    bench.module('datasets', bench.config(os.getcwd(), s,"
        " w['config'])['dataset'])\n"
        "for m in s['per_layer']:\n"
        "    bench.metric_reader(m['name'])\n"
        "import mmlspark_tpu_torch.lightgbm.estimators\n"
        "import mmlspark_tpu_torch.observability.compute\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "mmlspark_tpu_torch" in loaded
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN


def test_the_reference_imports_nothing_of_either_package():
    for path in glob.glob(os.path.join(REPO, "portbench", "reference",
                                       "*.py")):
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] not in FORBIDDEN | {
                    "mmlspark_tpu_torch"}, (path, n)


def test_run_refuses_without_a_card():
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "higgs.fit",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=REPO,
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert "correct" not in out.stdout


def test_run_fails_where_only_the_benchmark_is(tmp_path):
    import shutil
    shutil.copytree(os.path.join(REPO, "portbench"),
                    os.path.join(tmp_path, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    # past the look for a card: the program itself is missing
    code = ("import sys; sys.path.insert(0, '.'); from portbench import run;"
            " sys.exit(run.main(['--workload', 'higgs.fit', '--seed', '1',"
            " '--seconds', '1', '--trace', '0'], device='cpu'))")
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
        text=True, timeout=300,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.returncode != 0
    assert "mmlspark_tpu_torch" in out.stderr
    assert "correct" not in out.stdout


def test_no_result_when_a_reader_loads_jax_after_the_window(tmp_path):
    """A per-layer reader (or the reference) that loads JAX once the
    window has closed: the run prints no result and exits non-zero."""
    import json
    from conftest import make_tiny, run_in
    root = make_tiny(str(tmp_path))
    os.makedirs(os.path.join(root, "jax"))
    with open(os.path.join(root, "jax", "__init__.py"), "w") as f:
        f.write('"""A stand-in named jax."""\n')
    with open(os.path.join(root, "portbench", "metrics",
                           "loads_jax.fit.py"), "w") as f:
        f.write("def read(run):\n    import jax  # noqa: F401\n"
                "    return 1.0\n")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        spec = json.load(f)
    spec["per_layer"].append({
        "name": "loads_jax.fit", "unit": "count", "better": "lower",
        "source": "host_clock", "layer": "estimator and data plane",
        "moves": "fit_row_iters_per_s", "workloads": ["higgs.fit"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    saved = sys.modules.pop("jax", None)
    try:
        rc, lines = run_in(root, "run", [
            "--workload", "higgs.fit", "--seed", "2147483663",
            "--seconds", "1", "--trace", "1"])
        assert sys.modules["jax"].__doc__ == "A stand-in named jax."
    finally:
        sys.modules.pop("jax", None)
        if saved is not None:
            sys.modules["jax"] = saved
    assert rc != 0
    assert not any(x.startswith("{") for x in lines), lines[-1]
