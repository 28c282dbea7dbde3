"""The port's codegen (``mmlspark_tpu_torch/codegen``), its ``__main__`` and
``dl/procedural_shapes.py::digits_as_images`` against the JAX package, on
the CPU.

- The registry finds the reference's 144 stages under the same qualified
  names (the package prefix mapped).
- The params manifest equals the JAX package's committed
  ``docs/api/params_manifest.json`` (read-only) with the prefix mapped:
  stage set, param names and order, dtype, default ``repr`` and complex
  flag exactly; the one extra param is ``device`` (on 36 stages); docs
  may differ, and ``PORT_WORDED_DOCS`` pins how many do.
- Stubs and API docs name the port and cover the same classes and params.
- The R package lexes with balanced delimiters (the lexer of
  ``tests/test_r_bindings.py``) and exports the committed package's
  function names.
- ``testgen``'s files, generated into ``tmp_path``, pass in a child pytest
  on the CPU.
- ``python -m mmlspark_tpu_torch``: ``help``, ``codegen`` in a child
  process, and ``graft-lint``/``lint``/``analysis`` dispatching to the
  port's graft-lint CLI (``--list-rules`` prints its rule catalog).
- ``digits_as_images``: the reference's arrays, identical, with jitter on
  and off.
"""
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from mmlspark_tpu.codegen import registry as jax_registry
from mmlspark_tpu_torch.codegen import (all_stage_classes, generate_all,
                                        generate_docs, generate_r_classes,
                                        generate_stub_file, generate_tests)
from mmlspark_tpu_torch.codegen.codegen import (DEFAULT_OUT_DIR,
                                                generate_manifest)
from tests.test_r_bindings import PAIR, _exported_defs, r_lex

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
API = os.path.join(ROOT, "docs", "api")
#: params whose doc the port words its own way (LightGBM's
#: categorical_features, use_quantized_grad, num_grad_quant_bins on the
#: three estimators, the ranker's max_position, ImageFeaturizer.model)
PORT_WORDED_DOCS = 11
#: stages that take the port's ``device`` param
DEVICE_STAGES = 36


def _ref_name(qual):
    assert qual.startswith("mmlspark_tpu_torch."), qual
    return "mmlspark_tpu." + qual[len("mmlspark_tpu_torch."):]


@pytest.fixture(scope="module")
def manifest(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("manifest") / "params_manifest.json")
    return generate_manifest(path)


def test_registry_finds_the_reference_stages():
    port = [f"{c.__module__}.{c.__qualname__}" for c in all_stage_classes()]
    ref = [f"{c.__module__}.{c.__qualname__}"
           for c in jax_registry.all_stage_classes()]
    assert len(port) == 144
    assert [_ref_name(q) for q in port] == ref
    assert jax_registry.SUBPACKAGES == \
        __import__("mmlspark_tpu_torch.codegen.registry",
                   fromlist=["x"]).SUBPACKAGES


def test_manifest_equals_the_committed_reference_manifest(manifest):
    with open(os.path.join(API, "params_manifest.json")) as f:
        committed = json.load(f)
    port = {_ref_name(k): v for k, v in manifest.items()}
    assert sorted(port) == sorted(committed)
    docs, devices = [], 0
    for qual, entry in committed.items():
        ours = port[qual]["params"]
        extra = [p["name"] for p in ours
                 if p["name"] not in {q["name"] for q in entry["params"]}]
        assert extra in ([], ["device"]), (qual, extra)
        devices += bool(extra)
        ours = [p for p in ours if p["name"] != "device"]
        assert [p["name"] for p in ours] == \
            [p["name"] for p in entry["params"]], qual
        for a, b in zip(ours, entry["params"]):
            for key in ("dtype", "default", "complex"):
                assert a[key] == b[key], (qual, a["name"], key)
            if a["doc"] != b["doc"]:
                docs.append(f"{qual}.{a['name']}")
    assert devices == DEVICE_STAGES
    assert len(docs) == PORT_WORDED_DOCS, docs


def test_stubs_and_docs_name_the_port(tmp_path):
    stub = generate_stub_file(str(tmp_path / "s.pyi"))
    api = generate_docs(str(tmp_path / "API.md"))
    assert stub.startswith("# Auto-generated by mmlspark_tpu_torch.codegen")
    assert api.startswith("# mmlspark_tpu_torch API reference")
    with open(os.path.join(API, "mmlspark_tpu.pyi")) as f:
        ref_stub = f.read()
    classes = re.findall(r"^class (\w+):", stub, re.M)
    assert classes == re.findall(r"^class (\w+):", ref_stub, re.M)
    ref_setters = set(re.findall(r"def (set_\w+)", ref_stub))
    assert ref_setters <= set(re.findall(r"def (set_\w+)", stub))
    assert "## `mmlspark_tpu_torch.lightgbm.estimators`" in api
    assert "| num_leaves |" in api


def test_generate_all_defaults_to_the_ports_own_directory(tmp_path):
    assert DEFAULT_OUT_DIR == os.path.join(ROOT, "mmlspark_tpu_torch",
                                           "_generated")
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert "mmlspark_tpu_torch/_generated/" in f.read().split()
    generate_all(str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == [
        "API.md", "R-package", "mmlspark_tpu_torch.pyi",
        "params_manifest.json"]


def test_r_package_lexes_and_exports_the_reference_names(tmp_path):
    paths = generate_r_classes(str(tmp_path))
    assert len(paths) == 145                       # 144 stages + the core
    exported = set()
    for path in paths:
        with open(path) as f:
            src = f.read()
        stack = []
        for kind, text, ln in r_lex(src, path):
            if kind == "open":
                stack.append(text)
            elif kind == "close":
                assert stack and stack.pop() == PAIR[text], (path, ln)
        assert not stack, path
        exported.update(_exported_defs(path)[0])
    with open(os.path.join(API, "R-package", "NAMESPACE")) as f:
        ref = set(re.findall(r"export\(([^)]+)\)", f.read()))
    with open(tmp_path / "NAMESPACE") as f:
        ours = set(re.findall(r"export\(([^)]+)\)", f.read()))
    assert exported == ours == ref
    core = (tmp_path / "R" / "mmlspark_tpu_torch_core.R").read_text()
    assert 'reticulate::import("mmlspark_tpu_torch")' in core
    assert (tmp_path / "DESCRIPTION").read_text().startswith(
        "Package: mmlsparktputorch")
    gbm = (tmp_path / "R" / "mt_light_gbm_classifier.R").read_text()
    assert "num_iterations = 100" in gbm and "device = NULL" in gbm
    assert "mmlspark_tpu_torch_engine()$lightgbm$estimators$" \
        "LightGBMClassifier()" in gbm


def test_generated_stage_tests_pass_on_the_cpu(tmp_path):
    out = str(tmp_path / "gen")
    paths = generate_tests(out)
    assert len(paths) == 144
    with open(os.path.join(out, "conftest.py")) as f:
        assert "jax" not in f.read()
    seeded = [p for p in paths
              if "test_seeded_experiment_and_model_roundtrip" in open(p).read()]
    assert len(seeded) == 17
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", out, "-q", "-p", "no:cacheprovider",
         "-p", "no:randomly"],
        capture_output=True, text=True, env=env, timeout=600, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-2000:]
    m = re.search(r"(\d+) passed", proc.stdout)
    assert m and int(m.group(1)) == 3 * 144 + 17, proc.stdout[-500:]


def _main(*args, cwd=ROOT):
    return subprocess.run([sys.executable, "-m", "mmlspark_tpu_torch", *args],
                          capture_output=True, text=True, timeout=300,
                          cwd=cwd, env={**os.environ, "PYTHONPATH": ROOT})


def test_main_help_codegen_and_lint(tmp_path, manifest, capsys):
    proc = _main("help")
    assert proc.returncode == 0 and "codegen [out_dir]" in proc.stdout
    assert _main("nonsense").returncode == 2
    proc = _main("codegen", str(tmp_path / "out"))
    assert proc.returncode == 0, proc.stderr[-2000:]
    with open(tmp_path / "out" / "params_manifest.json") as f:
        assert sorted(json.load(f)) == sorted(manifest)
    from mmlspark_tpu_torch.__main__ import main
    from mmlspark_tpu_torch.analysis import rule_catalog
    for cmd in ("graft-lint", "lint", "analysis"):
        capsys.readouterr()
        assert main([cmd, "--list-rules"]) == 0
        listed = capsys.readouterr().out
        assert [line.split()[0] for line in listed.splitlines()] == \
            sorted(rule_catalog())


@pytest.mark.parametrize("jitter", [True, False])
def test_digits_as_images_equal_the_reference(jitter):
    from mmlspark_tpu.dl.procedural_shapes import digits_as_images as ref
    from mmlspark_tpu_torch.dl.procedural_shapes import digits_as_images
    X, y = digits_as_images(jitter=jitter)
    Xr, yr = ref(jitter=jitter)
    assert X.shape == (1797, 32, 32, 3)
    assert X.dtype == Xr.dtype == np.float32 and y.dtype == yr.dtype
    np.testing.assert_array_equal(X, Xr)
    np.testing.assert_array_equal(y, yr)
