"""Generated per-stage binding tests — the PyTestFuzzing equivalent.

Reference: ``core/test/fuzzing/Fuzzing.scala:47-172`` PyTestFuzzing EMITS a
runnable python unittest file per stage (instantiate the generated wrapper
with a full param map, assert wrapper<->engine equality via ModelEquality,
optionally fit) into ``generated/test/python``, executed by
``tools/pytest/run_all_tests.py``.

Here the "wrapper" is the generated binding contract (the params manifest +
synthesised ``set_<name>``/``get_<name>`` accessor surface), so each emitted
``test_gen_<Stage>.py`` asserts, AT RUNTIME:

1. manifest equality — the stage's live Params match the committed manifest
   entry name-for-name, dtype-for-dtype, default-for-default (the
   wrapper<->engine equality check);
2. accessor surface — every simple param round-trips through its fluent
   ``set_<name>`` / ``get_<name>`` pair;
3. serialization — default-constructible stages save/load with identical
   params;
4. experiment — stages with a declared seed (``testing/seeds.py``) fit and
   transform, and the fitted artifact survives save/load
   (SerializationFuzzing semantics).

``generate_tests`` writes the files; run them with pytest (see
``tools/run_generated_tests.py``, the ``run_all_tests.py`` analogue).

The port's twin of the JAX package's ``codegen/testgen.py``.  The files
import ``mmlspark_tpu_torch``; the conftest only puts the checkout on
``sys.path`` (the reference's pins JAX to the CPU).  The experiment half
seeds with ``seed_objects(device="cpu")`` when no CUDA card is present and
on the card otherwise.  ``manifest_path`` defaults to a manifest generated
beside the files from the live registry (the port commits none; the JAX
package's committed ``docs/api`` manifest is held against the port's by the
port's own tests).
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Type

from .registry import all_stage_classes

_CONFTEST = '''\
import sys
sys.path.insert(0, {root!r})  # the checkout that holds mmlspark_tpu_torch
'''

_TEMPLATE = '''\
"""Auto-generated binding test for {qual} — do not edit.

Generated by mmlspark_tpu_torch.codegen.testgen (PyTestFuzzing analogue,
reference Fuzzing.scala:47).  Asserts the live engine class matches the
committed binding manifest, the synthesised accessor surface works, and the
stage serializes (and, with a declared seed, fits/transforms).
"""
import importlib
import json
import tempfile

MANIFEST_PATH = {manifest_path!r}
QUAL = {qual!r}


def _load_cls():
    mod, _, name = QUAL.rpartition(".")
    return getattr(importlib.import_module(mod), name)


def test_manifest_binding_equality():
    cls = _load_cls()
    with open(MANIFEST_PATH) as f:
        entry = json.load(f)[QUAL]
    live = {{p.name: p for p in cls.params()}}
    man = {{p["name"]: p for p in entry["params"]}}
    assert set(live) == set(man), (
        f"param set drifted from committed manifest: "
        f"live-only={{set(live) - set(man)}} manifest-only={{set(man) - set(live)}}")
    for name, p in live.items():
        assert man[name]["dtype"] == p.dtype, f"{{name}}: dtype drift"
        assert man[name]["default"] == repr(p.default), f"{{name}}: default drift"
        assert man[name]["complex"] == p.is_complex, name


def test_accessor_surface():
    cls = _load_cls()
    from mmlspark_tpu_torch.codegen import instantiate_default
    stage = instantiate_default(cls)
    if stage is None:
        return  # needs ctor args; accessor surface covered via seeds
    for p in cls.params():
        if p.is_complex or p.default is None:
            continue
        getattr(stage, "set_" + p.name)(p.default)
        got = stage.get(p.name)
        from mmlspark_tpu_torch.core.params import ServiceValue
        if isinstance(got, ServiceValue):  # ServiceParam wraps literals
            got = got.value
        assert got == p.default, p.name


def test_default_serialization_roundtrip():
    cls = _load_cls()
    from mmlspark_tpu_torch.codegen import instantiate_default
    from mmlspark_tpu_torch.core.serialize import load_stage, save_stage
    stage = instantiate_default(cls)
    if stage is None:
        return
    with tempfile.TemporaryDirectory() as d:
        save_stage(stage, f"{{d}}/s")
        re = load_stage(f"{{d}}/s")
        assert type(re) is type(stage)
        assert re.has_same_params(stage)
{experiment}
'''

_EXPERIMENT = '''\


def test_seeded_experiment_and_model_roundtrip():
    import torch
    from mmlspark_tpu_torch.testing import (ExperimentFuzzing,
                                            SerializationFuzzing)
    from mmlspark_tpu_torch.testing.seeds import seed_objects
    device = None if torch.cuda.is_available() else "cpu"
    obj = seed_objects(device=device)[{short!r}]
    _, out = ExperimentFuzzing.run(obj)
    assert out.count() > 0
    SerializationFuzzing.run(obj)
'''


def generate_tests(out_dir: str, manifest_path: Optional[str] = None) -> List[str]:
    """Emit one runnable pytest file per registered stage; returns paths.
    ``manifest_path`` defaults to ``params_manifest.json`` generated into
    ``out_dir`` from the live registry (the artifact the tests must stay
    equal to)."""
    os.makedirs(out_dir, exist_ok=True)
    if manifest_path is None:
        from .codegen import generate_manifest
        manifest_path = os.path.abspath(
            os.path.join(out_dir, "params_manifest.json"))
        generate_manifest(manifest_path)
    from ..testing.seeds import seed_objects
    seeded = set(seed_objects())
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    with open(os.path.join(out_dir, "conftest.py"), "w") as f:
        f.write(_CONFTEST.format(root=root))
    paths = []
    for cls in all_stage_classes():
        qual = f"{cls.__module__}.{cls.__qualname__}"
        short = cls.__qualname__
        experiment = _EXPERIMENT.format(short=short) if short in seeded else ""
        body = _TEMPLATE.format(qual=qual, manifest_path=manifest_path,
                                experiment=experiment)
        path = os.path.join(out_dir, f"test_gen_{short.replace('.', '_')}.py")
        with open(path, "w") as f:
            f.write(body)
        paths.append(path)
    return paths
