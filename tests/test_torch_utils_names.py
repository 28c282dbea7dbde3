"""The port's package surface and small utilities against the JAX package,
on the CPU: every public name of every reference module with a twin exists
in the twin (with the exemptions listed and commented below); the
``utils``, ``ops`` and ``testing`` packages re-export the reference's
``__all__``; ``ClusterUtil`` (driven with ``set_topology_override``),
``using`` / ``using_many``, ``utils.fault``, ``lightgbm.constants``, and
``LightGBMDelegate`` plugged into ``train()`` / ``train_streamed()``
(boosters equal to the undelegated fits', every array bit for bit).
"""
import ast
import importlib
import os

import numpy as np
import pytest

import mmlspark_tpu.lightgbm.constants as jax_constants
import mmlspark_tpu.ops as jax_ops
import mmlspark_tpu.testing as jax_testing
import mmlspark_tpu.utils as jax_utils
import mmlspark_tpu.utils.cluster as jax_cluster
import mmlspark_tpu.utils.fault as jax_fault
import mmlspark_tpu_torch.lightgbm.constants as port_constants
import mmlspark_tpu_torch.ops as port_ops
import mmlspark_tpu_torch.testing as port_testing
import mmlspark_tpu_torch.utils as port_utils
import mmlspark_tpu_torch.utils.cluster as port_cluster
import mmlspark_tpu_torch.utils.fault as port_fault
from mmlspark_tpu_torch.lightgbm import GBDTParams, train, train_streamed
from mmlspark_tpu_torch.lightgbm.delegate import LightGBMDelegate
from mmlspark_tpu_torch.utils.streams import using, using_many

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = os.path.join(ROOT, "mmlspark_tpu")
PORT = os.path.join(ROOT, "mmlspark_tpu_torch")

#: reference names with no twin, each for a stated reason
EXEMPT = {
    # JAX's own trace directory knob; the port's is TORCH_TRACE_DIR_ENV
    ("observability/profiling.py", "JAX_TRACE_DIR_ENV"),
    # XLA's virtual-CPU-device flag: a torch world is processes, each
    # with its own device (parallel/world.py), so there is nothing to fake
    ("parallel/mesh.py", "host_device_count_flag"),
    # the partition rules the package re-exports: ROADMAP §1 item 10
    ("parallel/__init__.py", "match_partition_rules"),
    ("parallel/__init__.py", "replace_on_mesh"),
    ("parallel/__init__.py", "tree_path_names"),
    # InstrumentedJit's AOT-cache switch; InstrumentedJit is ROADMAP §1
    # item 13 (it raises naming it)
    ("observability/compute.py", "AOT_ENV"),
    # flax's module-type alias (``Any``); the port's ResNet is nn.Modules
    ("models/resnet.py", "ModuleDef"),
}
#: reference modules whose whole surface waits for a queued item
EXEMPT_MODULES = set()


def _public_names(path):
    """Top-level defs, classes and assignments not starting with ``_``,
    and every entry of a literal ``__all__``."""
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    names.add(t.id)
                    if t.id == "__all__":
                        names |= set(ast.literal_eval(node.value))
        elif isinstance(node, ast.AnnAssign) and \
                isinstance(node.target, ast.Name):
            names.add(node.target.id)
    return sorted(n for n in names if not n.startswith("_"))


def _twinned_modules():
    """Reference modules (relative paths) with a twin at the same path."""
    out = []
    for dirpath, _, files in os.walk(REF):
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), REF)
            if f.endswith(".py") and os.path.exists(os.path.join(PORT, rel)):
                out.append(rel)
    return sorted(out)


def test_the_slice_modules_have_twins():
    twins = set(_twinned_modules())
    for rel in ("utils/streams.py", "utils/fault.py", "utils/cluster.py",
                "lightgbm/constants.py", "lightgbm/delegate.py",
                "testing/fuzzing.py", "testing/modifiers.py",
                "testing/benchmarks.py", "testing/chaos.py",
                "testing/seeds.py", "codegen/registry.py",
                "codegen/codegen.py", "codegen/rgen.py",
                "codegen/testgen.py", "__main__.py",
                "dl/procedural_shapes.py", "parallel/mesh.py",
                "parallel/sharding.py", "parallel/collectives.py",
                "parallel/__init__.py"):
        assert rel in twins, rel


@pytest.mark.parametrize("rel", [r for r in _twinned_modules()
                                 if r not in EXEMPT_MODULES])
def test_every_reference_name_exists_in_the_twin(rel):
    mod = "mmlspark_tpu_torch." + rel[:-3].replace(os.sep, ".")
    mod = mod[:-len(".__init__")] if mod.endswith(".__init__") else mod
    twin = importlib.import_module(mod)
    missing = [n for n in _public_names(os.path.join(REF, rel))
               if (rel, n) not in EXEMPT and not hasattr(twin, n)]
    assert not missing, f"{rel}: the port lacks {missing}"


def test_the_exemptions_are_still_needed():
    # an exemption whose name the port has gained must leave the list
    for rel, name in EXEMPT:
        mod = "mmlspark_tpu_torch." + rel[:-3].replace("/", ".")
        mod = mod[:-len(".__init__")] if mod.endswith(".__init__") else mod
        assert not hasattr(importlib.import_module(mod), name), (rel, name)
        assert name in _public_names(os.path.join(REF, rel)), (rel, name)


@pytest.mark.parametrize("pair", [(jax_utils, port_utils),
                                  (jax_ops, port_ops),
                                  (jax_testing, port_testing)],
                         ids=["utils", "ops", "testing"])
def test_packages_export_the_reference_names(pair):
    ref, port = pair
    assert set(port.__all__) >= set(ref.__all__)
    for name in ref.__all__:
        assert hasattr(port, name), name


def test_fault_3_13_imports():
    from mmlspark_tpu_torch.utils import ClusterUtil, StopWatch, using
    from mmlspark_tpu_torch.utils.native_loader import load_native
    import mmlspark_tpu_torch.ops
    assert mmlspark_tpu_torch.ops.image.resize
    assert ClusterUtil is port_cluster.ClusterUtil and StopWatch and using
    lib = load_native()              # the host plane, built with g++
    from mmlspark_tpu_torch.kernels._build import load_host_library
    assert lib is load_host_library() and lib is not None
    assert hasattr(lib, "mm_bin_edges")


# ---------------------------------------------------------------------------
# utils/cluster.py
# ---------------------------------------------------------------------------

TOPOLOGIES = [dict(num_devices=8, num_local_devices=4, num_hosts=2,
                   host_index=1, platform="gpu", coordinator="node0:1234"),
              dict(num_devices=1, num_local_devices=1, num_hosts=1,
                   host_index=0, platform="cpu", coordinator="box:0")]


@pytest.mark.parametrize("topo", TOPOLOGIES, ids=["two_hosts", "one"])
def test_cluster_util_answers_as_the_reference(topo):
    answers = []
    for mod in (jax_cluster, port_cluster):
        cu = mod.ClusterUtil
        cu.set_topology_override(mod.Topology(**topo))
        try:
            answers.append((
                cu.get_num_devices(), cu.get_num_hosts(),
                cu.get_num_tasks_per_executor(), cu.get_driver_host(),
                [cu.default_parallelism(p, r) for p in (0, 1, 3, 16)
                 for r in (None, 2, 32)],
                cu.get_topology().platform))
        finally:
            cu.set_topology_override(None)
    assert answers[0] == answers[1]


def test_cluster_util_reports_this_host_without_a_card(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("MMLSPARK_TPU_COORDINATOR", "driver:7")
    topo = port_cluster.ClusterUtil.get_topology()
    assert (topo.num_devices, topo.num_hosts, topo.host_index,
            topo.platform) == (1, 1, 0, "cpu")
    assert port_cluster.ClusterUtil.get_driver_host() == "driver"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    topo = port_cluster.ClusterUtil.get_topology()
    assert (topo.num_devices, topo.num_local_devices, topo.platform) == \
        (4, 4, "gpu")
    assert port_cluster.ClusterUtil.default_parallelism(16) == 4
    assert port_cluster.ClusterUtil.default_parallelism(3) == 3


def test_cluster_util_reads_an_initialised_process_group(tmp_path):
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            world_size=1, rank=0)
    try:
        topo = port_cluster.ClusterUtil.get_topology()
        assert (topo.num_devices, topo.num_hosts, topo.host_index) == \
            (1, 1, 0)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# utils/streams.py, utils/fault.py, lightgbm/constants.py
# ---------------------------------------------------------------------------

class _Res:
    def __init__(self, fail_close=False):
        self.closed = False
        self.fail_close = fail_close

    def close(self):
        self.closed = True
        if self.fail_close:
            raise OSError("close failed")


def test_using_closes_even_when_fn_raises():
    r = _Res()
    assert using(r, lambda x: 7) == 7 and r.closed
    r = _Res()
    with pytest.raises(ValueError):
        using(r, lambda x: (_ for _ in ()).throw(ValueError("boom")))
    assert r.closed


def test_using_many_closes_all_and_swallows_close_errors():
    rs = [_Res(), _Res(fail_close=True), _Res()]
    assert using_many(iter(rs), len) == 3
    assert all(r.closed for r in rs)
    rs = [_Res(), _Res()]

    def boom(_):
        raise KeyError("x")
    with pytest.raises(KeyError):
        using_many(rs, boom)
    assert all(r.closed for r in rs)


def test_fault_and_constants_match_the_reference():
    assert port_fault.__all__ == jax_fault.__all__
    from mmlspark_tpu_torch.utils import resilience
    for name in port_fault.__all__:
        assert getattr(port_fault, name) is getattr(resilience, name)
    ref = {k: v for k, v in vars(jax_constants).items()
           if k.isupper()}
    assert ref and ref == {k: v for k, v in vars(port_constants).items()
                           if k.isupper()}


# ---------------------------------------------------------------------------
# lightgbm/delegate.py
# ---------------------------------------------------------------------------

class _Recorder(LightGBMDelegate):
    def __init__(self):
        self.seen = []

    def after_training_iteration(self, iteration, eval_result=None):
        self.seen.append((iteration, eval_result))


def _same_booster(a, b):
    for k in a._present_arrays():
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k), err_msg=k)


@pytest.mark.parametrize("driver", ["train", "train_streamed"])
def test_delegate_sees_every_iteration_and_changes_nothing(driver):
    rng = np.random.default_rng(4)
    X = rng.normal(size=(600, 5)).astype(np.float32)
    y = (X[:, 0] - X[:, 2] > 0).astype(np.float32)
    Xv = rng.normal(size=(200, 5)).astype(np.float32)
    yv = (Xv[:, 0] - Xv[:, 2] > 0).astype(np.float32)
    params = GBDTParams(num_iterations=6, num_leaves=7, objective="binary",
                        min_data_in_leaf=5)
    if driver == "train":
        def fit(**kw):
            return train(X, y, params, valid=(Xv, yv), device="cpu", **kw)
    else:
        def fit(**kw):
            return train_streamed(X, y, params, tile_rows=256,
                                  device="cpu", **kw)
    delegate = _Recorder()
    plain = fit()
    hooked = fit(callbacks=[delegate.as_callback()])
    _same_booster(plain.booster, hooked.booster)
    assert [it for it, _ in delegate.seen] == list(range(6))
    if driver == "train":
        assert all(ev is not None for _, ev in delegate.seen)
    base = LightGBMDelegate()
    assert base.get_learning_rate(3, 0.1) == 0.1
    assert base.before_training_iteration(0) is None
