"""The port's partition rules and executor processes against the JAX
package's.

- Partition rules: ``tree_path_names`` and ``match_partition_rules`` give
  the reference's names and specs letter for letter on the reference's
  trees (flax params, an optax Adam state, the trainer's ``TrainState``);
  an unmatched leaf raises the reference's error; ``replace_on_mesh``
  keeps each rank's block on a ``data x model`` mesh of 2 executor
  processes x 2 ranks.
- ``run_local_cluster``: real OS processes joined over gloo on a
  ``file://`` rendezvous — a psum across 2 processes of 2 ranks each, the
  reference test's numbers; ``JaxModel`` batch-sharded inference equal to
  one process's (within 1e-6 relative: the blocks are scored by smaller
  matmuls); a cross-process serving round trip on ports the OS picks
  (every routed reply equal, bit for bit, to the scorer called directly);
  VowpalWabbit's pass-end average, equal across ranks and to the numpy
  mean of each rank's one-process weights, bit for bit.

The functions the processes run live at module level and this module
imports no jax at its top.
"""
import os

import numpy as np
import pytest
import torch

from mmlspark_tpu_torch import parallel as TP
from mmlspark_tpu_torch.parallel.executor import (
    ExecutorConfig, free_port, make_cluster_configs, run_local_cluster)
from mmlspark_tpu_torch.parallel.sharding import PartitionSpec

TIMEOUT = 120


def _jax_trees():
    """The reference's trees: flax MLP params, an optax Adam state over
    them, and the JAX trainer's TrainState, all as host numpy."""
    import jax
    import flax.linen as nn
    import optax
    from mmlspark_tpu.parallel.trainer import TrainState

    class MLP(nn.Module):
        @nn.compact
        def __call__(self, x):
            return nn.Dense(8)(nn.relu(nn.Dense(256)(x)))

    params = jax.device_get(MLP().init(jax.random.PRNGKey(0),
                                       np.zeros((2, 16), np.float32))
                            ["params"])
    opt = jax.device_get(optax.adam(1e-2).init(params))
    state = TrainState(params=params, opt_state=opt,
                       step=np.zeros((), np.int32), batch_stats=None)
    return {"params": params, "opt_state": opt,
            "step": np.zeros((), np.int32), "batch_stats": {}}, state


def _port_state(tree):
    from mmlspark_tpu_torch.parallel.trainer import TrainState
    return TrainState(params=tree["params"], opt_state=tree["opt_state"],
                      step=tree["step"], batch_stats=None)


# ---------------------------------------------------------------------------
# partition rules
# ---------------------------------------------------------------------------

def test_path_names_and_specs_are_the_references():
    import jax
    from jax.sharding import PartitionSpec as JP
    from mmlspark_tpu.parallel import partition as JPart
    from mmlspark_tpu.parallel.trainer import param_spec as jax_param_spec
    tree, jstate = _jax_trees()
    for ref_tree, port_tree in ((tree, tree),
                                (jstate, _port_state(tree))):
        want = jax.tree.leaves(JPart.tree_path_names(ref_tree))
        got = [name for name, _ in TP.partition.tree_leaves_with_path(
            TP.tree_path_names(port_tree))]
        assert got == want
    assert "opt_state/0/mu/Dense_0/kernel" in want
    assert "params/Dense_0/kernel" in want

    def kernel(name, leaf):
        return jax_param_spec(leaf, 2, 64)

    def port_kernel(name, leaf):
        spec = jax_param_spec(leaf, 2, 64)
        return PartitionSpec(*tuple(spec))

    for rules_j, rules_p in (
            (((r"^params(/|$)", kernel), (r"^(opt_state|step)(/|$)", JP())),
             ((r"^params(/|$)", port_kernel),
              (r"^(opt_state|step)(/|$)", PartitionSpec()))),
            (((r"kernel$", JP(None, "model")), (".*", JP())),
             ((r"kernel$", PartitionSpec(None, "model")),
              (".*", PartitionSpec())))):
        want = jax.tree.leaves(
            JPart.match_partition_rules(rules_j, tree),
            is_leaf=lambda x: isinstance(x, JP))
        got = [spec for _, spec in TP.partition.tree_leaves_with_path(
            TP.match_partition_rules(rules_p, tree))]
        assert [tuple(s) for s in got] == [tuple(s) for s in want]


def test_an_unmatched_leaf_raises_the_references_error():
    from mmlspark_tpu.parallel import partition as JPart
    tree, _ = _jax_trees()
    rules = ((r"^params/Dense_0(/|$)", PartitionSpec()),)
    with pytest.raises(ValueError) as ref:
        JPart.match_partition_rules(rules, tree)
    with pytest.raises(ValueError) as got:
        TP.match_partition_rules(rules, tree)
    assert str(got.value) == str(ref.value)
    assert "opt_state/0/mu/Dense_0/bias" in str(got.value)
    # a scalar never needs a rule
    assert TP.match_partition_rules((), {"step": np.zeros(())}) == \
        {"step": PartitionSpec()}


# ---------------------------------------------------------------------------
# functions the executor processes run
# ---------------------------------------------------------------------------

def _psum_job(mesh, process_id):
    from mmlspark_tpu_torch.parallel.mesh import world_rank
    assert mesh.devices.size == 4          # 2 processes x 2 ranks
    local = torch.ones((2, 2)) * (process_id + 1)
    row = local[world_rank() % 2]          # this rank's block of its host's
    return float(TP.psum(row.sum(), mesh.axis_names, mesh))


def _replace_job(mesh, process_id):
    tree = {"params": {"w": np.arange(32, dtype=np.float32).reshape(4, 8),
                       "b": np.arange(8, dtype=np.float32)},
            "step": np.zeros(())}
    rules = ((r"/w$", PartitionSpec(None, "model")),
             (r"/b$", PartitionSpec("data")), (".*", PartitionSpec()))
    placed = TP.replace_on_mesh(tree, rules, mesh, site="test.replace")
    return (mesh.axis_index("data"), mesh.axis_index("model"),
            placed["params"]["w"].numpy(), placed["params"]["b"].numpy(),
            float(placed["step"]))


def _features():
    rng = np.random.default_rng(0)           # identical on every process
    return (rng.normal(size=(64, 8)).astype(np.float32),
            rng.normal(size=(8, 3)).astype(np.float32))


def _tanh_apply(state, batch):
    return torch.tanh(batch @ state["w"])


def _score_frame():
    from mmlspark_tpu_torch.core import DataFrame
    from mmlspark_tpu_torch.core.schema import vector_column
    from mmlspark_tpu_torch.dl import JaxModel
    X, W = _features()
    jm = JaxModel()
    jm.set_model(apply_fn=_tanh_apply, variables={"w": W})
    jm.set_params(input_col="features", output_col="out", batch_size=64,
                  device="cpu")
    df = DataFrame.from_dict({"features": vector_column(list(X))})
    out = jm.transform(df).collect()["out"]
    return np.stack([np.asarray(v, np.float32) for v in out])


def _jaxmodel_job(mesh, process_id):
    from mmlspark_tpu_torch.parallel import collectives as TC
    TC.reset_collective_stats()
    got = _score_frame()
    return got, TC.collective_stats()["routes"]


class _DeviceScorer:
    """reply = sum(tanh(x * [1, 2, 3])), computed by torch."""

    @staticmethod
    def score(v: float) -> float:
        return float(torch.tanh(torch.tensor(v) *
                                torch.arange(1.0, 4.0)).sum())


def _scorer_stage():
    from mmlspark_tpu_torch.core import Transformer

    class Scorer(Transformer):
        def _transform(self, df):
            def per_part(p):
                vals = np.asarray([_DeviceScorer.score(float(v))
                                   for v in p["request"]], float)
                return {**p, "reply": vals}
            return df.map_partitions(per_part)

        def transform_schema(self, schema):
            return schema

    return Scorer()


def _serving_job(mesh, process_id):
    import torch.distributed as dist
    from mmlspark_tpu_torch.observability import MetricsRegistry
    from mmlspark_tpu_torch.serving import (RoutingClient, TopologyService,
                                            WorkerServer)
    svc = worker = None
    if process_id == 0:
        svc = TopologyService(port=0, registry=MetricsRegistry()).start()
        worker = WorkerServer(_scorer_stage(), server_id="w0",
                              driver_address=svc.address, port=0,
                              registry=MetricsRegistry()).start()
        port = int(svc.address.rsplit(":", 1)[1])
    else:
        port = 0
    port = int(TP.psum(torch.tensor([port]), "data", mesh))
    dist.barrier()                                   # serving is up
    out = "served"
    if process_id == 1:
        client = RoutingClient(f"http://127.0.0.1:{port}")
        out = [(float(client.request(x)), _DeviceScorer.score(x))
               for x in (0.5, 1.5, 2.5)]
    dist.barrier()                                   # every reply is in
    if worker is not None:
        worker.stop()
        svc.stop()
    return out, port


def _vw_frame(seed):
    from mmlspark_tpu_torch.core import DataFrame
    from mmlspark_tpu_torch.vw.featurizer import VowpalWabbitFeaturizer
    rng = np.random.default_rng(seed)
    x = rng.normal(size=300)
    y = 2.0 * x + rng.normal(scale=0.1, size=300)
    df = DataFrame.from_dict({"x": x, "label": y})
    return VowpalWabbitFeaturizer(input_cols=["x"],
                                  output_col="features").transform(df)


def _vw_fit(seed):
    from mmlspark_tpu_torch.vw import VowpalWabbitRegressor
    return VowpalWabbitRegressor().set_params(
        num_passes=1, num_bits=10, device="cpu").fit(_vw_frame(seed)).weights


def _vw_job(mesh, process_id):
    return np.asarray(_vw_fit(process_id))   # different data per process


def _two_by_two_job(mesh, process_id):
    return _psum_job(mesh, process_id), _replace_job(mesh, process_id)


def _two_process_job(mesh, process_id):
    return {"jaxmodel": _jaxmodel_job(mesh, process_id),
            "serving": _serving_job(mesh, process_id),
            "vw": _vw_job(mesh, process_id)}


@pytest.fixture(scope="module")
def two_by_two():
    """One cluster of 2 executor processes x 2 ranks, ``data x model``."""
    return run_local_cluster(_two_by_two_job, num_processes=2,
                             devices_per_process=2,
                             mesh_axes={"data": 2, "model": 2},
                             timeout_s=TIMEOUT, threads=1)


@pytest.fixture(scope="module")
def two_processes():
    """One cluster of 2 executor processes x 1 rank: sharded scoring, the
    serving round trip and VW, in that order."""
    return run_local_cluster(_two_process_job, num_processes=2,
                             devices_per_process=1, timeout_s=TIMEOUT,
                             threads=1)


# ---------------------------------------------------------------------------
# the executor
# ---------------------------------------------------------------------------

def test_cluster_configs_and_free_port():
    port = free_port()
    assert 0 < port < 65536
    cfgs = make_cluster_configs(2, 2, mesh_axes={"data": 4})
    assert [(c.process_id, c.local_index, c.rank) for c in cfgs] == \
        [(0, 0, 0), (0, 1, 1), (1, 0, 2), (1, 1, 3)]
    assert all(c.world_size == 4 and c.coordinator_address.startswith(
        "127.0.0.1:") for c in cfgs)
    assert ExecutorConfig("h:1", 3, 2).rank == 2


def test_a_psum_across_two_processes_of_two_ranks(two_by_two):
    assert [psum for psum, _ in two_by_two] == [12.0, 12.0]


def test_replace_on_mesh_keeps_each_ranks_block(two_by_two):
    w = np.arange(32, dtype=np.float32).reshape(4, 8)
    b = np.arange(8, dtype=np.float32)
    # the processes' first ranks: global ranks 0 and 2
    got = [placed for _, placed in two_by_two]
    for d, m, wl, bl, step in got:
        np.testing.assert_array_equal(wl, w[:, 4 * m:4 * m + 4])
        np.testing.assert_array_equal(bl, b[4 * d:4 * d + 4])
        assert step == 0.0
    assert [(d, m) for d, m, *_ in got] == [(0, 0), (1, 0)]


def test_sharded_jaxmodel_inference_equals_one_process(two_processes):
    want = _score_frame()                       # one process, world of one
    X, W = _features()
    np.testing.assert_allclose(want, np.tanh(X @ W), rtol=1e-5, atol=1e-6)
    got = [r["jaxmodel"] for r in two_processes]
    for out, routes in got:
        np.testing.assert_allclose(out, want, rtol=1e-6, atol=1e-7)
        # each process scored its half and gathered the other's rows
        assert routes["all_gather/all_gather"]["calls"] == 1
        assert routes["all_gather/all_gather"]["bytes"] == 32 * 3 * 4
    np.testing.assert_array_equal(got[0][0], got[1][0])


def test_serving_round_trip_across_processes(two_processes):
    (served, port0), (replies, port1) = [r["serving"]
                                         for r in two_processes]
    assert served == "served" and port0 == port1 > 0
    assert len(replies) == 3
    for routed, direct in replies:
        assert routed == direct


def test_vw_pass_end_average_across_processes(two_processes):
    got = [r["vw"] for r in two_processes]
    np.testing.assert_array_equal(got[0], got[1])
    assert np.abs(got[0]).sum() > 0
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        alone = [np.asarray(_vw_fit(seed), np.float32) for seed in (0, 1)]
    finally:
        torch.set_num_threads(threads)
    assert not np.array_equal(alone[0], alone[1])
    np.testing.assert_array_equal(got[0], np.mean(np.stack(alone), axis=0))


def test_without_cloudpickle_a_main_function_is_refused(monkeypatch, tmp_path):
    import builtins
    from mmlspark_tpu_torch.parallel import executor as EX
    real = builtins.__import__

    def no_cloudpickle(name, *a, **k):
        if name == "cloudpickle":
            raise ImportError("blocked")
        return real(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_cloudpickle)
    root = str(tmp_path)
    with pytest.raises(ValueError, match="importable"):
        EX._ship(lambda mesh, pid: 0, str(tmp_path / "fn.pkl"), root)
    # this test module is not under the root the ranks import from
    with pytest.raises(ValueError, match="importable"):
        EX._ship(_psum_job, str(tmp_path / "fn.pkl"), root)
    # a module-level function of the package goes by name
    EX._ship(EX.free_port, str(tmp_path / "fn.pkl"),
             os.path.dirname(os.path.dirname(EX.__file__)).rsplit(
                 os.sep, 1)[0])
