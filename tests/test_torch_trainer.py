"""The port's ``parallel.trainer`` and ``parallel.checkpoint``, the ResNet's
training mode and ``InstrumentedJit`` against the JAX package's on the same
seeded inputs.

The port's ranks run in worlds of 2 and 4 CPU ranks
(``parallel.world.World`` over gloo, one spawn each, shared by the
module); the JAX side runs on the conftest's virtual CPU devices with the
same mesh.  The functions the ranks run live at module level and this
module imports no jax at its top.

Tolerances: losses step for step within rtol 1e-5 of the JAX trainer's
(the reference test's MLP under SGD at data 2 and at data 2 x model 2, the
BatchNorm ConvNet at data 2); BatchNorm statistics within 1e-6 (rtol and
atol); the ResNet's ``train=True`` outputs within 1e-5 of the largest
output; a checkpoint round trip bit for bit; an elastic resume from world
2 onto world 1 within rtol 1e-5 of the uninterrupted losses.
"""
import itertools

import numpy as np
import pytest
import torch

from mmlspark_tpu_torch import parallel as TP
from mmlspark_tpu_torch.models.resnet import BatchNorm
from mmlspark_tpu_torch.parallel.world import World

RTOL = 1e-5


@pytest.fixture(scope="module")
def world2():
    with World(2, threads=1) as w:
        yield w


@pytest.fixture(scope="module")
def world4():
    with World(4, threads=1) as w:
        yield w


# ---------------------------------------------------------------------------
# the port's models and the functions the ranks run
# ---------------------------------------------------------------------------

def _mlp():
    return torch.nn.Sequential(torch.nn.Linear(16, 256), torch.nn.ReLU(),
                               torch.nn.Linear(256, 8))


class _ConvNet(torch.nn.Module):
    """The reference test's ConvNet: 3x3 conv (SAME), BatchNorm (flax's
    defaults: momentum 0.99, eps 1e-5), relu, spatial mean, Dense(4)."""

    def __init__(self):
        super().__init__()
        self.conv = torch.nn.Conv2d(3, 8, 3, padding=1)
        self.bn = BatchNorm(8, momentum=0.99)
        self.dense = torch.nn.Linear(8, 4)

    def forward(self, x, train: bool = False):
        x = self.conv(x.permute(0, 3, 1, 2))
        x = torch.relu(self.bn(x, train))
        return self.dense(x.mean(dim=(2, 3)))


def _sgd(lr):
    return lambda ps: torch.optim.SGD(ps, lr=lr)


def _rank_steps(kind, axes, state, batch, lr, steps, min_size):
    from mmlspark_tpu_torch.parallel.trainer import (Trainer,
                                                     softmax_cross_entropy)
    module = _mlp() if kind == "mlp" else _ConvNet()
    module.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    mesh = TP.make_mesh(axes, device="cpu")
    tr = Trainer(module, _sgd(lr), softmax_cross_entropy, mesh=mesh,
                 has_batch_stats=kind == "conv", min_shard_size=min_size)
    st = tr.init_state(None, batch)
    shapes = {n: tuple(v.shape) for n, v in
              TP.partition.tree_leaves_with_path(st.params)}
    losses = []
    for _ in range(steps):
        st, loss = tr.train_step(st, batch)
        losses.append(float(loss))
    full = tr.full_state(st)
    return losses, shapes, full.params, full.batch_stats, int(st.step)


def _resnet_trainer(mesh, seed=0):
    from mmlspark_tpu_torch.models.resnet import resnet18
    from mmlspark_tpu_torch.parallel.trainer import (Trainer,
                                                     softmax_cross_entropy)
    module = resnet18(num_classes=4,
                      generator=torch.Generator().manual_seed(seed))
    return Trainer(module, lambda ps: torch.optim.SGD(ps, lr=0.01,
                                                      momentum=0.9),
                   softmax_cross_entropy, mesh=mesh, has_batch_stats=True,
                   min_shard_size=2 ** 12)


def _resnet_batches(n=6):
    """Learnable batches: the label is the quadrant of the first two
    channels' means."""
    r = np.random.default_rng(42)
    for _ in range(n):
        x = r.normal(size=(8, 32, 32, 3)).astype(np.float32)
        m = x[..., :2].mean(axis=(1, 2))
        yield {"x": x, "y": (2 * (m[:, 0] > 0) + (m[:, 1] > 0)).astype(
            np.int64)}


def _same(a, b) -> bool:
    fa = dict(TP.partition.tree_leaves_with_path(a))
    fb = dict(TP.partition.tree_leaves_with_path(b))
    return fa.keys() == fb.keys() and all(
        np.array_equal(np.asarray(fa[k]), np.asarray(fb[k])) for k in fa)


def _rank_checkpoint_round_trip(path, backend="npz"):
    from mmlspark_tpu_torch.parallel.checkpoint import (load_train_state,
                                                        save_train_state)
    mesh = TP.make_mesh({"data": 2}, device="cpu")
    batch = next(_resnet_batches(1))
    tr = _resnet_trainer(mesh)
    st = tr.init_state()
    st, _ = tr.train_step(st, batch)
    save_train_state(st, path, backend=backend, trainer=tr)
    tr2 = _resnet_trainer(mesh, seed=7)
    template = tr2.init_state() if backend == "orbax" else None
    restored = load_train_state(path, trainer=tr2, template=template)
    a, b = tr.full_state(st), tr2.full_state(restored)
    same = [_same(a.params, b.params), _same(a.opt_state, b.opt_state),
            _same(a.batch_stats, b.batch_stats), int(a.step) == int(b.step)]
    _, la = tr.train_step(st, batch)
    _, lb = tr2.train_step(restored, batch)
    return same, float(la) == float(lb), int(b.step)


def _rank_stream_full():
    tr = _resnet_trainer(TP.make_mesh({"data": 2}, device="cpu"))
    _, losses, stats = tr.train_stream(tr.init_state(), _resnet_batches())
    return losses, stats


def _rank_stream_part(path):
    tr = _resnet_trainer(TP.make_mesh({"data": 2}, device="cpu"))
    _, losses, stats = tr.train_stream(
        tr.init_state(), itertools.islice(_resnet_batches(), 2),
        checkpoint_dir=path, checkpoint_every=2)
    return losses, stats


# ---------------------------------------------------------------------------
# the JAX side
# ---------------------------------------------------------------------------

def _jax_mesh(axes):
    import jax
    from mmlspark_tpu.parallel import make_mesh
    n = int(np.prod(list(axes.values())))
    return make_mesh(axes, jax.devices()[:n])


def _jax_mlp():
    import flax.linen as nn

    class MLP(nn.Module):
        @nn.compact
        def __call__(self, x):
            x = nn.relu(nn.Dense(256)(x))
            return nn.Dense(8)(x)

    return MLP()


def _jax_convnet():
    import flax.linen as nn

    class ConvNet(nn.Module):
        @nn.compact
        def __call__(self, x, train: bool = False):
            x = nn.Conv(8, (3, 3))(x)
            x = nn.BatchNorm(use_running_average=not train)(x)
            x = nn.relu(x).mean(axis=(1, 2))
            return nn.Dense(4)(x)

    return ConvNet()


def _port_weights(kind, params, batch_stats=None):
    """The port module's state_dict (numpy) of the flax variables."""
    p = {k: np.asarray(v) for k, v in _flat_dict(params).items()}
    if kind == "mlp":
        return {"0.weight": p["Dense_0/kernel"].T.copy(),
                "0.bias": p["Dense_0/bias"],
                "2.weight": p["Dense_1/kernel"].T.copy(),
                "2.bias": p["Dense_1/bias"]}
    bs = {k: np.asarray(v) for k, v in _flat_dict(batch_stats).items()}
    return {"conv.weight": p["Conv_0/kernel"].transpose(3, 2, 0, 1).copy(),
            "conv.bias": p["Conv_0/bias"],
            "bn.weight": p["BatchNorm_0/scale"],
            "bn.bias": p["BatchNorm_0/bias"],
            "bn.running_mean": bs["BatchNorm_0/mean"],
            "bn.running_var": bs["BatchNorm_0/var"],
            "dense.weight": p["Dense_0/kernel"].T.copy(),
            "dense.bias": p["Dense_0/bias"]}


def _flat_dict(d, prefix=""):
    out = {}
    for k, v in d.items():
        name = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flat_dict(v, name))
        else:
            out[name] = v
    return out


def _jax_run(kind, axes, batch, lr, steps, min_size):
    import jax
    import optax
    from mmlspark_tpu.parallel import active_mesh
    from mmlspark_tpu.parallel.trainer import Trainer, softmax_cross_entropy
    mesh = _jax_mesh(axes)
    module = _jax_mlp() if kind == "mlp" else _jax_convnet()
    with active_mesh(mesh):
        tr = Trainer(module, optax.sgd(lr), softmax_cross_entropy,
                     mesh=mesh, has_batch_stats=kind == "conv",
                     min_shard_size=min_size)
        st = tr.init_state(jax.random.PRNGKey(0), batch)
        weights = _port_weights(kind, jax.device_get(st.params),
                                jax.device_get(st.batch_stats)
                                if kind == "conv" else None)
        losses = []
        for _ in range(steps):
            st, loss = tr.train_step(st, batch)
            losses.append(float(loss))
    return weights, losses, jax.device_get(st.params), \
        jax.device_get(st.batch_stats)


# ---------------------------------------------------------------------------
# the trainer against the reference's
# ---------------------------------------------------------------------------

def _mlp_batch():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(32, 16)).astype(np.float32)
    return {"x": x, "y": ((x[:, 0] > 0).astype(np.int32) * 7)}


def test_mlp_data_parallel_losses_equal_jax(world2):
    batch = _mlp_batch()
    weights, want, _, _ = _jax_run("mlp", {"data": 2}, batch, 0.1, 6, 2 ** 16)
    runs = world2.run(_rank_steps, "mlp", {"data": 2}, weights, batch, 0.1,
                      6, 2 ** 16)
    for losses, shapes, params, _, step in runs:
        np.testing.assert_allclose(losses, want, rtol=RTOL)
        assert shapes["0/weight"] == (256, 16) and step == 6
    assert _same(runs[0][2], runs[1][2])
    assert want[-1] < want[0]


def test_mlp_data_x_model_losses_equal_jax_with_sharded_kernels(world4):
    batch = _mlp_batch()
    axes = {"data": 2, "model": 2}
    weights, want, jparams, _ = _jax_run("mlp", axes, batch, 0.1, 6, 64)
    runs = world4.run(_rank_steps, "mlp", axes, weights, batch, 0.1, 6, 64)
    final = _port_weights("mlp", jparams)
    for losses, shapes, params, _, _ in runs:
        np.testing.assert_allclose(losses, want, rtol=RTOL)
        # the rule: >= 2-d kernels of >= 64 elements shard their last axis
        assert shapes == {"0/weight": (256, 8), "0/bias": (256,),
                          "2/weight": (8, 128), "2/bias": (8,)}
        for name, v in TP.partition.tree_leaves_with_path(params):
            np.testing.assert_allclose(v, final[name.replace("/", ".")],
                                       rtol=1e-4, atol=1e-6)
    for r in runs[1:]:
        assert _same(runs[0][2], r[2])


def test_batchnorm_convnet_losses_and_statistics_equal_jax(world2):
    rng = np.random.default_rng(1)
    batch = {"x": rng.normal(size=(16, 8, 8, 3)).astype(np.float32),
             "y": rng.integers(0, 4, 16).astype(np.int32)}
    weights, want, _, jstats = _jax_run("conv", {"data": 2}, batch, 0.1, 4,
                                        2 ** 16)
    runs = world2.run(_rank_steps, "conv", {"data": 2}, weights, batch, 0.1,
                      4, 2 ** 16)
    for losses, _, _, stats, _ in runs:
        np.testing.assert_allclose(losses, want, rtol=RTOL)
        np.testing.assert_allclose(stats["bn"]["running_mean"],
                                   jstats["BatchNorm_0"]["mean"],
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(stats["bn"]["running_var"],
                                   jstats["BatchNorm_0"]["var"],
                                   rtol=1e-6, atol=1e-6)
    assert _same(runs[0][3], runs[1][3])


def test_resnet18_checkpoint_round_trip(world2, tmp_path):
    """Both backends round-trip at world 2 (``orbax`` through
    ``torch.distributed.checkpoint`` into a template), and both
    snapshots of the ranks' state resume at world 1, equal bit for bit
    with the same next loss."""
    from mmlspark_tpu_torch.parallel.checkpoint import load_train_state
    for backend in ("npz", "orbax"):
        runs = world2.run(_rank_checkpoint_round_trip,
                          str(tmp_path / backend), backend)
        for same, next_equal, step in runs:
            assert same == [True, True, True, True] and next_equal and \
                step == 1
    assert (tmp_path / "orbax" / "LATEST_BACKEND").read_text() == "orbax"
    assert (tmp_path / "orbax" / "orbax" / ".metadata").exists()
    mesh1 = TP.make_mesh({"data": 1}, device="cpu")
    tr_n, tr_o = _resnet_trainer(mesh1, seed=3), _resnet_trainer(mesh1,
                                                                 seed=5)
    st_n = load_train_state(str(tmp_path / "npz"), trainer=tr_n)
    st_o = load_train_state(str(tmp_path / "orbax"), trainer=tr_o,
                            template=tr_o.init_state())
    a, b = tr_n.full_state(st_n), tr_o.full_state(st_o)
    assert _same(a.params, b.params) and _same(a.opt_state, b.opt_state)
    assert _same(a.batch_stats, b.batch_stats) and int(b.step) == 1
    batch = next(_resnet_batches(1))
    assert float(tr_n.train_step(st_n, batch)[1]) == \
        float(tr_o.train_step(st_o, batch)[1])


def _mlp_state(seed, steps=1):
    """A world-1 MLP trainer under Adam (its state made at the first
    step) after ``steps`` steps."""
    from mmlspark_tpu_torch.parallel.trainer import (Trainer,
                                                     softmax_cross_entropy)
    torch.manual_seed(seed)
    tr = Trainer(_mlp(), lambda ps: torch.optim.Adam(ps, lr=1e-2),
                 softmax_cross_entropy,
                 mesh=TP.make_mesh({"data": 1}, device="cpu"))
    st = tr.init_state()
    rng = np.random.default_rng(seed)
    batch = {"x": rng.normal(size=(8, 16)).astype(np.float32),
             "y": rng.integers(0, 8, 8)}
    for _ in range(steps):
        st, _ = tr.train_step(st, batch)
    return tr, st, batch


def test_orbax_backend_round_trips_at_world_1_and_needs_a_template(tmp_path):
    """The Adam state a fresh template lacks is restored from the
    checkpoint's own entries; without ``template`` the restore raises."""
    from mmlspark_tpu_torch.parallel.checkpoint import (load_train_state,
                                                        save_train_state)
    tr, st, batch = _mlp_state(0)
    save_train_state(st, str(tmp_path), backend="orbax", trainer=tr)
    tr2, _, _ = _mlp_state(1, steps=0)
    with pytest.raises(ValueError, match="template"):
        load_train_state(str(tmp_path), trainer=tr2)
    template = tr2.init_state()
    assert template.opt_state == {}
    restored = load_train_state(str(tmp_path), trainer=tr2,
                                template=template)
    a, b = tr.full_state(st), tr2.full_state(restored)
    assert _same(a.params, b.params) and _same(a.opt_state, b.opt_state)
    assert a.opt_state and int(b.step) == 1
    assert float(tr.train_step(st, batch)[1]) == \
        float(tr2.train_step(restored, batch)[1])
    # a second save publishes over the first
    st, _ = tr.train_step(st, batch)
    save_train_state(st, str(tmp_path), backend="orbax", trainer=tr)
    again = load_train_state(str(tmp_path), template=tr2.init_state(),
                             backend="orbax")
    assert int(again.step) == int(st.step) == 2
    assert sorted(p.name for p in tmp_path.iterdir()) == \
        ["LATEST_BACKEND", "orbax"]


def test_checkpoint_backend_marker_beats_mtime(tmp_path):
    """The port's twin of the reference's marker test
    (``tests/test_advice_fixes.py``): where both backends wrote, the
    marker decides, not cp/rsync-fragile mtimes; a forced ``backend=``
    wins over everything; without the marker the newer artifact wins."""
    import os
    from mmlspark_tpu_torch.parallel.checkpoint import (load_train_state,
                                                        save_train_state)
    from mmlspark_tpu_torch.parallel.trainer import TrainState
    w = np.arange(4, dtype=np.float32)
    state_a = TrainState(params={"w": w}, opt_state={}, step=1)
    state_b = TrainState(params={"w": w + 10}, opt_state={}, step=2)
    path = str(tmp_path / "ckpt")
    save_train_state(state_a, path, backend="orbax")
    save_train_state(state_b, path, backend="npz")   # npz wrote last
    os.utime(os.path.join(path, "orbax"))            # adversarial mtime
    assert int(load_train_state(path).step) == 2     # marker wins
    template = TrainState(params={"w": np.zeros(4, np.float32)},
                          opt_state={}, step=0)
    forced = load_train_state(path, template=template, backend="orbax")
    assert int(forced.step) == 1                     # explicit wins
    np.testing.assert_array_equal(forced.params["w"], w)
    os.remove(os.path.join(path, "LATEST_BACKEND"))  # a pre-marker dir
    assert int(load_train_state(path, template=template).step) == 1
    later = os.path.getmtime(os.path.join(path, "orbax")) + 10
    os.utime(os.path.join(path, "state.npz"), (later, later))
    assert int(load_train_state(path, template=template).step) == 2


def test_a_jax_written_orbax_checkpoint_says_what_it_is(tmp_path):
    """The JAX package's orbax directory has no DCP metadata: the port
    refuses it with a message naming its writer (ROADMAP fact 3.20)."""
    import jax.numpy as jnp
    import optax
    from mmlspark_tpu.parallel.checkpoint import \
        save_train_state as j_save
    from mmlspark_tpu.parallel.trainer import TrainState as JState
    from mmlspark_tpu_torch.parallel.checkpoint import load_train_state
    from mmlspark_tpu_torch.parallel.trainer import TrainState
    params = {"w": jnp.arange(4, dtype=jnp.float32)}
    j_save(JState(params=params, opt_state=optax.sgd(0.1).init(params),
                  step=1), str(tmp_path), backend="orbax")
    template = TrainState(params={"w": np.zeros(4, np.float32)},
                          opt_state={}, step=0)
    with pytest.raises(NotImplementedError, match="JAX package's orbax"):
        load_train_state(str(tmp_path), template=template)


def test_trainer_stream_resume_across_device_count(world2, tmp_path):
    """The reference's elastic resume, world 2 -> world 1: the snapshot
    of a 2-rank stream restores onto this process's 1-position mesh."""
    from mmlspark_tpu_torch.observability import get_registry
    (full, st_full), _ = world2.run(_rank_stream_full)
    d = str(tmp_path / "ck")
    (part, st1), _ = world2.run(_rank_stream_part, d)
    assert st1["steps"] == 2.0 and st1["resharded"] == 0.0
    np.testing.assert_array_equal(part, full[:2])
    tr1 = _resnet_trainer(TP.make_mesh({"data": 1}, device="cpu"))
    state, tail, st2 = tr1.train_stream(tr1.init_state(), _resnet_batches(),
                                        checkpoint_dir=d,
                                        checkpoint_every=2, resume="must")
    assert st2["resumed_from_step"] == 2.0 and st2["steps"] == 6.0
    assert st2["resharded"] == 1.0 and int(state.step) == 6
    np.testing.assert_allclose(tail, full[2:], rtol=RTOL, atol=1e-6)
    fam = get_registry().family("mmlspark_reshard_total")
    assert fam.labels(driver="parallel.trainer",
                      direction="shrink").value >= 1


def test_parallel_entry_points_need_the_card_unless_told_cpu(monkeypatch):
    """Without a card, the trainer and the step makers raise unless their
    mesh was built with ``device="cpu"``."""
    from mmlspark_tpu_torch.models.transformer import TransformerEncoder
    from mmlspark_tpu_torch.parallel.moe import MoELayer, shard_moe_params
    from mmlspark_tpu_torch.parallel.pipeline_parallel import \
        make_pipeline_train_step
    from mmlspark_tpu_torch.parallel.ring_attention import \
        make_ring_attention_fn
    from mmlspark_tpu_torch.parallel.seq_parallel import \
        make_seq_parallel_train_step
    from mmlspark_tpu_torch.parallel.trainer import (Trainer,
                                                     softmax_cross_entropy)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    axes = {"data": 1, "seq": 1, "pipe": 1, "expert": 1}
    moe = MoELayer(2, 4, 3)
    builds = (
        lambda m: Trainer(_mlp(), _sgd(0.1), softmax_cross_entropy, mesh=m),
        lambda m: make_seq_parallel_train_step(
            TransformerEncoder(8, num_classes=2, embed_dim=4, num_heads=1,
                               num_layers=1, mlp_dim=4, max_len=8,
                               attention_mode="ring", pool="none"), 0.1, m),
        lambda m: make_pipeline_train_step(
            lambda p, x: x, 1, lambda o, y: o.sum(), mesh=m),
        lambda m: make_ring_attention_fn(m),
        lambda m: shard_moe_params(dict(moe.state_dict()), m))
    for build in builds:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build(TP.make_mesh(axes))
        build(TP.make_mesh(axes, device="cpu"))


# ---------------------------------------------------------------------------
# the ResNet's training mode
# ---------------------------------------------------------------------------

def test_resnet_train_mode_equals_flax_with_updated_statistics():
    import jax
    from mmlspark_tpu.models.resnet import (BottleneckBlock as JB,
                                            ResNet as JR)
    from mmlspark_tpu_torch.convert import resnet_state_dict_from_flax
    from mmlspark_tpu_torch.models.resnet import BottleneckBlock, ResNet
    ref = JR([1, 1], JB, num_classes=4, num_filters=8)
    x = np.random.default_rng(0).normal(size=(4, 16, 16, 3)).astype(
        np.float32)
    variables = jax.jit(ref.init)(jax.random.PRNGKey(0), x)
    rng = np.random.default_rng(1)     # every BN parameter off its init
    variables = jax.tree.map(
        lambda a: np.asarray(a) + 0.1 * rng.normal(size=a.shape).astype(
            np.float32), variables)
    want, upd = jax.jit(lambda v, x: ref.apply(
        v, x, train=True, mutable=["batch_stats"]))(variables, x)
    port = ResNet([1, 1], BottleneckBlock, num_classes=4, num_filters=8)
    port.load_state_dict(resnet_state_dict_from_flax(variables, port))
    got = port(torch.from_numpy(x), train=True)
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    new = resnet_state_dict_from_flax(
        {"params": variables["params"], "batch_stats": upd["batch_stats"]})
    running = {k: v for k, v in port.state_dict().items() if "running" in k}
    assert len(running) == 2 * 9            # bn_init + 4 in each block
    for k, v in running.items():
        np.testing.assert_allclose(v.numpy(), new[k].numpy(), rtol=1e-6,
                                   atol=1e-6, err_msg=k)
    # train=False is the running statistics' path, untouched by it
    before = {k: v.clone() for k, v in running.items()}
    port(torch.from_numpy(x))
    assert all(torch.equal(before[k], port.state_dict()[k]) for k in before)


# ---------------------------------------------------------------------------
# InstrumentedJit
# ---------------------------------------------------------------------------

def test_instrumented_jit_books_signatures_like_the_reference():
    import jax.numpy as jnp
    from mmlspark_tpu.observability import MetricsRegistry as JaxRegistry
    from mmlspark_tpu.observability import compute as JC
    from mmlspark_tpu_torch.observability import MetricsRegistry
    from mmlspark_tpu_torch.observability import compute as PC

    jreg, preg = JaxRegistry(), MetricsRegistry()
    jf = JC.instrumented_jit(lambda x, n: x * n, name="f", registry=jreg,
                             storm_signatures=3, static_argnums=(1,))
    pf = PC.instrumented_jit(lambda x, n: x * n, name="f", registry=preg,
                             storm_signatures=3, static_argnums=(1,))
    calls = [(np.ones((3, 4), np.float32), 2),
             (np.full((3, 4), 5, np.float32), 2),     # same signature
             (np.ones((3, 4), np.float32), 3),        # new static value
             (np.ones((5,), np.float32), 2),          # new shape: storm
             (np.ones((5,), np.int32), 2)]
    for x, n in calls:
        np.testing.assert_array_equal(
            pf(torch.from_numpy(x), n).numpy(),
            np.asarray(jf(jnp.asarray(x), n)))
    assert pf.compiles == jf.compiles == 4
    want = JC.compile_report(jreg)["functions"]["f"]
    got = PC.compile_report(preg)["functions"]["f"]
    assert set(got) == set(want)
    assert got["compiles"] == want["compiles"] == 4
    assert got["storm_tripped"] and want["storm_tripped"]
    assert [s["signature"] for s in got["signatures"]] == \
        [s["signature"] for s in want["signatures"]]
    assert got["signatures"][0]["signature"] == "f32[3,4], static:2"
    assert got["last_cost_analysis"] is None
    for reg in (jreg, preg):
        fams = reg.to_dict()
        assert fams["mmlspark_jit_recompile_storm_total"]["samples"][0][
            "value"] == 2.0
        assert fams["mmlspark_jit_compile_total"]["samples"][0][
            "value"] == 4.0
    assert pf.last_compile_s >= 0 and pf.snapshot()["fn"] == "f"
    # nests and keywords key by structure, shape and dtype
    g = PC.instrumented_jit(lambda t, scale=1.0: t["a"] * scale,
                            name="g", registry=preg)
    g({"a": torch.ones(2)}, scale=2.0)
    g({"a": torch.zeros(2)}, scale=3.0)
    assert g.compiles == 1
    g({"a": torch.ones(3)}, scale=2.0)
    assert g.compiles == 2
