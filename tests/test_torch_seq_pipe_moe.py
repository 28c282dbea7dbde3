"""Ring attention, the sequence-parallel step, the pipeline and the experts
of the port's ``parallel`` package against the JAX package's on the same
seeded inputs.

The port runs in a world of 4 CPU ranks (``parallel.world.World`` over
gloo, one spawn shared by the module); each test lays out its own mesh on
it.  The JAX side runs on the conftest's virtual CPU devices with the same
mesh.  The functions the ranks run live at module level and this module
imports no jax at its top (a rank imports it by name).

Tolerances: attention outputs within 1e-5 absolute of the JAX function's
and of dense numpy attention; losses step for step within rtol 1e-5 of the
JAX step's, which pins the gradient scale each step takes (the sequence
step's P = data x seq, the pipeline's S, the experts' exact gradient);
the pipeline's forward within 1e-5 of the sequential stack.
"""
import numpy as np
import pytest
import torch

from mmlspark_tpu_torch import parallel as TP
from mmlspark_tpu_torch.parallel.world import World

WIDTH = 4
ATOL = 1e-5
RTOL = 1e-5


@pytest.fixture(scope="module")
def world4():
    with World(WIDTH, threads=1) as w:
        yield w


def dense_attention(q, k, v, causal=False):
    d = q.shape[-1]
    s = (q @ np.swapaxes(k, -1, -2)) / np.sqrt(d)
    if causal:
        L = q.shape[-2]
        s = np.where(np.tril(np.ones((L, L), bool)), s, -1e30)
    s = s - s.max(axis=-1, keepdims=True)
    p = np.exp(s)
    return (p / p.sum(axis=-1, keepdims=True)) @ v


# ---------------------------------------------------------------------------
# functions the ranks run
# ---------------------------------------------------------------------------

def _rank_ring(axes, q, k, v, causal):
    from mmlspark_tpu_torch.parallel.ring_attention import \
        make_ring_attention_fn
    mesh = TP.make_mesh(axes, device="cpu")
    fn = make_ring_attention_fn(mesh, causal=causal)
    out = fn(*(torch.from_numpy(a) for a in (q, k, v)))
    return out.numpy(), fn.compiles


def _rank_seq_steps(cfg, state, tokens, positions, labels, lr, steps):
    from mmlspark_tpu_torch.models.transformer import TransformerEncoder
    from mmlspark_tpu_torch.parallel.seq_parallel import \
        make_seq_parallel_train_step
    mesh = TP.make_mesh({"data": 2, "seq": 2}, device="cpu")
    module = TransformerEncoder(**cfg)
    module.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    init_fn, step_fn = make_seq_parallel_train_step(module, lr, mesh)
    params = init_fn(None, tokens, positions)
    losses = []
    for _ in range(steps):
        params, loss = step_fn(params, tokens, positions, labels)
        losses.append(float(loss))
    return losses, {k: v.numpy() for k, v in params.items()}


def _stage_apply(p, x):
    return torch.tanh(x @ p["W"] + p["b"])


def _mse(outs, y):
    return torch.mean((outs - y) ** 2)


def _rank_pipeline(params, x, y, lr, steps):
    from mmlspark_tpu_torch.parallel.pipeline_parallel import \
        make_pipeline_train_step
    mesh = TP.make_mesh({"pipe": 4}, device="cpu")
    S = params["W"].shape[0]
    init_fn, step_fn, fwd_fn = make_pipeline_train_step(
        _stage_apply, S, _mse, learning_rate=lr, mesh=mesh)
    p = init_fn(params)
    out = fwd_fn(p, x).numpy()
    losses = []
    for _ in range(steps):
        p, loss = step_fn(p, x, y)
        losses.append(float(loss))
    return out, losses, {k: v.numpy() for k, v in p.items()}


def _rank_moe(cfg, state, x, y, steps):
    from torch.func import functional_call
    from mmlspark_tpu_torch.parallel.collectives import live_axes
    from mmlspark_tpu_torch.parallel.moe import MoELayer, shard_moe_params
    mesh = TP.make_mesh({"data": 2, "expert": 2}, device="cpu")
    module = MoELayer(**cfg)
    module.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    params = shard_moe_params(dict(module.state_dict()), mesh)
    shapes = {k: tuple(v.shape) for k, v in params.items()}
    x, y = torch.from_numpy(x), torch.from_numpy(y)
    with torch.no_grad(), live_axes(mesh):
        out = functional_call(module, params, (x,)).numpy()
    leaves = [v.requires_grad_(True) for v in params.values()]
    opt = torch.optim.Adam(leaves, lr=1e-2)
    losses = []
    for _ in range(steps):
        with live_axes(mesh):
            pred = functional_call(module, params, (x,))
            loss = torch.mean((pred - y) ** 2) + \
                sum(module.losses["moe_aux"])
            loss.backward()
        opt.step()
        opt.zero_grad(set_to_none=True)
        losses.append(float(loss))
    return out, losses, shapes


def _bits(t):
    return t.contiguous().view(torch.uint8).numpy()


def _rank_slot_route():
    """all_gather and ppermute through the slot all_reduce (the route of
    CUDA tensors on gloo, forced here on CPU tensors) and through gloo's
    own collectives: equal bit for bit, booked by route."""
    from mmlspark_tpu_torch.parallel import collectives as TC
    r = TP.axis_index()
    out = {}
    for slot in (False, True):
        TC._slot_route = (lambda t, g: True) if slot else \
            (lambda t, g: False)
        TC.reset_collective_stats()
        res = {}
        for dt in (torch.float32, torch.bfloat16, torch.int64):
            x = (torch.arange(6, dtype=torch.float64).reshape(2, 3)
                 * (r + 1) - 2.5).to(dt)
            if dt == torch.float32:
                x[0, 0] = -0.0
                x[1, 2] = float("nan")
            res[str(dt)] = (_bits(TP.all_gather(x)),
                            _bits(TP.all_gather(x, tiled=False)),
                            _bits(TP.ppermute(x, TP.ring_perm(4))),
                            _bits(TP.ppermute(x, [(0, 2)])))
        # the backwards: the inverse rotation, and JAX's all_gather
        # transpose (the cotangent's sum, this rank's block)
        a = torch.tensor([float(r + 1)], requires_grad=True)
        (TP.ppermute(a, TP.ring_perm(4)) * (r + 1)).sum().backward()
        b = torch.tensor([float(r + 1)], requires_grad=True)
        (TP.all_gather(b) * torch.arange(1.0, 5.0)).sum().backward()
        res["grads"] = (float(a.grad), float(b.grad))
        st = TC.collective_stats()
        res["routes"] = sorted(st["routes"])
        res["flat"] = (st["all_reduce_calls"], st["all_reduce_bytes"])
        out[slot] = res
    return out


# ---------------------------------------------------------------------------
# the JAX side
# ---------------------------------------------------------------------------

def _jax_mesh(axes):
    import jax
    from mmlspark_tpu.parallel import make_mesh
    n = int(np.prod(list(axes.values())))
    return make_mesh(axes, jax.devices()[:n])


# ---------------------------------------------------------------------------
# the collectives' slot route and autograd
# ---------------------------------------------------------------------------

def test_slot_route_is_bit_exact_and_booked_by_route(world4):
    runs = world4.run(_rank_slot_route)
    xs = [(torch.arange(6, dtype=torch.float64).reshape(2, 3) * (r + 1)
           - 2.5) for r in range(4)]
    for r, res in enumerate(runs):
        for dt in (torch.float32, torch.bfloat16, torch.int64):
            want_x = []
            for x in xs:
                x = x.to(dt)
                if dt == torch.float32:
                    x[0, 0] = -0.0
                    x[1, 2] = float("nan")
                want_x.append(x)
            gathered = torch.cat(want_x)
            perm = want_x[(r - 1) % 4]
            only = want_x[0] if r == 2 else torch.zeros_like(want_x[0])
            for slot in (False, True):
                tiled, stacked, ring, one = res[slot][str(dt)]
                np.testing.assert_array_equal(tiled, _bits(gathered))
                np.testing.assert_array_equal(stacked,
                                              _bits(torch.stack(want_x)))
                np.testing.assert_array_equal(ring, _bits(perm))
                np.testing.assert_array_equal(one, _bits(only))
        for slot in (False, True):
            # d/da of ppermute(a) * (dst + 1): the receiver's factor
            assert res[slot]["grads"] == ((r + 1) % 4 + 1, 4.0 * (r + 1))
        assert res[True]["routes"] == ["all_gather/slot_all_reduce",
                                       "all_reduce/sum",
                                       "ppermute/slot_all_reduce"]
        assert res[False]["routes"] == ["all_gather/all_gather",
                                        "all_reduce/sum",
                                        "ppermute/send_recv"]
        # the flat all_reduce keys count the all_reduce routes only: the
        # all_gather's backward, one sum of a (4, 1) float32 cotangent
        assert res[True]["flat"] == res[False]["flat"] == (1, 16)


# ---------------------------------------------------------------------------
# ring attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("seq", [2, 4])
def test_ring_attention_equals_dense_and_jax(world4, seq, causal):
    from mmlspark_tpu.parallel.ring_attention import \
        make_ring_attention_fn as jax_ring
    from mmlspark_tpu.parallel import active_mesh
    rng = np.random.default_rng(seq + 10 * causal)
    q, k, v = (rng.normal(size=(2, 2, 16, 8)).astype(np.float32)
               for _ in range(3))
    axes = {"seq": 4} if seq == 4 else {"seq": 2, "data": 2}
    outs = world4.run(_rank_ring, axes, q, k, v, causal)
    jmesh = _jax_mesh(axes)
    with active_mesh(jmesh):
        want = np.asarray(jax_ring(jmesh, causal=causal)(q, k, v))
    for out, compiles in outs:
        np.testing.assert_allclose(out, want, atol=ATOL)
        np.testing.assert_allclose(out, dense_attention(q, k, v, causal),
                                   atol=ATOL)
        assert compiles == 1


def test_ring_attention_outside_a_seq_axis_is_one_block():
    """In a world of one the ring has one position: the rotation returns
    the block to itself, and the result is plain attention."""
    from mmlspark_tpu_torch.parallel.ring_attention import ring_attention
    rng = np.random.default_rng(3)
    q, k, v = (rng.normal(size=(1, 2, 12, 4)).astype(np.float32)
               for _ in range(3))
    got = ring_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                         causal=True, mesh=TP.make_mesh({"seq": 1}))
    np.testing.assert_allclose(got.numpy(), dense_attention(q, k, v, True),
                               atol=ATOL)


# ---------------------------------------------------------------------------
# the sequence-parallel step
# ---------------------------------------------------------------------------

def test_seq_parallel_step_losses_equal_jax(world4):
    """The reference test's encoder (4 x 16 tokens, 1 layer) at data 2 x
    seq 2: the port's losses equal JAX's step for step, so its gradient
    takes the reference's scale."""
    import jax
    from mmlspark_tpu.models import TransformerEncoder as JaxEncoder
    from mmlspark_tpu.parallel import active_mesh
    from mmlspark_tpu.parallel.seq_parallel import (
        global_positions, make_seq_parallel_train_step)
    from mmlspark_tpu_torch.convert import transformer_state_dict_from_flax
    from mmlspark_tpu_torch.parallel.seq_parallel import \
        global_positions as port_positions
    rng = np.random.default_rng(3)
    B, L, V, C = 4, 16, 50, 3
    tokens = rng.integers(0, V, (B, L)).astype(np.int32)
    labels = (tokens % C).astype(np.int32)
    positions = global_positions(B, L)
    np.testing.assert_array_equal(port_positions(B, L), positions)
    cfg = dict(vocab_size=V, num_classes=C, embed_dim=32, num_heads=2,
               num_layers=1, mlp_dim=64, max_len=64, attention_mode="ring",
               pool="none")
    module = JaxEncoder(**cfg)
    axes = {"data": 2, "seq": 2}
    jmesh = _jax_mesh(axes)
    steps, lr = 6, 0.1
    with active_mesh(jmesh):
        init_fn, step_fn = make_seq_parallel_train_step(module, lr, jmesh)
        params = init_fn(jax.random.PRNGKey(0), tokens, positions)
        state = {k: v.numpy() for k, v in transformer_state_dict_from_flax(
            {"params": jax.device_get(params)}).items()}
        want = []
        for _ in range(steps):
            params, loss = step_fn(params, tokens, positions, labels)
            want.append(float(loss))
    runs = world4.run(_rank_seq_steps, cfg, state, tokens, positions,
                      labels, lr, steps)
    for losses, _ in runs:
        np.testing.assert_allclose(losses, want, rtol=RTOL)
    assert want[-1] < want[0]
    final = transformer_state_dict_from_flax(
        {"params": jax.device_get(params)})
    for name, got in runs[0][1].items():
        np.testing.assert_allclose(got, final[name].numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=name)


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------

def test_pipeline_forward_and_steps_equal_sequential_and_jax(world4):
    import jax.numpy as jnp
    from mmlspark_tpu.parallel import active_mesh
    from mmlspark_tpu.parallel.pipeline_parallel import (
        make_pipeline_train_step, microbatch)
    from mmlspark_tpu_torch.parallel.pipeline_parallel import \
        microbatch as port_microbatch
    rng = np.random.default_rng(1)
    S, d = 4, 6
    params = {"W": rng.normal(size=(S, d, d)).astype(np.float32) * 0.5,
              "b": rng.normal(size=(S, d)).astype(np.float32) * 0.1}
    flat = rng.normal(size=(32, d)).astype(np.float32)
    x = microbatch(flat, 4)
    np.testing.assert_array_equal(port_microbatch(flat, 4), x)
    y = np.tanh(x @ rng.normal(size=(d, d)).astype(np.float32) * 0.5)

    def stage_apply(p, h):
        return jnp.tanh(h @ p["W"] + p["b"])

    def loss_fn(outs, yy):
        return jnp.mean((outs - yy) ** 2)

    steps, lr = 5, 0.2
    jmesh = _jax_mesh({"pipe": 4})
    with active_mesh(jmesh):
        init_fn, step_fn, fwd_fn = make_pipeline_train_step(
            stage_apply, S, loss_fn, learning_rate=lr, mesh=jmesh)
        p = init_fn(params)
        want_out = np.asarray(fwd_fn(p, x))
        want = []
        for _ in range(steps):
            p, loss = step_fn(p, x, y)
            want.append(float(loss))
        want_params = {k: np.asarray(v) for k, v in p.items()}
    ref = flat
    for s in range(S):
        ref = np.tanh(ref @ params["W"][s] + params["b"][s])
    runs = world4.run(_rank_pipeline, params, x, y, lr, steps)
    for s, (out, losses, stage) in enumerate(runs):
        np.testing.assert_allclose(out, ref.reshape(x.shape), atol=ATOL)
        np.testing.assert_allclose(out, want_out, atol=ATOL)
        np.testing.assert_allclose(losses, want, rtol=RTOL)
        for k, v in stage.items():
            np.testing.assert_allclose(v, want_params[k][s:s + 1],
                                       rtol=1e-4, atol=1e-6)
    assert want[-1] < want[0]


def test_pipeline_checks_its_stage_count():
    from mmlspark_tpu_torch.parallel.pipeline_parallel import (
        make_pipeline_train_step, microbatch)
    with pytest.raises(ValueError, match="stages"):
        make_pipeline_train_step(_stage_apply, 2, _mse,
                                 mesh=TP.make_mesh({"pipe": 1}))
    with pytest.raises(ValueError, match="microbatches"):
        microbatch(np.zeros((5, 2)), 2)


# ---------------------------------------------------------------------------
# the experts
# ---------------------------------------------------------------------------

def _moe_pair(T=64, d=8, E=4, H=16):
    import jax
    import jax.numpy as jnp
    from mmlspark_tpu.parallel.moe import MoELayer as JaxMoE
    from mmlspark_tpu_torch.convert import moe_state_dict_from_flax
    from mmlspark_tpu_torch.parallel.moe import MoELayer
    rng = np.random.default_rng(2)
    x = rng.normal(size=(T, d)).astype(np.float32)
    y = np.where(x[:, :1] > 0, x * 2.0, -x).astype(np.float32)
    ref = JaxMoE(num_experts=E, hidden=H)
    variables = ref.init(jax.random.PRNGKey(0), jnp.asarray(x))
    cfg = dict(num_experts=E, hidden=H, d_model=d)
    port = MoELayer(**cfg)
    state = moe_state_dict_from_flax(variables, port)
    port.load_state_dict(state)
    return ref, variables, port, cfg, {k: v.numpy() for k, v in
                                       state.items()}, x, y


def test_moe_layer_equals_flax_with_its_aux_loss():
    ref, variables, port, *_, x, _y = _moe_pair()
    want, aux = ref.apply({"params": variables["params"]}, x,
                          mutable=["losses"])
    got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    (want_aux,) = aux["losses"]["moe_aux"]
    (got_aux,) = port.losses["moe_aux"]
    np.testing.assert_allclose(float(got_aux.detach()), float(want_aux),
                               rtol=1e-6)


def test_moe_expert_parallel_step_losses_equal_jax(world4):
    import jax
    import jax.numpy as jnp
    import optax
    from mmlspark_tpu.parallel import active_mesh
    from mmlspark_tpu.parallel.moe import shard_moe_params as jax_shard
    ref, variables, port, cfg, state, x, y = _moe_pair()
    want_out = np.asarray(ref.apply(variables, x, mutable=["losses"])[0])
    jmesh = _jax_mesh({"data": 2, "expert": 2})
    steps = 8
    with active_mesh(jmesh):
        params = jax_shard(variables["params"], jmesh)
        tx = optax.adam(1e-2)
        opt = tx.init(params)

        @jax.jit
        def step(params, opt, x, y):
            def loss_fn(p):
                out, aux = ref.apply({"params": p}, x, mutable=["losses"])
                return jnp.mean((out - y) ** 2) + \
                    sum(jax.tree.leaves(aux["losses"]))
            loss, grads = jax.value_and_grad(loss_fn)(params)
            updates, opt = tx.update(grads, opt)
            return optax.apply_updates(params, updates), opt, loss

        want = []
        for _ in range(steps):
            params, opt, loss = step(params, opt, jnp.asarray(x),
                                     jnp.asarray(y))
            want.append(float(loss))
    runs = world4.run(_rank_moe, cfg, state, x, y, steps)
    for out, losses, shapes in runs:
        np.testing.assert_allclose(out, want_out, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(losses, want, rtol=RTOL)
        assert shapes["w_in"] == (2, 8, 16) and shapes["w_out"] == (2, 16, 8)
        assert shapes["gate.weight"] == (4, 8)
    assert runs[0][1] == runs[1][1] == runs[2][1] == runs[3][1]
    assert want[-1] < want[0]
