"""Port parity for the ResNet family (``mmlspark_tpu_torch/models/resnet.py``)
and the flax -> ``state_dict`` converter (``convert.py``) against the JAX
package's flax modules, on the CPU.

Every parameter, BN scale, bias and running statistic is drawn from a
numpy seed: a fresh flax init zeroes the last BN scale of each block, so
it would never exercise the residual branch.  Narrow nets
(``num_filters=8``, one block per stage) run at 32 x 32 with the ImageNet
stem (every stride-2 conv sees an even size: flax pads it (0, 1)) and at
35 x 35 with the CIFAR stem (odd and even sizes in turn).

Tolerances: float32 logits and features within atol 2e-5 (measured
~1e-6: the same convolutions summed in another order); bfloat16 within
atol 0.05 of the JAX package's jitted bfloat16 on outputs of magnitude
~1-6 (measured at most 0.047, 1.5 bfloat16 ulps at magnitude 4-8: both
round every layer's output to bfloat16, at places that differ where BN
runs in float32 and where XLA fuses).  That is as wide as bfloat16's own
distance from float32 on these nets (0.005-0.042 measured), so it cannot
tell a bfloat16 path from a float32 one.  Two checks do: the port's
bfloat16 outputs are bfloat16 values cast to float32, as the reference's
are (``resnet.py:104,106``), and they lie more than 2e-3 (100 x the
float32 tolerance) from the port's float32 outputs on the same weights.
ResNet-50 is checked for names and shapes only (a full-depth ``init`` and
``apply`` cost ~25 s on this CPU).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlspark_tpu.models import resnet as jax_resnet
from mmlspark_tpu_torch.convert import (flatten_variables,
                                        resnet_state_dict_from_flax)
from mmlspark_tpu_torch.models import resnet

BLOCKS = {"basic": (jax_resnet.BasicBlock, resnet.BasicBlock),
          "bottleneck": (jax_resnet.BottleneckBlock, resnet.BottleneckBlock)}
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 5e-2)}
#: the least max |bfloat16 - float32| the port's bfloat16 path must show
BF16_FROM_F32 = 2e-3


def seeded_variables(module, shape, seed):
    """Every leaf of ``module``'s variables drawn from a numpy seed: BN
    scales and variances in [0.5, 1.5], biases and means N(0, 0.2^2),
    kernels N(0, 1 / fan_in)."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0),
                            jnp.zeros(shape))
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = path[-1].key
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        if name in ("bias", "mean"):
            return rng.normal(0, 0.2, s.shape).astype(np.float32)
        fan_in = int(np.prod(s.shape[:-1]))
        return (rng.normal(size=s.shape) / np.sqrt(fan_in)).astype(
            np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("hw", [32, 35])
@pytest.mark.parametrize("block", sorted(BLOCKS))
def test_narrow_resnet_equals_flax(block, hw, dtype):
    jax_block, port_block = BLOCKS[block]
    jdt, tdt, atol = DTYPES[dtype]
    cifar = hw == 35                    # both stems, both sizes covered
    ref_module = jax_resnet.ResNet([1, 1, 1, 1], jax_block, 10,
                                   num_filters=8, dtype=jdt,
                                   cifar_stem=cifar)
    variables = seeded_variables(ref_module, (1, hw, hw, 3), seed=hw)
    x = np.random.default_rng(hw + 1).normal(
        size=(3, hw, hw, 3)).astype(np.float32)
    apply = jax.jit(ref_module.apply, static_argnames="features")
    want = np.asarray(apply(variables, x))
    want_f = np.asarray(apply(variables, x, features=True))

    model = resnet.ResNet([1, 1, 1, 1], port_block, 10, num_filters=8,
                          dtype=tdt, cifar_stem=cifar)
    model.load_state_dict(resnet_state_dict_from_flax(variables, model))
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
        got_f = model(torch.from_numpy(x), features=True).numpy()
    assert got.dtype == got_f.dtype == np.float32
    assert got.shape == (3, 10)
    width = 8 * 8 * port_block.expansion
    assert got_f.shape == (3, width)
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    np.testing.assert_allclose(got_f, want_f, rtol=0, atol=atol)
    if tdt == torch.bfloat16:
        f32 = resnet.ResNet.from_config({**model.config(),
                                         "dtype": "float32"})
        f32.load_state_dict(model.state_dict())
        with torch.inference_mode():
            for out, features in ((got, False), (got_f, True)):
                as_bf16 = torch.from_numpy(out).bfloat16().float().numpy()
                np.testing.assert_array_equal(out, as_bf16)
                ref32 = f32(torch.from_numpy(x), features=features).numpy()
                assert np.abs(out - ref32).max() > BF16_FROM_F32


@pytest.mark.parametrize("n,k,s", [(32, 3, 2), (35, 3, 2), (32, 1, 2),
                                   (35, 1, 2), (7, 3, 1), (8, 7, 2),
                                   (5, 4, 3)])
def test_same_pads_are_flax_pads(n, k, s):
    """The pads the port computes give flax's ``SAME`` output: a 1-channel
    conv of ones counts each window's real cells."""
    x = np.ones((1, n, n, 1), np.float32)
    ref = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.ones((k, k, 1, 1)), (s, s), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    conv = resnet.Conv(1, 1, k, s)
    with torch.no_grad():
        conv.weight.fill_(1.0)
        got = conv(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(ref))
    lo, hi = resnet.same_pads(n, k, s)
    assert hi - lo in (0, 1)


def test_resnet50_converted_names_and_shapes_fit():
    """ResNet-50's flax variables (shapes from ``jax.eval_shape``, no
    numerics) convert to exactly the port's ``state_dict`` names and
    shapes; the flat ``variables.npz`` keys convert the same way."""
    shapes = jax.eval_shape(jax_resnet.resnet50().init,
                            jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3)))
    variables = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes)
    model = resnet.resnet50()
    state = resnet_state_dict_from_flax(variables, model)
    assert len(state) == len(model.state_dict()) == 267
    flat = flatten_variables(variables)
    assert set(resnet_state_dict_from_flax(flat)) == set(state)
    assert state["blocks.15.convs.2.weight"].shape == (2048, 512, 1, 1)
    assert state["blocks.0.conv_proj.weight"].shape == (256, 64, 1, 1)
    assert state["conv_init.weight"].shape == (64, 3, 7, 7)
    assert state["head.weight"].shape == (1000, 2048)
    assert "params/BottleneckBlock_15/Conv_2/kernel" in flat


def test_converter_refuses_leftover_keys():
    module = jax_resnet.ResNet([1, 1], jax_resnet.BasicBlock, 4,
                               num_filters=4, cifar_stem=True)
    flat = flatten_variables(seeded_variables(module, (1, 8, 8, 3), 0))
    model = resnet.ResNet([1, 1], resnet.BasicBlock, 4, num_filters=4,
                          cifar_stem=True)
    assert len(resnet_state_dict_from_flax(flat, model)) == len(
        model.state_dict())
    with pytest.raises(KeyError, match="Dropout_0"):
        resnet_state_dict_from_flax(
            {**flat, "params/Dropout_0/rate": np.zeros(1)}, model)
    short = {k: v for k, v in flat.items() if "norm_proj" not in k}
    with pytest.raises(ValueError, match="missing.*norm_proj"):
        resnet_state_dict_from_flax(short, model)
    wide = resnet.ResNet([1, 1], resnet.BasicBlock, 4, num_filters=8,
                         cifar_stem=True)
    with pytest.raises(ValueError, match="shape differs"):
        resnet_state_dict_from_flax(flat, wide)


def test_zoo_init_is_flax_shaped_and_seeded():
    """Fresh weights follow flax's initializers (unit BN scales, the last
    BN of each block zero, lecun-normal kernels) from a generator: equal
    for equal seeds, different for different ones."""
    a = resnet.resnet18(generator=torch.Generator().manual_seed(1))
    b = resnet.resnet18(generator=torch.Generator().manual_seed(1))
    c = resnet.resnet18(generator=torch.Generator().manual_seed(2))
    for k, v in a.state_dict().items():
        assert torch.equal(v, b.state_dict()[k]), k
    assert not torch.equal(a.conv_init.weight, c.conv_init.weight)
    assert torch.count_nonzero(a.blocks[0].norms[1].weight) == 0
    assert torch.all(a.blocks[0].norms[0].weight == 1)
    std = a.blocks[3].convs[1].weight.std().item()
    assert abs(std - (1 / (128 * 9)) ** 0.5) < 0.01
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        resnet.resnet18(dtype=torch.float16)


def test_config_round_trip_and_dtype():
    model = resnet.cifar_resnet20(width=8, dtype=torch.bfloat16)
    again = resnet.ResNet.from_config(model.config())
    assert again.config() == model.config()
    assert again.conv_init.weight.dtype == torch.bfloat16
    assert again.bn_init.weight.dtype == torch.float32
    x = torch.zeros(2, 32, 32, 3)
    with torch.inference_mode():
        assert model(x).dtype == torch.float32


def test_float32_exact_is_one_switch_across_threads():
    """Two float32-exact bodies that overlap on two threads (A enters, B
    enters, A leaves, B leaves): TF32 stays off until the last leaves, and
    the process's flags end as they began."""
    import threading
    from mmlspark_tpu_torch._device import float32_exact

    def flags():
        return (torch.backends.cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32)

    saved = flags()
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    a_in, b_in, a_out = (threading.Event() for _ in range(3))
    seen = {}

    def a():
        with float32_exact():
            a_in.set()
            b_in.wait(10)
            seen["a"] = flags()
        a_out.set()

    def b():
        a_in.wait(10)
        with float32_exact():
            b_in.set()
            a_out.wait(10)
            seen["b"] = flags()

    try:
        threads = [threading.Thread(target=f) for f in (a, b)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(20)
        assert seen == {"a": (False, False), "b": (False, False)}
        assert flags() == (True, True)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
