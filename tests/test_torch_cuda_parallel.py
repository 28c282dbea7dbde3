"""The rest of ``parallel/`` on the card: a world of two ranks on the one card
over gloo.  gloo takes CUDA tensors in ``all_reduce`` and ``broadcast``
only, so ``all_gather`` and ``ppermute`` travel by the slot all_reduce
(``parallel.collectives``): bit for bit in float32 (signed zeros, NaN
payloads), bfloat16 and int64, booked under their route.  Then ring
attention against dense attention, and the expert-parallel layer against
the same layer at world 1, at small sizes (the ``parallel`` phase of
``chip_smoke.py`` runs them at full size).  Marked ``cuda``: without a
CUDA device every test skips (the CPU tier-1 run holds the same paths
against the JAX package in ``test_torch_seq_pipe_moe.py``).  On the card:

    python -m pytest tests/test_torch_cuda_parallel.py -q -m cuda --noconftest
"""
import numpy as np
import pytest
import torch

from mmlspark_tpu_torch import parallel as TP
from mmlspark_tpu_torch.parallel.world import World

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def world2():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    with World(2, backend="gloo") as w:
        yield w


def _x(r: int, dt: torch.dtype) -> torch.Tensor:
    x = (torch.arange(12, dtype=torch.float64).reshape(3, 4) * (r + 1)
         - 5.5).to(dt)
    if dt == torch.float32:
        x[0, 0] = -0.0
        x[2, 3] = float("nan")
    return x


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.uint8).cpu().numpy()


def _rank_collectives():
    from mmlspark_tpu_torch.parallel import collectives as TC
    r = TP.axis_index()
    TC.reset_collective_stats()
    out = {}
    for dt in (torch.float32, torch.bfloat16, torch.int64):
        x = _x(r, dt).cuda()
        out[str(dt)] = (_bits(TP.all_gather(x)),
                        _bits(TP.ppermute(x, TP.ring_perm(2))),
                        TP.all_gather(x).is_cuda)
    a = torch.tensor([float(r + 1)], device="cuda", requires_grad=True)
    (TP.ppermute(a, TP.ring_perm(2)) * (r + 1)).sum().backward()
    out["grad"] = float(a.grad)
    out["routes"] = sorted(TC.collective_stats()["routes"])
    return out


def _rank_ring(causal: bool):
    from mmlspark_tpu_torch.parallel.ring_attention import \
        make_ring_attention_fn
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = TP.make_mesh({"seq": 2})
    gen = torch.Generator(device="cuda").manual_seed(3)
    q, k, v = (torch.randn(2, 2, 256, 32, device="cuda", generator=gen)
               for _ in range(3))
    got = make_ring_attention_fn(mesh, causal=causal)(q, k, v)
    s = (q @ k.transpose(-1, -2)) / np.sqrt(32)
    if causal:
        s = torch.where(torch.ones(256, 256, dtype=torch.bool,
                                   device="cuda").tril(), s, -1e30)
    return float((got - torch.softmax(s, -1) @ v).abs().max())


def _rank_moe():
    from torch.func import functional_call
    from mmlspark_tpu_torch.parallel.collectives import live_axes
    from mmlspark_tpu_torch.parallel.moe import MoELayer, shard_moe_params
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = TP.make_mesh({"expert": 2})
    module = MoELayer(4, 64, 32, generator=torch.Generator().manual_seed(4))
    x = torch.randn(128, 32, generator=torch.Generator().manual_seed(5))
    x = x.cuda()
    module = module.cuda()
    with torch.no_grad():
        ref = module(x)
    params = shard_moe_params(dict(module.state_dict()), mesh)
    with torch.no_grad(), live_axes(mesh):
        got = functional_call(module, params, (x,))
    return float((got - ref).abs().max() / ref.abs().max()), \
        tuple(params["w_in"].shape)


def test_slot_route_is_bit_exact_on_the_card(world2):
    r0, r1 = world2.run(_rank_collectives)
    for r, res in enumerate((r0, r1)):
        for dt in (torch.float32, torch.bfloat16, torch.int64):
            gathered, permuted, on_card = res[str(dt)]
            assert on_card
            np.testing.assert_array_equal(
                gathered, _bits(torch.cat([_x(0, dt), _x(1, dt)])))
            np.testing.assert_array_equal(permuted, _bits(_x(1 - r, dt)))
        assert res["grad"] == float((r + 1) % 2 + 1)
        assert res["routes"] == ["all_gather/slot_all_reduce",
                                 "ppermute/slot_all_reduce"]


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_ring_attention_on_the_card_equals_dense(world2, causal):
    for err in world2.run(_rank_ring, causal):
        assert err <= 1e-4


def test_experts_on_the_card_equal_world_one(world2):
    for err, shape in world2.run(_rank_moe):
        assert err <= 1e-5 and shape == (2, 32, 64)
