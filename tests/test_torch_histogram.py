"""Port parity: ``mmlspark_tpu_torch.ops`` (histogram + the plain versions of
the Hopper frontier kernels) against the JAX package on the same numpy
inputs.  The JAX Pallas kernel runs in interpret mode, as
``tests/test_pallas_histogram.py`` runs it on the CPU.

Integer outputs (lanes, decoded sums, quantized gradients, histograms, node
totals) must be bit-identical.  Split picks must be equal except at f32
near-ties: both packages sum bins in f32 but in different orders, so a pick
may differ only where the two best gains are within 1e-6 relative; left
stats agree within rtol 1e-5 for the same reason.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mmlspark_tpu.ops import histogram as JH
from mmlspark_tpu.ops import pallas_histogram as JP
from mmlspark_tpu_torch.ops import cuda_histogram as TP
from mmlspark_tpu_torch.ops import histogram as TH


def _inputs(n=3000, f=7, b=255, p=8, seed=0, balanced=False):
    rng = np.random.default_rng(seed)
    binned = rng.integers(0, b, (n, f)).astype(np.uint8)
    g = rng.normal(size=n).astype(np.float32)
    h = rng.uniform(0.01, 1, n).astype(np.float32)
    if balanced:
        node = (np.arange(n) % p).astype(np.int32)
    else:
        node = rng.integers(-1, p, n).astype(np.int32)
    return binned, g, h, node


def _jax_uniforms(g, h, seed):
    """The quantizer's uniforms exactly as the JAX package draws them on a
    single shard (``ops/histogram.py`` quantize_gradients)."""
    import jax
    import jax.random as jrandom
    gj, hj = jnp.asarray(g, jnp.float32), jnp.asarray(h, jnp.float32)
    mix = jax.lax.bitcast_convert_type(jnp.sum(gj) + 3.0 * jnp.sum(hj),
                                       jnp.int32)
    key = jrandom.fold_in(jrandom.PRNGKey(seed), jnp.asarray(mix, jnp.int32))
    return np.asarray(jrandom.uniform(key, (2,) + gj.shape))


def _quantized(g, h, seed=3, quant_bins=16):
    qg, qh, gs, hs = JH.quantize_gradients(jnp.asarray(g), jnp.asarray(h),
                                           quant_bins, seed=seed)
    return np.asarray(qg), np.asarray(qh), float(gs), float(hs)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("bound", [16, 128, 256, 4000, 62500, 10 ** 6])
def test_lane_layout_pack_unpack_bit_identical(bound):
    """_packed_layout / _pack_lanes / _unpack_lanes: the same plan, the same
    packed ints, and the same decode of sums, negative all3 sums included
    (floor division and modulo)."""
    assert TH._packed_layout(bound, 16) == JH._packed_layout(bound, 16)
    mode, cbits, hbits = JH._packed_layout(bound, 16)
    rng = np.random.default_rng(bound)
    m = min(bound, 512)
    qg = rng.integers(-8, 9, (64, m)).astype(np.int32)
    qg[0] = -8                        # all-negative rows: negative sums
    qh = rng.integers(0, 16, (64, m)).astype(np.int32)
    j_lanes = JH._pack_lanes(jnp.asarray(qg), jnp.asarray(qh), mode, cbits,
                             hbits)
    t_lanes = TH._pack_lanes(_t(qg), _t(qh), mode, cbits, hbits)
    for a, b in zip(j_lanes, t_lanes):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    # sums of at most `bound` rows per cell decode exactly
    j_acc = [jnp.sum(x, axis=1) for x in j_lanes]
    t_acc = [x.sum(dim=1, dtype=torch.int32) for x in t_lanes]
    if mode == "all3":
        assert int(t_acc[0][0]) < 0
    for a, b in zip(JH._unpack_lanes(j_acc, mode, cbits, hbits),
                    TH._unpack_lanes(t_acc, mode, cbits, hbits)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    np.testing.assert_array_equal(
        TH._unpack_lanes(t_acc, mode, cbits, hbits)[0].numpy(),
        qg.sum(axis=1))


@pytest.mark.parametrize("quant_bins", [4, 16, 128])
def test_quantize_gradients_with_injected_noise_bit_identical(quant_bins):
    _, g, h, _ = _inputs(n=4099, seed=quant_bins)
    u = _jax_uniforms(g, h, seed=11)
    jq = JH.quantize_gradients(jnp.asarray(g), jnp.asarray(h), quant_bins,
                               seed=11)
    tq = TH.quantize_gradients(_t(g), _t(h), quant_bins, noise=_t(u))
    for a, b in zip(jq, tq):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_quantize_gradients_generator_is_unbiased_and_bounded():
    _, g, h, _ = _inputs(n=20000, seed=5)
    gen = torch.Generator().manual_seed(0)
    qg, qh, gs, hs = TH.quantize_gradients(_t(g), _t(h), 16, generator=gen)
    assert int(qg.abs().max()) <= 8 and 0 <= int(qh.min()) <= int(qh.max()) <= 15
    assert abs(float((qg.float() * gs).mean()) - float(g.mean())) < 0.01
    assert abs(float((qh.float() * hs).mean()) - float(h.mean())) < 0.01
    with pytest.raises(ValueError, match="noise must have shape"):
        TH.quantize_gradients(_t(g), _t(h), 16, noise=torch.zeros(2, 3))


@pytest.mark.parametrize("layout,bound", [("all3", 128), ("2ch", 4000),
                                          ("wide", None)])
def test_quantized_builds_bit_identical(layout, bound):
    """The plain packed-lane build and the kernels' plain pair (accumulate +
    decode) equal JAX's scatter build and the interpret-mode Pallas build,
    with masked rows and a ragged row count."""
    p, n = 8, 17011 if bound is None else 1021
    binned, g, h, node = _inputs(n=n, p=p, seed=2)
    if bound is not None:
        # a true node-row bound: keep at most `bound` rows in every node
        for k in range(p):
            rows = np.flatnonzero(node == k)
            node[rows[bound:]] = -1
    assert JH._packed_layout(min(n, bound or n), 16)[0] == layout
    qg, qh, _, _ = _quantized(g, h)
    args = (jnp.asarray(binned), jnp.asarray(qg), jnp.asarray(qh),
            jnp.asarray(node), p, 255)
    ref = np.asarray(JH.build_histograms_quantized(*args,
                                                   node_rows_bound=bound))
    pallas = np.asarray(JP.build_histograms_pallas(*args,
                                                   node_rows_bound=bound))
    np.testing.assert_array_equal(ref, pallas)
    targs = (_t(binned), _t(qg), _t(qh), _t(node), p, 255)
    plain = TH.build_histograms_quantized(*targs, node_rows_bound=bound)
    assert plain.dtype == torch.int32
    np.testing.assert_array_equal(plain.numpy(), ref)
    via_kernels = TP.build_histograms_cuda(*targs, node_rows_bound=bound)
    np.testing.assert_array_equal(via_kernels.numpy(), ref)
    # the feature-major view the trainer keeps gives the same sums
    fm = _t(binned).t().contiguous().t()
    np.testing.assert_array_equal(
        TH.build_quantized(fm, *targs[1:], node_rows_bound=bound).numpy(),
        ref)


def test_float_histograms_match_jax_to_rounding():
    binned, g, h, node = _inputs(n=2000, f=5, b=63, p=4, seed=4)
    ref = np.asarray(JH.build_histograms(jnp.asarray(binned), jnp.asarray(g),
                                         jnp.asarray(h), jnp.asarray(node),
                                         4, 63))
    got = TH.build_histograms(_t(binned), _t(g), _t(h), _t(node), 4, 63)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    gs, hs = np.float32(0.3), np.float32(0.07)
    q = np.random.default_rng(1).integers(-900, 900, (4, 5, 63, 3)) \
        .astype(np.int32)
    np.testing.assert_array_equal(
        TH.dequantize_histogram(_t(q), gs, hs).numpy(),
        np.asarray(JH.dequantize_histogram(jnp.asarray(q), gs, hs)))


def _assert_best_match(jb, tb):
    """Fused best-split tuples: equal picks except at near-ties."""
    jg, jf, jbin, jleft, jtot = (np.asarray(x) for x in jb)
    tg, tf, tbin, tleft, ttot = (x.numpy() for x in tb)
    np.testing.assert_array_equal(ttot, jtot)          # exact int totals
    same = (jf == tf) & (jbin == tbin)
    with np.errstate(invalid="ignore"):       # -inf - -inf at gated nodes
        tie = np.abs(jg - tg) <= 1e-6 * np.abs(jg)
    assert np.all(same | tie), (jf, tf, jbin, tbin, jg, tg)
    fin = np.isfinite(jg) & same
    np.testing.assert_allclose(tg[fin], jg[fin], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tleft[same], jleft[same], rtol=1e-5,
                               atol=1e-6)


def _edge_ok(f, b):
    return np.concatenate([np.ones((f, b - 1), bool), np.zeros((f, 1), bool)],
                          axis=1)


def test_fused_frontier_direct_mode_matches_jax():
    f, b, p = 7, 255, 8
    binned, g, h, node = _inputs(n=3000, f=f, b=b, p=p, seed=0)
    qg, qh, gs, hs = _quantized(g, h)
    fmask = np.ones(f, bool)
    fmask[3] = False
    kw = dict(quant_bins=16, l1=0.05, l2=0.1, min_data=20.0, min_hess=1e-3)
    jh, jb = JP.fused_frontier(
        jnp.asarray(binned), jnp.asarray(qg), jnp.asarray(qh),
        jnp.asarray(node), p, b, gs, hs, jnp.asarray(fmask),
        jnp.asarray(_edge_ok(f, b)), **kw)
    th, tb = TP.fused_frontier(
        _t(binned), _t(qg), _t(qh), _t(node), p, b, gs, hs, _t(fmask),
        _t(_edge_ok(f, b)), **kw)
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    _assert_best_match(jb, tb)
    assert not np.any(tb[1].numpy() == 3)      # the masked feature never wins


def test_fused_frontier_subtract_mode_matches_jax():
    n, f, b, P = 4000, 6, 127, 4
    binned, g, h, _ = _inputs(n=n, f=f, b=b, seed=1)
    rng = np.random.default_rng(11)
    qg, qh, gs, hs = _quantized(g, h, seed=5)
    node_parent = (np.arange(n) % P).astype(np.int32)
    node_small = np.where(rng.random(n) < 0.45, node_parent, -1) \
        .astype(np.int32)
    small_left = rng.random(P) < 0.5
    parent = np.asarray(JH.build_histograms_quantized(
        jnp.asarray(binned), jnp.asarray(qg), jnp.asarray(qh),
        jnp.asarray(node_parent), P, b))
    kw = dict(quant_bins=16, l1=0.0, l2=1.0, min_data=10.0, min_hess=1e-3,
              node_rows_bound=n // 2 + 2 * P)
    jh, jb = JP.fused_frontier(
        jnp.asarray(binned), jnp.asarray(qg), jnp.asarray(qh),
        jnp.asarray(node_small), P, b, gs, hs, jnp.ones((f,), bool),
        jnp.asarray(_edge_ok(f, b)), parent_hist=jnp.asarray(parent),
        small_left=jnp.asarray(small_left), **kw)
    th, tb = TP.fused_frontier(
        _t(binned), _t(qg), _t(qh), _t(node_small), P, b, gs, hs,
        torch.ones(f, dtype=torch.bool), _t(_edge_ok(f, b)),
        parent_hist=_t(parent), small_left=_t(small_left), **kw)
    assert th.shape == (2 * P, f, b, 3)
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    _assert_best_match(jb, tb)


@pytest.mark.parametrize("depth_ok", [True, False])
def test_fused_frontier_depth_gate_matches_jax(depth_ok):
    f, b, p = 6, 63, 2
    binned, g, h, node = _inputs(n=2000, f=f, b=b, p=p, seed=3)
    qg, qh, gs, hs = _quantized(g, h, seed=1)
    kw = dict(quant_bins=16, l1=0.0, l2=1.0, min_data=5.0, min_hess=1e-3)
    jh, jb = JP.fused_frontier(
        jnp.asarray(binned), jnp.asarray(qg), jnp.asarray(qh),
        jnp.asarray(node), p, b, gs, hs, jnp.ones((f,), bool),
        jnp.asarray(_edge_ok(f, b)), depth_ok=jnp.bool_(depth_ok), **kw)
    th, tb = TP.fused_frontier(
        _t(binned), _t(qg), _t(qh), _t(node), p, b, gs, hs,
        torch.ones(f, dtype=torch.bool), _t(_edge_ok(f, b)),
        depth_ok=depth_ok, **kw)
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    _assert_best_match(jb, tb)
    if not depth_ok:   # every candidate gated: argmax parks at (0, 0)
        assert torch.isneginf(tb[0]).all()
        assert (tb[1] == 0).all() and (tb[2] == 0).all()


def test_kernel_wrappers_validate_and_count():
    """CPU tensors take the plain versions and do not count as launches;
    bad arguments raise before any launch."""
    binned, g, h, node = _inputs(n=300, f=3, b=15, p=2, seed=6)
    qg, qh, _, _ = _quantized(g, h)
    TP.reset_launch_counts()
    TP.build_histograms_cuda(_t(binned), _t(qg), _t(qh), _t(node), 2, 15)
    assert TP.launch_counts() == {"hist_accumulate": 0, "frontier_finish": 0}
    with pytest.raises(ValueError, match="num_bins"):
        TP.build_histograms_cuda(_t(binned), _t(qg), _t(qh), _t(node), 2,
                                 300)
    with pytest.raises(ValueError, match="meta"):
        TP.hist_accumulate(_t(binned).to("meta"), TP.to_int8(_t(qg)),
                           TP.to_int8(_t(qh)), _t(node), 2, 15,
                           TP.lane_layout(300, 300, 16))
    plan = TP._accumulate_plan(10 ** 6, 200, 8, 255, 132)
    assert plan.Ng * plan.Fg * 255 * TP._CELL_BYTES + TP._QUEUE_BYTES \
        <= TP._SMEM_PER_BLOCK
    assert plan.Ng == 8 and plan.G * plan.Fg >= 200 and plan.blocks == 132
