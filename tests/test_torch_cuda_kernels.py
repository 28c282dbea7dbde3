"""The Hopper frontier kernels against their plain PyTorch versions, on the
card.  Marked ``cuda``: without a CUDA device every test skips (the CPU
tier-1 run reaches the same arithmetic through the plain versions, which
``test_torch_histogram.py`` holds against the JAX package).  On the card:

    python -m pytest tests/test_torch_cuda_kernels.py -q -m cuda --noconftest

(``--noconftest``: the suite's conftest imports jax, which a GPU host need
not have.)

Histograms must be bit-identical, and so must the best-split records: the
kernel's f32 scan adds bins in the plain version's order with no fused
multiply-adds.
"""
import numpy as np
import pytest
import torch

from mmlspark_tpu_torch.ops import cuda_histogram as CH
from mmlspark_tpu_torch.ops.histogram import quantize_gradients

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(dev, n, F, B, N, seed, feature_major=True, mask=0.2):
    gen = torch.Generator(device=dev).manual_seed(seed)
    shape = (F, n) if feature_major else (n, F)
    binned = torch.randint(0, B, shape, generator=gen, device=dev,
                           dtype=torch.uint8)
    binned = binned.t() if feature_major else binned
    g = torch.randn(n, generator=gen, device=dev)
    h = torch.rand(n, generator=gen, device=dev)
    qg, qh, gs, hs = quantize_gradients(g, h, 16, generator=gen)
    ids = torch.randint(0, N, (n,), generator=gen, device=dev,
                        dtype=torch.int32)
    ids[torch.rand(n, generator=gen, device=dev) < mask] = -1
    return binned, CH.to_int8(qg), CH.to_int8(qh), gs, hs, ids, gen


@pytest.mark.parametrize("n,F,B,N", [(1, 1, 2, 1), (1000, 3, 17, 5),
                                     (70001, 9, 255, 40),
                                     (20000, 33, 256, 64)])
@pytest.mark.parametrize("feature_major", [True, False])
def test_build_bit_identical(dev, n, F, B, N, feature_major):
    binned, qg, qh, _, _, ids, _ = _inputs(dev, n, F, B, N, n + F,
                                           feature_major)
    for bound in (n, max(1, n // N // 2), 1):
        lay = CH.lane_layout(n, bound, 16)
        if bound < n:     # hold the bound: keep <= bound rows per node
            keep = torch.zeros(n, dtype=torch.bool, device=dev)
            for k in range(N):
                keep[torch.nonzero(ids == k)[:bound, 0]] = True
            ids = torch.where(keep, ids, -1)
        acc = CH.hist_accumulate(binned, qg, qh, ids, N, B, lay)
        assert torch.equal(acc, CH.hist_accumulate_plain(binned, qg, qh, ids,
                                                         N, B, lay)), lay
        hist, _ = CH.frontier_finish(acc, *lay)
        assert torch.equal(hist, CH.frontier_finish_plain(acc, *lay)[0]), lay
    torch.cuda.synchronize()


@pytest.mark.parametrize("case", ["quant128_extremes", "one_node_one_bin",
                                  "all_inactive", "ragged_rows"])
def test_accumulate_edges_bit_identical(dev, case):
    """The kernel's edges: gradients at the 128-bin quantizer's extremes,
    every row on one address, a frontier with no active row, and a row
    count that is no multiple of a warp's 4 x 1024-row round."""
    n, F, B, N = 300007, 12, 255, 8
    binned, qg, qh, _, _, ids, gen = _inputs(dev, n, F, B, N, 9)
    qg8 = torch.randint(-64, 65, (n,), generator=gen, device=dev) \
        .to(torch.int8)
    qh8 = torch.randint(0, 128, (n,), generator=gen, device=dev) \
        .to(torch.int8)
    if case == "quant128_extremes":
        qg8[: n // 3], qh8[: n // 3] = -64, 127
        qg8[n // 3: n // 2], qh8[n // 3: n // 2] = 64, 127
    elif case == "one_node_one_bin":
        binned = torch.full((F, n), 7, dtype=torch.uint8, device=dev).t()
        ids = torch.full((n,), 5, dtype=torch.int32, device=dev)
        qg8[:], qh8[:] = -64, 127
    elif case == "all_inactive":
        ids = torch.full((n,), -1, dtype=torch.int32, device=dev)
    else:
        n = 4096 * 7 + 33
        binned, ids = binned[:n].t().contiguous().t(), ids[:n].contiguous()
        qg8, qh8 = qg8[:n].contiguous(), qh8[:n].contiguous()
    for bound in (n, 4000, 60):
        lay = CH.lane_layout(n, bound, 128)
        acc = CH.hist_accumulate(binned, qg8, qh8, ids, N, B, lay)
        ref = CH.hist_accumulate_plain(binned, qg8, qh8, ids, N, B, lay)
        assert torch.equal(acc, ref), (case, lay)
        if case == "all_inactive":
            assert not acc.any()
    torch.cuda.synchronize()


def _same_best(a, b):
    return torch.equal(torch.nan_to_num(a, nan=7.0), torch.nan_to_num(
        b, nan=7.0)) and torch.equal(a.isnan(), b.isnan())


@pytest.mark.parametrize("l1,l2,min_data,min_hess", [
    (0.0, 0.0, 20.0, 1e-3), (0.3, 2.0, 1.0, 0.5),
    (0.0, 0.0, 0.0, 0.0)])          # ungated: 0/0 gains are NaN
@pytest.mark.parametrize("subtract", [False, True])
def test_frontier_finish_bit_identical(dev, l1, l2, min_data, min_hess,
                                       subtract):
    n, F, B, N = 50000, 11, 63, 4
    binned, qg, qh, gs, hs, ids, gen = _inputs(dev, n, F, B, N, 3)
    lay = CH.lane_layout(n, n, 16)
    fmask = torch.rand(F, generator=gen, device=dev) < 0.8
    edge = torch.rand((F, B), generator=gen, device=dev) < 0.9
    parent = small_left = None
    if subtract:
        parent = CH.frontier_finish(CH.hist_accumulate(binned, qg, qh, ids,
                                                       N, B, lay), *lay)[0]
        ids = torch.where(torch.rand(n, generator=gen, device=dev) < 0.4,
                          ids, -1)
        small_left = torch.rand(N, generator=gen, device=dev) < 0.5
    acc = CH.hist_accumulate(binned, qg, qh, ids, N, B, lay)
    for depth_ok in (None, True, False):
        gp = CH.gain_params(gs, hs, fmask, edge, depth_ok, l1=l1, l2=l2,
                            min_data=min_data, min_hess=min_hess)
        hist, best = CH.frontier_finish(acc, *lay, parent, small_left, gp)
        hist_p, best_p = CH.frontier_finish_plain(acc, *lay, parent,
                                                  small_left, gp)
        assert torch.equal(hist, hist_p)
        assert _same_best(best, best_p), (best, best_p)
    torch.cuda.synchronize()


def _slot_case(dev, n, F, B, dtype, do, seed, ungated=False):
    """A leaf-wise split step on the card: lane sums of the left child and
    an 8-slot carry whose slot 2 holds the parent, in ``dtype``."""
    binned, qg, qh, gs, hs, _, gen = _inputs(dev, n, F, B, 1, seed)
    lay = CH.lane_layout(n, n, 16)
    zeros = torch.zeros(n, dtype=torch.int32, device=dev)
    parent = CH.frontier_finish(CH.hist_accumulate(binned, qg, qh, zeros, 1,
                                                   B, lay), *lay)[0]
    in_left = torch.rand(n, generator=gen, device=dev) < 0.4
    acc = CH.hist_accumulate(binned, qg, qh, torch.where(
        in_left, 0, -1).to(torch.int32), 1, B, lay)
    L = 7
    hists = torch.randint(-99, 99, (L + 1, F, B, 3), generator=gen,
                          device=dev).to(dtype)
    hists[2] = parent[0].to(dtype)
    carry = CH.FinishOut(hists, torch.randn(L + 1, generator=gen, device=dev),
                         torch.zeros(L + 1, dtype=torch.int32, device=dev),
                         torch.zeros(L + 1, dtype=torch.int32, device=dev),
                         torch.randn((L + 1, 3), generator=gen, device=dev))
    lim = (0.0, 0.0) if ungated else (20.0, 1e-3)
    gp = CH.gain_params(gs, hs, torch.ones(F, dtype=torch.bool, device=dev),
                        torch.ones((F, B), dtype=torch.bool, device=dev),
                        None if ungated else True, l2=0.0 if ungated else 1.0,
                        min_data=lim[0], min_hess=lim[1])
    slots = [torch.tensor([s], device=dev) for s in
             ((2, 2, 5) if do else (2, L, L))]
    return acc, lay, carry, gp, slots


def _same_carry(a, b):
    return all(_same_best(x, y) if x.is_floating_point() else torch.equal(x, y)
               for x, y in zip(a[:5], b[:5]))


@pytest.mark.parametrize("do", [True, False])
@pytest.mark.parametrize("dtype", [torch.int16, torch.int32])
def test_finish_slot_form_bit_identical(dev, dtype, do):
    """The leaf-wise N = 1 step in the slot form: the parent read from the
    carry, the children and best splits written into it (to the trash slot
    when the gate is off, the real slots untouched)."""
    acc, lay, carry, gp, (j, at_j, at_new) = _slot_case(
        dev, 30000, 13, 255, dtype, do, 5)
    left = torch.ones((1,), dtype=torch.bool, device=dev)
    got = CH.FinishOut(*(x.clone() for x in carry[:5]))
    ref = CH.FinishOut(*(x.clone() for x in carry[:5]))
    CH.frontier_finish(acc, *lay, None, left, gp, out=got,
                       out_slots=(at_j, at_new), parent_slot=j)
    CH.frontier_finish_plain(acc, *lay, None, left, gp, out=ref,
                             out_slots=(at_j, at_new), parent_slot=j)
    torch.cuda.synchronize()
    assert _same_carry(got, ref)
    if not do:
        assert all(torch.equal(x[:7], y[:7])
                   for x, y in zip(got[:5], carry))


@pytest.mark.parametrize("case", ["B=2", "B=256", "F=1", "F ragged",
                                  "ungated NaN"])
def test_finish_edges_bit_identical(dev, case):
    """Edges of the one-launch finish, dense (8 parents: five features a
    block) and in the slot form (N = 1: one feature a block)."""
    n, F, B = 20000, 24, 63
    if case == "B=2":
        B = 2
    elif case == "B=256":
        B = 256
    elif case == "F=1":
        F = 1
    elif case == "F ragged":
        F = 203
    ungated = case == "ungated NaN"
    acc, lay, carry, gp, (j, at_j, at_new) = _slot_case(
        dev, n, F, B, torch.int32, True, 7, ungated)
    left = torch.ones((1,), dtype=torch.bool, device=dev)
    got = CH.FinishOut(*(x.clone() for x in carry[:5]))
    ref = CH.FinishOut(*(x.clone() for x in carry[:5]))
    CH.frontier_finish(acc, *lay, None, left, gp, out=got,
                       out_slots=(at_j, at_new), parent_slot=j)
    CH.frontier_finish_plain(acc, *lay, None, left, gp, out=ref,
                             out_slots=(at_j, at_new), parent_slot=j)
    assert _same_carry(got, ref)
    binned, qg, qh, _, _, ids, gen = _inputs(dev, n, F, B, 8, 11)
    parent = CH.frontier_finish(CH.hist_accumulate(
        binned, qg, qh, ids, 8, B, lay), *lay)[0]
    ids = torch.where(torch.rand(n, generator=gen, device=dev) < 0.4, ids,
                      -1)
    acc8 = CH.hist_accumulate(binned, qg, qh, ids, 8, B, lay)
    sl = torch.rand(8, generator=gen, device=dev) < 0.5
    if case == "F ragged":
        assert CH._finish_plan(8, F, CH._num_sms(dev.index)) == 5
    hist, best = CH.frontier_finish(acc8, *lay, parent, sl, gp)
    hist_p, best_p = CH.frontier_finish_plain(acc8, *lay, parent, sl, gp)
    torch.cuda.synchronize()
    assert torch.equal(hist, hist_p)
    assert _same_best(best, best_p), (best, best_p)
    if ungated:
        assert best.isnan().any()


def test_finish_is_one_launch(dev):
    """One kernel per call, dense and in the slot form: the profiler sees
    only frontier_finish_kernel, once per call."""
    from torch.profiler import ProfilerActivity, profile
    acc, lay, carry, gp, (j, at_j, at_new) = _slot_case(
        dev, 20000, 17, 255, torch.int32, True, 9)
    left = torch.ones((1,), dtype=torch.bool, device=dev)
    parent = carry.hist[2:3].to(torch.int32)
    CH.reset_launch_counts()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            CH.frontier_finish(acc, *lay, parent, left, gp,
                               out=CH.dense_out(2, *acc.shape[2:], dev))
            CH.frontier_finish(acc, *lay, None, left, gp, out=carry,
                               out_slots=(at_j, at_new), parent_slot=j)
        torch.cuda.synchronize()
    kernels = {e.key: e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and "frontier" in e.key}
    assert list(kernels.values()) == [6], kernels
    assert "frontier_finish_kernel" in next(iter(kernels))
    assert CH.launch_counts()["frontier_finish"] == 6


def test_launch_counts_and_argument_checks(dev):
    n, F, B, N = 5000, 4, 31, 2
    binned, qg, qh, _, _, ids, _ = _inputs(dev, n, F, B, N, 1)
    CH.reset_launch_counts()
    CH.build_histograms_cuda(binned, qg, qh, ids, N, B)
    assert CH.launch_counts() == {"hist_accumulate": 1, "frontier_finish": 1}
    lay = CH.lane_layout(n, n, 16)
    with pytest.raises(TypeError, match="int32"):
        CH.hist_accumulate(binned, qg, qh, ids.to(torch.int64), N, B, lay)
    with pytest.raises(TypeError, match="int8"):
        CH.hist_accumulate(binned, qg.to(torch.int32), qh, ids, N, B, lay)
    with pytest.raises(ValueError, match="must lie on"):
        CH.hist_accumulate(binned, qg, qh, ids.cpu(), N, B, lay)
    assert CH.launch_counts()["hist_accumulate"] == 1


@pytest.mark.parametrize("n,num_leaves,max_depth,store16", [
    (2000, 31, 0, True), (2000, 31, 0, False), (20000, 31, 0, True),
    (20000, 15, 4, True)])
def test_leafwise_grower_card_equals_cpu(dev, n, num_leaves, max_depth,
                                         store16):
    """A leaf-wise tree grown on the card (the two kernels, no host sync in
    the step loop) equals the same tree grown by the plain versions on the
    CPU: integer arrays and every row's leaf bit-identical.  At 2,000 rows
    the histogram carry is int16 unless ``store16`` is off."""
    from mmlspark_tpu_torch.lightgbm import GBDTParams
    from mmlspark_tpu_torch.lightgbm.core import make_leafwise_grower
    F, B = 12, 63
    gen = torch.Generator().manual_seed(n + num_leaves + max_depth)
    binned = torch.randint(0, B, (n, F), generator=gen, dtype=torch.uint8)
    g = torch.randn(n, generator=gen) + binned[:, 0].float() / B - 0.5
    h = torch.rand(n, generator=gen) * 0.25 + 1e-3
    noise = torch.rand((2, n), generator=gen)
    edges = torch.arange(B - 1, dtype=torch.float32).repeat(F, 1)
    params = GBDTParams(num_leaves=num_leaves, max_depth=max_depth,
                        use_quantized_grad=True, lambda_l2=1.0).resolve()
    grow = make_leafwise_grower(num_leaves, max_depth, F, B, params,
                                store16=store16)
    trees = []
    for d in (dev, torch.device("cpu")):
        bd = binned.to(d).t().contiguous().t()
        mask = torch.ones(n, dtype=torch.bool, device=d)
        fmask = torch.ones(F, dtype=torch.bool, device=d)
        args = (bd, g.to(d), h.to(d), mask, fmask, edges.to(d))
        u = noise.to(d)
        torch.cuda.synchronize()
        CH.reset_launch_counts()
        if d.type == "cuda":
            torch.cuda.set_sync_debug_mode("error")
        try:
            tree = grow(*args, noise=u)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        if d.type == "cuda":
            assert CH.launch_counts() == {"hist_accumulate": num_leaves,
                                          "frontier_finish": num_leaves}
        trees.append([None if x is None else x.cpu() for x in tree])
    for name, a, b in zip(tree._fields, *trees):
        if a is None:
            assert b is None, name
        elif a.is_floating_point():
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                       atol=0, err_msg=name)
        else:
            assert torch.equal(a, b), name


@pytest.mark.parametrize("quant_bins", [6, 16, 128])
def test_quantize_on_the_card_equals_cpu(dev, quant_bins):
    """The quantizer's ints and scales on the card equal the CPU's (and so
    the JAX package's) bit for bit: the scales are true divisions."""
    gen = torch.Generator().manual_seed(quant_bins)
    g = torch.randn(50000, generator=gen)
    h = torch.rand(50000, generator=gen) * 0.3 + 1e-3
    u = torch.rand((2, 50000), generator=gen)
    cpu = quantize_gradients(g, h, quant_bins, noise=u)
    card = quantize_gradients(g.to(dev), h.to(dev), quant_bins,
                              noise=u.to(dev))
    for a, b in zip(card, cpu):
        assert torch.equal(a.cpu(), b)


def _cat_inputs(n, F, B, seed):
    """Bins whose features 0 and 1 are categorical codes (40 and 3 of
    them, the NaN bin B - 1 on some rows) and gradients that follow a
    planted half of feature 0's codes."""
    gen = torch.Generator().manual_seed(seed)
    binned = torch.randint(0, B - 1, (n, F), generator=gen,
                           dtype=torch.uint8)
    binned[:, 0] = torch.randint(0, 40, (n,), generator=gen)
    binned[:, 1] = torch.randint(0, 3, (n,), generator=gen)
    binned[torch.rand(n, generator=gen) < 0.05, 0] = B - 1
    planted = torch.randperm(40, generator=gen)[:20]
    member = torch.isin(binned[:, 0].long(), planted).float()
    g = torch.randn(n, generator=gen) * 0.5 + member - 0.5 \
        + 0.3 * (binned[:, 1] == 1).float()
    h = torch.rand(n, generator=gen) * 0.25 + 1e-3
    noise = torch.rand((2, n), generator=gen)
    edges = torch.arange(B - 1, dtype=torch.float32).repeat(F, 1)
    edges[:2] = torch.inf
    return binned, g, h, noise, edges


@pytest.mark.parametrize("growth", ["leaf", "level"])
@pytest.mark.parametrize("cat_subset", [(0,), ()],
                         ids=["subset", "onehot"])
def test_categorical_grower_card_equals_cpu(dev, growth, cat_subset):
    """A tree with categorical features grown on the card (histograms from
    the two kernels, the split search in torch, int32 prefix sums) equals
    the CPU tree in every array; the leaf-wise loop never syncs, and each
    grower launches ``hist_accumulate`` once per step or level."""
    from mmlspark_tpu_torch.lightgbm import GBDTParams
    from mmlspark_tpu_torch.lightgbm.core import (make_leafwise_grower,
                                                  make_tree_grower)
    n, F, B = 20000, 8, 63
    binned, g, h, noise, edges = _cat_inputs(n, F, B, seed=len(cat_subset))
    kw = dict(use_quantized_grad=True, lambda_l2=1.0,
              categorical_features=(0, 1), cat_subset=cat_subset)
    if growth == "leaf":
        params = GBDTParams(num_leaves=15, **kw).resolve()
        grow, launches = make_leafwise_grower(15, 0, F, B, params), 15
    else:
        params = GBDTParams(max_depth=5, **kw).resolve()
        grow, launches = make_tree_grower(5, F, B, params), 5
    trees = []
    for d in (dev, torch.device("cpu")):
        args = (binned.to(d).t().contiguous().t(), g.to(d), h.to(d),
                torch.ones(n, dtype=torch.bool, device=d),
                torch.ones(F, dtype=torch.bool, device=d), edges.to(d))
        u = noise.to(d)
        torch.cuda.synchronize()
        CH.reset_launch_counts()
        if d.type == "cuda" and growth == "leaf":
            torch.cuda.set_sync_debug_mode("error")
        try:
            tree = grow(*args, noise=u)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        if d.type == "cuda":
            assert CH.launch_counts()["hist_accumulate"] == launches
        trees.append([x.cpu() for x in tree])
    sf = trees[1][tree._fields.index("split_feature")]
    assert bool(((sf == 0) | (sf == 1)).any())      # categorical splits
    for name, a, b in zip(tree._fields, *trees):
        assert torch.equal(a, b), name


def test_categorical_walk_card_equals_cpu(dev):
    from mmlspark_tpu_torch.lightgbm import GBDTParams, train
    gen = np.random.default_rng(4)
    n = 30000
    X = np.column_stack([gen.integers(0, 40, n), gen.integers(0, 3, n),
                         gen.normal(size=(n, 4))]).astype(np.float32)
    y = ((X[:, 0] % 3 == 0) ^ (X[:, 1] == 1)).astype(np.float32)
    X[::17, 0] = np.nan
    b = train(X, y, GBDTParams(num_iterations=4, num_leaves=15,
                               categorical_features=(0, 1)),
              device=dev).booster
    assert b.cat_bitset is not None
    probe = np.concatenate([X[:5000], [[np.nan, 9, 0, 0, 0, 0],
                                       [200, -3, 0, 0, 0, 0]]]) \
        .astype(np.float32)
    np.testing.assert_array_equal(b.predict_leaf(probe),
                                  b.predict_leaf(probe, device="cpu"))


@pytest.mark.parametrize("route", ["cxx", "numpy"])
def test_bin_on_device_card_equals_cpu(dev, route, monkeypatch):
    """The train route's bins applied on the card equal the CPU's (which
    the CPU tests hold equal to the JAX package's host bins), NaN, ±inf,
    the leading -inf edge and categorical codes included."""
    import multiprocessing
    from mmlspark_tpu_torch.lightgbm import BinMapper
    from mmlspark_tpu_torch.ops.histogram import bin_matrix
    monkeypatch.setattr(multiprocessing, "cpu_count",
                        lambda: 8 if route == "cxx" else 1)
    rng = np.random.default_rng(5)
    n = 20000 if route == "cxx" else 4000
    X = rng.normal(size=(n, 6)).astype(np.float32)
    X[::7, 1] = -np.inf
    X[:, 1] = np.where(np.isfinite(X[:, 1]), np.round(X[:, 1]), X[:, 1])
    X[::11, 2] = np.nan
    X[::13, 3] = np.inf
    X[:, 5] = rng.integers(0, 30, n)
    X[::9, 5] = np.nan
    m = BinMapper(255, categorical_features=(5,)).fit(X)
    card = m.bin_on_device(X, dev)
    cpu = m.bin_on_device(X, "cpu")
    assert torch.equal(card.cpu(), cpu)
    np.testing.assert_array_equal(cpu.t().numpy(), m.transform(X))
    e = torch.from_numpy(m.edges)
    assert torch.equal(bin_matrix(torch.from_numpy(X).to(dev), e.to(dev),
                                  255).cpu(),
                       bin_matrix(torch.from_numpy(X), e, 255))


def test_multiclass_leafwise_trees_card_equal_cpu(dev):
    """K = 3 leaf-wise trees from the multiclass gradients' columns (views
    with stride 3, as ``train()`` hands them over) grown on the card equal
    the CPU's in every array, back to back under sync debug mode "error"
    (the finish's per-stream counters must be zero at each tree's first
    launch), each tree launching each kernel 15 times."""
    from mmlspark_tpu_torch.lightgbm import GBDTParams
    from mmlspark_tpu_torch.lightgbm.core import (make_leafwise_grower,
                                                  make_objective)
    n, F, B, K = 20000, 10, 63, 3
    gen = torch.Generator().manual_seed(11)
    binned = torch.randint(0, B, (n, F), generator=gen, dtype=torch.uint8)
    y = (binned[:, 0].long() * K // B).float()
    s = torch.randn((n, K), generator=gen)
    noise = torch.rand((K, 2, n), generator=gen)
    edges = torch.arange(B - 1, dtype=torch.float32).repeat(F, 1)
    params = GBDTParams(num_leaves=15, objective="multiclass", num_class=K,
                        use_quantized_grad=True, lambda_l2=1.0).resolve()
    grow = make_leafwise_grower(15, 0, F, B, params)
    # the (n, K) gradients are made once, so both devices quantize the
    # same floats; each device gets the (n, K) layout and reads columns
    g_all, h_all = make_objective(params)(s, y, torch.ones(n))
    out = []
    for d in (dev, torch.device("cpu")):
        g, h = g_all.to(d), h_all.to(d)
        assert g.stride() == (K, 1)
        args = (binned.to(d).t().contiguous().t(),)
        rest = (torch.ones(n, dtype=torch.bool, device=d),
                torch.ones(F, dtype=torch.bool, device=d), edges.to(d))
        u = noise.to(d)
        torch.cuda.synchronize()
        CH.reset_launch_counts()
        if d.type == "cuda":
            torch.cuda.set_sync_debug_mode("error")
        try:
            trees = [grow(*args, g[:, c], h[:, c], *rest, noise=u[c])
                     for c in range(K)]
        finally:
            torch.cuda.set_sync_debug_mode(0)
        if d.type == "cuda":
            assert CH.launch_counts() == {"hist_accumulate": 15 * K,
                                          "frontier_finish": 15 * K}
        out.append([[None if x is None else x.cpu() for x in t]
                    for t in trees])
    for c in range(K):
        for name, a, b in zip(trees[0]._fields, out[0][c], out[1][c]):
            if a is None:
                assert b is None, name
            elif a.is_floating_point():
                np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                           atol=0, err_msg=f"{c} {name}")
            else:
                assert torch.equal(a, b), (c, name)


@pytest.mark.parametrize("case", ["tied", "scored", "uncovered"])
def test_lambda_pass_card_equals_cpu(dev, case):
    """The LambdaRank pass on the card equals the CPU's within rtol 1e-5,
    atol 1e-6 (f32 ``exp``/``log2`` and summation orders differ by ulps),
    at all-tied scores (ranks from the stable sort's tie order alone), at
    spread scores and with rows outside every query; it never syncs."""
    from mmlspark_tpu_torch.lightgbm.core import make_lambdarank_grad_fn
    rng = np.random.default_rng(12)
    sizes = rng.integers(16, 257, 300)
    lead = 9 if case == "uncovered" else 0
    gp = lead + np.concatenate([[0], np.cumsum(sizes)])
    n = int(gp[-1]) + (13 if case == "uncovered" else 0)
    rel = rng.integers(0, 5, n).astype(np.float32)
    scores = np.zeros((n, 1), np.float32) if case == "tied" else \
        rng.normal(size=(n, 1)).astype(np.float32)
    got = []
    for d in (dev, torch.device("cpu")):
        fn = make_lambdarank_grad_fn(rel, gp, 1.0, device=d)
        s = torch.from_numpy(scores).to(d)
        torch.cuda.synchronize()
        if d.type == "cuda":
            torch.cuda.set_sync_debug_mode("error")
        try:
            g, h = fn(s)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        got.append((g.cpu().numpy(), h.cpu().numpy()))
    np.testing.assert_allclose(got[0][0], got[1][0], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[0][1], got[1][1], rtol=1e-5, atol=1e-6)
    assert np.abs(got[0][0]).max() > 0


def test_row_noise_on_the_card_equals_cpu(dev):
    """The streamed quantizer's counter-based noise is integer arithmetic:
    the same bits on the card and on the CPU."""
    from mmlspark_tpu_torch.ops.histogram import row_noise
    rows = torch.arange(3_000_000, 3_400_000)
    assert torch.equal(row_noise(rows.to(dev), 7, -99).cpu(),
                       row_noise(rows, 7, -99))


@pytest.mark.parametrize("growth", [dict(max_depth=4), dict(num_leaves=9)],
                         ids=["level", "leaf"])
def test_train_streamed_card_equals_cpu(dev, growth):
    """Tiles through pinned memory on the copy stream into the kernels:
    the card's streamed booster equals the CPU's in every array, and the
    tile width moves no bit."""
    from mmlspark_tpu_torch.lightgbm import GBDTParams, train_streamed
    rng = np.random.default_rng(4)
    X = rng.normal(size=(9_000, 12)).astype(np.float32)
    y = (X[:, 0] - X[:, 1] * X[:, 2] > 0).astype(np.float32)
    p = GBDTParams(num_iterations=3, objective="binary", seed=2,
                   use_quantized_grad=True, bagging_fraction=0.8,
                   bagging_freq=1, **growth)
    card = train_streamed(X, y, p, tile_rows=2_000)
    assert card.extras["h2d_s"] > 0.0
    others = (train_streamed(X, y, p, tile_rows=2_000, device="cpu"),
              train_streamed(X, y, p, tile_rows=3_500))
    for other in others:
        for k in ("split_feature", "threshold_bin", "left_child",
                  "right_child", "split_gain", "internal_value",
                  "leaf_value", "leaf_count", "tree_weight"):
            np.testing.assert_array_equal(getattr(card.booster, k),
                                          getattr(other.booster, k))
