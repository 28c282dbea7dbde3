"""The plain reference agrees with the port's CPU path at a small size:
edges, bins, gradients, quantization, routing, the walk and the tree a
fit grows."""
from __future__ import annotations

from unittest import mock

import numpy as np
import pytest
import torch

from conftest import REPO

from portbench.datasets import higgs, mslr
from portbench.harness import bench
from portbench.reference import gbdt as ref
from portbench.reference import judge


def _rows(n=30000, seed=5):
    x = higgs.features(n, higgs.generator(seed, "cpu"), "cpu")
    return x, higgs.label(x, higgs.generator(seed + 1, "cpu"))


def test_edges_and_bins_equal_the_ports_on_its_native_route():
    from mmlspark_tpu_torch.lightgbm.binning import BinMapper
    x, _ = _rows()
    xs = x.numpy()
    with mock.patch("multiprocessing.cpu_count", return_value=8):
        mapper = BinMapper(63).fit(xs)
        bins_port = mapper.transform(xs)
    edges = ref.bin_edges(xs[ref.sample_index(xs.shape[0])], 63)
    np.testing.assert_array_equal(edges, mapper.edges)
    np.testing.assert_array_equal(ref.apply_bins(x, edges).numpy(),
                                  bins_port)


def test_sampled_edges_follow_the_200000_row_sample():
    x = torch.rand((250_000, 2), generator=higgs.generator(9, "cpu"))
    from mmlspark_tpu_torch.lightgbm.binning import BinMapper
    with mock.patch("multiprocessing.cpu_count", return_value=8):
        mapper = BinMapper(15).fit(x.numpy())
    edges = ref.bin_edges(x.numpy()[ref.sample_index(250_000)], 15)
    np.testing.assert_array_equal(edges, mapper.edges)


def test_binary_gradients_and_quantization_equal_the_ports():
    from mmlspark_tpu_torch.lightgbm.core import GBDTParams, make_objective
    from mmlspark_tpu_torch.ops.histogram import quantize_gradients
    x, y = _rows(5000)
    s = torch.randn((5000, 1), generator=higgs.generator(3, "cpu"))
    g_p, h_p = make_objective(GBDTParams(objective="binary"))(
        s, y, torch.ones(5000))
    g, h = ref.binary_grads(s[:, 0], y)
    assert torch.equal(g, g_p[:, 0]) and torch.equal(h, h_p[:, 0])
    u = torch.rand((2, 5000), generator=higgs.generator(4, "cpu"))
    qg_p, qh_p, sg_p, sh_p = quantize_gradients(g_p[:, 0], h_p[:, 0], 16,
                                                noise=u)
    qg, qh, sg, sh = ref.quantize(g, h, 16, u)
    assert torch.equal(qg, qg_p.to(torch.int64))
    assert torch.equal(qh, qh_p.to(torch.int64))
    assert sg == float(sg_p) and sh == float(sh_p)


def test_lambdarank_gradients_agree_with_the_ports():
    from mmlspark_tpu_torch.lightgbm.core import lambdarank_grads
    cfg = {"num_data": 3000, "num_queries": 40, "longest_query": 250,
           "relevance_shares": [0.514, 0.325, 0.134, 0.019, 0.008]}
    d = mslr.make(cfg, 7, "cpu")
    s = torch.randn((3000,), generator=higgs.generator(8, "cpu"))
    g_p, h_p = lambdarank_grads(s.numpy()[:, None], d["y"].numpy(),
                                d["group_ptr"], device="cpu")
    g, h = ref.lambdarank_grads(s, d["y"], d["group_ptr"])
    np.testing.assert_allclose(g.numpy(), g_p[:, 0], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(h.numpy(), h_p[:, 0], rtol=1e-4, atol=1e-6)


def test_a_fitted_tree_is_the_references_best_first_tree():
    from mmlspark_tpu_torch.lightgbm.core import GBDTParams, train
    x, y = _rows(20000)
    cfg = {"max_bin": 15, "num_leaves": 15, "num_grad_quant_bins": 16,
           "objective": "binary", "min_data_in_leaf": 1,
           "min_sum_hessian_in_leaf": 1.0, "learning_rate": 0.1}
    p = GBDTParams(num_iterations=2, num_leaves=15, max_bin=15,
                   min_data_in_leaf=1, min_sum_hessian_in_leaf=1.0,
                   use_quantized_grad=True, growth="leaf")
    b = train(x.numpy(), y.numpy(), p, device="cpu").booster

    def noise(t):
        gen = torch.Generator().manual_seed(t)
        return torch.rand((2, 20000), generator=gen)

    trees = {k: np.asarray(getattr(b, k)) for k in judge.TREE_KEYS}
    out = judge.fit_readings(x, y, None, cfg, trees, b.init_score, noise,
                             b.num_trees, x.numpy()[:300],
                             b.raw_scores(x.numpy()[:300], device="cpu")
                             [:, 0])
    assert out["edge_mismatch"] == 0 and out["count_mismatch"] == 0
    assert out["gain_gap"] == 0 and out["order_gap"] == 0
    assert out["leaf_gap"] < 1e-5 and out["raw_gap"] < 1e-12
    assert out["init_gap"] < 1e-6


def test_the_walk_equals_the_ports_leaves_and_scores():
    from mmlspark_tpu_torch.models.gbdt import GBDTBooster
    from portbench.harness import forest
    x = higgs.features(3000, higgs.generator(1, "cpu"), "cpu")
    q = higgs.quantile_table({}, 2, "cpu", n=4096)
    shape = bench.config(REPO, bench.benchmark(REPO),
                         "higgs")["score_forest"]
    tr = forest.generate(q, 12, 31, higgs.generator(3, "cpu"), shape)
    T, M = tr["split_feature"].shape
    z = np.zeros((T, M), np.float32)
    b = GBDTBooster(tr["split_feature"], tr["threshold"],
                    np.zeros((T, M), np.int32), z, z, z, tr["leaf_value"],
                    np.zeros((T, 31), np.float32), np.ones(T, np.float32),
                    max_depth=tr["max_depth"], num_features=28,
                    objective="binary", init_score=0.25,
                    left_child=tr["left_child"],
                    right_child=tr["right_child"])
    raw_ref = judge.score_reference(x, dict(tr, init_score=0.25))
    np.testing.assert_allclose(b.raw_scores(x.numpy(), device="cpu")[:, 0],
                               raw_ref, rtol=0, atol=1e-12)
    _, visits = ref.walk_raw(x, tr["split_feature"], tr["threshold"],
                             tr["left_child"], tr["right_child"],
                             tr["leaf_value"])
    assert int(visits.min()) >= T and int(visits.max()) <= T * (
        tr["max_depth"])


@pytest.mark.parametrize("seed", [1, 2147483671])
def test_the_score_forest_has_the_configured_depth_on_every_seed(seed):
    from portbench.harness import forest
    cfg = bench.config(REPO, bench.benchmark(REPO), "higgs")
    shape = cfg["score_forest"]
    q = higgs.quantile_table({}, seed, "cpu", n=4096)
    tr = forest.generate(q, 6, int(cfg["num_leaves"]),
                         higgs.generator(seed, "cpu"), shape)
    assert tr["max_depth"] == shape["max_depth"]
    # every slot used, every leaf reached from the root once
    T, M = tr["left_child"].shape
    for t in range(T):
        kids = np.concatenate([tr["left_child"][t], tr["right_child"][t]])
        assert sorted(kids[kids >= 0].tolist()) == list(range(1, M))
        assert sorted((~kids[kids < 0]).tolist()) == list(range(M + 1))
    np.testing.assert_allclose(tr["leaf_share"].sum(1), 1.0, rtol=1e-9)
