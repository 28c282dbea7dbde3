"""The GBDT family's compiled programs (``lightgbm.iter`` / ``iter_pre``,
``objective``, ``multi_iter``, ``valid_update``, ``tree_walk``,
``lambdarank_grads``, ``grower``, the four ``ooc_*`` programs,
``models.gbdt_walk``, ``ops.bin_matrix``) against the JAX package's, on
the CPU.

Each configuration goes through both packages' ``train()`` (or
``train_streamed()``, or a booster's ``predict``) on the same seeded
numpy inputs, with both packages' program caches emptied first, and the
compile booking is compared after it: the compiles each function's
``mmlspark_jit_compile_total`` counter gained (names and counts), and the
names of the programs the configuration left in the package's program
cache, which ``compile_report()`` lists with them.  On the CPU the port's
programs run eagerly under that booking; on the card they are CUDA graphs
(``tests/test_torch_cuda_graphs.py``).  The chunked path is the port's
alone here (the reference's CPU scan compile is too slow for this tier):
``MMLSPARK_TPU_GBDT_CHUNK=4`` at 50,000 rows books ``lightgbm.multi_iter``
and grows the unchunked booster bit for bit.
"""
import gc

import numpy as np
import pytest
import torch

from mmlspark_tpu.lightgbm import core as jax_core
from mmlspark_tpu.observability import get_registry as jax_registry
from mmlspark_tpu.observability.compute import compile_report as jax_report
from mmlspark_tpu_torch.lightgbm import core as port_core
from mmlspark_tpu_torch.models import gbdt as port_gbdt
from mmlspark_tpu_torch.models.transformer import TransformerEncoder
from mmlspark_tpu_torch.observability import MetricsRegistry
from mmlspark_tpu_torch.observability import get_registry as port_registry
from mmlspark_tpu_torch.observability.compute import compile_report, \
    instrumented_jit

PACKAGES = ((jax_core, jax_registry, jax_report, {}),
            (port_core, port_registry, compile_report, {"device": "cpu"}))


def _counts(reg) -> dict:
    fam = reg.counter("mmlspark_jit_compile_total", labels=("fn",))
    return {key[0]: child.value for key, child in fam._snapshot()}


def _delta(before: dict, after: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}


def _cached(core, report) -> list:
    """The names of the programs in ``core``'s program cache, each listed
    by ``report()``."""
    names = sorted({w.name for w in core._JIT_CACHE.values()})
    assert set(names) <= set(report()["functions"])
    return names


@pytest.fixture
def fresh(monkeypatch):
    """Both packages with empty program caches: each configuration's first
    fit compiles, whatever ran before in this process."""
    monkeypatch.setattr(jax_core, "_JIT_CACHE", {})
    monkeypatch.setattr(port_core, "_JIT_CACHE", {})
    monkeypatch.setattr(port_gbdt, "_WALKS", {})


def _booked(run):
    """``run(core, kw)`` on both packages: per package the compiles it
    booked, the programs it left in the cache and its result."""
    out = []
    for core, registry, report, kw in PACKAGES:
        gc.collect()
        before = _counts(registry())
        res = run(core, kw)
        out.append((_delta(before, _counts(registry())),
                    _cached(core, report), res))
    return out


def _data(n=1500, F=8, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, F)).astype(np.float32)
    y = (X[:, 0] + rng.normal(scale=0.1, size=n) > 0).astype(np.float32)
    return rng, X, y


_RNG, _X, _Y = _data()
_YMC = np.digitize(_X[:, 0], [-0.5, 0.5]).astype(np.float32)
_REL = _RNG.integers(0, 4, len(_X)).astype(np.float32)
_GP = np.arange(0, len(_X) + 1, 50)
_XV = _RNG.normal(size=(300, _X.shape[1])).astype(np.float32)
_YV = (_XV[:, 0] > 0).astype(np.float32)

#: configuration -> (labels, params, train() keywords, what it compiles)
CONFIGS = {
    "binary_level": (_Y, dict(max_depth=3), {}, {"lightgbm.iter": 1}),
    "binary_leaf": (_Y, dict(num_leaves=7), {}, {"lightgbm.iter": 1}),
    "multiclass": (_YMC, dict(num_leaves=5, objective="multiclass",
                              num_class=3), {}, {"lightgbm.iter": 1}),
    "dart": (_Y, dict(num_leaves=7, boosting_type="dart", drop_rate=0.5,
                      skip_drop=0.0, num_iterations=5), {},
             {"lightgbm.iter": 1, "lightgbm.iter_pre": 1,
              "lightgbm.objective": 1, "lightgbm.tree_walk": 1}),
    "lambdarank": (_REL, dict(num_leaves=7, objective="lambdarank"),
                   {"group_ptr": _GP},
                   {"lightgbm.iter_pre": 1, "lightgbm.lambdarank_grads": 1}),
    "goss": (_Y, dict(num_leaves=7, boosting_type="goss"), {},
             {"lightgbm.iter": 1}),
    "valid_early_stopping": (
        _Y, dict(num_leaves=7, num_iterations=20, early_stopping_round=2,
                 learning_rate=0.8), {"valid": (_XV, _YV)},
        {"lightgbm.iter": 1, "lightgbm.tree_walk": 1}),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_train_books_the_reference_compiles(fresh, name):
    labels, pkw, kw, want = CONFIGS[name]
    pkw = dict({"num_iterations": 3}, **pkw)
    (jd, jnames, jres), (pd, pnames, pres) = _booked(
        lambda core, dkw: core.train(_X, labels, core.GBDTParams(**pkw),
                                     **kw, **dkw))
    assert pd == jd == want
    assert pnames == jnames
    # the cached programs of the fit stay listed, ``lightgbm.grower`` and
    # both iteration programs among them, compiled or not
    assert {"lightgbm.grower", "lightgbm.iter", "lightgbm.iter_pre",
            "lightgbm.valid_update", "lightgbm.tree_walk"} <= set(pnames)
    assert pres.booster.num_trees == jres.booster.num_trees


@pytest.mark.parametrize("growth", [dict(max_depth=3), dict(num_leaves=5)],
                         ids=["level", "leaf"])
def test_train_streamed_books_the_four_ooc_programs(fresh, growth):
    params = dict(num_iterations=3, **growth)
    (jd, jnames, _), (pd, pnames, pres) = _booked(
        lambda core, dkw: core.train_streamed(
            _X, _Y, core.GBDTParams(**params), tile_rows=512,
            valid=(_XV, _YV), **dkw))
    assert pd == jd
    per_level = 3 if "max_depth" in growth else 1
    assert pd["lightgbm.ooc_grad"] == 1
    assert pd["lightgbm.ooc_tile_hist"] == per_level
    assert pd.get("lightgbm.ooc_level_decide", 0) == \
        (per_level if "max_depth" in growth else 0)
    assert pd.get("lightgbm.ooc_leaf_best", 0) == \
        (0 if "max_depth" in growth else 1)
    assert pnames == jnames


def test_predict_books_one_walk_per_signature(fresh):
    """``models.gbdt_walk`` past the host-walk threshold (rows x trees >
    2**17) books one compile on both packages; the port keeps the program
    (one per walk depth, over row buckets), so a second transform of the
    same shapes books none, where the reference builds a wrapper per call
    and books another."""
    boosters = [core.train(_X, _Y, core.GBDTParams(num_iterations=3,
                                                   max_depth=3),
                           **kw).booster
                for core, _, _, kw in PACKAGES]
    Xp = _RNG.normal(size=(50_000, _X.shape[1])).astype(np.float32)
    got = []
    for (core, registry, _, kw), b in zip(PACKAGES, boosters):
        before = _counts(registry())
        got.append(b.predict(Xp, **kw))
        assert _delta(before, _counts(registry())) == {"models.gbdt_walk": 1}
    np.testing.assert_allclose(got[1], got[0], rtol=1e-6, atol=1e-7)
    before = _counts(port_registry())
    small = boosters[1].predict(Xp[:1000], device="cpu")   # a plain walk
    again = boosters[1].predict(Xp, device="cpu")
    assert _delta(before, _counts(port_registry())) == {}
    np.testing.assert_array_equal(again, got[1])
    np.testing.assert_array_equal(small, got[1][:1000])


def test_gbdt_training_is_compile_stable_after_warmup(fresh):
    """The twin of the reference's acceptance test
    (``tests/test_compute_telemetry.py``): a second same-shape ``train()``
    compiles nothing, on either package."""
    rng = np.random.default_rng(0)
    X = rng.normal(size=(1500, 8)).astype(np.float32)

    def y():
        return (X[:, 0] + rng.normal(scale=0.1, size=len(X)) > 0).astype(
            np.float32)

    for core, registry, _, kw in PACKAGES:
        params = core.GBDTParams(num_iterations=4, objective="binary",
                                 max_depth=3)
        core.train(X, y(), params, **kw)
        before = _counts(registry())
        core.train(X, y(), params, **kw)
        assert _counts(registry()) == before


def test_chunked_iterations_grow_the_unchunked_booster(fresh, monkeypatch):
    """Port only: ``MMLSPARK_TPU_GBDT_CHUNK=4`` at 50,000 rows runs
    ``lightgbm.multi_iter`` (four iterations per program, their draws
    taken first in the unchunked loop's order) and ``valid_update``, and
    the booster equals the unchunked fit's bit for bit: quantized with
    GOSS, and RF with per-iteration bags and feature masks."""
    rng, X, y = _data(n=50_000, F=5, seed=3)
    Xv = rng.normal(size=(500, 5)).astype(np.float32)
    yv = (Xv[:, 0] > 0).astype(np.float32)
    for pkw in (dict(num_leaves=5, boosting_type="goss",
                     use_quantized_grad=True),
                dict(max_depth=2, boosting_type="rf", bagging_fraction=0.7,
                     bagging_freq=1, feature_fraction=0.6)):
        params = port_core.GBDTParams(num_iterations=9, **pkw)
        fits = []
        for chunk in ("1", "4"):
            monkeypatch.setenv("MMLSPARK_TPU_GBDT_CHUNK", chunk)
            before = _counts(port_registry())
            res = port_core.train(X, y, params, valid=(Xv, yv),
                                  device="cpu")
            fits.append((res, _delta(before, _counts(port_registry()))))
        (plain, booked1), (chunked, booked4) = fits
        assert "lightgbm.multi_iter" not in booked1
        assert booked4["lightgbm.multi_iter"] == 1
        assert booked4["lightgbm.valid_update"] == 1
        # two chunks of four, then one iteration alone: its evals step by
        # the chunk, as the reference's
        assert [e["iteration"] for e in chunked.evals] == [3, 7, 8]
        for k in ("split_feature", "threshold", "threshold_bin",
                  "left_child", "right_child", "leaf_value", "leaf_count",
                  "tree_weight"):
            np.testing.assert_array_equal(getattr(chunked.booster, k),
                                          getattr(plain.booster, k))


def test_python_scalar_values_do_not_churn_the_compile_counter():
    """Fault 3.16's CPU twin of the reference's test: four Python floats,
    one compile, each call its own answer."""
    reg = MetricsRegistry()

    @instrumented_jit(name="t.scale", registry=reg)
    def f(x, s):
        return x * s

    outs = [f(torch.ones(3), s) for s in (1.5, 2.5, 3.5, 4.5)]
    assert reg.counter("mmlspark_jit_compile_total",
                       labels=("fn",)).value(fn="t.scale") == 1
    assert [float(o[0]) for o in outs] == [1.5, 2.5, 3.5, 4.5]


def test_positions_past_max_len_raise_before_the_lookup():
    """Fault 3.17 on the CPU: out-of-range positions raise ``ValueError``
    (the card reads its positions back for the same check whenever no
    capture is under way: ``tests/test_torch_cuda_graphs.py``)."""
    lm = TransformerEncoder(16, num_classes=16, embed_dim=8, num_heads=2,
                            num_layers=1, mlp_dim=16, max_len=8,
                            causal=True, pool="none")
    tokens = torch.zeros((1, 2), dtype=torch.int64)
    with torch.inference_mode():
        lm(tokens, positions=torch.tensor([[0, 7]]))
        for bad in ([[0, 8]], [[-1, 0]]):
            with pytest.raises(ValueError, match="max_len"):
                lm(tokens, positions=torch.tensor(bad))
