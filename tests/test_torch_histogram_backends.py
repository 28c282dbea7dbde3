"""The rest of ``ops/histogram.py`` in the port: the one-hot matmul builds,
the float dispatcher, the backend choice and the growers' ``backend``.

Each scenario feeds the same seeded numpy inputs to the JAX package's
function and its port (``device="cpu"``):

- the quantized matmul build equals the JAX package's and the port's
  scatter build bit for bit, at 1, 8 and 64 nodes, with masked rows,
  ``max_rows``, ``lo_width`` 16 and 128 and both row layouts;
- the float matmul build (with and without residual channels) and
  ``build`` match the JAX package's within rtol 1e-5;
- ``resolve_quantized_backend`` gives the JAX package's answer under each
  environment setting, ``pallas`` read as ``cuda`` and a TPU as the card;
- both growers grow the ``cuda`` backend's tree, in every array, under
  ``matmul`` and ``scatter``; ``train()`` under ``MMLSPARK_TPU_HIST_QUANT=
  OFF`` runs the float path.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mmlspark_tpu.ops import histogram as JH
from mmlspark_tpu_torch.lightgbm import GBDTParams, train
from mmlspark_tpu_torch.lightgbm import core as port_core
from mmlspark_tpu_torch.ops import cuda_histogram
from mmlspark_tpu_torch.ops import histogram as TH

_ENV = ("MMLSPARK_TPU_HIST_BACKEND", "MMLSPARK_TPU_HIST_PALLAS",
        "MMLSPARK_TPU_HIST_LAYOUT", "MMLSPARK_TPU_HIST_QUANT",
        "MMLSPARK_TPU_HIST_BLOCK_ROWS", "MMLSPARK_TPU_HIST_LO",
        "MMLSPARK_TPU_HIST_RESID")


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for k in _ENV:
        monkeypatch.delenv(k, raising=False)


def _inputs(n=2_500, F=6, B=63, N=8, seed=0):
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, B, size=(n, F)).astype(np.uint8)
    qg = rng.integers(-8, 9, size=n).astype(np.int32)
    qh = rng.integers(0, 16, size=n).astype(np.int32)
    node = rng.integers(-1, N, size=n).astype(np.int32)   # -1: masked
    g = rng.normal(size=n).astype(np.float32)
    h = rng.uniform(0.05, 1.0, size=n).astype(np.float32)
    return bins, qg, qh, node, g, h


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


# ---------------------------------------------------------------------------
# quantized builds
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["sort", "cumsum"])
@pytest.mark.parametrize("lo_width", [16, 128])
@pytest.mark.parametrize("N", [1, 8, 64])
def test_matmul_quantized_equals_jax_and_scatter(monkeypatch, N, lo_width,
                                                layout):
    monkeypatch.setenv("MMLSPARK_TPU_HIST_LAYOUT", layout)
    bins, qg, qh, node, _, _ = _inputs(N=N, seed=N + lo_width)
    B = 63
    unmasked = int((node >= 0).sum())
    for max_rows in (None, unmasked):
        port = TH.build_histograms_matmul_quantized(
            *_t(bins, qg, qh, node), N, B, lo_width=lo_width,
            max_rows=max_rows)
        ref = JH.build_histograms_matmul_quantized(
            *_j(bins, qg, qh, node), N, B, lo_width=lo_width,
            max_rows=max_rows)
        scat = TH.build_histograms_quantized(*_t(bins, qg, qh, node), N, B)
        assert port.dtype == torch.int32 and port.shape == (N, 6, B, 3)
        np.testing.assert_array_equal(port.numpy(), np.asarray(ref))
        assert torch.equal(port, scat)


def test_matmul_quantized_small_blocks_and_guards():
    """Many small blocks (the per-block int32 hand-off, the cross-block
    adds) equal the scatter build; the block size that would break the
    float32 exactness of a block's sum is refused."""
    bins, qg, qh, node, _, _ = _inputs(n=3_000, N=4, seed=3)
    port = TH.build_histograms_matmul_quantized(*_t(bins, qg, qh, node), 4,
                                                63, block_rows=256)
    ref = JH.build_histograms_matmul_quantized(*_j(bins, qg, qh, node), 4,
                                               63, block_rows=256)
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))
    assert torch.equal(port, TH.build_histograms_quantized(
        *_t(bins, qg, qh, node), 4, 63))
    big = _inputs(n=140_000, N=4, seed=3)[:4]
    with pytest.raises(ValueError, match="2\\*\\*24"):
        TH.build_histograms_matmul_quantized(*_t(*big), 4, 63,
                                             block_rows=1 << 18)
    with pytest.raises(ValueError, match="128"):
        TH.build_histograms_matmul_quantized(*_t(bins, qg, qh, node), 4, 63,
                                             quant_bins=256)
    with pytest.raises(ValueError, match="lo_width"):
        TH.build_histograms_matmul_quantized(*_t(bins, qg, qh, node), 4, 63,
                                             lo_width=8)


@pytest.mark.parametrize("backend", ["auto", "cuda", "pallas", "matmul",
                                     "scatter"])
def test_build_quantized_backends_agree(backend):
    bins, qg, qh, node, _, _ = _inputs(N=8, seed=11)
    got = TH.build_quantized(*_t(bins, qg, qh, node), 8, 63, 16,
                             backend=backend)
    ref = JH.build_quantized(*_j(bins, qg, qh, node), 8, 63, 16,
                             backend="scatter")
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_histogram_subtraction():
    bins, qg, qh, node, _, _ = _inputs(N=2, seed=5)
    parent = TH.build_histograms_quantized(
        *_t(bins, qg, qh, np.where(node >= 0, 0, -1).astype(np.int32)), 1, 63)
    small = TH.build_histograms_quantized(
        *_t(bins, qg, qh, np.where(node == 0, 0, -1).astype(np.int32)), 1, 63)
    sib = TH.build_histograms_quantized(
        *_t(bins, qg, qh, np.where(node == 1, 0, -1).astype(np.int32)), 1, 63)
    assert torch.equal(TH.histogram_subtraction(parent, small), sib)
    np.testing.assert_array_equal(
        np.asarray(JH.histogram_subtraction(jnp.asarray(parent.numpy()),
                                            jnp.asarray(small.numpy()))),
        sib.numpy())


# ---------------------------------------------------------------------------
# float builds
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("residuals", [True, False])
def test_matmul_float_matches_jax(residuals, weighted):
    bins, _, _, node, g, h = _inputs(N=8, seed=21)
    sw = np.random.default_rng(2).uniform(0.5, 2.0, len(g)) \
        .astype(np.float32) if weighted else None
    port = TH.build_histograms_matmul(
        *_t(bins, g, h, node), 8, 63,
        None if sw is None else torch.from_numpy(sw), residuals=residuals)
    ref = JH.build_histograms_matmul(
        *_j(bins, g, h, node), 8, 63,
        None if sw is None else jnp.asarray(sw), residuals=residuals)
    assert port.dtype == torch.float32 and port.shape == (8, 6, 63, 3)
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("backend", ["auto", "pallas", "matmul", "scatter"])
def test_build_matches_jax(backend):
    bins, _, _, node, g, h = _inputs(N=4, seed=31)
    # the JAX package on the CPU: auto and pallas take its scatter build
    port = TH.build(*_t(bins, g, h, node), 4, 63, backend=backend)
    ref = JH.build(*_j(bins, g, h, node), 4, 63, backend=backend)
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


def test_build_env_override_applies_to_auto_only(monkeypatch):
    bins, _, _, node, g, h = _inputs(N=4, seed=32)
    monkeypatch.setenv("MMLSPARK_TPU_HIST_BACKEND", "matmul")
    monkeypatch.setenv("MMLSPARK_TPU_HIST_RESID", "0")
    auto = TH.build(*_t(bins, g, h, node), 4, 63)
    plain = TH.build(*_t(bins, g, h, node), 4, 63, backend="scatter")
    ref = JH.build(*_j(bins, g, h, node), 4, 63)
    np.testing.assert_allclose(auto.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)
    # the residual-free matmul rounds grads to bfloat16: not the scatter
    assert not torch.equal(auto, plain)
    np.testing.assert_allclose(plain.numpy(), np.asarray(JH.build(
        *_j(bins, g, h, node), 4, 63, backend="scatter")), rtol=1e-5,
        atol=1e-6)


# ---------------------------------------------------------------------------
# backend choice
# ---------------------------------------------------------------------------

_SETTINGS = [
    {},
    {"MMLSPARK_TPU_HIST_BACKEND": "matmul"},
    {"MMLSPARK_TPU_HIST_BACKEND": "scatter"},
    {"MMLSPARK_TPU_HIST_BACKEND": "pallas"},
    {"MMLSPARK_TPU_HIST_PALLAS": "1"},
    {"MMLSPARK_TPU_HIST_PALLAS": "off"},
    {"MMLSPARK_TPU_HIST_PALLAS": "0",
     "MMLSPARK_TPU_HIST_BACKEND": "pallas"},
    {"MMLSPARK_TPU_HIST_PALLAS": "1",
     "MMLSPARK_TPU_HIST_BACKEND": "scatter"},
]


@pytest.mark.parametrize("platform", ["cpu", "tpu"])
@pytest.mark.parametrize("env", _SETTINGS,
                         ids=lambda e: ",".join(f"{k[18:]}={v}"
                                                for k, v in e.items())
                         or "unset")
def test_resolve_quantized_backend_is_the_references(monkeypatch, env,
                                                     platform):
    """The port's answer is the JAX package's, with ``pallas`` read as
    ``cuda`` and the JAX package's TPU as the card."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(JH.jax, "default_backend", lambda: platform)
    device = "cpu" if platform == "cpu" else "cuda"
    for requested in ("auto", "matmul", "scatter", "pallas"):
        ref = JH.resolve_quantized_backend(requested)
        got = TH.resolve_quantized_backend(requested, device)
        assert got == {"pallas": "cuda"}.get(ref, ref), (requested, env)
    with pytest.raises(ValueError, match="unknown histogram backend"):
        TH.resolve_quantized_backend("xla", device)


# ---------------------------------------------------------------------------
# the growers' backend
# ---------------------------------------------------------------------------

def _grower_inputs(n=2_000, F=6, max_bin=63, seed=0):
    from mmlspark_tpu_torch.lightgbm.binning import BinMapper
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, F)).astype(np.float32)
    y = (X[:, 0] * 2 - X[:, 1] + 0.5 * X[:, 2] * X[:, 3]
         + rng.normal(scale=0.5, size=n) > 0).astype(np.float32)
    mapper = BinMapper(max_bin).fit(X)
    binned = torch.from_numpy(mapper.transform(X))
    p = 1 / (1 + np.exp(-rng.normal(scale=0.5, size=n)))
    g = torch.from_numpy((p - y).astype(np.float32))
    h = torch.from_numpy(np.maximum(p * (1 - p), 1e-16).astype(np.float32))
    mask = torch.from_numpy(rng.random(n) > 0.1)
    fmask = torch.ones(F, dtype=torch.bool)
    noise = torch.from_numpy(rng.random((2, n)).astype(np.float32))
    return (binned, g, h, mask, fmask, torch.from_numpy(mapper.edges)), \
        noise, mapper.num_bins


def _tree_arrays(tree):
    return {k: v for k, v in tree._asdict().items() if v is not None}


@pytest.mark.parametrize("backend", ["matmul", "scatter"])
@pytest.mark.parametrize("growth", ["level", "leaf"])
def test_growers_grow_the_cuda_backends_trees(monkeypatch, growth, backend):
    """The ``cuda`` backend (its plain versions on the CPU) and the
    ``matmul`` / ``scatter`` builds with the kernel-order gain scan grow
    the same tree in every array; level-wise with ``FUSED_MAX_NODES``
    lowered so the deeper levels take the torch scan on both sides."""
    args, noise, B = _grower_inputs(seed=3 if growth == "leaf" else 4)
    F = args[0].shape[1]
    p = GBDTParams(objective="binary", use_quantized_grad=True,
                   lambda_l2=0.5, min_data_in_leaf=10,
                   **({"num_leaves": 15} if growth == "leaf"
                      else {"max_depth": 5})).resolve()
    if growth == "level":
        monkeypatch.setattr(cuda_histogram, "FUSED_MAX_NODES", 4)

    def grow(bk):
        g = port_core._make_grower(p, F, B, backend=bk)
        return _tree_arrays(g(*args, noise=noise))

    spy = []
    real = cuda_histogram.frontier_finish
    monkeypatch.setattr(cuda_histogram, "frontier_finish",
                        lambda *a, **k: spy.append(1) or real(*a, **k))
    ref = grow("cuda")
    n_fused = len(spy)
    # leaf-wise: one fused step per leaf; level-wise: levels 0-3 fused,
    # level 4's smaller children built on the kernels with gains off
    assert n_fused == (15 if growth == "leaf" else 5)
    got = grow(backend)
    assert len(spy) == n_fused          # no finish call under this backend
    assert set(got) == set(ref)
    for k in ref:
        assert torch.equal(got[k], ref[k]), k
    assert (ref["split_feature"] >= 0).sum() > 5


def _fit_data(n=1_500, F=6, seed=7):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, F)).astype(np.float32)
    y = (X[:, 0] - X[:, 1] + rng.normal(scale=0.3, size=n) > 0) \
        .astype(np.float32)
    return X, y


def _booster_arrays(r):
    return {k: np.asarray(v) for k, v in r.booster.__dict__.items()
            if isinstance(v, np.ndarray)}


@pytest.mark.parametrize("growth", ["level", "leaf"])
def test_train_backends_grow_the_same_booster(monkeypatch, growth):
    X, y = _fit_data()
    shape = {"num_leaves": 15} if growth == "leaf" else {"max_depth": 4}
    params = GBDTParams(num_iterations=3, objective="binary",
                        use_quantized_grad=True, **shape)
    out = {}
    for env in ("pallas", "matmul", "scatter", None):
        if env is None:
            monkeypatch.delenv("MMLSPARK_TPU_HIST_BACKEND", raising=False)
        else:
            monkeypatch.setenv("MMLSPARK_TPU_HIST_BACKEND", env)
        out[env] = _booster_arrays(train(X, y, params, device="cpu"))
    assert out["pallas"]
    for env in ("matmul", "scatter", None):
        assert out[env].keys() == out["pallas"].keys()
        for k in out["pallas"]:
            np.testing.assert_array_equal(out[env][k], out["pallas"][k],
                                          err_msg=f"{env}: {k}")


@pytest.mark.parametrize("value", ["OFF", "0", "false", "No"])
def test_train_quant_off_runs_the_float_path(monkeypatch, value):
    """``MMLSPARK_TPU_HIST_QUANT`` off (any case) overrides
    ``use_quantized_grad=True``: no quantizer call, the float booster."""
    X, y = _fit_data(n=800)
    params = GBDTParams(num_iterations=2, max_depth=3, objective="binary",
                        use_quantized_grad=True)
    calls = []
    real = port_core.hist_ops.quantize_gradients
    monkeypatch.setattr(port_core.hist_ops, "quantize_gradients",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    monkeypatch.setenv("MMLSPARK_TPU_HIST_QUANT", value)
    off = _booster_arrays(train(X, y, params, device="cpu"))
    assert calls == []
    monkeypatch.delenv("MMLSPARK_TPU_HIST_QUANT")
    flt = _booster_arrays(train(X, y, GBDTParams(
        num_iterations=2, max_depth=3, objective="binary",
        use_quantized_grad=False), device="cpu"))
    for k in flt:
        np.testing.assert_array_equal(off[k], flt[k], err_msg=k)
    # any other value turns quantization on, as in the JAX package
    monkeypatch.setenv("MMLSPARK_TPU_HIST_QUANT", "yes")
    train(X, y, GBDTParams(num_iterations=1, max_depth=3,
                           objective="binary"), device="cpu")
    assert calls
