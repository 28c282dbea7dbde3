"""Port parity for the fit's data plane: ``BinMapper`` edges and host bins
on both of the JAX package's routes (its threaded C++ plane, which the port
runs from its own copy ``csrc/binning.cpp``, and numpy), the ``bin_matrix``
twin, and the train route's bins applied on a device, all against the JAX
package on the same seeded inputs.  Every comparison is bit for bit (edges
with NaN equal to NaN).

The route is the reference's own predicate (``n * F >= 65536`` cells and at
least 4 cores): each test picks it through ``multiprocessing.cpu_count``,
which both packages read.  The inputs hold NaN, ``±inf``, few-distinct and
constant columns, and the column whose first fitted edge is ``-inf``
(integer codes with ``-inf`` in every 7th row), on which the reference's two
host routes disagree.
"""
import multiprocessing

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mmlspark_tpu.lightgbm.binning import BinMapper as JaxBinMapper
from mmlspark_tpu.ops.histogram import bin_matrix as jax_bin_matrix
from mmlspark_tpu.utils import native_loader as jax_native
from mmlspark_tpu_torch.kernels import _build
from mmlspark_tpu_torch.lightgbm import GBDTParams, train
from mmlspark_tpu_torch.lightgbm import binning as port_binning
from mmlspark_tpu_torch.lightgbm.binning import BinMapper, host_route
from mmlspark_tpu_torch.lightgbm.core import _bin
from mmlspark_tpu_torch.ops.histogram import bin_matrix


def _X(n, seed):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 5, n).astype(np.float32)
    codes[::7] = -np.inf                          # first edge -inf
    heavy = rng.normal(size=n)
    heavy[::17] = -np.inf                         # quantile path with -inf
    expo = rng.exponential(size=n)
    expo[::13] = np.inf
    X = np.stack([
        rng.normal(size=n),
        codes,
        np.where(rng.random(n) < 0.2, np.nan, rng.normal(size=n)),
        expo,
        heavy,
        np.where(rng.random(n) < 0.5, -np.inf, np.inf),   # ±inf only
        np.full(n, 3.0),
        np.full(n, np.nan),
        rng.integers(0, 300, n) * 0.5,
    ], axis=1).astype(np.float32)
    return X


ROUTES = {"cxx": (12_000, 8), "numpy": (3_000, 1)}    # rows, cores


@pytest.fixture(params=["cxx", "numpy"])
def route(request, monkeypatch):
    monkeypatch.setattr(multiprocessing, "cpu_count",
                        lambda: ROUTES[request.param][1])
    return request.param


def _fitted(route, max_bin=255, seed=0, **kw):
    n = ROUTES[route][0]
    X = _X(n, seed)
    assert host_route(X.size) == route
    return X, JaxBinMapper(max_bin, **kw).fit(X), BinMapper(max_bin,
                                                            **kw).fit(X)


@pytest.mark.parametrize("max_bin", [255, 63])
def test_edges_and_host_bins_equal_the_reference(route, max_bin):
    X, jm, tm = _fitted(route, max_bin)
    np.testing.assert_array_equal(tm.edges, jm.edges)
    assert jm.edges[1, 0] == -np.inf               # the leading -inf edge
    for A in (X, _X(len(X), seed=1)):              # unseen rows too
        got = tm.transform(A)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, jm.transform(A))


def test_the_reference_routes_disagree_on_a_leading_inf_edge(monkeypatch):
    """A fact about the reference that the port keeps: its C++ plane counts
    only the leading finite edges, so the -inf column bins to 0 there, and
    its numpy route and ``bin_matrix`` each bin it differently."""
    X = _X(70_000, seed=2)[:, :4]
    monkeypatch.setattr(multiprocessing, "cpu_count", lambda: 8)
    jm = JaxBinMapper(255).fit(X)
    cxx = jm.transform(X)
    assert int(cxx[:, 1].max()) == 0
    finite = jm.edges[1][np.isfinite(jm.edges[1])]
    numpy_bins = np.searchsorted(finite, np.nan_to_num(X[:, 1], nan=-np.inf))
    device = jm.transform(X, device=True)
    # 70,000 rows, 10,000 of them -inf: bin_matrix shifts every other row
    # up by one, numpy moves the rows of codes 1-4 off bin 0
    assert (device[:, 1] != cxx[:, 1]).sum() == 60_000
    assert (numpy_bins != cxx[:, 1]).sum() == (X[:, 1] >= 1).sum()
    assert (device[:, 1] != numpy_bins).sum() == 60_000


def test_bin_matrix_equals_the_jax_bin_matrix(route):
    X, jm, tm = _fitted(route)
    want = np.asarray(jax_bin_matrix(jnp.asarray(X), jnp.asarray(jm.edges),
                                     255))
    got = bin_matrix(torch.from_numpy(X), torch.from_numpy(tm.edges), 255)
    assert got.dtype == torch.uint8 and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tm.transform(X, device="cpu"),
                                  jm.transform(X, device=True))


@pytest.mark.parametrize("cats", [None, (1, 6)])
def test_train_route_bins_equal_the_reference_transform(route, cats):
    """``bin_on_device`` (run here on CPU tensors) and the trainer's
    ``_bin`` give the bins the reference's ``train()`` uses: its
    ``transform`` on the same X, categorical codes included."""
    X, jm, tm = _fitted(route, categorical_features=cats)
    if cats:
        X[:, 1] = np.where(np.isfinite(X[:, 1]), X[:, 1], np.nan)
        X[::5, 6] = 300.0                          # clipped to max_bin-1
        X[::3, 6] = 2.5                            # round half to even
    want = jm.transform(X)
    got = tm.bin_on_device(X, "cpu")
    assert got.shape == (X.shape[1], X.shape[0]) and got.is_contiguous()
    np.testing.assert_array_equal(got.t().numpy(), want)
    np.testing.assert_array_equal(
        _bin(tm, X, torch.device("cpu")).numpy(), want)


def test_a_non_ascending_edge_row_bins_on_the_host(monkeypatch):
    """The C++ fit interpolates quantiles between ``-inf`` neighbours into
    NaN and sorts them with ``std::sort``, which leaves the finite edges of
    such a column out of order.  The numpy route (a small X, here a valid
    set) searches them as they are, which no ascending table reproduces:
    that feature is binned on the host instead, so the bins are still the
    reference's."""
    monkeypatch.setattr(multiprocessing, "cpu_count", lambda: 8)
    rng = np.random.default_rng(0)
    col = rng.normal(size=424).astype(np.float32)
    col[rng.choice(424, 86, replace=False)] = -np.inf
    col[rng.choice(np.nonzero(np.isfinite(col))[0], 48,
                   replace=False)] = np.inf
    X = np.column_stack([col, rng.normal(size=(424, 159))]) \
        .astype(np.float32)
    assert host_route(X.size) == "cxx"
    jm, tm = JaxBinMapper(63).fit(X), BinMapper(63).fit(X)
    np.testing.assert_array_equal(tm.edges, jm.edges)
    Xv = X[:100]
    assert host_route(Xv.size) == "numpy"
    _, ascending = tm.route_table("numpy")
    assert not ascending[0] and ascending[1:].all()
    np.testing.assert_array_equal(tm.bin_on_device(Xv, "cpu").t().numpy(),
                                  jm.transform(Xv))
    # the C++ route, by hand-set edges: only the leading finite edges count
    tm.edges[1, :5] = [0.5, -0.5, 1.0, 0.0, 2.0]
    assert not tm.route_table("cxx")[1][1]
    np.testing.assert_array_equal(
        tm.bin_on_device(X, "cpu").t().numpy(),
        jax_native.bin_apply_native(X, tm.edges, 63))


@pytest.mark.parametrize("where", ["host", "device"])
def test_negative_category_codes_raise(route, where):
    X, _, tm = _fitted(route, categorical_features=(0,))
    msg = "categorical feature 0 holds negative codes"
    with pytest.raises(ValueError, match=msg):
        JaxBinMapper(255, categorical_features=(0,)).fit(X).transform(X)
    with pytest.raises(ValueError, match=msg):
        if where == "host":
            tm.transform(X)
        else:
            tm.bin_on_device(X, "cpu")


def test_train_reports_the_binning_phases():
    X = _X(3_000, seed=4)
    y = (np.nan_to_num(X[:, 0]) > 0).astype(np.float32)
    r = train(X, y, GBDTParams(num_iterations=2, max_depth=3), device="cpu")
    ex = r.extras
    assert ex["binning_s"] == ex["edges_s"] + ex["bin_apply_s"]
    np.testing.assert_array_equal(
        r.bin_mapper.edges, JaxBinMapper(255).fit(X).edges)


def test_a_failed_host_build_raises_and_never_falls_back(monkeypatch,
                                                         tmp_path):
    monkeypatch.setattr(multiprocessing, "cpu_count", lambda: 8)
    monkeypatch.setattr(_build, "BUILD_ROOT", str(tmp_path))
    monkeypatch.setattr(_build, "_host_lib", None)
    X = _X(12_000, seed=5)
    monkeypatch.setenv("CXX", "false")             # a compiler that fails
    with pytest.raises(RuntimeError, match="false failed"):
        BinMapper(255).fit(X)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        BinMapper(255).fit(X)
    assert host_route(X.size) == "cxx"
    assert port_binning.NATIVE_MIN_CELLS == 1 << 16


def test_the_bindings_check_shapes_before_passing_pointers():
    from mmlspark_tpu_torch.utils import native_loader
    X = _X(100, seed=6)
    with pytest.raises(ValueError, match="edges must be"):
        native_loader.bin_apply_native(X, np.zeros((9, 10), np.float32), 255)
    with pytest.raises(ValueError, match="max_bin"):
        native_loader.bin_edges_native(X, 300)
