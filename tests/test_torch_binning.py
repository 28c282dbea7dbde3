"""Port parity: ``mmlspark_tpu_torch.lightgbm.BinMapper`` against the JAX
package's on its numpy path (``n * F < 65536``): identical edges and bins,
NaN columns and few-distinct columns included."""
import numpy as np
import pytest

from mmlspark_tpu.lightgbm.binning import BinMapper as JaxBinMapper
from mmlspark_tpu_torch.convert import bin_mapper_from_edges
from mmlspark_tpu_torch.lightgbm.binning import BinMapper


def _data(n, seed):
    rng = np.random.default_rng(seed)
    X = np.stack([
        rng.normal(size=n),                       # many distinct values
        rng.integers(0, 5, n),                    # few distinct values
        np.where(rng.random(n) < 0.2, np.nan, rng.exponential(size=n)),
        np.full(n, 3.0),                          # constant
        np.full(n, np.nan),                       # all missing
        rng.integers(0, 300, n) * 0.5,            # ~300 distinct values
    ], axis=1).astype(np.float32)
    return X


@pytest.mark.parametrize("max_bin,n", [(255, 4000), (63, 1500), (16, 777)])
def test_edges_and_bins_identical(max_bin, n):
    X = _data(n, seed=max_bin)
    assert X.size < 1 << 16   # the JAX package's numpy path
    jm = JaxBinMapper(max_bin).fit(X)
    tm = BinMapper(max_bin).fit(X)
    np.testing.assert_array_equal(tm.edges, jm.edges)
    Xt = _data(n // 2, seed=max_bin + 1)     # transform unseen rows too
    for A in (X, Xt):
        got = tm.transform(A)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, jm.transform(A))
    assert int(tm.transform(X)[:, 4].max()) == 0   # NaN -> bin 0


def test_row_sample_above_sample_cnt_identical():
    X = _data(3000, seed=9)
    jm = JaxBinMapper(255).fit(X, sample_cnt=1000, seed=4)
    tm = BinMapper(255).fit(X, sample_cnt=1000, seed=4)
    np.testing.assert_array_equal(tm.edges, jm.edges)


def test_bin_mapper_from_edges_transforms_identically():
    X = _data(2000, seed=1)
    jm = JaxBinMapper(127).fit(X)
    tm = bin_mapper_from_edges(jm.edges, 127)
    np.testing.assert_array_equal(tm.transform(X), jm.transform(X))
    with pytest.raises(ValueError, match="edges must be"):
        bin_mapper_from_edges(jm.edges, 255)
    with pytest.raises(ValueError, match="max_bin"):
        BinMapper(300)
