"""Port parity for out-of-core training: the port's ``io/chunked.py``,
streaming sketch, row-keyed quantizer noise and ``train_streamed`` against
the JAX package's on the same seeded inputs, on the CPU.

Tolerances:

- geometry, padding, sketch samples, edges and bins: identical;
- per-tile int32 partials: their sum equals the monolithic
  ``build_quantized`` bit for bit (port and JAX alike);
- ``train_streamed``, unquantized on both sides (the JAX package's CPU
  default): every tree of both growers equal in every integer array, leaf
  values within atol 1e-5 and split gains within rtol 1e-4 plus 1e-6 of
  the tree's largest gain (a gain is a difference of leaf scores, each
  rounded at f32; float histograms are summed in different orders, and
  the port rounds float64 gradients where JAX computes in float32); the
  fit's accuracy within 0.005 of JAX's (classifier), MSE within 2%
  (regressor);
- the port quantized against JAX unquantized: the reference's own
  quick-parity precisions (``tests/test_out_of_core.py``): accuracy at
  least JAX's minus 0.02, MSE at most 1.35 x JAX's + 0.05.  The two
  packages draw different rounding noise, and the port scans integer
  prefix sums before dequantizing where JAX scans dequantized f32 sums.
"""
import multiprocessing
import time
import warnings

import numpy as np
import pytest
import torch

from mmlspark_tpu.io import chunked as jax_chunked
from mmlspark_tpu.observability.metrics import \
    MetricsRegistry as JaxRegistry
from mmlspark_tpu.utils import resilience as jax_resilience
from mmlspark_tpu.lightgbm import GBDTParams as JaxParams
from mmlspark_tpu.lightgbm import core as jax_core
from mmlspark_tpu.lightgbm.binning import BinMapper as JaxBinMapper
from mmlspark_tpu.lightgbm.binning import \
    StreamingQuantileSketch as JaxSketch
from mmlspark_tpu_torch.io import chunked
from mmlspark_tpu_torch.lightgbm import GBDTParams, train_streamed
from mmlspark_tpu_torch.lightgbm import core as port_core
from mmlspark_tpu_torch.lightgbm.binning import (BinMapper,
                                                 StreamingQuantileSketch)
from mmlspark_tpu_torch.observability.metrics import MetricsRegistry
from mmlspark_tpu_torch.ops import histogram as hist_ops
from mmlspark_tpu_torch.utils import resilience
from mmlspark_tpu_torch.utils.resilience import FakeClock


# --------------------------------------------------------------- geometry

@pytest.mark.parametrize("case", [
    dict(n=10_000, bpr=100, memory_budget_bytes=2 * 100 * 700),
    dict(n=500, bpr=100, tile_rows=2000),
    dict(n=500, bpr=100),
    dict(n=10_000, bpr=100, tile_rows=50, memory_budget_bytes=1),
    dict(n=10_000, bpr=100, memory_budget_bytes=2 * 100 * 10),
    dict(n=10_000, bpr=100, tile_rows=300, env="123"),
], ids=["budget", "tile_rows_clipped", "whole", "tile_rows_wins",
        "budget_floor", "env"])
def test_resolve_tile_rows_equals_the_reference(case, monkeypatch):
    case = dict(case)
    env = case.pop("env", None)
    if env:
        monkeypatch.setenv(chunked.TILE_ROWS_ENV, env)
    else:
        monkeypatch.delenv(chunked.TILE_ROWS_ENV, raising=False)
    n, bpr = case.pop("n"), case.pop("bpr")
    with warnings.catch_warnings(record=True) as wp:
        warnings.simplefilter("always")
        port = chunked.resolve_tile_rows(n, bpr, **case)
    with warnings.catch_warnings(record=True) as wj:
        warnings.simplefilter("always")
        ref = jax_chunked.resolve_tile_rows(n, bpr, **case)
    assert port == ref
    assert [str(w.message) for w in wp] == [str(w.message) for w in wj]
    assert chunked.MIN_TILE_ROWS == jax_chunked.MIN_TILE_ROWS
    assert chunked.TILE_ROWS_ENV == jax_chunked.TILE_ROWS_ENV


def test_pad_tile_and_chunked_dataset_equal_the_reference():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(25, 3)).astype(np.float32)
    y = rng.integers(0, 2, 25).astype(np.float32)
    w = rng.random(25).astype(np.float32)
    cp = chunked.ChunkedDataset(X, y=y, sample_weight=w, tile_rows=10)
    cj = jax_chunked.ChunkedDataset(X, y=y, sample_weight=w, tile_rows=10)
    assert (cp.n_rows, cp.num_features, cp.tile_rows, cp.num_tiles,
            cp.bytes_per_row) == (cj.n_rows, cj.num_features, cj.tile_rows,
                                  cj.num_tiles, cj.bytes_per_row) \
        == (25, 3, 10, 3, 28)
    for i in range(cp.num_tiles):
        assert cp.tile_slice(i) == cj.tile_slice(i)
        assert cp.tile_valid_rows(i) == cj.tile_valid_rows(i)
        tp = cp.tile(i, ("X", "y", "w"), fill={"y": -1})
        tj = cj.tile(i, ("X", "y", "w"), fill={"y": -1})
        for k in tp:
            np.testing.assert_array_equal(tp[k], tj[k])
    assert cp.tile(0, ("X",))["X"].base is not None       # full tile: a view
    for fill in (0, -1, 2.5):
        np.testing.assert_array_equal(chunked.pad_tile(X, 20, 25, 10, fill),
                                      jax_chunked.pad_tile(X, 20, 25, 10,
                                                           fill))
    with pytest.raises(IndexError):
        cp.tile_slice(3)
    with pytest.raises(ValueError, match="rows"):
        cp.add_column("bad", np.zeros(7))


# ------------------------------------------------------------------ sketch

@pytest.mark.parametrize("n,cap", [(1_000, 200_000), (3_000, 700)],
                         ids=["below_cap", "above_cap"])
def test_fit_streaming_equals_the_reference(n, cap):
    """Below the cap the reservoir holds every row; above it the port's
    sketch keeps the very rows the JAX package's keeps (same rng draws)."""
    rng = np.random.default_rng(11)
    X = rng.normal(size=(n, 6)).astype(np.float32)
    X[rng.random(n) < 0.05, 2] = np.nan
    X[:, 4] = rng.integers(0, 5, n)                 # few distinct values
    chunks = [X[lo:lo + 256] for lo in range(0, n, 256)]
    sp, sj = StreamingQuantileSketch(6, cap, 3), JaxSketch(6, cap, 3)
    for c in chunks:
        sp.add(c)
        sj.add(c)
    np.testing.assert_array_equal(sp.sample(), sj.sample())
    mp = BinMapper(63).fit_streaming(iter(chunks), sample_cnt=cap)
    mj = JaxBinMapper(63).fit_streaming(iter(chunks), sample_cnt=cap)
    np.testing.assert_array_equal(mp.edges, mj.edges)
    if n <= cap:       # the whole stream: the in-memory fit's edges
        np.testing.assert_array_equal(mp.edges, BinMapper(63).fit(X).edges)
    with pytest.raises(ValueError, match="empty"):
        BinMapper(63).fit_streaming(iter([]))


# -------------------------------------------------------------- prefetcher

def _fake_prefetcher(n_tiles, load_fn, clock):
    return chunked.TilePrefetcher(range(n_tiles), load_fn, clock=clock,
                                  registry=MetricsRegistry(), site="test")


def test_prefetcher_books_no_wait_when_the_transfer_hides():
    clock = FakeClock()

    def load(i):
        clock.advance(0.2)
        return i

    pf = _fake_prefetcher(3, load, clock)
    it = iter(pf)
    got = []
    for _ in range(3):
        deadline = time.time() + 10
        while pf._q.empty():                 # the tile visibly resident
            assert time.time() < deadline, "prefetch worker stalled"
            time.sleep(0.001)
        got.append(next(it))
        clock.advance(1.0)                   # compute outlasts transfer
    with pytest.raises(StopIteration):
        next(it)
    assert got == [0, 1, 2]
    assert pf.wait_s == 0.0
    assert pf.overlap_stats()["overlap_pct"] == 100.0
    assert pf.snapshot()["tiles_served"] == 3


def test_prefetcher_books_the_consumers_compute_per_tile():
    """Compute is the consumer's time between a take and the next ask,
    the last tile's included (booked when the stream ends)."""
    clock = FakeClock()
    reg = MetricsRegistry()
    pf = chunked.TilePrefetcher(range(3), lambda i: i, clock=clock,
                                registry=reg, site="compute")
    for _ in pf:
        clock.advance(0.3)
    assert pf.compute_s == pytest.approx(0.9)
    assert pf.overlap_stats()["compute_s"] == pytest.approx(0.9)
    fam = reg.family("mmlspark_tile_compute_seconds")
    assert fam.labels(site="compute").count == 3


def test_prefetcher_books_wait_when_compute_outruns_the_transfer():
    clock = FakeClock()
    holder = []

    def load(i):
        while not holder:
            time.sleep(0.001)
        assert holder[0].waiting.wait(10), "consumer never blocked"
        clock.advance(0.7)
        return i

    pf = _fake_prefetcher(3, load, clock)
    holder.append(pf)
    for _ in pf:
        clock.advance(0.1)
    assert pf.wait_s == pytest.approx(3 * 0.7)
    stats = pf.overlap_stats()
    assert stats["overlap_pct"] < 15.0 and stats["tiles"] == 3.0


_PACKAGES = {"port": (chunked, MetricsRegistry, resilience),
             "jax": (jax_chunked, JaxRegistry, jax_resilience)}


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_prefetcher_retries_back_off_and_fatal_skips_retry(pkg):
    """Transient load failures retry with exponential backoff on the
    injected sleep; exhausted retries and fatal errors propagate, a fatal
    one without burning a retry — the same in both packages."""
    mod, registry, res = _PACKAGES[pkg]
    clk, sleeps, attempts = res.FakeClock(), [], [0]

    def sleep(s):
        sleeps.append(s)
        clk.sleep(s)

    def load(i):
        attempts[0] += 1
        if attempts[0] <= 3:
            raise ConnectionError("flaky")
        return i

    pf = mod.TilePrefetcher([1], load, site="s", clock=clk,
                            registry=registry(), retries=3,
                            retry_backoff_s=0.1, retry_backoff_mult=2.0,
                            sleep=sleep)
    assert list(pf) == [1]
    assert sleeps == pytest.approx([0.1, 0.2, 0.4])
    pf2 = mod.TilePrefetcher([1], (lambda i: (_ for _ in ()).throw(
        ConnectionError("always"))), site="s", clock=clk,
        registry=registry(), retries=2, retry_backoff_s=0.1,
        sleep=clk.sleep)
    with pytest.raises(ConnectionError):
        list(pf2)
    assert pf2.retries_total == 2
    pf3 = mod.TilePrefetcher([1], (lambda i: (_ for _ in ()).throw(
        FileNotFoundError("gone"))), site="s", clock=clk,
        registry=registry(), sleep=clk.sleep)
    with pytest.raises(FileNotFoundError):
        list(pf3)
    assert pf3.retries_total == 0
    assert not res.is_transient_io(FileNotFoundError())
    assert res.is_transient_io(ConnectionError())


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_prefetcher_retry_clips_to_the_ambient_deadline(pkg):
    """The worker captures the consumer's ``deadline_scope``: a backoff
    never sleeps past its remaining budget, and an expired deadline makes
    the next transient failure terminal."""
    mod, registry, res = _PACKAGES[pkg]
    clk, sleeps, attempts = res.FakeClock(), [], [0]

    def sleep(s):
        sleeps.append(s)
        clk.sleep(s)

    def load(i):
        attempts[0] += 1
        if attempts[0] <= 2:
            raise ConnectionError("flaky")
        return i

    with res.deadline_scope(res.Deadline(clk() + 0.15, clock=clk)):
        assert res.current_deadline().remaining() == pytest.approx(0.15)
        pf = mod.TilePrefetcher([1], load, site="s", clock=clk,
                                registry=registry(), retries=5,
                                retry_backoff_s=0.1, retry_backoff_mult=2.0,
                                sleep=sleep)
        assert list(pf) == [1]
    assert res.current_deadline() is None
    assert sleeps == pytest.approx([0.1, 0.05])
    with res.deadline_scope(res.Deadline(clk() - 1.0, clock=clk)):
        pf2 = mod.TilePrefetcher([1], (lambda i: (_ for _ in ()).throw(
            ConnectionError("x"))), site="s", clock=clk,
            registry=registry(), sleep=clk.sleep)
        with pytest.raises(ConnectionError):
            list(pf2)
        assert pf2.retries_total == 0


def test_prefetcher_keeps_two_tiles_live_and_retires_its_worker():
    """The token semaphore: the worker loads tile k+1 only once tile k was
    taken, so at most two tiles exist; an early exit retires the worker."""
    loaded, taken = [], []

    def load(i):
        loaded.append(i)
        return i

    pf = _fake_prefetcher(6, load, FakeClock())
    for i in pf:
        time.sleep(0.02)
        assert len(loaded) - len(taken) <= 2
        taken.append(i)
        if i == 3:
            break
    pf._thread.join(5)
    assert not pf._thread.is_alive()
    with pytest.raises(RuntimeError, match="single-pass"):
        list(pf)


@pytest.mark.parametrize("growth", ["level", "leaf"])
def test_streamed_loops_hold_at_most_two_tiles(growth, monkeypatch):
    """Taking tile k + 1 lets the prefetch worker stage k + 2 at once, so
    the streamed loops must hold nothing of tile k by then.  With the
    consumer slowed between taking a tile and using it (the worker stages
    the next meanwhile), no tile is staged while two others are alive."""
    import weakref
    alive, most = [], [0]
    load, ready = port_core._TileStager.load, port_core._TileStager.ready

    def counted_load(self, parts):
        most[0] = max(most[0], 1 + sum(r() is not None for r in alive))
        out = load(self, parts)
        alive.append(weakref.ref(out[0][0]))
        return out

    def slow_ready(self, tile):
        time.sleep(0.005)
        return ready(self, tile)

    monkeypatch.setattr(port_core._TileStager, "load", counted_load)
    monkeypatch.setattr(port_core._TileStager, "ready", slow_ready)
    X, y = _parity_data(n=1000)
    shape = {"max_depth": 3} if growth == "level" else {"num_leaves": 6}
    res = train_streamed(X, y, GBDTParams(num_iterations=2, **shape),
                         tile_rows=200, device="cpu")
    assert res.extras["num_tiles"] == 5 and len(alive) > 20
    assert most[0] == 2


# ------------------------------------------------ tiles and the quantizer

def _tile_inputs(n=1_000, F=5, B=31, seed=4):
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, B, size=(n, F)).astype(np.uint8)
    g = rng.normal(size=n).astype(np.float32)
    h = rng.uniform(0.1, 1.0, size=n).astype(np.float32)
    node = rng.integers(-1, 4, size=n).astype(np.int32)
    return bins, g, h, node


def test_tile_partials_sum_to_the_monolithic_build():
    """Each padded tile (``node = -1`` past its rows, lanes planned from
    the tile's row bound) builds an int32 partial; their sum is the
    monolithic build, bit for bit, and that build is the JAX package's."""
    import jax.numpy as jnp
    from mmlspark_tpu.ops import histogram as jax_hist
    bins, g, h, node = _tile_inputs()
    n, T, N, B, qb = len(g), 300, 4, 31, 16
    rows = torch.arange(n)
    qg, qh, gs, hs = hist_ops.quantize_gradients(
        torch.from_numpy(g), torch.from_numpy(h), qb, row_ids=rows, seed=7,
        mix=12345)
    mono = hist_ops.build_quantized(torch.from_numpy(bins), qg, qh,
                                    torch.from_numpy(node), N, B, qb)
    acc = torch.zeros_like(mono)
    for lo in range(0, n, T):
        hi = min(n, lo + T)
        pad = chunked.pad_tile
        acc += hist_ops.build_quantized(
            torch.from_numpy(pad(bins, lo, hi, T)),
            torch.from_numpy(pad(qg.numpy(), lo, hi, T)),
            torch.from_numpy(pad(qh.numpy(), lo, hi, T)),
            torch.from_numpy(pad(node, lo, hi, T, fill=-1)), N, B, qb,
            node_rows_bound=T)
    assert acc.dtype == torch.int32
    assert torch.equal(acc, mono)
    ref = jax_hist.build_quantized(jnp.asarray(bins), jnp.asarray(qg.numpy()),
                                   jnp.asarray(qh.numpy()), jnp.asarray(node),
                                   N, B, quant_bins=qb)
    np.testing.assert_array_equal(np.asarray(ref), mono.numpy())


@pytest.mark.parametrize("T", [1, 97, 256, 1_000])
def test_row_keyed_noise_is_the_same_under_any_tile_width(T):
    _, g, h, _ = _tile_inputs(seed=9)
    n = len(g)
    gs = torch.tensor(float(np.abs(g).max()) / 8)
    hs = torch.tensor(float(h.max()) / 15)

    def q(lo, hi):
        return hist_ops.quantize_gradients(
            torch.from_numpy(g[lo:hi]), torch.from_numpy(h[lo:hi]), 16,
            g_scale=gs, h_scale=hs, row_ids=torch.arange(lo, hi), seed=3,
            mix=-77)[:2]

    whole = q(0, n)
    parts = [q(lo, min(n, lo + T)) for lo in range(0, n, T)]
    assert torch.equal(whole[0], torch.cat([a for a, _ in parts]))
    assert torch.equal(whole[1], torch.cat([b for _, b in parts]))


def test_row_noise_is_a_pure_function_of_its_keys():
    rows = torch.arange(50_000)
    u = hist_ops.row_noise(rows, seed=3, mix=5)
    assert u.shape == (2, 50_000) and u.dtype == torch.float32
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    assert abs(float(u.mean()) - 0.5) < 0.01
    assert torch.equal(u, hist_ops.row_noise(rows.flip(0), 3, 5).flip(1))
    for other in (dict(seed=4, mix=5), dict(seed=3, mix=6)):
        v = hist_ops.row_noise(rows, **other)
        assert float((u == v).float().mean()) < 0.01
    assert float((u[0] == u[1]).float().mean()) < 0.01       # channels


@pytest.mark.parametrize("chunk", [1, 777, 5_000])
def test_quantize_rows_is_quantize_gradients_by_global_row(chunk):
    """The driver's per-iteration quantization, in chunks of any size, is
    ``quantize_gradients`` keyed on each row's global id, cast to int8."""
    _, g, h, _ = _tile_inputs(n=5_000, seed=13)
    qg, qh = port_core._quantize_rows(g, h, 16, 0.2, 0.07, 5, -123,
                                      torch.device("cpu"), chunk)
    tg, th, _, _ = hist_ops.quantize_gradients(
        torch.from_numpy(g), torch.from_numpy(h), 16,
        g_scale=torch.tensor(0.2), h_scale=torch.tensor(0.07),
        row_ids=torch.arange(5_000), seed=5, mix=-123)
    assert qg.dtype == qh.dtype == np.int8
    np.testing.assert_array_equal(qg, tg.numpy())
    np.testing.assert_array_equal(qh, th.numpy())


def test_quant_mix_is_the_reference_fold():
    _, g, h, _ = _tile_inputs(seed=12)
    assert port_core._quant_mix(g, h) == jax_core._quant_mix(g, h)
    assert port_core._quant_mix(-g, h) == port_core._quant_mix(g, h)


def test_a_short_last_tile_takes_its_own_host_route(monkeypatch):
    """The reference bins tile by tile, each tile by the route its own
    cell count picks: the full tiles (>= 65,536 cells) take the C++ plane,
    which bins the leading ``-inf`` edge column to 0, and the short last
    tile the numpy route, which does not.  The port reproduces that."""
    monkeypatch.setattr(multiprocessing, "cpu_count", lambda: 8)
    rng = np.random.default_rng(2)
    n, T, F = 19_000, 9_000, 8
    X = rng.normal(size=(n, F)).astype(np.float32)
    X[:, 1] = rng.integers(0, 5, n)
    X[::7, 1] = -np.inf
    cd = chunked.ChunkedDataset(X, tile_rows=T)
    mapper, binned_fm = port_core._stream_bins(cd, 255)
    jm = JaxBinMapper(255).fit_streaming(X[lo:lo + T] for lo in
                                         range(0, n, T))
    np.testing.assert_array_equal(mapper.edges, jm.edges)
    assert jm.edges[1, 0] == -np.inf
    ref = np.concatenate([jm.transform(X[lo:lo + T])
                          for lo in range(0, n, T)])
    np.testing.assert_array_equal(binned_fm.T, ref)
    assert int(binned_fm[1, :2 * T].max()) == 0          # C++ tiles
    assert int(binned_fm[1, 2 * T:].max()) > 0           # the numpy tile


def test_streamed_edges_equal_the_reference_at_every_tile_width(
        monkeypatch):
    """Both packages feed the edge sketch the dataset's tiles.  With the
    sample cap patched to 900 rows (3,000 rows stream past it), the port's
    ``train_streamed`` edges, and its ``_stream_bins`` edges, equal the JAX
    package's ``train_streamed`` edges at 250 and at 1,000 rows a tile;
    above the cap the reservoir's draws follow the chunks, so the two
    widths give different edges, in both packages alike."""
    rng = np.random.default_rng(5)
    X = rng.normal(size=(3_000, 4)).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.float32)
    cap = 900
    for mapper_cls in (BinMapper, JaxBinMapper):
        fit = mapper_cls.fit_streaming
        monkeypatch.setattr(
            mapper_cls, "fit_streaming",
            lambda self, chunks, sample_cnt=cap, seed=3, _fit=fit:
            _fit(self, chunks, sample_cnt=cap, seed=seed))
    edges = {}
    for T in (250, 1_000):
        ref = jax_core.train_streamed(
            X, y, JaxParams(num_iterations=1, max_depth=2, max_bin=63),
            tile_rows=T).bin_mapper.edges
        port = train_streamed(
            X, y, GBDTParams(num_iterations=1, max_depth=2, max_bin=63),
            tile_rows=T, device="cpu").bin_mapper.edges
        mapper, binned_fm = port_core._stream_bins(
            chunked.ChunkedDataset(X, tile_rows=T), 63)
        np.testing.assert_array_equal(port, ref)
        np.testing.assert_array_equal(mapper.edges, ref)
        np.testing.assert_array_equal(binned_fm, mapper.transform(X).T)
        edges[T] = ref
    assert not np.array_equal(edges[250], edges[1_000])


# ----------------------------------------------------------- the driver

def _parity_data(seed=7, n=2000):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 8)).astype(np.float32)
    y = (X[:, 0] * 2 - X[:, 1] + 0.5 * X[:, 2] * X[:, 3]
         + rng.normal(scale=0.5, size=n) > 0).astype(np.float32)
    return X, y


def _reg_data(seed=17, n=2000):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 8)).astype(np.float32)
    y = (3 * X[:, 0] - 2 * X[:, 1] + X[:, 2] ** 2
         + rng.normal(scale=0.3, size=n)).astype(np.float32)
    return X, y


def _raw(booster, X, port: bool):
    out = booster.predict(X, device="cpu") if port else booster.predict(X)
    return np.asarray(out).reshape(len(X), -1)[:, 0]


def _score(objective, raw, y):
    if objective == "binary":
        return float(((raw > 0.5) == (y > 0)).mean())
    return float(np.mean((raw - y) ** 2))


_INTEGER_ARRAYS = ("split_feature", "threshold_bin", "left_child",
                   "right_child")


@pytest.mark.parametrize("objective", ["binary", "regression"])
@pytest.mark.parametrize("growth", [dict(max_depth=4), dict(num_leaves=8)],
                         ids=["level", "leaf"])
def test_train_streamed_matches_the_reference(objective, growth):
    X, y = _parity_data() if objective == "binary" else _reg_data()
    pkw = dict(num_iterations=10, objective=objective, seed=3,
               min_data_in_leaf=5, **growth)
    rj = jax_core.train_streamed(X, y, JaxParams(**pkw), tile_rows=450)
    rf = train_streamed(X, y, GBDTParams(**pkw), tile_rows=450,
                        device="cpu")
    rq = train_streamed(X, y, GBDTParams(use_quantized_grad=True, **pkw),
                        tile_rows=450, device="cpu")
    assert rj.extras["quantized"] == rf.extras["quantized"] == 0.0
    assert rq.extras["quantized"] == 1.0
    for k in ("num_tiles", "tile_rows"):
        assert rf.extras[k] == rq.extras[k] == rj.extras[k]
    assert rf.extras["num_tiles"] == 5.0
    # passes: one gradient pass per tree, then D (level) or up to
    # 1 + (num_leaves - 1) (leaf) histogram passes
    assert rf.extras["grad_passes"] == 10.0
    per_tree = 4 if "max_depth" in growth else 8
    assert 10 < rf.extras["hist_passes"] <= 10 * per_tree
    # a tile: its bins, the gradient and hessian (float32, or int8 when
    # quantized) and its node ids
    assert rf.extras["hist_pass_bytes"] == 450 * 5 * (8 + 12)
    assert rq.extras["hist_pass_bytes"] == 450 * 5 * (8 + 6)
    jb, fb, qb = rj.booster, rf.booster, rq.booster
    s_j = _score(objective, _raw(jb, X, False), y)
    s_f = _score(objective, _raw(fb, X, True), y)
    s_q = _score(objective, _raw(qb, X, True), y)
    # tree by tree: the leaf-wise steps pick the same leaf and split, and
    # the sibling histograms subtract to the same sums, in every tree
    assert fb.num_trees == jb.num_trees == 10
    for t in range(jb.num_trees):
        for k in _INTEGER_ARRAYS:
            np.testing.assert_array_equal(getattr(fb, k)[t],
                                          getattr(jb, k)[t],
                                          err_msg=f"{k}, tree {t}")
        np.testing.assert_allclose(fb.leaf_value[t], jb.leaf_value[t],
                                   rtol=0, atol=1e-5, err_msg=f"tree {t}")
        np.testing.assert_allclose(
            fb.split_gain[t], jb.split_gain[t], rtol=1e-4,
            atol=1e-6 * np.abs(jb.split_gain[t]).max(), err_msg=f"tree {t}")
    if objective == "binary":
        assert abs(s_f - s_j) <= 0.005
        assert s_q >= s_j - 0.02
    else:
        assert s_f <= s_j * 1.02
        assert s_q <= s_j * 1.35 + 0.05


def test_train_streamed_valid_set_and_early_stopping():
    X, y = _parity_data()
    pkw = dict(max_depth=4, objective="binary", seed=3, min_data_in_leaf=5,
               early_stopping_round=3, num_iterations=40)
    rp = train_streamed(X[:1500], y[:1500], GBDTParams(**pkw),
                        valid=(X[1500:], y[1500:]), tile_rows=400,
                        device="cpu")
    rj = jax_core.train_streamed(X[:1500], y[:1500],
                                 JaxParams(**pkw),
                                 valid=(X[1500:], y[1500:]), tile_rows=400)
    assert rp.evals and rp.booster.best_iteration >= 0
    # the same early stop; the logloss within rtol 1e-4 (float histograms
    # and gradients rounded differently, see the module docstring)
    assert [e["iteration"] for e in rp.evals] == \
        [e["iteration"] for e in rj.evals]
    np.testing.assert_allclose([e["binary_logloss"] for e in rp.evals],
                               [e["binary_logloss"] for e in rj.evals],
                               rtol=1e-4)
    assert rp.booster.best_iteration == rj.booster.best_iteration


def test_train_streamed_takes_a_chunked_dataset_with_weights():
    X, y = _parity_data(n=900)
    w = np.random.default_rng(3).uniform(0.5, 2.0, 900).astype(np.float32)
    p = dict(num_iterations=3, max_depth=3, objective="binary", seed=1)
    rp = train_streamed(chunked.ChunkedDataset(X, y=y, sample_weight=w,
                                               tile_rows=256),
                        params=GBDTParams(**p), device="cpu")
    rj = jax_core.train_streamed(
        jax_chunked.ChunkedDataset(X, y=y, sample_weight=w, tile_rows=256),
        params=JaxParams(**p))
    for k in _INTEGER_ARRAYS:
        np.testing.assert_array_equal(getattr(rp.booster, k),
                                      getattr(rj.booster, k))
    np.testing.assert_allclose(rp.booster.leaf_value, rj.booster.leaf_value,
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("call,match", [
    (lambda X, y: train_streamed(X, y, GBDTParams(objective="multiclass",
                                                  num_class=3),
                                 device="cpu"), "multiclass"),
    (lambda X, y: train_streamed(X, y, GBDTParams(objective="lambdarank"),
                                 device="cpu"), "lambdarank"),
    (lambda X, y: train_streamed(X, y, GBDTParams(boosting_type="dart"),
                                 device="cpu"), "boosting_type"),
    (lambda X, y: train_streamed(X, y, GBDTParams(boosting_type="goss"),
                                 device="cpu"), "boosting_type"),
    (lambda X, y: train_streamed(X, y, GBDTParams(categorical_features=(0,)),
                                 device="cpu"), "categorical"),
    (lambda X, y: train_streamed(
        chunked.ChunkedDataset(X, y=y, tile_rows=10), params=GBDTParams(),
        tile_rows=5, device="cpu"), "tile sizing"),
    (lambda X, y: train_streamed(chunked.ChunkedDataset(X),
                                 params=GBDTParams(), device="cpu"),
     "labels"),
    (lambda X, y: train_streamed(
        chunked.ChunkedDataset(X, y=y, sample_weight=np.ones(50, np.float32)),
        params=GBDTParams(), sample_weight=np.ones(50, np.float32),
        device="cpu"), "sample weights"),
    (lambda X, y: train_streamed(X, y - 1, GBDTParams(objective="poisson"),
                                 device="cpu"), "non-negative"),
    (lambda X, y: train_streamed(X, y, GBDTParams(objective="gamma"),
                                 device="cpu"), "strictly positive"),
    (lambda X, y: train_streamed(X, y, None, device="cpu"), "params"),
], ids=["multiclass", "lambdarank", "dart", "goss", "categorical",
        "tile_sizing", "labels", "sample_weights", "poisson", "gamma",
        "params"])
def test_train_streamed_refuses_what_the_reference_refuses(call, match):
    X = np.zeros((50, 3), np.float32)
    y = np.zeros(50, np.float32)
    with pytest.raises(ValueError, match=match):
        call(X, y)


def test_train_streamed_monitor_waits_for_its_queue():
    X, y = _parity_data(n=200)
    with pytest.raises(NotImplementedError, match="telemetry"):
        train_streamed(X, y, GBDTParams(num_iterations=1), monitor_port=0,
                       device="cpu")


def test_train_streamed_books_the_prefetch_seam():
    X, y = _parity_data(n=1_000)
    from mmlspark_tpu_torch.observability.metrics import get_registry
    r = train_streamed(X, y, GBDTParams(num_iterations=2, max_depth=2),
                       memory_budget_bytes=2 * 256 * (8 * 4 + 16),
                       device="cpu")
    assert r.extras["tile_rows"] == 256.0 and r.extras["num_tiles"] == 4.0
    assert r.extras["tiles_streamed"] == 4 * (2 + 2 * 2)
    assert 0.0 < r.extras["prefetch_overlap_pct"] <= 100.0
    assert r.extras["h2d_s"] == 0.0           # no copy stream on the CPU
    reg = get_registry()
    for metric in ("mmlspark_prefetch_wait_seconds",
                   "mmlspark_tile_compute_seconds"):
        assert reg.family(metric) is not None, metric
