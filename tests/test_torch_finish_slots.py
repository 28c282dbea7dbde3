"""The slot form of ``frontier_finish`` (the leaf-wise grower's carry as its
inputs and outputs) on the CPU, where the wrapper runs the plain version.

- One call in the slot form equals the composition the grower made before
  it, bit for bit: read the parent with ``index_select`` and widen it,
  finish densely, then put both children and their best splits into the
  carry with ``index_copy_``.  For int16 and int32 carries, with the
  step's gate on and off (off: both outputs go to the trash slot, the
  second one last, and the real slots keep what they held).
- The root writes slot 0 the same way, with the node totals.
- The dense ``out`` form (the level-wise grower's) equals the 9-float
  record with int32 features and bins.
- A leaf-wise grower makes one ``frontier_finish`` call per leaf, every one
  in the slot form, and its trees still equal the JAX package's.
"""
import numpy as np
import pytest
import torch

from mmlspark_tpu_torch.ops import cuda_histogram as CH

from tests.test_torch_leafwise import _assert_same_leafwise_tree, _grow_both

L, F, B = 7, 5, 31


def _step_inputs(seed, n=600):
    """Lane sums of a left child and a carry whose slot 2 holds its parent
    (every row), as the grower has them at a split step."""
    rng = np.random.default_rng(seed)
    binned = torch.from_numpy(rng.integers(0, B, (n, F)).astype(np.uint8))
    qg = torch.from_numpy(rng.integers(-8, 9, n).astype(np.int8))
    qh = torch.from_numpy(rng.integers(0, 16, n).astype(np.int8))
    in_left = torch.from_numpy(rng.random(n) < 0.4)
    lay = CH.lane_layout(n, n, 16)
    acc_parent = CH.hist_accumulate(binned, qg, qh, torch.zeros(
        n, dtype=torch.int32), 1, B, lay)
    parent = CH.frontier_finish(acc_parent, *lay)[0]
    acc = CH.hist_accumulate(binned, qg, qh, torch.where(
        in_left, 0, -1).to(torch.int32), 1, B, lay)
    fmask = torch.from_numpy(rng.random(F) < 0.8)
    edge = torch.from_numpy(rng.random((F, B)) < 0.9)
    edge[:, B - 1] = False
    gains = CH.gain_params(0.05, 0.02, fmask, edge, torch.tensor([True]),
                           l2=1.0, min_data=3.0, min_hess=1e-3)
    return acc, lay, parent, gains, rng


def _carry(rng, dtype, parent):
    hists = torch.from_numpy(rng.integers(-99, 99, (L + 1, F, B, 3))
                             ).to(dtype)
    hists[2] = parent[0].to(dtype)
    return CH.FinishOut(
        hists, torch.from_numpy(rng.normal(size=L + 1).astype(np.float32)),
        torch.from_numpy(rng.integers(0, F, L + 1).astype(np.int32)),
        torch.from_numpy(rng.integers(0, B, L + 1).astype(np.int32)),
        torch.from_numpy(rng.normal(size=(L + 1, 3)).astype(np.float32)))


def _clone(out):
    return CH.FinishOut(*(None if x is None else x.clone() for x in out))


def _assert_equal(a, b):
    for name, x, y in zip(a._fields, a, b):
        if x is None or y is None:
            assert x is y, name
            continue
        assert x.dtype == y.dtype, name
        if x.is_floating_point():   # NaN gains (0/0) are equal here
            assert torch.equal(x.isnan(), y.isnan()), name
            x, y = x.nan_to_num(nan=7.0), y.nan_to_num(nan=7.0)
        assert torch.equal(x, y), name


@pytest.mark.parametrize("do", [True, False])
@pytest.mark.parametrize("dtype", [torch.int16, torch.int32])
def test_slot_form_equals_the_old_composition(dtype, do):
    acc, lay, parent, gains, rng = _step_inputs(1 + (dtype == torch.int32))
    carry = _carry(rng, dtype, parent)
    j = torch.tensor([2])
    at_j = torch.tensor([2 if do else L])
    at_new = torch.tensor([5 if do else L])
    left = torch.ones((1,), dtype=torch.bool)

    # before: index_select + widen, the dense finish, ten puts
    ref = _clone(carry)
    pair, best = CH.frontier_finish_plain(
        acc, *lay, ref.hist.index_select(0, j).to(torch.int32), left, gains)
    for k, at in enumerate((at_j, at_new)):
        b = best[k:k + 1]
        for arr, val in ((ref.hist, pair[k:k + 1]), (ref.gain, b[:, 0]),
                         (ref.feat, b[:, 1].to(torch.int32)),
                         (ref.bin, b[:, 2].to(torch.int32)),
                         (ref.left, b[:, 3:6])):
            arr.index_copy_(0, at, val.to(arr.dtype))

    got = _clone(carry)
    assert CH.frontier_finish(acc, *lay, None, left, gains, out=got,
                              out_slots=(at_j, at_new),
                              parent_slot=j) is None
    _assert_equal(got, ref)
    if not do:   # only the trash slot changed
        for x, y in zip(got[:5], carry[:5]):
            assert torch.equal(x[:L], y[:L])
        assert torch.equal(got.hist[L], pair[1].to(dtype))
    else:        # the children, left in the parent's slot, sum to it
        assert torch.equal(got.hist[2].int() + got.hist[5].int(), parent[0])
        assert not torch.equal(got.hist[2], carry.hist[2])


@pytest.mark.parametrize("dtype", [torch.int16, torch.int32])
def test_root_slot_form_writes_slot_zero_with_totals(dtype):
    acc, lay, _, gains, rng = _step_inputs(3)
    carry = _carry(rng, dtype, torch.zeros((1, F, B, 3), dtype=torch.int32))
    carry = carry._replace(tot=torch.zeros((L + 1, 3)))
    hist, best = CH.frontier_finish_plain(acc, *lay, gains=gains)
    got = _clone(carry)
    CH.frontier_finish(acc, *lay, gains=gains, out=got,
                       out_slots=(torch.zeros((1,), dtype=torch.int64),))
    assert torch.equal(got.hist[0], hist[0].to(dtype))
    assert torch.equal(got.gain[:1], best[:, 0])
    assert got.feat[0] == int(best[0, 1]) and got.bin[0] == int(best[0, 2])
    assert torch.equal(got.left[:1], best[:, 3:6])
    assert torch.equal(got.tot[:1], best[:, 6:9])
    for x, y in zip(got, carry):
        assert torch.equal(x[1:], y[1:])


@pytest.mark.parametrize("subtract", [False, True])
def test_dense_out_form_equals_the_record(subtract):
    acc, lay, parent, gains, _ = _step_inputs(4)
    par = parent if subtract else None
    sl = torch.zeros((1,), dtype=torch.bool) if subtract else None
    hist, best = CH.frontier_finish_plain(acc, *lay, par, sl, gains)
    out = CH.dense_out(hist.shape[0], hist.shape[1], hist.shape[2], "cpu")
    CH.frontier_finish(acc, *lay, par, sl, gains, out=out)
    assert torch.equal(out.hist, hist)
    rec = torch.cat([out.gain[:, None], out.feat[:, None].float(),
                     out.bin[:, None].float(), out.left, out.tot], dim=1)
    assert torch.equal(rec, best)
    assert out.feat.dtype == out.bin.dtype == torch.int32


@pytest.mark.parametrize("seed,store16", [(7, True), (8, False)])
def test_leafwise_grower_writes_through_the_carry(monkeypatch, seed,
                                                  store16):
    """One finish call per leaf, each in the slot form (the children reach
    the carry with no copy), and the tree equals the JAX package's."""
    calls = []
    real = CH.frontier_finish

    def spy(*args, **kw):
        calls.append((kw.get("out") is not None,
                      kw.get("out_slots") is not None,
                      kw.get("parent_slot") is not None))
        return real(*args, **kw)

    monkeypatch.setattr(CH, "frontier_finish", spy)
    jout, tout = _grow_both(15, seed=seed, store16=store16)
    assert _assert_same_leafwise_tree(jout, tout)
    assert calls == [(True, True, False)] + [(True, True, True)] * 14
