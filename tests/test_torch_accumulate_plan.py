"""The Python around the Hopper ``hist_accumulate`` kernel, on the CPU.

The kernel itself runs only on the card (``test_torch_cuda_kernels.py``).
What it relies on is checked here: its launch plan, and the arithmetic of
its merge, which sums ``(qg, qh, count)`` per block in three int32 planes
and adds them to the output re-encoded in the packed-lane layout.  A numpy
mirror of that merge (the same shifts, in wrapping 32-bit integers) must
reproduce the plain version's packed-lane sums mod 2^32 bit for bit, for
any split of the rows into blocks, in every layout, at the quantizer's
extreme values.
"""
import numpy as np
import pytest
import torch

from mmlspark_tpu_torch.ops import cuda_histogram as CH
from mmlspark_tpu_torch.ops import histogram as TH

M32 = (1 << 32) - 1


def _merge_mirror(qg, qh, blocks, mode, cbits, hbits):
    """The kernel's merge for rows split into ``blocks`` contiguous blocks:
    per block, int32 sums of qg, qh and the count, re-encoded in the
    output layout with wrapping uint32 shifts, added mod 2^32."""
    lanes = [0] * CH._CHANNELS[mode]
    for idx in np.array_split(np.arange(qg.size), blocks):
        sg = int(qg[idx].astype(np.int64).sum()) & M32
        sh = int(qh[idx].astype(np.int64).sum()) & M32
        cnt = idx.size & M32
        if mode == "all3":
            enc = [(sg << (hbits + cbits)) + (sh << cbits) + cnt]
        elif mode == "2ch":
            enc = [sg, (sh << cbits) + cnt]
        else:
            enc = [sg, sh, cnt]
        lanes = [(x + (e & M32)) & M32 for x, e in zip(lanes, enc)]
    return lanes


def _plain_lane_sums(qg, qh, mode, cbits, hbits):
    packed = TH._pack_lanes(torch.from_numpy(qg), torch.from_numpy(qh), mode,
                            cbits, hbits)
    return [int(x.to(torch.int64).sum()) & M32 for x in packed]


@pytest.mark.parametrize("B", [2, 15, 63, 255, 256])
def test_plan_covers_every_node_and_feature_within_shared_memory(B):
    for N in range(1, 65):
        for F in (1, 7, 200, 1000):
            p = CH._accumulate_plan(10 ** 6, F, N, B, 132)
            assert (p.NG - 1) * p.Ng < N <= p.NG * p.Ng
            assert p.G * p.Fg >= F and p.Fg == -(-F // p.G)
            widths = [(i + 1) * F // p.G - i * F // p.G for i in range(p.G)]
            assert sum(widths) == F and 1 <= min(widths)
            assert max(widths) <= p.Fg
            assert (CH._QUEUE_BYTES + CH._CELL_BYTES * p.Ng * p.Fg * B
                    <= CH._SMEM_PER_BLOCK)
            assert p.Ng < 1 << 16           # the row queue's node field
            assert p.blocks == 132
    # tiny inputs give each block at least one row of work
    assert CH._accumulate_plan(1, 3, 2, 17, 132).blocks == 1


def test_block_sums_fit_int32_at_every_quant_bins_extreme():
    """At the most rows ``lane_layout`` accepts, all rows at the quantizer's
    extremes: every field of a block's sums stays an exact int32."""
    for quant_bins in range(2, 129):
        qg_cap, qh_cap = max(1, quant_bins // 2), max(1, quant_bins - 1)
        n = ((1 << 31) - 1) // qh_cap
        CH.lane_layout(n, n, quant_bins)             # accepted
        with pytest.raises(ValueError, match="overflow"):
            CH.lane_layout(n + 1, n + 1, quant_bins)
        for total in (-n * qg_cap, n * qg_cap, n * qh_cap, n):
            assert -(1 << 31) <= total < 1 << 31


@pytest.mark.parametrize("quant_bins", [2, 16, 128])
@pytest.mark.parametrize("bound", [1, 40, 600, 5000])
def test_merge_mirror_reproduces_packed_lane_sums(quant_bins, bound):
    """Every layout: random and extreme gradients, any block split."""
    qg_cap, qh_cap = max(1, quant_bins // 2), max(1, quant_bins - 1)
    mode, cbits, hbits = CH.lane_layout(bound, bound, quant_bins)
    rng = np.random.default_rng(quant_bins * 7919 + bound)
    cases = {
        "random": (rng.integers(-qg_cap, qg_cap + 1, bound),
                   rng.integers(0, qh_cap + 1, bound)),
        "low": (np.full(bound, -qg_cap), np.full(bound, qh_cap)),
        "high": (np.full(bound, qg_cap), np.full(bound, qh_cap)),
    }
    for name, (qg, qh) in cases.items():
        qg, qh = qg.astype(np.int8), qh.astype(np.int8)
        want = _plain_lane_sums(qg, qh, mode, cbits, hbits)
        for blocks in (1, 3, min(bound, 132)):
            got = _merge_mirror(qg, qh, blocks, mode, cbits, hbits)
            assert got == want, (name, mode, blocks)
        # the decode of the plain lane sums gives the exact field sums back
        acc = [torch.tensor([x], dtype=torch.int64).to(torch.int32)
               for x in want]
        dec = [int(x) for x in TH._unpack_lanes(acc, mode, cbits, hbits)]
        assert dec == [int(qg.astype(np.int64).sum()),
                       int(qh.astype(np.int64).sum()), bound], (name, mode)


def test_merge_mirror_wraps_like_the_plain_lanes_on_any_int8():
    """Outside the quantizer's range (negative qh, sums past int32) the
    wrapping merge still equals the plain int32 lane sums mod 2^32."""
    rng = np.random.default_rng(3)
    qg = rng.integers(-128, 128, 4099).astype(np.int8)
    qh = rng.integers(-128, 128, 4099).astype(np.int8)
    for mode, cbits, hbits in (("all3", 5, 9), ("2ch", 13, 17),
                               ("wide", 21, 25)):
        want = _plain_lane_sums(qg, qh, mode, cbits, hbits)
        assert _merge_mirror(qg, qh, 7, mode, cbits, hbits) == want


def test_plain_accumulate_takes_int8_gradients_as_int32():
    rng = np.random.default_rng(4)
    n, F, B, N = 2000, 5, 31, 3
    binned = torch.from_numpy(rng.integers(0, B, (n, F)).astype(np.uint8))
    ids = torch.from_numpy(rng.integers(-1, N, n).astype(np.int32))
    qg = torch.from_numpy(rng.integers(-64, 65, n).astype(np.int32))
    qh = torch.from_numpy(rng.integers(0, 128, n).astype(np.int32))
    for bound in (n, 300, 20):
        lay = CH.lane_layout(n, bound, 128)
        a = CH.hist_accumulate(binned, CH.to_int8(qg), CH.to_int8(qh), ids,
                               N, B, lay)
        b = CH.hist_accumulate_plain(binned, qg, qh, ids, N, B, lay)
        assert a.dtype == torch.int32 and torch.equal(a, b)
