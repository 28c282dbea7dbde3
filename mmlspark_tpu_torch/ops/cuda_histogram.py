"""Fused GBDT frontier step on Hopper — the counterpart of
``mmlspark_tpu/ops/pallas_histogram.py``.

The TPU kernel (one ``pl.pallas_call`` in ``_frontier``) accumulates
packed-lane integer histograms over a sequential row-tile grid, then in its
last grid step decodes the lanes, subtracts the smaller child from its
parent in exact int32 and scans split gains.  Its two accumulation modes
exist only because Mosaic has no vector scatter.  Hopper has shared-memory
atomics, so the port is two hand-written CUDA kernels
(``csrc/frontier.cu``), one per half:

- ``hist_accumulate`` — replaces ``_make_kernel``'s accumulation half
  (``pallas_histogram.py:199-238``): the ``(C, N, F, B)`` int32 packed-lane
  sums per (node, feature, bin).  Its floor is the bytes it must read (node
  ids, then the active rows' bins and int8 gradients) against the issue
  rate of shared-memory atomics, one per (active row, feature, field).  The
  design answers each part of that: a persistent grid of one block per SM
  splits the (node group, feature group, row) work evenly, with groups as
  wide as the SM's shared memory allows (``_accumulate_plan``); each warp
  queues the rows of its node group by ballot, so every pass of the
  feature loop runs 32 live rows; rows read 2 bytes of int8 gradients
  instead of 4·C bytes of packed lanes; the block sums ``(Σqg, Σqh,
  count)`` in three int32 planes, one native shared atomic each (a 64-bit
  shared atomic is a compare-and-swap loop on sm_90); and each block adds
  its non-zero cells to the output once per group, re-encoded in the
  output lane layout, with global atomics.  The lanes are linear in
  ``(qg, qh, 1)`` and integer addition is associative, so the sums equal
  the plain version's mod 2^32 bit for bit, in any order.
- ``frontier_finish`` — one launch: decode, sibling subtraction and
  (with gains) the dequantize -> f32 bin scan -> gain -> gates -> first
  max.  A block takes one parent and a group of at most five features and
  emits both children; one lane per (child, channel, feature) scans the
  bins in the plain version's sequential f32 order; the last block of each
  parent reduces the groups' partial bests through an atomic counter that
  it leaves at zero.  Its inputs and outputs may be the leaf-wise grower's
  carry itself (``FinishOut`` with device slot indices), so a split step
  makes one call and no copies.  Bound by bytes: the lane sums and
  histograms.

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs, launches on PyTorch's current stream, raises on a launch error and
adds one to its ``launches`` count.  Beside each kernel sits its plain
PyTorch version (``*_plain``): a CPU tensor runs it, the tests hold the JAX
package against it, and ``chip_smoke.py`` holds the kernel against it on
the card.  Nothing on the CUDA path calls it.  The plain gain scan adds the
bins one at a time in f32, the kernel's order, so the two agree bit for
bit; the JAX package's cumsum orders its adds differently, so against JAX
the gains agree to f32 rounding.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import torch

from .histogram import _check_overflow, _pack_lanes, _packed_layout, \
    _scatter_rows, _unpack_lanes

_CHANNELS = {"all3": 1, "2ch": 2, "wide": 3}
_MODE_CODE = {"all3": 0, "2ch": 1, "wide": 2}

#: frontier parents per level up to which the growers take the fused
#: frontier step — the JAX package's VMEM cap, kept as the same per-level
#: gate so both packages grow trees through the same branches.  The CUDA
#: kernels themselves have no node cap.
FUSED_MAX_NODES = 16

#: ``hist_accumulate`` runs one block of ``_ACC_THREADS`` threads per SM
#: with the SM's whole opt-in shared memory: a 64-row queue of 8 bytes per
#: warp, the rest for three int32 planes per (node, feature, bin)
_ACC_THREADS = 1024
_SMEM_PER_BLOCK = 227 * 1024
_QUEUE_BYTES = _ACC_THREADS // 32 * 64 * 8
_CELL_BYTES = 12
#: ``frontier_finish`` blocks take at most this many features each, and
#: leave a partial best of ``_PART`` floats per (parent, group, child)
_FINISH_MAX_FEAT = 5
_PART = 8


def supported(num_bins: int, quant_bins: int = 16) -> bool:
    """The kernels take 2 <= num_bins <= 256 (one warp scans a feature's
    bins from shared memory) and quant_bins <= 128 (gradients fit int8)."""
    return 2 <= num_bins <= 256 and 2 <= quant_bins <= 128


class LaneLayout(NamedTuple):
    """The packed int32 lane plan of ``ops.histogram._packed_layout``."""
    mode: str
    cbits: int
    hbits: int


def lane_layout(n: int, bound: int, quant_bins: int) -> LaneLayout:
    """The lane plan for ``n`` rows of which at most ``bound`` reach one
    node; raises where int32 sums could overflow."""
    _check_overflow(n, quant_bins)
    return LaneLayout(*_packed_layout(bound, quant_bins))


class GainParams(NamedTuple):
    """Inputs of the gain scan (``frontier_finish`` with gains on), on the
    accumulator's device in the kernel's types: ``gain_params`` builds them
    once per tree."""
    scales: torch.Tensor        # (2,) float32 [g_scale, h_scale]
    feat_mask: torch.Tensor     # (F,) bool or uint8
    edge_ok: torch.Tensor       # (F, B) bool or uint8
    depth_ok: Optional[torch.Tensor] = None   # (1,) bool or None
    l1: float = 0.0
    l2: float = 0.0
    min_data: float = 0.0
    min_hess: float = 0.0


def gain_params(g_scale, h_scale, feat_mask, edge_ok, depth_ok=None, *,
                l1: float = 0.0, l2: float = 0.0, min_data: float = 0.0,
                min_hess: float = 0.0, device=None) -> GainParams:
    """``GainParams`` on ``device`` (default: ``feat_mask``'s)."""
    dev = torch.as_tensor(feat_mask).device if device is None else device

    def mask(x):
        return torch.as_tensor(x, device=dev).to(torch.bool).contiguous()

    scales = torch.stack([
        torch.as_tensor(g_scale, dtype=torch.float32, device=dev).reshape(()),
        torch.as_tensor(h_scale, dtype=torch.float32, device=dev).reshape(())])
    return GainParams(scales, mask(feat_mask), mask(edge_ok),
                      None if depth_ok is None else mask(depth_ok).reshape(1),
                      float(l1), float(l2), float(min_data), float(min_hess))


class FinishOut(NamedTuple):
    """Arrays that ``frontier_finish`` writes its outputs into, each indexed
    by output row: the leaf-wise grower's carry (with device slot indices),
    or dense arrays of one row per output node."""
    hist: torch.Tensor            # (rows, F, B, 3) int32 or int16
    gain: torch.Tensor            # (rows,) float32
    feat: torch.Tensor            # (rows,) int32
    bin: torch.Tensor             # (rows,) int32
    left: torch.Tensor            # (rows, 3) float32 [GL, HL, CL]
    tot: Optional[torch.Tensor] = None    # (rows, 3) float32 [G, H, C]


def dense_out(n_out: int, F: int, B: int, device) -> FinishOut:
    """A ``FinishOut`` of one row per output node (``tot`` included): the
    form ``frontier_step`` gives the level-wise grower."""
    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=device)
    return FinishOut(empty(n_out, F, B, 3, dtype=torch.int32), empty(n_out),
                     empty(n_out, dtype=torch.int32),
                     empty(n_out, dtype=torch.int32), empty(n_out, 3),
                     empty(n_out, 3))


def _record(out: FinishOut) -> torch.Tensor:
    """The ``(rows, 9)`` float32 record ``[gain, feature, bin, GL, HL, CL,
    G, H, C]`` of dense arrays (features and bins convert exactly)."""
    return torch.cat([out.gain[:, None], out.feat[:, None].to(torch.float32),
                      out.bin[:, None].to(torch.float32), out.left, out.tot],
                     dim=1)


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def hist_accumulate_plain(binned: torch.Tensor, qg: torch.Tensor,
                          qh: torch.Tensor, node_ids: torch.Tensor,
                          num_nodes: int, num_bins: int,
                          layout: LaneLayout) -> torch.Tensor:
    """The packed int32 lanes of ``(qg, qh)`` summed per (node, feature,
    bin) over rows with ``node >= 0`` -> ``(C, N, F, B)`` int32."""
    F = binned.shape[1]
    lanes = _pack_lanes(qg, qh, layout.mode, layout.cbits, layout.hbits)
    sums = _scatter_rows(binned, node_ids, lanes, num_nodes, num_bins)
    return torch.stack(sums).reshape(len(lanes), num_nodes, F, num_bins)


def _leaf_score(G, H, l1, l2):
    t = torch.sign(G) * torch.clamp(G.abs() - l1, min=0.0)
    return t ** 2 / (H + l2)


def _cumsum_bins(x: torch.Tensor) -> torch.Tensor:
    """f32 prefix sums over dim -2, one bin at a time from bin 0 — the add
    order of the kernel's scan, so both round identically."""
    out = x.clone()
    for b in range(1, x.shape[-2]):
        out[..., b, :] += out[..., b - 1, :]
    return out


def frontier_finish_plain(acc: torch.Tensor, mode: str, cbits: int,
                          hbits: int, parent_hist=None, small_left=None,
                          gains: Optional[GainParams] = None, *,
                          out: Optional[FinishOut] = None, out_slots=None,
                          parent_slot=None):
    """Decode ``(C, N, F, B)`` lane sums; in subtract mode emit both
    children of each parent interleaved ``(2N, F, B, 3)`` (child ``2k`` is
    the small one iff ``small_left[k]``); with ``gains`` also return the
    per-node best split ``(N_out, 9)`` float32 record
    ``[gain, feature, bin, GL, HL, CL, G, H, C]``.

    With ``out`` (gains required) the outputs go into its arrays instead
    and nothing is returned: output ``o`` into row ``out_slots[o]`` (a
    ``(1,)`` int64 device tensor) or, without ``out_slots``, into row
    ``o``; the histograms narrowed to ``out.hist``'s dtype as ``.to()``
    wraps; ``tot`` only where ``out.tot`` is given.  Outputs that share a
    row leave the last one.  ``parent_slot`` (a ``(1,)`` int64 device
    tensor, N = 1) reads the parent as ``out.hist[parent_slot]`` widened to
    int32, in place of ``parent_hist``."""
    if parent_slot is not None:
        parent_hist = out.hist.index_select(0, parent_slot).to(torch.int32)
    hist, best = _finish_plain(acc, mode, cbits, hbits, parent_hist,
                               small_left, gains)
    if out is None:
        return hist, best
    if out_slots is None:
        rows = [(torch.arange(hist.shape[0], device=hist.device),
                 slice(None))]
    else:       # one output at a time: a later one wins a shared row
        rows = [(at, slice(o, o + 1)) for o, at in enumerate(out_slots)]
    for at, o in rows:
        b = best[o]
        out.hist.index_copy_(0, at, hist[o].to(out.hist.dtype))
        out.gain.index_copy_(0, at, b[:, 0])
        out.feat.index_copy_(0, at, b[:, 1].to(torch.int32))
        out.bin.index_copy_(0, at, b[:, 2].to(torch.int32))
        out.left.index_copy_(0, at, b[:, 3:6])
        if out.tot is not None:
            out.tot.index_copy_(0, at, b[:, 6:9])
    return None


def _finish_plain(acc, mode, cbits, hbits, parent_hist, small_left, gains):
    small = torch.stack(_unpack_lanes(acc, mode, cbits, hbits), dim=-1)
    if parent_hist is not None:
        N, F, B = small.shape[:3]
        sib = parent_hist - small
        sl = small_left.to(torch.bool)[:, None, None, None]
        hist = torch.stack([torch.where(sl, small, sib),
                            torch.where(sl, sib, small)],
                           dim=1).reshape(2 * N, F, B, 3)
    else:
        hist = small
    if gains is None:
        return hist, None
    n_out, F, B = hist.shape[:3]
    gsc, hsc = gains.scales[0], gains.scales[1]
    # dequantize, then the f32 scan over bins: the growers' op order
    f = hist.to(torch.float32)
    cum = _cumsum_bins(torch.stack([f[..., 0] * gsc, f[..., 1] * hsc,
                                    f[..., 2]], dim=-1))
    GL, HL, CL = cum[..., 0], cum[..., 1], cum[..., 2]
    # node totals from the exact integer sums of feature 0
    tot = hist[:, 0].sum(dim=1, dtype=torch.int32).to(torch.float32)
    tg, th, tc = tot[:, 0] * gsc, tot[:, 1] * hsc, tot[:, 2]
    GR = tg[:, None, None] - GL
    HR = th[:, None, None] - HL
    CR = tc[:, None, None] - CL
    l1, l2 = gains.l1, gains.l2
    gain = (_leaf_score(GL, HL, l1, l2) + _leaf_score(GR, HR, l1, l2)
            - _leaf_score(tg, th, l1, l2)[:, None, None])
    ok = ((CL >= gains.min_data) & (CR >= gains.min_data)
          & (HL >= gains.min_hess) & (HR >= gains.min_hess)
          & gains.feat_mask.to(torch.bool)[None, :, None]
          & gains.edge_ok.to(torch.bool)[None])
    if gains.depth_ok is not None:
        ok = ok & gains.depth_ok.to(torch.bool).reshape(())
    gain = torch.where(ok, gain, torch.full_like(gain, -math.inf))
    flat = gain.reshape(n_out, F * B)
    am = torch.argmax(flat, dim=1)            # first max, as jnp.argmax

    def take(X):
        return torch.gather(X.reshape(n_out, F * B), 1, am[:, None])[:, 0]

    best = torch.stack([take(gain), (am // B).to(torch.float32),
                        (am % B).to(torch.float32), take(GL), take(HL),
                        take(CL), tg, th, tc], dim=-1)
    return hist, best


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_BYTES = (torch.bool, torch.uint8)     # masks the kernels read as bytes


def _check(name: str, t: torch.Tensor, dtype, dev, shape=None) -> None:
    if t.device != dev:
        raise ValueError(f"{name} must lie on {dev}, got {t.device}")
    if t.dtype not in (dtype if isinstance(dtype, tuple) else (dtype,)):
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")


def _binned_strides(binned: torch.Tensor):
    """(row stride, feature stride) of a row-major ``(n, F)`` matrix or of
    the transposed view of a feature-major ``(F, n)`` one — the layout the
    trainer keeps, so a warp reads consecutive rows of one feature."""
    if binned.is_contiguous():
        return binned.shape[1], 1
    if binned.t().is_contiguous():
        return 1, binned.shape[0]
    raise ValueError("binned must be row-major (n, F) or the transpose of "
                     "a contiguous (F, n) matrix")


class AccPlan(NamedTuple):
    """``hist_accumulate``'s launch plan, in the C launcher's order."""
    G: int          # feature groups
    NG: int         # node groups
    Fg: int         # features per group (at most)
    Ng: int         # nodes per group (at most)
    blocks: int     # persistent grid


def _accumulate_plan(n: int, F: int, N: int, B: int,
                     num_sms: int) -> AccPlan:
    """Groups as wide as one block's accumulator allows (node groups first,
    then features split evenly), and one block per SM that takes an even
    share of the (node group, feature group, row) work."""
    slots = (_SMEM_PER_BLOCK - _QUEUE_BYTES) // (_CELL_BYTES * B)
    NG = -(-N // min(N, slots))
    Ng = -(-N // NG)
    G = -(-F // max(1, min(F, slots // Ng)))
    Fg = -(-F // G)
    return AccPlan(G, NG, Fg, Ng, max(1, min(num_sms, G * NG * n)))


@functools.lru_cache(maxsize=None)
def _num_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _library():
    from ..kernels._build import load_library
    return load_library()


def _raise_on(err: int, name: str, lib) -> None:
    if err != 0:
        msg = lib.frontier_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {err} ({msg})")


def hist_accumulate(binned: torch.Tensor, qg: torch.Tensor, qh: torch.Tensor,
                    node_ids: torch.Tensor, num_nodes: int, num_bins: int,
                    layout: LaneLayout) -> torch.Tensor:
    """Replaces the accumulation half of ``_make_kernel``
    (``mmlspark_tpu/ops/pallas_histogram.py:199-238``).  Returns
    ``(C, N, F, B)`` int32 lane sums, bit-identical to
    ``hist_accumulate_plain``.  On the card ``qg``/``qh`` are int8 and
    ``node_ids`` int32; ``binned`` values must be below ``num_bins`` (the
    BinMapper's contract)."""
    if binned.device.type == "cpu":
        return hist_accumulate_plain(binned, qg, qh, node_ids, num_nodes,
                                     num_bins, layout)
    if binned.device.type != "cuda":
        raise ValueError(f"no kernel for device {binned.device}")
    dev = binned.device
    n, F = binned.shape
    N, B = int(num_nodes), int(num_bins)
    if binned.dtype != torch.uint8:
        raise TypeError(f"binned must be uint8, got {binned.dtype}")
    if not 2 <= B <= 256 or N < 1:
        raise ValueError(f"unsupported shape: bins={B} nodes={N}")
    _check("qg", qg, torch.int8, dev, (n,))
    _check("qh", qh, torch.int8, dev, (n,))
    _check("node_ids", node_ids, torch.int32, dev, (n,))
    s_row, s_feat = _binned_strides(binned)
    acc = torch.zeros((_CHANNELS[layout.mode], N, F, B), dtype=torch.int32,
                      device=dev)
    if n == 0:
        return acc
    plan = _accumulate_plan(n, F, N, B, _num_sms(dev.index))
    lib = _library()
    err = lib.hist_accumulate_launch(
        binned.data_ptr(), s_row, s_feat, qg.data_ptr(), qh.data_ptr(),
        node_ids.data_ptr(), acc.data_ptr(), n, F, B, N, *plan,
        _MODE_CODE[layout.mode], layout.cbits, layout.hbits,
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "hist_accumulate", lib)
    hist_accumulate.launches += 1
    return acc


def _finish_plan(rows: int, F: int, num_sms: int) -> int:
    """Features per ``frontier_finish`` block: one while the grid of
    (feature groups x parents) would not cover two blocks per SM, up to
    ``_FINISH_MAX_FEAT`` (30 scan chains in one warp) as parents grow."""
    return max(1, min(_FINISH_MAX_FEAT, rows * F // (2 * num_sms)))


#: per (device, stream): the per-parent counters the last block of each
#: parent resets (zeroed once here) and the partial-best scratch rows.  The
#: kernel needs the counters at zero when it starts; a launch that reports
#: an error drops its stream's entry, so the next call starts from zeros.
_finish_state: dict = {}


def _finish_buffers(dev: torch.device, stream: int, parts: int):
    key = (dev.index, stream)
    counter, scratch = _finish_state.get(key, (None, None))
    if counter is None:
        counter = torch.zeros(65535, dtype=torch.int32, device=dev)
    if scratch is None or scratch.numel() < parts * _PART:
        scratch = torch.empty(max(parts, 4096) * _PART, dtype=torch.float32,
                              device=dev)
    _finish_state[key] = (counter, scratch)
    return counter, scratch


def _slot(name: str, t, dev) -> int:
    _check(name, t, torch.int64, dev, (1,))
    return t.data_ptr()


def _out_pointers(out: FinishOut, F: int, B: int, n_out: int, out_slots,
                  dev):
    """Check ``out`` and its slots; returns (int16 histograms?, the two
    slot pointers, the five array pointers) in the C launcher's order."""
    hist = out.hist
    if hist.dtype not in (torch.int32, torch.int16) or hist.dim() != 4 \
            or tuple(hist.shape[1:]) != (F, B, 3):
        raise ValueError(f"out.hist must be (rows, {F}, {B}, 3) int32 or "
                         f"int16, got {tuple(hist.shape)} {hist.dtype}")
    _check("out.hist", hist, hist.dtype, dev)
    rows = hist.shape[0]
    _check("out.gain", out.gain, torch.float32, dev, (rows,))
    _check("out.feat", out.feat, torch.int32, dev, (rows,))
    _check("out.bin", out.bin, torch.int32, dev, (rows,))
    _check("out.left", out.left, torch.float32, dev, (rows, 3))
    if out.tot is not None:
        _check("out.tot", out.tot, torch.float32, dev, (rows, 3))
    if out_slots is None:
        if rows < n_out:
            raise ValueError(f"out has {rows} rows for {n_out} outputs")
        slots = (None, None)
    else:
        if len(out_slots) != n_out or n_out > 2:
            raise ValueError(f"out_slots must hold one (1,) slot per output "
                             f"({n_out}), at most two")
        slots = tuple(_slot("out_slots", s, dev) for s in out_slots) \
            + (None,) * (2 - n_out)
    arrays = tuple(None if x is None else x.data_ptr() for x in
                   (out.gain, out.feat, out.bin, out.left, out.tot))
    return int(hist.dtype == torch.int16), slots, arrays


def frontier_finish(acc: torch.Tensor, mode: str, cbits: int, hbits: int,
                    parent_hist=None, small_left=None,
                    gains: Optional[GainParams] = None, *,
                    out: Optional[FinishOut] = None, out_slots=None,
                    parent_slot=None):
    """Replaces the ``_finish`` epilogue of ``_make_kernel`` and the
    cross-feature-block reduction of ``_frontier``
    (``mmlspark_tpu/ops/pallas_histogram.py:240-300, 424-429``).  Same
    contract as ``frontier_finish_plain``, in one kernel launch.  On the
    card every input already lies on the accumulator's device in the
    kernel's types (``gain_params``; bool masks are read as bytes; slots
    int64), so a call converts nothing and never waits for the card.  The
    kernel writes the best splits into ``FinishOut`` arrays only: without
    ``out`` the dense record is assembled from ``dense_out`` arrays."""
    if acc.device.type == "cpu":
        return frontier_finish_plain(acc, mode, cbits, hbits, parent_hist,
                                     small_left, gains, out=out,
                                     out_slots=out_slots,
                                     parent_slot=parent_slot)
    if acc.device.type != "cuda":
        raise ValueError(f"no kernel for device {acc.device}")
    dev = acc.device
    _check("acc", acc, torch.int32, dev)
    C, N, F, B = acc.shape
    if C != _CHANNELS[mode] or not 2 <= B <= 256:
        raise ValueError(f"acc {tuple(acc.shape)} does not fit layout "
                         f"{mode!r} / 2 <= bins <= 256")
    if N > 65535:    # one grid row per parent
        raise ValueError(f"frontier_finish takes at most 65535 parents, "
                         f"got {N}")
    if parent_slot is not None and (out is None or parent_hist is not None
                                    or N != 1):
        raise ValueError("parent_slot reads the parent from out.hist: it "
                         "needs out, no parent_hist, and one parent")
    if out is not None and gains is None:
        raise ValueError("out needs gains")
    subtract = parent_hist is not None or parent_slot is not None
    n_out = 2 * N if subtract else N
    parent_p = sl_p = pslot_p = None
    if subtract:
        if parent_hist is not None:
            _check("parent_hist", parent_hist, torch.int32, dev,
                   (N, F, B, 3))
            parent_p = parent_hist.data_ptr()
        if small_left is None:
            raise ValueError("subtract mode needs small_left of shape (N,)")
        _check("small_left", small_left, _BYTES, dev, (N,))
        sl_p = small_left.data_ptr()
    record = out is None and gains is not None
    if record:
        out = dense_out(n_out, F, B, dev)
    if out is None:     # histograms only
        hist = torch.empty((n_out, F, B, 3), dtype=torch.int32, device=dev)
        hist_i16, slots, arrays = 0, (None, None), (None,) * 5
    else:
        hist = out.hist
        hist_i16, slots, arrays = _out_pointers(out, F, B, n_out, out_slots,
                                                dev)
        if parent_slot is not None:
            pslot_p = _slot("parent_slot", parent_slot, dev)
            parent_p = hist.data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    Fb = _finish_plan(N, F, _num_sms(dev.index))
    scales_p = fmask_p = edge_p = dok_p = counter_p = scratch_p = None
    l1 = l2 = min_data = min_hess = 0.0
    if gains is not None:
        _check("scales", gains.scales, torch.float32, dev, (2,))
        _check("feat_mask", gains.feat_mask, _BYTES, dev, (F,))
        _check("edge_ok", gains.edge_ok, _BYTES, dev, (F, B))
        scales_p, fmask_p, edge_p = (gains.scales.data_ptr(),
                                     gains.feat_mask.data_ptr(),
                                     gains.edge_ok.data_ptr())
        if gains.depth_ok is not None:
            _check("depth_ok", gains.depth_ok, _BYTES, dev, (1,))
            dok_p = gains.depth_ok.data_ptr()
        l1, l2 = float(gains.l1), float(gains.l2)
        min_data, min_hess = float(gains.min_data), float(gains.min_hess)
        counter, scratch = _finish_buffers(dev, stream,
                                           n_out * -(-F // Fb))
        counter_p, scratch_p = counter.data_ptr(), scratch.data_ptr()
    lib = _library()
    err = lib.frontier_finish_launch(
        acc.data_ptr(), N, F, B, _MODE_CODE[mode], cbits, hbits, parent_p,
        hist_i16 if parent_slot is not None else 0, pslot_p, sl_p,
        hist.data_ptr(), hist_i16, *slots, scales_p, fmask_p, edge_p, dok_p,
        l1, l2, min_data, min_hess, *arrays, scratch_p, counter_p, Fb, stream)
    if err != 0:
        _finish_state.pop((dev.index, stream), None)
    _raise_on(err, "frontier_finish", lib)
    frontier_finish.launches += 1
    if record:
        return hist, _record(out)
    return (hist, None) if out is None else None


hist_accumulate.launches = 0
frontier_finish.launches = 0


def launch_counts() -> dict:
    """Launches of each kernel since the last reset."""
    return {"hist_accumulate": hist_accumulate.launches,
            "frontier_finish": frontier_finish.launches}


def reset_launch_counts() -> None:
    hist_accumulate.launches = 0
    frontier_finish.launches = 0


# ---------------------------------------------------------------------------
# public entries (the JAX module's names)
# ---------------------------------------------------------------------------

def _require_supported(num_bins: int, quant_bins: int) -> None:
    if not supported(num_bins, quant_bins):
        raise ValueError(f"cuda histogram kernels support 2 <= num_bins <= "
                         f"256 and quant_bins <= 128, got ({num_bins}, "
                         f"{quant_bins})")


def to_int8(q) -> torch.Tensor:
    """Quantized gradients in the kernel's type: |qg| <= 64 and
    0 <= qh <= 127 up to 128 quant bins, so the cast is exact."""
    return q.to(torch.int8).contiguous()


def build_histograms_cuda(binned, qg, qh, node_ids, num_nodes: int,
                          num_bins: int, quant_bins: int = 16,
                          node_rows_bound: Optional[int] = None,
                          max_rows: Optional[int] = None) -> torch.Tensor:
    """Quantized histogram builder on the two kernels (``hist_accumulate``,
    then ``frontier_finish`` with gains off) — the counterpart of
    ``build_histograms_pallas``.  Same contract as
    ``ops.histogram.build_histograms_quantized``: ``(num_nodes, F, B, 3)``
    int32, bit-identical to it.  No node cap."""
    _require_supported(num_bins, quant_bins)
    n = binned.shape[0]
    bound = max(1, min(n, int(node_rows_bound or n), int(max_rows or n)))
    layout = lane_layout(n, bound, quant_bins)
    acc = hist_accumulate(binned, to_int8(qg), to_int8(qh),
                          node_ids.to(torch.int32), num_nodes, num_bins,
                          layout)
    hist, _ = frontier_finish(acc, *layout)
    return hist


def frontier_step(binned, qg, qh, node_ids, num_nodes: int, num_bins: int,
                  gains: GainParams, *, quant_bins: int = 16,
                  parent_hist=None, small_left=None,
                  node_rows_bound: Optional[int] = None,
                  out: Optional[FinishOut] = None, out_slots=None,
                  parent_slot=None):
    """``fused_frontier`` on inputs already in the kernels' types (int8
    ``qg``/``qh`` from ``to_int8``, int32 ``node_ids``, ``gains`` from
    ``gain_params``): the growers' per-level or per-step call, whose
    conversions are made once per tree.  Returns ``(hist, (best_gain,
    best_feat, best_bin, left_stats, node_totals))`` with int32 features
    and bins; with ``out`` (and ``out_slots`` / ``parent_slot``, see
    ``frontier_finish_plain``) it writes into those arrays and returns
    None."""
    _require_supported(num_bins, quant_bins)
    n = binned.shape[0]
    bound = max(1, min(n, int(node_rows_bound or n)))
    layout = lane_layout(n, bound, quant_bins)
    acc = hist_accumulate(binned, qg, qh, node_ids, num_nodes, num_bins,
                          layout)
    dense = out is None
    if dense:
        out = dense_out(num_nodes * (1 if parent_hist is None else 2),
                        binned.shape[1], num_bins, binned.device)
    frontier_finish(acc, *layout, parent_hist, small_left, gains, out=out,
                    out_slots=out_slots, parent_slot=parent_slot)
    return (out.hist, tuple(out[1:])) if dense else None


def fused_frontier(binned, qg, qh, node_ids, num_nodes: int, num_bins: int,
                   g_scale, h_scale, feat_mask, edge_ok, *,
                   quant_bins: int = 16, l1: float = 0.0, l2: float = 0.0,
                   min_data: float = 0.0, min_hess: float = 0.0,
                   parent_hist=None, small_left=None, depth_ok=None,
                   node_rows_bound: Optional[int] = None):
    """One fused frontier step: histogram build (+ integer sibling
    subtraction against ``parent_hist``) feeding the split-gain scan.

    Modes as in the JAX package: **direct** (``parent_hist=None``) builds
    ``num_nodes`` histograms; **subtract** (``parent_hist`` =
    ``(num_nodes, F, B, 3)`` int32, ``small_left`` = ``(num_nodes,)``
    bool) reads ``node_ids`` as each parent's SMALLER child and emits both
    children interleaved.  ``depth_ok`` gates every candidate.  Returns
    ``(hist, (best_gain, best_feat, best_bin, left_stats, node_totals))``."""
    dev = binned.device
    gains = gain_params(g_scale, h_scale, feat_mask, edge_ok, depth_ok,
                        l1=l1, l2=l2, min_data=min_data, min_hess=min_hess,
                        device=dev)
    if parent_hist is not None:
        parent_hist = parent_hist.to(torch.int32)
        small_left = torch.as_tensor(small_left, device=dev) \
            .to(torch.bool).contiguous()
    return frontier_step(binned, to_int8(qg), to_int8(qh),
                         node_ids.to(torch.int32), num_nodes, num_bins,
                         gains, quant_bins=quant_bins,
                         parent_hist=parent_hist, small_left=small_left,
                         node_rows_bound=node_rows_bound)
