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
- ``frontier_finish`` — decode, optional sibling subtraction, and (with
  gains) the dequantize -> f32 bin scan -> gain -> gates -> first-max
  argmax, one warp per (node, feature), then a per-node reduction over
  features.  Bound by bytes: the lane sums and histograms.

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
_RECORD = 8  # floats per (node, feature) in frontier_finish's scratch


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
                          gains: Optional[GainParams] = None):
    """Decode ``(C, N, F, B)`` lane sums; in subtract mode emit both
    children of each parent interleaved ``(2N, F, B, 3)`` (child ``2k`` is
    the small one iff ``small_left[k]``); with ``gains`` also return the
    per-node best split ``(N_out, 9)`` float32 record
    ``[gain, feature, bin, GL, HL, CL, G, H, C]``."""
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


def frontier_finish(acc: torch.Tensor, mode: str, cbits: int, hbits: int,
                    parent_hist=None, small_left=None,
                    gains: Optional[GainParams] = None):
    """Replaces the ``_finish`` epilogue of ``_make_kernel`` and the
    cross-feature-block reduction of ``_frontier``
    (``mmlspark_tpu/ops/pallas_histogram.py:240-300, 424-429``).  Same
    contract as ``frontier_finish_plain``.  On the card every input already
    lies on the accumulator's device in the kernel's types (``gain_params``;
    bool masks are read as bytes), so a call converts nothing."""
    if acc.device.type == "cpu":
        return frontier_finish_plain(acc, mode, cbits, hbits, parent_hist,
                                     small_left, gains)
    if acc.device.type != "cuda":
        raise ValueError(f"no kernel for device {acc.device}")
    dev = acc.device
    _check("acc", acc, torch.int32, dev)
    C, N, F, B = acc.shape
    if C != _CHANNELS[mode] or not 2 <= B <= 256:
        raise ValueError(f"acc {tuple(acc.shape)} does not fit layout "
                         f"{mode!r} / 2 <= bins <= 256")
    subtract = parent_hist is not None
    n_out = 2 * N if subtract else N
    if n_out > 65535:    # one grid row per output node
        raise ValueError(f"frontier_finish takes at most 65535 output "
                         f"nodes, got {n_out}")
    parent_p = sl_p = None
    if subtract:
        _check("parent_hist", parent_hist, torch.int32, dev, (N, F, B, 3))
        if small_left is None:
            raise ValueError("subtract mode needs small_left of shape (N,)")
        _check("small_left", small_left, _BYTES, dev, (N,))
        parent_p, sl_p = parent_hist.data_ptr(), small_left.data_ptr()
    hist = torch.empty((n_out, F, B, 3), dtype=torch.int32, device=dev)
    best = None
    scales_p = fmask_p = edge_p = dok_p = rec_p = best_p = None
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
        record = torch.empty((n_out, F, _RECORD), dtype=torch.float32,
                             device=dev)
        best = torch.empty((n_out, 9), dtype=torch.float32, device=dev)
        rec_p, best_p = record.data_ptr(), best.data_ptr()
        l1, l2 = float(gains.l1), float(gains.l2)
        min_data, min_hess = float(gains.min_data), float(gains.min_hess)
    lib = _library()
    err = lib.frontier_finish_launch(
        acc.data_ptr(), N, F, B, _MODE_CODE[mode], cbits, hbits, parent_p,
        sl_p, hist.data_ptr(), n_out, scales_p, fmask_p, edge_p, dok_p, l1,
        l2, min_data, min_hess, rec_p, best_p,
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "frontier_finish", lib)
    frontier_finish.launches += 1
    return hist, best


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
                  node_rows_bound: Optional[int] = None):
    """``fused_frontier`` on inputs already in the kernels' types (int8
    ``qg``/``qh`` from ``to_int8``, int32 ``node_ids``, ``gains`` from
    ``gain_params``): the growers' per-level call, whose conversions are
    made once per tree."""
    _require_supported(num_bins, quant_bins)
    n = binned.shape[0]
    bound = max(1, min(n, int(node_rows_bound or n)))
    layout = lane_layout(n, bound, quant_bins)
    acc = hist_accumulate(binned, qg, qh, node_ids, num_nodes, num_bins,
                          layout)
    hist, best = frontier_finish(acc, *layout, parent_hist, small_left,
                                 gains)
    return hist, (best[:, 0], best[:, 1].to(torch.int32),
                  best[:, 2].to(torch.int32), best[:, 3:6], best[:, 6:9])


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
