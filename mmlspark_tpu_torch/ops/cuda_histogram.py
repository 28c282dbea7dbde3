"""Fused GBDT frontier step on Hopper — the counterpart of
``mmlspark_tpu/ops/pallas_histogram.py``.

The TPU kernel (one ``pl.pallas_call`` in ``_frontier``) accumulates
packed-lane integer histograms over a sequential row-tile grid, then in its
last grid step decodes the lanes, subtracts the smaller child from its
parent in exact int32 and scans split gains.  Its two accumulation modes
exist only because Mosaic has no vector scatter.  Hopper has shared-memory
atomics, so the port is two hand-written CUDA kernels
(``csrc/frontier.cu``), one per half:

- ``hist_accumulate`` — packed int32 lanes summed per (node, feature, bin):
  a shared-memory accumulator per block, merged into device memory with
  atomics.  Integer addition is associative, so the sums are bit-identical
  in any order.  Bound by bytes: the binned matrix is read once per step.
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

#: dynamic shared memory one ``hist_accumulate`` block may take: two blocks
#: fit on one SM's 227 KB, so one block's atomics overlap another's merge
_SMEM_BUDGET = 96 * 1024
_RECORD = 8  # floats per (node, feature) in frontier_finish's scratch


def supported(num_bins: int, quant_bins: int = 16) -> bool:
    """The kernels take 2 <= num_bins <= 256 (one warp scans a feature's
    bins from shared memory) and quant_bins <= 128."""
    return 2 <= num_bins <= 256 and 2 <= quant_bins <= 128


class GainParams(NamedTuple):
    """Inputs of the gain scan (``frontier_finish`` with gains on)."""
    g_scale: torch.Tensor       # 0-d float32
    h_scale: torch.Tensor       # 0-d float32
    feat_mask: torch.Tensor     # (F,) bool
    edge_ok: torch.Tensor       # (F, B) bool
    depth_ok: Optional[torch.Tensor] = None   # 0-d bool or None
    l1: float = 0.0
    l2: float = 0.0
    min_data: float = 0.0
    min_hess: float = 0.0


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def hist_accumulate_plain(binned: torch.Tensor, lanes: torch.Tensor,
                          node_ids: torch.Tensor, num_nodes: int,
                          num_bins: int) -> torch.Tensor:
    """``(C, n)`` int32 lanes summed per (node, feature, bin) over rows with
    ``node >= 0`` -> ``(C, N, F, B)`` int32."""
    F = binned.shape[1]
    sums = _scatter_rows(binned, node_ids, list(lanes), num_nodes, num_bins)
    return torch.stack(sums).reshape(lanes.shape[0], num_nodes, F, num_bins)


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
    gsc, hsc = gains.g_scale, gains.h_scale
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
        ok = ok & gains.depth_ok.to(torch.bool)
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

def _check(name: str, t: torch.Tensor, dtype, dev) -> None:
    if t.device != dev:
        raise ValueError(f"{name} must lie on {dev}, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


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


def _accumulate_plan(n: int, F: int, N: int, C: int, B: int, num_sms: int):
    """(feature group, node group, rows per block, row chunks): a block's
    shared accumulator ``C x Ng x Fg x B`` int32 stays within the budget,
    node groups cover every N, and row chunks make about 4 blocks per SM
    (at least 2048 rows each, so a block's merge stays small beside its
    row work)."""
    per_cell = C * B * 4
    Ng = max(1, min(N, _SMEM_BUDGET // per_cell))
    Fg = max(1, min(F, _SMEM_BUDGET // (per_cell * Ng)))
    blocks_xy = -(-F // Fg) * -(-N // Ng)
    chunks = max(1, min(-(-n // 2048), -(-4 * num_sms // blocks_xy), 65535))
    row_chunk = max(1, -(-n // chunks))
    return Fg, Ng, row_chunk, -(-max(n, 1) // row_chunk)


def _library():
    from ..kernels._build import load_library
    return load_library()


def _raise_on(err: int, name: str, lib) -> None:
    if err != 0:
        msg = lib.frontier_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {err} ({msg})")


def hist_accumulate(binned: torch.Tensor, lanes: torch.Tensor,
                    node_ids: torch.Tensor, num_nodes: int,
                    num_bins: int) -> torch.Tensor:
    """Replaces the accumulation half of ``_make_kernel``
    (``mmlspark_tpu/ops/pallas_histogram.py:199-238``).  Returns
    ``(C, N, F, B)`` int32 lane sums.  ``binned`` values must be below
    ``num_bins`` (the BinMapper's contract)."""
    if binned.device.type == "cpu":
        return hist_accumulate_plain(binned, lanes, node_ids, num_nodes,
                                     num_bins)
    if binned.device.type != "cuda":
        raise ValueError(f"no kernel for device {binned.device}")
    dev = binned.device
    n, F = binned.shape
    C = lanes.shape[0]
    N, B = int(num_nodes), int(num_bins)
    if binned.dtype != torch.uint8:
        raise TypeError(f"binned must be uint8, got {binned.dtype}")
    if not 2 <= B <= 256 or C not in (1, 2, 3) or N < 1:
        raise ValueError(f"unsupported shape: bins={B} lanes={C} nodes={N}")
    _check("lanes", lanes, torch.int32, dev)
    _check("node_ids", node_ids, torch.int32, dev)
    if tuple(lanes.shape) != (C, n) or tuple(node_ids.shape) != (n,):
        raise ValueError(f"lanes {tuple(lanes.shape)} / node_ids "
                         f"{tuple(node_ids.shape)} do not match {n} rows")
    s_row, s_feat = _binned_strides(binned)
    acc = torch.zeros((C, N, F, B), dtype=torch.int32, device=dev)
    if n == 0:
        return acc
    num_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    Fg, Ng, row_chunk, chunks = _accumulate_plan(n, F, N, C, B, num_sms)
    lib = _library()
    err = lib.hist_accumulate_launch(
        binned.data_ptr(), s_row, s_feat, lanes.data_ptr(),
        node_ids.data_ptr(), acc.data_ptr(), n, F, B, N, C, Fg, Ng,
        row_chunk, chunks, torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "hist_accumulate", lib)
    hist_accumulate.launches += 1
    return acc


def frontier_finish(acc: torch.Tensor, mode: str, cbits: int, hbits: int,
                    parent_hist=None, small_left=None,
                    gains: Optional[GainParams] = None):
    """Replaces the ``_finish`` epilogue of ``_make_kernel`` and the
    cross-feature-block reduction of ``_frontier``
    (``mmlspark_tpu/ops/pallas_histogram.py:240-300, 424-429``).  Same
    contract as ``frontier_finish_plain``."""
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
        _check("parent_hist", parent_hist, torch.int32, dev)
        if tuple(parent_hist.shape) != (N, F, B, 3):
            raise ValueError(f"parent_hist must be {(N, F, B, 3)}, got "
                             f"{tuple(parent_hist.shape)}")
        if small_left is None or tuple(small_left.shape) != (N,):
            raise ValueError("subtract mode needs small_left of shape (N,)")
        small_left = small_left.to(device=dev, dtype=torch.uint8) \
            .contiguous()
        parent_p, sl_p = parent_hist.data_ptr(), small_left.data_ptr()
    hist = torch.empty((n_out, F, B, 3), dtype=torch.int32, device=dev)
    best = None
    scales_p = fmask_p = edge_p = dok_p = rec_p = best_p = None
    l1 = l2 = min_data = min_hess = 0.0
    if gains is not None:
        scales = torch.stack([
            torch.as_tensor(gains.g_scale, device=dev).reshape(()),
            torch.as_tensor(gains.h_scale, device=dev).reshape(())]) \
            .to(torch.float32)
        fmask = gains.feat_mask.to(device=dev, dtype=torch.uint8) \
            .contiguous()
        edge = gains.edge_ok.to(device=dev, dtype=torch.uint8).contiguous()
        if tuple(fmask.shape) != (F,) or tuple(edge.shape) != (F, B):
            raise ValueError("feat_mask must be (F,) and edge_ok (F, B)")
        scales_p, fmask_p, edge_p = (scales.data_ptr(), fmask.data_ptr(),
                                     edge.data_ptr())
        if gains.depth_ok is not None:
            dok = torch.as_tensor(gains.depth_ok, device=dev) \
                .to(torch.uint8).reshape(1)
            dok_p = dok.data_ptr()
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

def pack(qg, qh, n: int, bound: int, quant_bins: int):
    """(lanes ``(C, n)`` int32, mode, cbits, hbits) for a node-row bound."""
    _check_overflow(n, quant_bins)
    mode, cbits, hbits = _packed_layout(bound, quant_bins)
    lanes = torch.stack(_pack_lanes(qg, qh, mode, cbits, hbits))
    return lanes, mode, cbits, hbits


def _require_supported(num_bins: int, quant_bins: int) -> None:
    if not supported(num_bins, quant_bins):
        raise ValueError(f"cuda histogram kernels support 2 <= num_bins <= "
                         f"256 and quant_bins <= 128, got ({num_bins}, "
                         f"{quant_bins})")


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
    lanes, mode, cbits, hbits = pack(qg, qh, n, bound, quant_bins)
    acc = hist_accumulate(binned, lanes, node_ids.to(torch.int32),
                          num_nodes, num_bins)
    hist, _ = frontier_finish(acc, mode, cbits, hbits)
    return hist


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
    _require_supported(num_bins, quant_bins)
    n = binned.shape[0]
    bound = max(1, min(n, int(node_rows_bound or n)))
    lanes, mode, cbits, hbits = pack(qg, qh, n, bound, quant_bins)
    acc = hist_accumulate(binned, lanes, node_ids.to(torch.int32),
                          num_nodes, num_bins)
    dev = binned.device
    gains = GainParams(
        g_scale=torch.as_tensor(g_scale, dtype=torch.float32, device=dev),
        h_scale=torch.as_tensor(h_scale, dtype=torch.float32, device=dev),
        feat_mask=feat_mask, edge_ok=edge_ok,
        depth_ok=None if depth_ok is None else torch.as_tensor(
            depth_ok, dtype=torch.bool, device=dev),
        l1=float(l1), l2=float(l2), min_data=float(min_data),
        min_hess=float(min_hess))
    if parent_hist is not None:
        parent_hist = parent_hist.to(torch.int32)
    hist, best = frontier_finish(acc, mode, cbits, hbits, parent_hist,
                                 small_left, gains)
    return hist, (best[:, 0], best[:, 1].to(torch.int32),
                  best[:, 2].to(torch.int32), best[:, 3:6], best[:, 6:9])
