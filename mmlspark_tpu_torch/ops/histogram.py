"""Gradient-histogram builds — the GBDT hot path (port of
``mmlspark_tpu/ops/histogram.py``, the single-shard subset).

Layout as in the JAX package: a histogram tensor is ``(nodes, features,
bins, 3)`` holding ``(sum_grad, sum_hess, count)``; quantized histograms
hold the same three channels as exact int32 sums of the quantized
gradients.

What is here:

- ``build_histograms`` — the float path (CPU default, ``use_quantized_grad``
  off), an ``index_add_`` over a flattened (node, feature, bin) index;
- ``quantize_gradients`` / ``dequantize_histogram`` — LightGBM 4.x
  quantized training, single-shard; ``row_noise`` — its counter-based
  rounding noise, a pure function of (seed, mix, global row, channel);
- ``_packed_layout`` / ``_pack_lanes`` / ``_unpack_lanes`` — the packed
  int32 lane plan, copied as integer code: the bit-exactness contract with
  the JAX package and with the CUDA kernels rides on them;
- ``build_histograms_quantized`` — the plain packed-lane scatter build;
- ``build_quantized`` — the dispatcher: a CUDA tensor goes to the Hopper
  kernels (``ops.cuda_histogram``), a CPU tensor to the plain build;
- ``bin_matrix`` — the twin of the JAX ``bin_matrix`` (XLA, not Pallas):
  digitize raw features on the tensor's device; ``apply_bins`` and
  ``category_bins`` — the host routes' bins on the device, feature-major,
  for ``BinMapper.bin_on_device``.
"""
from __future__ import annotations

from typing import Optional

import torch


_FLT_MAX = torch.finfo(torch.float32).max


def _search_fm(table: torch.Tensor, xt: torch.Tensor) -> torch.Tensor:
    """Per feature, the count of ``table[f]`` entries below each value of
    ``xt[f]``: ``(F, n)`` int32.  ``table`` rows must be ascending."""
    return torch.searchsorted(table.contiguous(), xt, side="left",
                              out_int32=True)


def bin_matrix(x: torch.Tensor, edges: torch.Tensor,
               num_bins: int) -> torch.Tensor:
    """Digitize raw features on ``x``'s device: bin = #edges < x, NaN -> 0,
    ``(n, F)`` uint8 — the twin of the JAX ``bin_matrix``
    (``mmlspark_tpu/ops/histogram.py:96-111``, a vmapped
    ``jnp.searchsorted(side="left")``).  ``edges`` is ``(F, num_bins - 1)``
    ascending with +inf padding.  jnp's search orders NaN above +inf, so a
    NaN edge is below no value: it searches here as +inf."""
    table = torch.where(torch.isnan(edges), torch.inf, edges)
    xt = x.t().contiguous()
    bins = torch.where(torch.isnan(xt), 0, _search_fm(table, xt))
    return bins.to(torch.uint8).t().contiguous()


def apply_bins(x: torch.Tensor, table: torch.Tensor,
               nan_to_num: bool) -> torch.Tensor:
    """The numerical bins of a host transform route, on ``x``'s device, as
    the feature-major ``(F, n)`` uint8 matrix: ``table`` is the route's
    ascending edge table (``BinMapper.route_table``).  The C++ route maps
    NaN to bin 0; the numpy route (``nan_to_num``) first maps NaN to
    ``-inf`` and ``±inf`` to ``±FLT_MAX``, as ``np.nan_to_num`` does."""
    xt = x.t().contiguous()
    if nan_to_num:
        xt = torch.nan_to_num(xt, nan=-_FLT_MAX, posinf=_FLT_MAX,
                              neginf=-_FLT_MAX)
        bins = _search_fm(table, xt)
    else:
        bins = torch.where(torch.isnan(xt), 0, _search_fm(table, xt))
    return bins.to(torch.uint8)


def category_bins(x: torch.Tensor, num_bins: int):
    """Code bins of categorical columns ``x`` (``(n, k)``), feature-major
    ``(k, n)`` uint8: NaN -> ``num_bins - 1``, then ``round`` and ``clip``
    to ``[0, num_bins - 1]`` (``BinMapper._overwrite_cat_bins``).  Also
    returns each column's smallest non-NaN value, which the caller checks
    for negative codes."""
    xt = x.t()
    nan = torch.isnan(xt)
    low = torch.where(nan, torch.inf, xt).amin(dim=1)
    codes = torch.where(nan, float(num_bins - 1), xt)
    return torch.clamp(torch.round(codes), 0, num_bins - 1) \
        .to(torch.uint8), low


def _row_chunk(n: int, F: int) -> int:
    # the JAX builders' chunk rule: the (chunk, F) index intermediate stays
    # ~8M entries instead of materialising n*F int64 indices
    return max(1024, min(max(n, 1), (1 << 23) // max(F, 1)))


def _scatter_rows(binned: torch.Tensor, node_ids: torch.Tensor,
                  values, num_nodes: int, num_bins: int) -> list:
    """Sum each ``values[k]`` (per-row, ``(n,)``) into ``(N*F*B,)`` cells
    addressed by (node, feature, bin); rows with ``node < 0`` are dropped.
    Exact for integer values in any order."""
    n, F = binned.shape
    B = num_bins
    S = num_nodes * F * B
    dev = binned.device
    accs = [torch.zeros(S + 1, dtype=v.dtype, device=dev) for v in values]
    f_idx = torch.arange(F, device=dev, dtype=torch.int64)[None, :]
    chunk = _row_chunk(n, F)
    for lo in range(0, n, chunk):
        hi = min(n, lo + chunk)
        node = node_ids[lo:hi].to(torch.int64)
        seg = (node[:, None] * F + f_idx) * B + binned[lo:hi].to(torch.int64)
        seg = torch.where(node[:, None] >= 0, seg, S).reshape(-1)
        for acc, v in zip(accs, values):
            acc.index_add_(0, seg, v[lo:hi, None].expand(-1, F).reshape(-1))
    return [a[:S] for a in accs]


def build_histograms(binned: torch.Tensor, grad: torch.Tensor,
                     hess: torch.Tensor, node_ids: torch.Tensor,
                     num_nodes: int, num_bins: int,
                     sample_weight: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """Float histograms for every (node, feature, bin) cell in one pass.
    Returns ``(num_nodes, F, num_bins, 3)`` float32 sums of grad, hess and
    count.  The summation order differs from the JAX segment-sum, so float
    results agree to rounding only."""
    g = grad.to(torch.float32)
    h = hess.to(torch.float32)
    c = torch.ones_like(g)  # counts stay unweighted (min_data_in_leaf)
    if sample_weight is not None:
        g, h = g * sample_weight, h * sample_weight
    gs, hs, cs = _scatter_rows(binned, node_ids, (g, h, c), num_nodes,
                               num_bins)
    F = binned.shape[1]
    return torch.stack([gs, hs, cs], dim=-1).reshape(num_nodes, F,
                                                     num_bins, 3)


# ---------------------------------------------------------------------------
# quantized-gradient packed histograms (LightGBM 4.x quantized training)
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**32`` for int64 ``x`` in ``[0, 2**32)``: the product
    is split at 16 bits, so no intermediate leaves int64 and every device
    computes the same bits."""
    lo, hi = x & 0xFFFF, x >> 16
    return (lo * c + ((hi * (c & 0xFFFF)) << 16)) & _M32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    """MurmurHash3's 32-bit finalizer on int64 tensors in ``[0, 2**32)``."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def _fmix32_int(h: int) -> int:
    h &= _M32
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & _M32
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & _M32
    return h ^ (h >> 16)


def row_noise(row_ids: torch.Tensor, seed: int, mix: int = 0) -> torch.Tensor:
    """The quantizer's uniforms keyed on each row's GLOBAL id: ``(2, n)``
    float32 in ``[0, 1)``, channel 0 for the gradient and 1 for the
    hessian.  ``u = fmix32(fmix32(row) ^ key(seed, mix, channel))``, scaled
    from its top 24 bits, in integer ops only: a row draws the same
    uniforms under any tiling, on the CPU and on the card alike (the role
    of the JAX package's ``fold_in(key, row_id)``, with other bits)."""
    r = _fmix32(row_ids.to(torch.int64) & _M32)
    base = _fmix32_int(_fmix32_int(int(seed)) ^ (int(mix) & _M32))
    h = _fmix32(torch.stack([
        r ^ _fmix32_int(base ^ (0x9E3779B9 * (c + 1) & _M32))
        for c in (0, 1)]))
    return (h >> 8).to(torch.float32) * (1.0 / (1 << 24))


def quantize_gradients(grad: torch.Tensor, hess: torch.Tensor,
                       quant_bins: int, *,
                       generator: Optional[torch.Generator] = None,
                       noise: Optional[torch.Tensor] = None,
                       g_scale=None, h_scale=None,
                       row_ids: Optional[torch.Tensor] = None,
                       seed: int = 0, mix: int = 0):
    """Stochastically round per-row grad/hess to small ints (single shard).

    Returns ``(qg, qh, g_scale, h_scale)``: ``qg`` int32 in
    ``[-quant_bins//2, quant_bins//2]``, ``qh`` int32 in
    ``[0, quant_bins - 1]``, scales as 0-d float32 tensors, with
    ``qg = clip(floor(g / g_scale + u))`` — the same scales, caps and
    rounding as ``mmlspark_tpu.ops.histogram.quantize_gradients``.

    The uniforms ``u`` come from ``noise`` (``(2, n)`` float32, so a test
    can hand both packages the same numbers), else from ``row_ids`` (each
    row's global id: ``row_noise(row_ids, seed, mix)``, the out-of-core
    driver's form, the same under any tile width), else from
    ``generator``.  The JAX package keys its noise on a float bitcast of
    the gradient sum or on threefry bits, which this package does not
    reproduce, so the two packages agree bit for bit only when given the
    same uniforms."""
    g = grad.to(torch.float32)
    h = hess.to(torch.float32)
    qg_cap = max(1, quant_bins // 2)
    qh_cap = max(1, quant_bins - 1)
    if (g_scale is None) != (h_scale is None):
        raise ValueError("pass both g_scale and h_scale or neither")
    if g_scale is None:
        # divide by device tensors: CUDA divides by a host scalar through
        # its reciprocal, one ulp away from the true division of the CPU
        # and of the JAX package
        def cap(c):
            return torch.full((), float(c), dtype=torch.float32,
                              device=g.device)
        g_scale = torch.clamp(g.abs().max(), min=1e-12) / cap(qg_cap)
        h_scale = torch.clamp(h.max(), min=1e-12) / cap(qh_cap)
    else:
        g_scale = torch.clamp(torch.as_tensor(g_scale, dtype=torch.float32,
                                              device=g.device), min=1e-30)
        h_scale = torch.clamp(torch.as_tensor(h_scale, dtype=torch.float32,
                                              device=g.device), min=1e-30)
    if noise is None and row_ids is not None:
        noise = row_noise(row_ids, seed, mix)
    if noise is None:
        if generator is None:
            raise ValueError("quantize_gradients needs a generator or noise")
        noise = torch.rand((2,) + tuple(g.shape), generator=generator,
                           device=g.device, dtype=torch.float32)
    elif tuple(noise.shape) != (2,) + tuple(g.shape):
        raise ValueError(f"noise must have shape (2, {g.shape[0]}), got "
                         f"{tuple(noise.shape)}")
    u = noise.to(device=g.device, dtype=torch.float32)
    qg = torch.clamp(torch.floor(g / g_scale + u[0]),
                     -qg_cap, qg_cap).to(torch.int32)
    qh = torch.clamp(torch.floor(h / h_scale + u[1]),
                     0, qh_cap).to(torch.int32)
    return qg, qh, g_scale, h_scale


def dequantize_histogram(hist_i32: torch.Tensor, g_scale, h_scale
                         ) -> torch.Tensor:
    """(..., 3) int32 [sum_qg, sum_qh, count] -> (..., 3) f32
    [sum_grad, sum_hess, count] — the rescale applied at split-gain time."""
    f = hist_i32.to(torch.float32)
    return torch.stack([f[..., 0] * g_scale, f[..., 1] * h_scale,
                        f[..., 2]], dim=-1)


def _packed_layout(bound: int, quant_bins: int):
    """Static lane plan for the int32 accumulation (integer code copied
    from the JAX package).

    ``bound`` is the max rows any single (node, feature, bin) cell can
    receive (== max rows per node).  The widest layout that still fits 31
    bits wins:

    - ``all3``: grad, hess AND count share ONE int32 channel;
    - ``2ch``: grad alone + (hess, count) packed in the hessian lane;
    - ``wide``: three separate int32 channels.
    """
    qg_cap = max(1, quant_bins // 2)
    qh_cap = max(1, quant_bins - 1)
    cbits = bound.bit_length()
    hbits = (bound * qh_cap).bit_length()
    gbits = (bound * qg_cap).bit_length()
    if cbits + hbits + gbits <= 31:
        return "all3", cbits, hbits
    if cbits + hbits <= 31:
        return "2ch", cbits, hbits
    return "wide", cbits, hbits


def _pack_lanes(qg: torch.Tensor, qh: torch.Tensor, mode: str, cbits: int,
                hbits: int) -> list:
    """Per-row packed int32 weight channels for a ``_packed_layout`` plan.
    One definition shared by the plain build and the CUDA kernel's
    wrapper: both sides pack (and ``_unpack_lanes`` decodes) identically."""
    KC, KH = 1 << cbits, 1 << hbits
    qg = qg.to(torch.int32)
    qh = qh.to(torch.int32)
    if mode == "all3":
        return [((qg * KH) + qh) * KC + 1]
    if mode == "2ch":
        return [qg, qh * KC + 1]
    return [qg, qh, torch.ones_like(qg)]


def _unpack_lanes(acc, mode: str, cbits: int, hbits: int):
    """Decode accumulated packed-lane sums -> ``(qg_sum, qh_sum, count)``.
    The lane terms are multiples of KC/KH, so FLOOR mod/div decode exactly,
    negative sums included (an all3 sum is negative whenever its qg sum
    is); torch spells floor as ``remainder`` and ``rounding_mode="floor"``."""
    KC, KH = 1 << cbits, 1 << hbits
    if mode == "all3":
        s = acc[0]
        count = torch.remainder(s, KC)
        s2 = torch.div(s - count, KC, rounding_mode="floor")
        qh_s = torch.remainder(s2, KH)
        qg_s = torch.div(s2 - qh_s, KH, rounding_mode="floor")
    elif mode == "2ch":
        qg_s = acc[0]
        count = torch.remainder(acc[1], KC)
        qh_s = torch.div(acc[1] - count, KC, rounding_mode="floor")
    else:
        qg_s, qh_s, count = acc[0], acc[1], acc[2]
    return qg_s, qh_s, count


def _check_overflow(n: int, quant_bins: int) -> None:
    qh_cap = max(1, quant_bins - 1)
    if n * qh_cap >= (1 << 31):
        raise ValueError("quantized histograms overflow int32 above "
                         f"{(1 << 31) // qh_cap} rows at {quant_bins} bins")


def build_histograms_quantized(binned: torch.Tensor, qg: torch.Tensor,
                               qh: torch.Tensor, node_ids: torch.Tensor,
                               num_nodes: int, num_bins: int,
                               quant_bins: int = 16,
                               node_rows_bound: Optional[int] = None,
                               max_rows: Optional[int] = None
                               ) -> torch.Tensor:
    """Packed-integer scatter build — the plain version the CPU runs.
    ``node_rows_bound`` is a caller guarantee on the max rows any node
    receives (a violated bound corrupts lanes, as in the JAX package).
    Returns ``(num_nodes, F, B, 3)`` int32 [sum_qg, sum_qh, count]."""
    n, F = binned.shape
    bound = max(1, min(n, int(node_rows_bound or n), int(max_rows or n)))
    _check_overflow(n, quant_bins)
    mode, cbits, hbits = _packed_layout(bound, quant_bins)
    chans = _pack_lanes(qg, qh, mode, cbits, hbits)
    acc = _scatter_rows(binned, node_ids, chans, num_nodes, num_bins)
    qg_s, qh_s, count = _unpack_lanes(acc, mode, cbits, hbits)
    return torch.stack([qg_s, qh_s, count], dim=-1).reshape(
        num_nodes, F, num_bins, 3)


def build_quantized(binned, qg, qh, node_ids, num_nodes, num_bins,
                    quant_bins: int = 16, max_rows=None,
                    node_rows_bound=None) -> torch.Tensor:
    """Quantized-build dispatcher (the JAX ``build_quantized`` with backend
    ``cuda`` in the place of ``pallas``): a CUDA tensor always goes to the
    Hopper kernels, at every node count; a CPU tensor always goes to the
    plain build.  Returns int32 ``(nodes, F, B, 3)``."""
    if binned.is_cuda:
        from . import cuda_histogram
        return cuda_histogram.build_histograms_cuda(
            binned, qg, qh, node_ids, num_nodes, num_bins,
            quant_bins=quant_bins, node_rows_bound=node_rows_bound,
            max_rows=max_rows)
    return build_histograms_quantized(
        binned, qg, qh, node_ids, num_nodes, num_bins,
        quant_bins=quant_bins, node_rows_bound=node_rows_bound,
        max_rows=max_rows)
