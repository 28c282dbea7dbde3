"""Gradient-histogram builds — the GBDT hot path (port of
``mmlspark_tpu/ops/histogram.py``).

Layout as in the JAX package: a histogram tensor is ``(nodes, features,
bins, 3)`` holding ``(sum_grad, sum_hess, count)``; quantized histograms
hold the same three channels as exact int32 sums of the quantized
gradients.

What is here:

- ``build_histograms`` — the float scatter build (CPU default,
  ``use_quantized_grad`` off), an ``index_add_`` over a flattened (node,
  feature, bin) index; ``histogram_subtraction`` — sibling = parent -
  child;
- ``quantize_gradients`` / ``dequantize_histogram`` — LightGBM 4.x
  quantized training, on one shard or, with ``axis_name``, on a rank of a
  row-sharded mesh; ``row_noise`` — its counter-based rounding noise, a
  pure function of (seed, mix, global row, channel); ``global_row_ids``
  — a shard's rows' global ids;
- ``_packed_layout`` / ``_pack_lanes`` / ``_unpack_lanes`` — the packed
  int32 lane plan, copied as integer code: the bit-exactness contract with
  the JAX package and with the CUDA kernels rides on them;
- ``build_histograms_quantized`` — the plain packed-lane scatter build;
- ``build_histograms_matmul`` / ``build_histograms_matmul_quantized`` —
  the JAX package's one-hot matmul builds over a node-pure block layout
  (``_node_pure_layout``, with the ``MMLSPARK_TPU_HIST_LAYOUT=cumsum``
  variant): float32 products of bfloat16-rounded channels, or of the
  quantized integers with each block's exact sum taken to int32, with
  TF32 off (``_device.float32_exact``);
- ``build_quantized`` / ``resolve_quantized_backend`` — the quantized
  dispatcher: ``cuda`` (the JAX package's ``pallas``; auto on a CUDA
  tensor) goes to the Hopper kernels (``ops.cuda_histogram``), ``scatter``
  (auto on a CPU tensor) and ``matmul`` to the builds above on the
  tensors' device; ``MMLSPARK_TPU_HIST_BACKEND`` overrides an ``auto``
  request only; ``build`` — the float dispatcher (auto: ``matmul`` on the
  card, ``scatter`` on the CPU, as the JAX package picks by platform);
- ``bin_matrix`` — the twin of the JAX ``bin_matrix`` (XLA, not Pallas):
  digitize raw features on the tensor's device; ``apply_bins`` and
  ``category_bins`` — the host routes' bins on the device, feature-major,
  for ``BinMapper.bin_on_device``.
"""
from __future__ import annotations

import operator
import os
from typing import Optional

import torch

from .._device import float32_exact
from ..observability.compute import instrumented_jit


_FLT_MAX = torch.finfo(torch.float32).max


def _search_fm(table: torch.Tensor, xt: torch.Tensor) -> torch.Tensor:
    """Per feature, the count of ``table[f]`` entries below each value of
    ``xt[f]``: ``(F, n)`` int32.  ``table`` rows must be ascending."""
    return torch.searchsorted(table.contiguous(), xt, side="left",
                              out_int32=True)


@instrumented_jit(name="ops.bin_matrix", static_argnames=("num_bins",),
                  inplace_argnums=(0,))
def bin_matrix(x: torch.Tensor, edges: torch.Tensor,
               num_bins: int) -> torch.Tensor:
    """Digitize raw features on ``x``'s device: bin = #edges < x, NaN -> 0,
    ``(n, F)`` uint8 — the twin of the JAX ``bin_matrix``
    (``mmlspark_tpu/ops/histogram.py:96-111``, a vmapped
    ``jnp.searchsorted(side="left")``).  ``edges`` is ``(F, num_bins - 1)``
    ascending with +inf padding.  jnp's search orders NaN above +inf, so a
    NaN edge is below no value: it searches here as +inf.  A compiled
    program, as the reference's: a CUDA graph per signature on the card
    (``observability.compute.instrumented_jit``), reading ``x`` in place
    (no second copy of a large matrix in the graph)."""
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


def histogram_subtraction(parent_hist: torch.Tensor,
                          child_hist: torch.Tensor) -> torch.Tensor:
    """Sibling trick: sibling = parent - child (LightGBM's halving of
    histogram work).  parent/child: (nodes_d, F, B, 3) with children of node
    i at 2i, 2i+1 — returns the sibling histograms for the next level."""
    return parent_hist - child_hist


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
    base = _fmix32_int(_fmix32_int(operator.index(seed))
                       ^ (operator.index(mix) & _M32))
    h = _fmix32(torch.stack([
        r ^ _fmix32_int(base ^ (0x9E3779B9 * (c + 1) & _M32))
        for c in (0, 1)]))
    return (h >> 8).to(torch.float32) * (1.0 / (1 << 24))


def global_row_ids(axis_name: Optional[str], n: int, mesh=None,
                   device=None) -> Optional[torch.Tensor]:
    """Global ids of this rank's ``n`` contiguous rows along ``axis_name``
    (``rank * n + arange(n)``), or None when unsharded (local ids are
    already global).  With contiguous block sharding a real row keeps its
    id at ANY shard count, so rounding noise keyed on it is
    width-independent: both growers use this one helper."""
    if axis_name is None:
        return None
    from ..parallel.collectives import axis_index
    return axis_index(axis_name, mesh) * n + torch.arange(n, device=device)


def quant_mix(grad: torch.Tensor, hess: torch.Tensor,
              axis_name: Optional[str] = None, mesh=None) -> int:
    """The quantizer's per-call key mix over the whole row space: an exact
    INTEGER fold of the bitcast ``|grad|`` and ``hess`` (``sum |g| + 3 sum
    h`` of their int32 bit patterns), summed in int64 on each rank, then
    over the axis, and wrapped to int32 once: the JAX package's integer
    psum of the same bits (and its host ``_quant_mix``), the same at any
    shard or tile count (``|g|`` clears the sign bit, so ``-0.0`` pad rows
    add nothing)."""
    from ..parallel.collectives import psum
    g = grad.to(torch.float32).abs().contiguous().view(torch.int32)
    h = hess.to(torch.float32).contiguous().view(torch.int32)
    total = g.to(torch.int64).sum() + 3 * h.to(torch.int64).sum()
    if axis_name is not None:
        total = psum(total.reshape(1), axis_name, mesh)[0]
    total = int(total) & _M32
    return total - (1 << 32) if total >= 1 << 31 else total


def quantize_gradients(grad: torch.Tensor, hess: torch.Tensor,
                       quant_bins: int, *,
                       generator: Optional[torch.Generator] = None,
                       noise: Optional[torch.Tensor] = None,
                       g_scale=None, h_scale=None,
                       row_ids: Optional[torch.Tensor] = None,
                       seed: int = 0, mix: Optional[int] = None,
                       axis_name: Optional[str] = None, mesh=None):
    """Stochastically round per-row grad/hess to small ints.

    Returns ``(qg, qh, g_scale, h_scale)``: ``qg`` int32 in
    ``[-quant_bins//2, quant_bins//2]``, ``qh`` int32 in
    ``[0, quant_bins - 1]``, scales as 0-d float32 tensors, with
    ``qg = clip(floor(g / g_scale + u))`` — the same scales, caps and
    rounding as ``mmlspark_tpu.ops.histogram.quantize_gradients``.  With
    ``axis_name`` (a rank of a row-sharded ``mesh``) the maxima behind the
    scales are taken over the axis (``pmax``), so every rank quantizes in
    the same units and the summed integer histograms stay meaningful.

    The uniforms ``u`` come from ``noise`` (``(2, n)`` float32, so a test
    can hand both packages the same numbers), else from ``row_ids`` (each
    row's global id: ``row_noise(row_ids, seed, mix)``, the same under any
    tiling or shard count; ``mix`` unset is 0 on one shard and, under
    ``axis_name``, ``quant_mix`` over the axis), else from ``generator``.
    The JAX package keys its noise on a float bitcast of the gradient sum
    or on threefry bits, which this package does not reproduce, so the two
    packages agree bit for bit only when given the same uniforms."""
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
            return torch.full((), c, dtype=torch.float32,
                              device=g.device)
        gmax, hmax = g.abs().max(), h.max()
        if axis_name is not None:
            from ..parallel.collectives import pmax
            gh = pmax(torch.stack([gmax, hmax]), axis_name, mesh)
            gmax, hmax = gh[0], gh[1]
        g_scale = torch.clamp(gmax, min=1e-12) / cap(qg_cap)
        h_scale = torch.clamp(hmax, min=1e-12) / cap(qh_cap)
    else:
        def given(x):
            # a Python number is filled on the device: no host copy
            t = x.to(device=g.device, dtype=torch.float32) \
                if isinstance(x, torch.Tensor) else torch.full(
                    (), x, dtype=torch.float32, device=g.device)
            return torch.clamp(t, min=1e-30)
        g_scale, h_scale = given(g_scale), given(h_scale)
    if noise is None and row_ids is not None:
        if mix is None:
            mix = quant_mix(g, h, axis_name, mesh) \
                if axis_name is not None else 0
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


# ---------------------------------------------------------------------------
# one-hot matmul builds (the JAX package's MXU backend)
# ---------------------------------------------------------------------------

def _node_pure_layout(binned, grad, hess, node_ids, num_nodes: int, R: int,
                      sample_weight=None, residuals: bool = True,
                      max_rows: Optional[int] = None,
                      quantized: bool = False):
    """Sort rows by node and pad so every ``R``-row block is node-pure, then
    build the weight channels: with ``quantized``, the int8 ``(qg, qh,
    valid)``; else ``(g_hi, g_lo, h_hi, h_lo, count)`` with the hi parts
    rounded to bfloat16 (``residuals=False`` keeps ``(g_hi, h_hi,
    count)``).

    Returns ``(bb_all (N_pad, F) uint8, w_ch (C, N_pad), node_blk (NB,)
    int64, NB)``.  Masked rows (node < 0) land in dummy node P, whose buffer
    the caller drops.  ``max_rows`` is a caller GUARANTEE that at most that
    many rows are unmasked: it truncates the layout to ``ceil(max_rows/R) +
    P + 1`` blocks, and rows past its end are dropped (the JAX scatter's
    out-of-bounds rule), so a violated bound drops unmasked rows.
    ``MMLSPARK_TPU_HIST_LAYOUT=cumsum`` ranks rows by an exclusive prefix
    count over an ``(n, P+1)`` one-hot (while P + 1 <= 33) instead of a
    stable sort: the same layout."""
    n, F = binned.shape
    P = num_nodes
    dev = binned.device
    if quantized:
        g = grad.to(torch.int32)
        h = hess.to(torch.int32)
    else:
        g = grad.to(torch.float32)
        h = hess.to(torch.float32)
        if sample_weight is not None:
            g, h = g * sample_weight, h * sample_weight
    c = torch.ones_like(g)  # counts stay unweighted (min_data_in_leaf)

    i64 = torch.int64
    node_s = torch.where(node_ids < 0, P, node_ids).to(i64)
    use_cumsum = os.environ.get("MMLSPARK_TPU_HIST_LAYOUT",
                                "sort") == "cumsum" and P + 1 <= 33
    rows = torch.arange(n, dtype=i64, device=dev)
    if use_cumsum:
        onehot_n = (node_s[:, None] == torch.arange(P + 1, device=dev)) \
            .to(i64)
        inc = torch.cumsum(onehot_n, dim=0)
        counts = inc[-1]
        rank_all = torch.gather(inc - onehot_n, 1, node_s[:, None])[:, 0]
    else:
        order = torch.argsort(node_s, stable=True)
        ns = node_s[order]
        # a count by scatter: bincount sizes its output from the data's
        # maximum, a wait for the card that a captured program refuses
        counts = torch.zeros(P + 1, dtype=i64, device=dev).index_add_(
            0, node_s, torch.ones_like(node_s))
        start = torch.cumsum(counts, 0) - counts
    padded_counts = ((counts + R - 1) // R) * R
    padded_off = torch.cumsum(padded_counts, 0) - padded_counts
    n_cap = n if max_rows is None else min(n, operator.index(max_rows))
    N_pad = ((n_cap + R - 1) // R + P + 1) * R
    if use_cumsum:
        pos, src = padded_off[node_s] + rank_all, rows
    else:
        pos, src = padded_off[ns] + (rows - start[ns]), order
    # rows past the layout's end spill into one slot past it: no boolean
    # index, which would wait for the card to count the kept rows
    padded_idx = torch.full((N_pad + 1,), -1, dtype=i64, device=dev)
    padded_idx.index_put_((torch.where(pos < N_pad, pos, N_pad),), src)
    padded_idx = padded_idx[:N_pad]

    NB = N_pad // R
    block_starts = torch.arange(NB, dtype=i64, device=dev) * R
    node_blk = torch.searchsorted(padded_off, block_starts, right=True) - 1
    node_blk = torch.clamp(node_blk, 0, P)

    valid = padded_idx >= 0
    safe_idx = torch.clamp(padded_idx, min=0)
    bb_all = binned[safe_idx]                            # (N_pad, F) uint8
    if quantized:
        vi = valid.to(torch.int32)
        w_ch = torch.stack([g[safe_idx] * vi, h[safe_idx] * vi, vi]) \
            .to(torch.int8)                              # (3, N_pad)
        return bb_all, w_ch, node_blk, NB
    gp = g[safe_idx] * valid
    hp = h[safe_idx] * valid
    cp = c[safe_idx] * valid
    g_hi = gp.to(torch.bfloat16).to(torch.float32)
    h_hi = hp.to(torch.bfloat16).to(torch.float32)
    if not residuals:
        return bb_all, torch.stack([g_hi, h_hi, cp]), node_blk, NB
    return (bb_all, torch.stack([g_hi, gp - g_hi, h_hi, hp - h_hi, cp]),
            node_blk, NB)


def _block_rows(n: int, block_rows: int) -> int:
    # small inputs: shrink the block so padding (one block minimum per
    # node) stays proportionate
    return min(block_rows, max(256, 1 << max(0, n - 1).bit_length()))


def _split_width(B: int, lo_width: int):
    if B > 256:
        raise ValueError("matmul backend supports max_bin <= 256")
    LO = lo_width or 16
    if LO not in (16, 32, 64, 128):
        raise ValueError("lo_width must be one of 16/32/64/128")
    return LO, (B + LO - 1) // LO, LO.bit_length() - 1


def _onehot_blocks(bb_all, w_ch, node_blk, NB: int, R: int, P: int,
                   LO: int, HI: int, shift: int, acc_dtype) -> torch.Tensor:
    """Per node, the sum over its blocks of ``einsum('rfm,rfl->fml',
    onehot_hi * weight, onehot_lo)``: ``(P + 1, F, C*HI, LO)`` in
    ``acc_dtype``.  The products run in float32 with TF32 off (the JAX
    package multiplies bfloat16 or int8 operands into float32 or int32
    sums; every operand here is exact in float32).  An int32 accumulator
    takes each block's sum as int32 before the sum across blocks: a block
    sums at most ``R`` integers of magnitude <= 127, exact in float32 while
    ``R * 127 < 2**24``.  Blocks go in chunks of about 64M operand
    elements."""
    F = bb_all.shape[1]
    C = w_ch.shape[0]
    dev = bb_all.device
    hi_iota = torch.arange(HI, dtype=torch.int32, device=dev)
    lo_iota = torch.arange(LO, dtype=torch.int32, device=dev)
    acc = torch.zeros((P + 1, F, C * HI, LO), dtype=acc_dtype, device=dev)
    per_block = R * F * (C * HI + LO)
    chunk = max(1, (1 << 26) // per_block)
    bb = bb_all.reshape(NB, R, F)
    wb = w_ch.reshape(C, NB, R).permute(1, 2, 0)          # (NB, R, C)
    with float32_exact(dev.type == "cuda"):
        for k0 in range(0, NB, chunk):
            k1 = min(NB, k0 + chunk)
            b32 = bb[k0:k1].to(torch.int32)
            hi = b32 >> shift
            lo = b32 & (LO - 1)
            onehot_lo = (lo[..., None] == lo_iota).to(torch.float32)
            onehot_hi = (hi[..., None] == hi_iota).to(torch.float32)
            w = wb[k0:k1].to(torch.float32)
            a = (onehot_hi[:, :, :, None, :] * w[:, :, None, :, None]) \
                .reshape(k1 - k0, R, F, C * HI)
            blk = torch.einsum("krfm,krfl->kfml", a, onehot_lo)
            acc.index_add_(0, node_blk[k0:k1], blk.to(acc_dtype))
    return acc


def build_histograms_matmul(binned: torch.Tensor, grad: torch.Tensor,
                            hess: torch.Tensor, node_ids: torch.Tensor,
                            num_nodes: int, num_bins: int,
                            sample_weight: Optional[torch.Tensor] = None,
                            block_rows: int = 4096, lo_width: int = 0,
                            residuals: bool = True,
                            max_rows: Optional[int] = None) -> torch.Tensor:
    """Float histogram build as one-hot matrix products over node-pure
    blocks (the JAX package's MXU build): each 8-bit bin splits into hi
    and lo parts (``lo_width`` lanes wide), a block's histogram is the
    pair of one-hot indicators contracted over its rows, and blocks add
    into per-node buffers.  Grad and hess are rounded to bfloat16, each
    with a bfloat16 residual channel (``residuals=False`` drops them);
    sums are float32.  Masked rows (node < 0) land in a dummy node that is
    dropped.  ``max_rows``: see ``_node_pure_layout``.  Returns
    ``(num_nodes, F, B, 3)`` float32."""
    n, F = binned.shape
    B, P = num_bins, num_nodes
    LO, HI, shift = _split_width(B, lo_width)
    R = _block_rows(n, block_rows)
    bb_all, w_ch, node_blk, NB = _node_pure_layout(
        binned, grad, hess, node_ids, num_nodes, R, sample_weight,
        residuals=residuals, max_rows=max_rows)
    # the JAX package feeds the matmul bfloat16 operands: the residual
    # channels round there too
    w_ch = w_ch.to(torch.bfloat16).to(torch.float32)
    C = w_ch.shape[0]
    acc = _onehot_blocks(bb_all, w_ch, node_blk, NB, R, P, LO, HI, shift,
                         torch.float32)
    acc = acc[:P].reshape(P, F, C, HI, LO)
    if residuals:
        acc3 = torch.stack([acc[:, :, 0] + acc[:, :, 1],
                            acc[:, :, 2] + acc[:, :, 3], acc[:, :, 4]])
    else:
        acc3 = acc.movedim(2, 0)
    hist = acc3.reshape(3, P, F, HI * LO)[..., :B]
    return hist.movedim(0, -1).contiguous()                # (P, F, B, 3)


def build_histograms_matmul_quantized(binned: torch.Tensor, qg: torch.Tensor,
                                      qh: torch.Tensor,
                                      node_ids: torch.Tensor,
                                      num_nodes: int, num_bins: int,
                                      quant_bins: int = 16,
                                      block_rows: int = 4096,
                                      lo_width: int = 0,
                                      max_rows: Optional[int] = None
                                      ) -> torch.Tensor:
    """Packed-integer build as one-hot matrix products (the JAX package's
    int8 MXU build) on the same node-pure block layout: the weighted
    one-hot operand carries ``(qg, qh, 1)`` per row, each block's sums are
    exact integers taken to int32, and blocks add in int32, so the result
    equals the scatter build bit for bit.  Returns ``(num_nodes, F, B, 3)``
    int32 [sum_qg, sum_qh, count]."""
    n, F = binned.shape
    B, P = num_bins, num_nodes
    if quant_bins > 128:
        raise ValueError("int8 operand lanes cap num_grad_quant_bins at 128")
    _check_overflow(n, quant_bins)
    LO, HI, shift = _split_width(B, lo_width)
    R = _block_rows(n, block_rows)
    if R * 127 >= (1 << 24):
        raise ValueError(f"block_rows {R} x 127 reaches 2**24: a block's "
                         "float32 sum would no longer be exact")
    bb_all, w_ch, node_blk, NB = _node_pure_layout(
        binned, qg, qh, node_ids, num_nodes, R, quantized=True,
        max_rows=max_rows)
    acc = _onehot_blocks(bb_all, w_ch, node_blk, NB, R, P, LO, HI, shift,
                         torch.int32)
    acc = acc[:P].reshape(P, F, 3, HI, LO)
    hist = acc.movedim(2, 0).reshape(3, P, F, HI * LO)[..., :B]
    return hist.movedim(0, -1).contiguous()                # (P, F, B, 3)


# ---------------------------------------------------------------------------
# dispatchers
# ---------------------------------------------------------------------------

#: the backends by name; ``pallas`` is the JAX package's name of ``cuda``
_BACKENDS = ("auto", "cuda", "matmul", "scatter")


def _pallas_pref() -> Optional[bool]:
    """``MMLSPARK_TPU_HIST_PALLAS`` hatch, as in the JAX package: 1/true
    forces the kernel backend into the auto choice on any device (its plain
    versions on a CPU tensor), 0/false keeps auto off it, unset = auto picks
    it on the card only.  Explicit ``backend=`` and
    ``MMLSPARK_TPU_HIST_BACKEND`` settings always win."""
    raw = os.environ.get("MMLSPARK_TPU_HIST_PALLAS", "").strip().lower()
    if raw in ("0", "false", "off", "no"):
        return False
    if raw in ("1", "true", "on", "yes"):
        return True
    return None


def _backend_name(backend: str) -> str:
    name = "cuda" if backend == "pallas" else backend
    if name not in _BACKENDS:
        raise ValueError(f"unknown histogram backend {backend!r}: one of "
                         "auto, cuda (or pallas), matmul, scatter")
    return name


def resolve_quantized_backend(backend: str = "auto", device=None) -> str:
    """The quantized build's backend, as ``build_quantized`` resolves it:
    an explicit choice > ``MMLSPARK_TPU_HIST_BACKEND`` > the device's auto
    (a CUDA tensor -> ``cuda``, the Hopper kernels, unless
    ``MMLSPARK_TPU_HIST_PALLAS=0``, which gives ``matmul``; the CPU ->
    ``scatter``; ``MMLSPARK_TPU_HIST_PALLAS=1`` -> ``cuda`` anywhere).  The
    JAX package's answer with ``pallas`` read as ``cuda`` and its TPU as
    the card.  ``device`` defaults to the CPU."""
    if backend == "auto":
        backend = os.environ.get("MMLSPARK_TPU_HIST_BACKEND", "auto")
    backend = _backend_name(backend)
    if backend != "auto":
        return backend
    pref = _pallas_pref()
    if pref is True:
        return "cuda"
    dev = torch.device("cpu" if device is None else device)
    if dev.type == "cpu":
        return "scatter"
    if dev.type == "cuda" and pref is not False:
        return "cuda"
    return "matmul"


def _matmul_knobs(float_path: bool) -> dict:
    """The JAX package's matmul tuning knobs, read at call time."""
    kw = {}
    block_rows = int(os.environ.get("MMLSPARK_TPU_HIST_BLOCK_ROWS", "0"))
    if block_rows:
        kw["block_rows"] = block_rows
    lo = int(os.environ.get("MMLSPARK_TPU_HIST_LO", "0"))
    if lo:
        kw["lo_width"] = lo
    if float_path and os.environ.get("MMLSPARK_TPU_HIST_RESID", "1") == "0":
        kw["residuals"] = False
    return kw


def build_quantized(binned, qg, qh, node_ids, num_nodes, num_bins,
                    quant_bins: int = 16, backend: str = "auto",
                    max_rows=None, node_rows_bound=None) -> torch.Tensor:
    """Quantized-build dispatcher (the JAX ``build_quantized``, with
    ``cuda`` for its ``pallas``): ``resolve_quantized_backend`` on the
    tensors' device picks the Hopper kernels (``ops.cuda_histogram``; their
    plain versions on a CPU tensor), the one-hot matmul build or the plain
    scatter build.  A shape the kernels do not take goes to the matmul
    build on the card and the scatter build on the CPU, as the JAX package
    sends it to its XLA builders; a failed build or launch raises.
    Returns int32 ``(nodes, F, B, 3)``."""
    from . import cuda_histogram
    backend = resolve_quantized_backend(backend, binned.device)
    if backend == "cuda":
        if cuda_histogram.supported(num_bins, quant_bins):
            return cuda_histogram.build_histograms_cuda(
                binned, qg, qh, node_ids, num_nodes, num_bins,
                quant_bins=quant_bins, node_rows_bound=node_rows_bound,
                max_rows=max_rows)
        backend = "matmul" if binned.is_cuda else "scatter"
    if backend == "matmul":
        return build_histograms_matmul_quantized(
            binned, qg, qh, node_ids, num_nodes, num_bins,
            quant_bins=quant_bins, max_rows=max_rows,
            **_matmul_knobs(False))
    return build_histograms_quantized(
        binned, qg, qh, node_ids, num_nodes, num_bins,
        quant_bins=quant_bins, node_rows_bound=node_rows_bound,
        max_rows=max_rows)


def build(binned, grad, hess, node_ids, num_nodes, num_bins,
          sample_weight=None, backend: str = "auto", max_rows=None
          ) -> torch.Tensor:
    """Float-path dispatcher (the JAX ``build``).  The kernels are
    integer-only, so ``auto`` and ``cuda`` (``pallas``) resolve by device
    as the JAX package resolves them by platform: the scatter build on the
    CPU, the one-hot matmul build on the card (at the bench shape's
    level-4 step on an H100 it takes about a seventh of the float
    scatter's time, within 1e-5 of its sums relative to the cells'
    magnitudes: PERF.md).  ``matmul`` reads ``MMLSPARK_TPU_HIST_BLOCK_ROWS``,
    ``_LO`` and ``_RESID`` as the JAX package does.
    ``MMLSPARK_TPU_HIST_BACKEND`` overrides an ``auto`` request only.
    Returns ``(nodes, F, B, 3)`` float32."""
    if backend == "auto":
        backend = os.environ.get("MMLSPARK_TPU_HIST_BACKEND", backend)
    backend = _backend_name(backend)
    if backend in ("auto", "cuda"):
        backend = "matmul" if binned.is_cuda else "scatter"
    if backend == "matmul":
        return build_histograms_matmul(binned, grad, hess, node_ids,
                                       num_nodes, num_bins, sample_weight,
                                       max_rows=max_rows,
                                       **_matmul_knobs(True))
    # scatter drops masked rows natively; the max_rows bound is a no-op
    return build_histograms(binned, grad, hess, node_ids, num_nodes,
                            num_bins, sample_weight)
