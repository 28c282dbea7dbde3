"""Plain NumPy/PyTorch reference of gradient-boosted trees, written from
the algorithm's description (LightGBM's quantile binning, leaf-wise
growth, quantized gradients, binary log-loss and LambdaRank): it imports
nothing of the program it judges.

- ``bin_edges`` / ``apply_bins``: quantile edges over a 200,000-row sample
  drawn with ``default_rng(3)`` (LightGBM's ``bin_construct_sample_cnt``):
  midpoints of the sorted distinct values when a feature has at most
  ``max_bin`` of them, else linear-interpolated quantiles at ``i / max_bin``
  computed in double and stored float32, de-duplicated; ``bin = #edges <
  x``.
- ``route``: each row's leaf under a tree's binned thresholds (``bin <=
  threshold_bin`` goes left).
- ``binary_grads`` / ``lambdarank_grads``: the objectives' gradients.
- ``quantize``: stochastic rounding of gradients to integer levels with
  given uniforms.
- ``node_histograms`` / ``best_splits`` / ``leaf_values``: integer
  histograms of every node of a tree, their best split gains and outputs.
- ``walk_raw``: leaves and raw scores of raw rows, one tree at a time.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

SAMPLE_ROWS = 200_000
SAMPLE_SEED = 3


# ---------------------------------------------------------------------------
# binning
# ---------------------------------------------------------------------------

def sample_index(n: int) -> np.ndarray:
    if n <= SAMPLE_ROWS:
        return np.arange(n)
    return np.random.default_rng(SAMPLE_SEED).choice(n, SAMPLE_ROWS,
                                                     replace=False)


def bin_edges(sample: np.ndarray, max_bin: int) -> np.ndarray:
    """``(F, max_bin - 1)`` float32 edges, +inf padded."""
    sample = np.asarray(sample, np.float32)
    F = sample.shape[1]
    out = np.full((F, max_bin - 1), np.inf, np.float32)
    p = np.arange(1, max_bin, dtype=np.float64) / max_bin
    for f in range(F):
        col = np.sort(sample[:, f][~np.isnan(sample[:, f])])
        if col.size == 0:
            continue
        distinct = col[np.concatenate([[True], col[1:] != col[:-1]])]
        if distinct.size <= 1:
            continue
        if distinct.size <= max_bin:
            mids = (distinct[1:] + distinct[:-1]) / np.float32(2.0)
            out[f, :mids.size] = mids[:max_bin - 1]
            continue
        pos = p * (col.size - 1)
        lo = pos.astype(np.int64)
        frac = pos - lo
        hi = np.minimum(lo + 1, col.size - 1)
        c64 = col.astype(np.float64)
        q = np.sort((c64[lo] * (1.0 - frac) + c64[hi] * frac).astype(
            np.float32))
        q = q[np.concatenate([[True], q[1:] != q[:-1]])]
        out[f, :q.size] = q
    return out


def apply_bins(X: torch.Tensor, edges: np.ndarray) -> torch.Tensor:
    """``(n, F)`` uint8 bins: the count of a feature's leading finite
    edges below ``x``; NaN is bin 0."""
    n, F = X.shape
    out = torch.empty((n, F), dtype=torch.uint8, device=X.device)
    for f in range(F):
        e = edges[f]
        fin = np.isfinite(e)
        e = e if fin.all() else e[:int(np.argmin(fin))]
        col = X[:, f].contiguous()
        b = torch.searchsorted(torch.from_numpy(np.ascontiguousarray(e))
                               .to(X.device), col, right=False)
        out[:, f] = torch.where(torch.isnan(col), 0, b).to(torch.uint8)
    return out


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------

def route(bins: torch.Tensor, sf, tb, lc, rc) -> torch.Tensor:
    """Each row's leaf (int64) under one tree of array-of-nodes children
    (``>= 0`` internal, ``~leaf`` a leaf)."""
    dev = bins.device
    n = bins.shape[0]
    sf_t, tb_t = (torch.from_numpy(np.asarray(a, np.int64)).to(dev)
                  for a in (sf, tb))
    lc_t, rc_t = (torch.from_numpy(np.asarray(a, np.int64)).to(dev)
                  for a in (lc, rc))
    node = torch.zeros((n,), dtype=torch.int64, device=dev)
    if len(sf) == 0 or sf[0] < 0:
        return torch.zeros((n,), dtype=torch.int64, device=dev)
    while True:
        live = node >= 0
        if not bool(live.any()):
            return ~node
        j = node.clamp(min=0)
        v = bins.gather(1, sf_t[j].clamp(min=0)[:, None])[:, 0].to(
            torch.int64)
        child = torch.where(v > tb_t[j], rc_t[j], lc_t[j])
        node = torch.where(live, child, node)


def walk_raw(X: torch.Tensor, sf, th, lc, rc, lv,
             dtype=torch.float64):
    """Raw rows through trees ``(T, M)`` one tree at a time: returns the
    ``(n,)`` sum of leaf values (in ``dtype``) and the ``(n,)`` int64 count
    of node visits.  ``x > threshold`` goes right; NaN goes left."""
    dev = X.device
    n = X.shape[0]
    Xc = torch.nan_to_num(X, nan=-math.inf).to(dtype if dtype in (
        torch.bfloat16, torch.float16) else X.dtype)
    total = torch.zeros((n,), dtype=dtype, device=dev)
    visits = torch.zeros((n,), dtype=torch.int64, device=dev)
    sf_a, th_a = np.asarray(sf), np.asarray(th)
    lc_a, rc_a, lv_a = np.asarray(lc), np.asarray(rc), np.asarray(lv)
    for t in range(sf_a.shape[0]):
        sf_t = torch.from_numpy(sf_a[t].astype(np.int64)).to(dev)
        th_t = torch.from_numpy(th_a[t]).to(dev).to(Xc.dtype)
        lc_t = torch.from_numpy(lc_a[t].astype(np.int64)).to(dev)
        rc_t = torch.from_numpy(rc_a[t].astype(np.int64)).to(dev)
        node = torch.zeros((n,), dtype=torch.int64, device=dev)
        if sf_a[t, 0] < 0:
            leaf = torch.zeros((n,), dtype=torch.int64, device=dev)
        else:
            while True:
                live = node >= 0
                if not bool(live.any()):
                    break
                visits += live.to(torch.int64)
                j = node.clamp(min=0)
                x = Xc.gather(1, sf_t[j][:, None])[:, 0]
                child = torch.where(x > th_t[j], rc_t[j], lc_t[j])
                node = torch.where(live, child, node)
            leaf = ~node
        lv_t = torch.from_numpy(lv_a[t]).to(dev).to(dtype)
        total = total + lv_t[leaf]
    return total, visits


# ---------------------------------------------------------------------------
# objectives
# ---------------------------------------------------------------------------

def binary_grads(scores: torch.Tensor, y: torch.Tensor, dtype=torch.float32):
    """Binary log-loss gradient and hessian of raw scores."""
    s, yy = scores.to(dtype), y.to(dtype)
    p = 1.0 / (1.0 + torch.exp(-s))
    g = p - yy
    h = torch.clamp(p * (1.0 - p), min=1e-16)
    return g, h


def lambdarank_grads(scores: torch.Tensor, y: torch.Tensor,
                     group_ptr: np.ndarray, dtype=torch.float64,
                     pair_budget: int = 1 << 26):
    """LambdaRank gradients with |delta NDCG| weights over every pair of a
    query whose relevances differ (the better document first), sigmoid 1.
    Ranks by a stable sort of the scores, descending.  Queries are taken
    in buckets of similar size, padded within a bucket only."""
    dev = scores.device
    n = scores.shape[0]
    sizes = np.diff(group_ptr)
    order = np.argsort(sizes, kind="stable")
    G = torch.zeros((n,), dtype=dtype, device=dev)
    H = torch.zeros((n,), dtype=dtype, device=dev)
    i = 0
    while i < order.size:
        # sizes ascend along ``order``: the bucket's last query is its
        # longest, and a bucket holds at least one query
        j = i + 1
        while j < order.size and \
                (j - i + 1) * int(sizes[order[j]]) ** 2 <= pair_budget:
            j += 1
        qs = order[i:j]
        gmax = int(sizes[qs].max())
        slots = np.arange(gmax)
        mask_np = slots[None, :] < sizes[qs][:, None]
        idx_np = np.where(mask_np, group_ptr[qs][:, None] + slots[None, :], 0)
        idx = torch.from_numpy(idx_np).to(dev)
        M = torch.from_numpy(mask_np).to(dev)
        S = scores[idx].to(dtype)
        Y = torch.where(M, y[idx].to(dtype), 0.0)
        key = torch.where(M, -S.to(torch.float64), math.inf)
        rank_order = torch.argsort(key, dim=1, stable=True)
        ranks = torch.empty_like(rank_order)
        ranks.scatter_(1, rank_order, torch.arange(gmax, device=dev)
                       .expand_as(rank_order).contiguous())
        gain = torch.where(M, torch.pow(2.0, Y) - 1.0, 0.0).to(dtype)
        disc = (1.0 / torch.log2(ranks.to(torch.float64) + 2.0)).to(dtype)
        ideal = torch.sort(gain, dim=1, descending=True).values
        ideal_disc = (1.0 / torch.log2(torch.arange(
            gmax, device=dev, dtype=torch.float64) + 2.0)).to(dtype)
        idcg = torch.clamp((ideal * ideal_disc).sum(dim=1, keepdim=True),
                           min=1e-9)
        better = (Y[:, :, None] > Y[:, None, :]) & M[:, :, None] \
            & M[:, None, :]
        rho = 1.0 / (1.0 + torch.exp(S[:, :, None] - S[:, None, :]))
        delta = ((gain[:, :, None] - gain[:, None, :])
                 * (disc[:, :, None] - disc[:, None, :])).abs() \
            / idcg[:, :, None]
        lam = torch.where(better, -rho * delta, 0.0)
        hes = torch.where(better, rho * (1.0 - rho) * delta, 0.0)
        g_q = lam.sum(dim=2) - lam.sum(dim=1)
        h_q = hes.sum(dim=2) + hes.sum(dim=1)
        rows = idx[M]
        G[rows] = g_q[M].to(dtype)
        H[rows] = h_q[M].to(dtype)
        i = j
    return G, torch.clamp(H, min=1e-16)


def quantize(g: torch.Tensor, h: torch.Tensor, levels: int,
             noise: torch.Tensor):
    """Stochastic rounding in float32: ``qg = floor(g / s_g + u0)`` within
    ``+-levels/2`` and ``qh = floor(h / s_h + u1)`` within ``[0, levels -
    1]``, the scales the largest magnitudes over the caps.  Returns int64
    levels and float64 scales."""
    cg, ch = max(1, levels // 2), max(1, levels - 1)
    g32, h32 = g.to(torch.float32), h.to(torch.float32)
    sg = torch.clamp(g32.abs().max(), min=1e-12) / torch.tensor(
        float(cg), device=g.device)
    sh = torch.clamp(h32.max(), min=1e-12) / torch.tensor(
        float(ch), device=g.device)
    qg = torch.clamp(torch.floor(g32 / sg + noise[0]), -cg, cg)
    qh = torch.clamp(torch.floor(h32 / sh + noise[1]), 0, ch)
    return qg.to(torch.int64), qh.to(torch.int64), float(sg), float(sh)


# ---------------------------------------------------------------------------
# histograms and splits
# ---------------------------------------------------------------------------

def leaf_histograms(bins: torch.Tensor, leaf: torch.Tensor, qg, qh,
                    num_leaves: int, num_bins: int,
                    ones: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``(L, F, B, 3)`` int64 sums of (qg, qh, 1) by each row's leaf
    (``ones``: the rows' third channel, 1 unless given)."""
    n, F = bins.shape
    dev = bins.device
    hist = torch.zeros((num_leaves * F * num_bins, 3), dtype=torch.int64,
                       device=dev)
    fofs = (torch.arange(F, device=dev) * num_bins)[None, :]
    rows_per_block = max(1, (1 << 25) // F)
    for lo in range(0, n, rows_per_block):
        hi = min(n, lo + rows_per_block)
        idx = (leaf[lo:hi, None] * (F * num_bins) + fofs
               + bins[lo:hi].to(torch.int64)).reshape(-1)
        one = torch.ones_like(qg[lo:hi]) if ones is None else ones[lo:hi]
        vals = torch.stack([qg[lo:hi], qh[lo:hi], one], dim=1)
        hist.index_add_(0, idx, vals.repeat_interleave(F, dim=0))
    return hist.reshape(num_leaves, F, num_bins, 3)


def node_histograms(leaf_hist: torch.Tensor, sf, lc, rc) -> torch.Tensor:
    """``(M, F, B, 3)`` int64 histograms of the internal nodes: each the
    sum of its two children (children are created after their parent, so
    one backward pass over the nodes suffices)."""
    M = len(sf)
    out = torch.zeros((M,) + tuple(leaf_hist.shape[1:]), dtype=torch.int64,
                      device=leaf_hist.device)
    for s in range(M - 1, -1, -1):
        if sf[s] < 0:
            continue
        for c in (lc[s], rc[s]):
            out[s] += leaf_hist[~c] if c < 0 else out[c]
    return out


def gains(hist: torch.Tensor, sg: float, sh: float, edges: np.ndarray,
          params: dict) -> torch.Tensor:
    """``(K, F, B)`` float64 split gains of ``(K, F, B, 3)`` histograms,
    ``-inf`` where a candidate breaks ``min_data_in_leaf``,
    ``min_sum_hessian_in_leaf`` or has no finite edge."""
    l1 = float(params.get("lambda_l1", 0.0))
    l2 = float(params.get("lambda_l2", 0.0))
    cum = torch.cumsum(hist, dim=2).to(torch.float64)
    tot = cum[:, :1, -1:, :]
    GL, HL, CL = cum[..., 0] * sg, cum[..., 1] * sh, cum[..., 2]
    G, H, C = tot[..., 0] * sg, tot[..., 1] * sh, tot[..., 2]
    GR, HR, CR = G - GL, H - HL, C - CL

    def score(g, h):
        t = torch.sign(g) * torch.clamp(g.abs() - l1, min=0.0)
        return t * t / (h + l2)

    gain = score(GL, HL) + score(GR, HR) - score(G, H)
    ok_edge = torch.from_numpy(np.concatenate(
        [np.isfinite(edges), np.zeros((edges.shape[0], 1), bool)], axis=1)
    ).to(hist.device)
    md = float(params["min_data_in_leaf"])
    mh = float(params["min_sum_hessian_in_leaf"])
    valid = (CL >= md) & (CR >= md) & (HL >= mh) & (HR >= mh) \
        & ok_edge[None]
    return torch.where(valid, gain, -math.inf)


def leaf_values(hist_leaf: torch.Tensor, sg: float, sh: float,
                params: dict, dtype=torch.float64) -> torch.Tensor:
    """``(L,)`` shrunk leaf outputs ``-lr * T(G) / (H + l2)``."""
    l1 = float(params.get("lambda_l1", 0.0))
    l2 = float(params.get("lambda_l2", 0.0))
    tot = hist_leaf[:, 0].sum(dim=1).to(torch.float64)
    G, H = (tot[:, 0] * sg).to(dtype), (tot[:, 1] * sh).to(dtype)
    t = torch.sign(G) * torch.clamp(G.abs() - l1, min=0.0)
    v = -t / (H + l2)
    return (v * float(params["learning_rate"])).to(dtype)
