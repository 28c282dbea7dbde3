"""The comparisons that decide ``correct``: what a fit or a transform
produced, judged against ``reference.gbdt`` on the same inputs.

A fit is judged step by step from its own trees: the reference bins the
raw rows itself, routes them through each of the fit's trees, and for the
first ``check_iterations`` trees recomputes the gradients from the scores
that the fit's earlier trees give, quantizes them with the same uniforms,
builds every node's histogram and judges the tree's splits, leaf values
and leaf-wise order.  Every tree's row counts are checked.  Readings:

- ``edge_mismatch``: splits whose threshold is not the reference's edge
  at the split's bin (exact: 0);
- ``count_mismatch``: rows by which the nodes' and leaves' counts differ
  from the reference's routing (exact: 0);
- ``init_gap``: the starting score against the reference's;
- ``gain_gap``: the gain lost against each node's best split, summed and
  divided by the summed best gains;
- ``order_gap``: the gain by which a leaf left unsplit beats a split made
  after the leaf was created, over the same sum;
- ``leaf_gap``: sum over leaves of rows x |leaf value - reference| over
  sum of rows x |reference|;
- ``raw_gap``: the model's raw scores of sampled rows against the
  reference's walk of the same trees.

The control (``candidate="bfloat16"``) is the reference in the program's
place one precision below the configuration's float32: the gradients and
the leaf outputs in bfloat16 on the same bins and trees, its choices then
judged as the program's are; the planted faults stand in the same way.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import numpy as np
import torch

from . import gbdt as ref

TREE_KEYS = ("split_feature", "threshold", "threshold_bin", "left_child",
             "right_child", "leaf_value", "leaf_count", "internal_count")


def init_score(objective: str, y: np.ndarray) -> float:
    if objective == "binary":
        p = float(np.clip(np.mean(y, dtype=np.float64), 1e-6, 1 - 1e-6))
        return math.log(p / (1.0 - p))
    return 0.0


def _parents(sf, lc, rc, L: int) -> np.ndarray:
    """Each leaf slot's parent node (-1: the root leaf or never made)."""
    par = np.full(L, -1, np.int64)
    for s in range(len(sf)):
        if sf[s] < 0:
            continue
        for c in (lc[s], rc[s]):
            if c < 0:
                par[~c] = s
    return par


def _node_counts(leaf_counts: np.ndarray, sf, lc, rc) -> np.ndarray:
    out = np.zeros(len(sf), np.int64)
    for s in range(len(sf) - 1, -1, -1):
        if sf[s] < 0:
            continue
        out[s] = sum(int(leaf_counts[~c]) if c < 0 else int(out[c])
                     for c in (lc[s], rc[s]))
    return out


def binned(X: torch.Tensor, cfg: dict):
    """The reference's ``(edges, bins)`` of the raw rows."""
    n = X.shape[0]
    sample = X[torch.from_numpy(ref.sample_index(n)).to(X.device)]
    edges = ref.bin_edges(sample.cpu().numpy(), int(cfg["max_bin"]))
    return edges, ref.apply_bins(X, edges)


#: what can stand in the program's place: the control one precision
#: below the configuration's, and the planted faults (a state left
#: unchanged: every tree from the starting scores; half the rows left out
#: of the histograms; an answer altered: the largest leaf's value moved
#: by a tenth)
CANDIDATES = ("program", "bfloat16", "stale", "half", "altered")


def fit_readings(X: torch.Tensor, y: torch.Tensor, group_ptr, cfg: dict,
                 trees: Dict[str, np.ndarray], prog_init: float,
                 noise: Callable[[int], torch.Tensor],
                 check_iterations: int,
                 raw_rows: Optional[np.ndarray] = None,
                 prog_raw: Optional[np.ndarray] = None,
                 candidate: str = "program",
                 binned_xy=None) -> Dict[str, float]:
    """The readings of one fit (see the module's docstring).  ``trees``
    holds the fitted booster's ``(T, M)`` / ``(T, L)`` arrays,
    ``noise(t)`` the ``(2, n)`` uniforms of iteration ``t``, ``raw_rows``
    the sampled rows whose model raw scores are ``prog_raw``;
    ``binned_xy`` the reference's ``binned(X, cfg)`` when already made.
    ``candidate`` other than ``"program"`` judges, in the program's place
    and on its trees, the choices of one of ``CANDIDATES``."""
    if candidate not in CANDIDATES:
        raise ValueError(f"candidate must be one of {CANDIDATES}")
    n, F = X.shape
    B, L = int(cfg["max_bin"]), int(cfg["num_leaves"])
    levels = int(cfg["num_grad_quant_bins"])
    objective = cfg["objective"]
    edges, bins = binned_xy if binned_xy is not None else binned(X, cfg)
    sf_all, tb_all, th_all = (trees[k] for k in (
        "split_feature", "threshold_bin", "threshold"))
    lc_all, rc_all = trees["left_child"], trees["right_child"]
    T = sf_all.shape[0]

    init_ref = init_score(objective, y.cpu().numpy())
    split = sf_all >= 0
    f_idx = np.where(split, sf_all, 0)
    b_idx = np.clip(np.where(split, tb_all, 0), 0, B - 2)
    edge_at = edges[f_idx, b_idx]
    if candidate == "bfloat16":
        # the control keeps its starting score and thresholds in bfloat16
        prog_init = float(torch.tensor(init_ref).to(torch.bfloat16))
        th_all = torch.from_numpy(edge_at).to(torch.bfloat16).to(
            torch.float32).numpy()
    out = {"init_gap": abs(prog_init - init_ref)}
    bad = split & ~((edge_at == th_all) & np.isfinite(edge_at)
                    & (tb_all <= B - 2))
    out["edge_mismatch"] = float(bad.sum())

    start = torch.full((n,), np.float32(prog_init), dtype=torch.float32,
                       device=X.device)
    scores = start
    half = (torch.arange(n, device=X.device) % 2 == 0).to(torch.int64)
    count_bad = 0
    gain_lost = gain_best = order_bad = 0.0
    leaf_num = leaf_den = 0.0
    for t in range(T):
        sf, tb = sf_all[t], tb_all[t]
        lc, rc = lc_all[t], rc_all[t]
        leaf = ref.route(bins, sf, tb, lc, rc)
        counts = torch.bincount(leaf, minlength=L).cpu().numpy()
        leaf_count = trees["leaf_count"][t].astype(np.int64)
        node_count = trees["internal_count"][t].astype(np.int64)
        if candidate == "half":
            # the fault counts only the rows it kept
            leaf_count = torch.bincount(leaf[half.bool()],
                                        minlength=L).cpu().numpy()
            node_count = _node_counts(leaf_count, sf, lc, rc)
        count_bad += int(np.abs(counts - leaf_count).sum())
        nodes = _node_counts(counts, sf, lc, rc)
        count_bad += int(np.abs(np.where(sf >= 0, nodes - node_count,
                                         0)).sum())
        if t >= check_iterations:
            continue

        def histograms(at, dtype, rows=None):
            if objective == "lambdarank":
                g, h = ref.lambdarank_grads(at, y, group_ptr, dtype=dtype)
            else:
                g, h = ref.binary_grads(at, y, dtype=dtype)
            qg, qh, sg, sh = ref.quantize(g, h, levels, noise(t))
            if rows is not None:
                qg, qh = qg * rows, qh * rows
            return ref.leaf_histograms(bins, leaf, qg, qh, L, B,
                                       ones=rows), sg, sh

        # the judgement: float64 from the exact integer sums of the
        # gradients in the stated float32 (LambdaRank's in float64)
        exact = torch.float64 if objective == "lambdarank" \
            else torch.float32
        lh, sg, sh = histograms(scores, exact)
        gn = ref.gains(ref.node_histograms(lh, sf, lc, rc), sg, sh, edges,
                       cfg).reshape(len(sf), -1)
        best = gn.max(dim=1).values.cpu().numpy()
        live = np.nonzero(sf >= 0)[0]
        lv_r = ref.leaf_values(lh, sg, sh, cfg).cpu().numpy()
        if candidate == "program":
            chosen = gn[live, sf[live].astype(np.int64) * B
                        + tb[live].astype(np.int64)].cpu().numpy()
            lv_p = trees["leaf_value"][t].astype(np.float64)
        else:
            # the candidate's own choices on the same bins and tree: its
            # best candidate split per node and its leaf outputs
            dt = torch.bfloat16 if candidate == "bfloat16" else exact
            lh_c, sg_c, sh_c = histograms(
                start if candidate == "stale" else scores, exact
                if candidate != "bfloat16" else dt,
                half if candidate == "half" else None)
            gn_c = ref.gains(ref.node_histograms(lh_c, sf, lc, rc), sg_c,
                             sh_c, edges, cfg).reshape(len(sf), -1)
            pick = gn_c.argmax(dim=1)
            chosen = gn.gather(1, pick[:, None])[:, 0].cpu().numpy()[live]
            lv_p = ref.leaf_values(lh_c, sg_c, sh_c, cfg, dtype=dt).to(
                torch.float64).cpu().numpy()
            if candidate == "altered":
                lv_p[int(np.argmax(counts))] *= 1.1
        chosen = np.where(np.isfinite(chosen), chosen, -np.inf)
        good = np.isfinite(best[live]) & (best[live] > 0)
        lost = np.where(good, np.clip(best[live] - chosen, 0.0, None), 0.0)
        lost = np.where(np.isfinite(lost), lost, best[live])
        gain_lost += float(lost.sum())
        gain_best += float(np.where(good, best[live], 0.0).sum())
        made = counts > 0
        leaf_num += float((counts * np.abs(lv_p - lv_r))[made].sum())
        leaf_den += float((counts * np.abs(lv_r))[made].sum())
        # leaf-wise order: a leaf left unsplit may not beat any split made
        # after it was created (nor a positive gain left when growth
        # stopped early)
        par = _parents(sf, lc, rc, L)
        gl = ref.gains(lh, sg, sh, edges, cfg).reshape(L, -1).max(
            dim=1).values.cpu().numpy()
        chosen_at = np.full(len(sf), np.inf)
        chosen_at[live] = chosen
        full = live.size == len(sf)
        for slot in np.nonzero(made)[0]:
            later = chosen_at[par[slot] + 1:] if par[slot] >= 0 \
                else chosen_at
            floor = later.min() if later.size else np.inf
            if not full:
                floor = min(floor, 0.0)
            if np.isfinite(gl[slot]) and gl[slot] > floor:
                # an invalid split (-inf) loses the whole leaf's gain
                order_bad += float(gl[slot] - max(floor, 0.0))
        # the next iteration's scores from this tree, as the fit adds them
        scores = scores + torch.from_numpy(
            trees["leaf_value"][t].astype(np.float32)).to(X.device)[leaf]
    out["count_mismatch"] = float(count_bad)
    out["gain_gap"] = gain_lost / max(gain_best, 1e-30)
    out["order_gap"] = order_bad / max(gain_best, 1e-30)
    out["leaf_gap"] = leaf_num / max(leaf_den, 1e-30)
    if raw_rows is not None:
        th_all = trees["threshold"]
        xr = torch.from_numpy(raw_rows).to(X.device)
        exact_raw, _ = ref.walk_raw(xr, sf_all, th_all, lc_all, rc_all,
                                    trees["leaf_value"])
        # the walk is judged from the fit's own starting score, which
        # init_gap judges
        raw_ref = prog_init + exact_raw.cpu().numpy()
        if candidate == "bfloat16":
            low, _ = ref.walk_raw(xr, sf_all, th_all, lc_all, rc_all,
                                  trees["leaf_value"], dtype=torch.bfloat16)
            prog_raw = prog_init + low.to(torch.float64).cpu().numpy()
        elif candidate != "program":
            prog_raw = raw_ref
        out["raw_gap"] = float(np.max(np.abs(prog_raw - raw_ref))) \
            if raw_ref.size else 0.0
    return out


def score_reference(X: torch.Tensor, model: Dict[str, np.ndarray],
                    precision: str = "float64") -> np.ndarray:
    """The reference's raw scores of the rows ``X`` under the model's
    trees (the control's with ``precision="bfloat16"``)."""
    dt = torch.bfloat16 if precision == "bfloat16" else torch.float64
    tot, _ = ref.walk_raw(X, model["split_feature"], model["threshold"],
                          model["left_child"], model["right_child"],
                          model["leaf_value"], dtype=dt)
    return float(model["init_score"]) + tot.to(torch.float64).cpu().numpy()


def score_readings(raw_ref: np.ndarray, raw: np.ndarray, prob: np.ndarray,
                   pred: np.ndarray) -> Dict[str, float]:
    """A transform's raw scores, probabilities and predictions against
    the reference's raw scores of the same rows."""
    p1 = 1.0 / (1.0 + np.exp(-raw_ref))
    prob_ref = np.stack([1.0 - p1, p1], axis=1)
    pred_ref = (p1 > 0.5).astype(np.float64)
    return {"raw_gap": float(np.max(np.abs(raw - raw_ref))),
            "prob_gap": float(np.max(np.abs(prob - prob_ref))),
            "pred_mismatch": float(np.sum(pred != pred_ref))}


def control_outputs(raw_low: np.ndarray):
    """The transform's three outputs as the control computes them from
    its bfloat16 raw scores."""
    p1 = 1.0 / (1.0 + np.exp(-raw_low))
    return raw_low, np.stack([1.0 - p1, p1], axis=1), \
        (p1 > 0.5).astype(np.float64)
