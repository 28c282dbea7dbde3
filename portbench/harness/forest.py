"""A seeded forest in the program's array-of-nodes layout, for cells that
score a model: the benchmark's stand-in for a model file a user loads.

Each tree grows best-first as a leaf-wise fit does.  Every step splits a
leaf drawn in proportion to its share of the rows raised to
``leaf_choice_exponent``, on a uniformly drawn feature.  The smaller
child's share of the leaf's rows is drawn from ``smaller_share``, a table
of its quantiles, and the smaller child goes left or right by a coin.
Both numbers come from the trees of a fit of the configuration (its
``score_forest``), so the generated trees are as deep and as lopsided as
fitted ones.  Features are treated as independent, so a leaf's rows are
the product of its ranges in quantile space, and a cut's raw threshold is
read from an empirical quantile table of the traffic's own rows.  Node
``s`` is step ``s``'s split; its left child keeps the split leaf's slot
and its right child takes slot ``s + 1``, as in a fitted leaf-wise tree.
All trees grow at once on the device.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch


def smaller_share(u: torch.Tensor, table: Sequence[Sequence[float]]
                  ) -> torch.Tensor:
    """The smaller child's share at probabilities ``u``: the table's
    ``[probability, share]`` points, linear between them."""
    p = torch.tensor([r[0] for r in table], dtype=u.dtype, device=u.device)
    q = torch.tensor([r[1] for r in table], dtype=u.dtype, device=u.device)
    k = torch.clamp(torch.searchsorted(p, u, right=True), 1, p.numel() - 1)
    w = (u - p[k - 1]) / (p[k] - p[k - 1])
    return q[k - 1] + w * (q[k] - q[k - 1])


def generate(qtable: torch.Tensor, trees: int, leaves: int,
             gen: torch.Generator, shape: dict, leaf_scale: float = 0.05
             ) -> Dict[str, np.ndarray]:
    """``trees`` trees of ``leaves`` leaves over ``qtable``'s ``(F, S)``
    sorted feature values, shaped by ``shape``
    (``leaf_choice_exponent``, ``smaller_share``).  Returns host arrays:
    ``split_feature``, ``threshold``, ``left_child``, ``right_child``
    ``(T, M)``, ``leaf_value`` ``(T, L)``, ``leaf_share`` ``(T, L)`` (a
    leaf's share of the rows, as drawn) and ``max_depth``."""
    dev = qtable.device
    F, S = qtable.shape
    T, L, M = trees, leaves, leaves - 1
    ar = torch.arange(T, device=dev)
    lo = torch.zeros((T, L, F), device=dev)
    hi = torch.ones((T, L, F), device=dev)
    alpha = float(shape["leaf_choice_exponent"])
    # the smaller child's head start in the draw: ramped up over the
    # first trees, fading with depth
    ramp = torch.clamp(torch.arange(T, device=dev, dtype=torch.float64)
                       / max(float(shape["ramp_trees"]), 1.0), max=1.0)
    bonus0 = float(shape["smaller_bonus"]) * ramp
    decay = float(shape["bonus_decay"])
    # the forest's depth, the same on every seed: no leaf splits past it,
    # and the last tree's first splits chain down to it
    D = int(shape["max_depth"])
    chain = ar == T - 1
    table = shape["smaller_share"]
    # log shares in float64: deep leaves' shares pass float32's range
    logshare = torch.full((T, L), -torch.inf, dtype=torch.float64,
                          device=dev)
    logshare[:, 0] = 0.0
    heat = torch.zeros((T, L), dtype=torch.float64, device=dev)
    depth = torch.zeros((T, L), dtype=torch.int64, device=dev)
    parent = torch.full((T, L), -1, dtype=torch.int64, device=dev)
    side = torch.zeros((T, L), dtype=torch.int64, device=dev)
    sf = torch.full((T, M), -1, dtype=torch.int64, device=dev)
    th = torch.zeros((T, M), dtype=torch.float32, device=dev)
    lc = torch.full((T, M), -1, dtype=torch.int64, device=dev)
    rc = torch.full((T, M), -1, dtype=torch.int64, device=dev)
    for s in range(M):
        live = torch.isfinite(logshare) & (depth < D)
        pick = torch.where(live, alpha * logshare + heat, -torch.inf)
        if s < D:
            deepest = live & (depth == torch.where(
                live, depth, -1).max(1, True).values)
            pick = torch.where(chain[:, None] & ~deepest, -torch.inf,
                               pick)
        w = torch.exp(pick - pick.max(1, True).values)
        j = torch.multinomial(w, 1, generator=gen)[:, 0]
        f = torch.randint(F, (T,), generator=gen, device=dev)
        u = torch.rand((2, T), generator=gen, device=dev,
                       dtype=torch.float64)
        b = smaller_share(u[0], table)
        r = torch.where(u[1] < 0.5, b, 1.0 - b).to(torch.float32)
        l0, h0 = lo[ar, j, f], hi[ar, j, f]
        cut = l0 + (h0 - l0) * r
        q = torch.clamp((cut * (S - 1)).to(torch.int64), 0, S - 1)
        sf[:, s] = f
        th[:, s] = qtable[f, q]
        # the edge that led to leaf j now leads to node s
        p, sd = parent[ar, j], side[ar, j]
        left, right = (p >= 0) & (sd == 0), (p >= 0) & (sd == 1)
        lc[ar[left], p[left]] = s
        rc[ar[right], p[right]] = s
        new = s + 1
        lc[:, s] = ~j
        rc[:, s] = ~new
        lo[:, new], hi[:, new] = lo[ar, j], hi[ar, j]
        hi[ar, j, f] = cut
        lo[ar, new, f] = cut
        hj = heat[ar, j]
        bonus = bonus0 * decay ** depth[ar, j].double()
        left_smaller = u[1] < 0.5
        heat[:, new] = hj + torch.where(left_smaller, 0.0, bonus)
        heat[ar, j] = hj + torch.where(left_smaller, bonus, 0.0)
        lj = logshare[ar, j]
        logshare[:, new] = lj + torch.log1p(-r.double())
        logshare[ar, j] = lj + torch.log(r.double())
        parent[ar, j] = s
        side[ar, j] = 0
        parent[:, new] = s
        side[:, new] = 1
        depth[ar, j] += 1
        depth[:, new] = depth[ar, j]
    leaf_value = torch.randn((T, L), generator=gen, device=dev) * leaf_scale
    return {"split_feature": sf.to(torch.int32).cpu().numpy(),
            "threshold": th.cpu().numpy(),
            "left_child": lc.to(torch.int32).cpu().numpy(),
            "right_child": rc.to(torch.int32).cpu().numpy(),
            "leaf_value": leaf_value.cpu().numpy(),
            "leaf_share": torch.exp(logshare).cpu().numpy(),
            "max_depth": int(depth.max())}
