"""Seeded query-document rows at the shape of MSLR-WEB30K Fold 1: 136
features, relevance 0-4, documents grouped by query.

The query sizes are the same for every seed: log-normal around the
configured mean, capped at the configured longest query (which appears at
least once), then trimmed so that they sum to ``num_data``; a seed only
shuffles their order.  So the padded LambdaRank work is the same in every
run.  Relevance follows the configured shares, skewed to 0 and 1, from a
latent quality with a per-query offset.  The 136 columns are assumed to
be of four kinds: integer counts (few distinct values), heavy-tailed
positive values, scores correlated with relevance, and small codes.
"""
from __future__ import annotations

import numpy as np
import torch

from .higgs import generator

#: a constant stream: the query sizes do not depend on the seed
SIZES_SEED = 0x4D534C52


def query_sizes(config: dict) -> np.ndarray:
    """The ``num_queries`` sizes, summing to ``num_data``, in a fixed
    order."""
    n, q = int(config["num_data"]), int(config["num_queries"])
    longest = int(config["longest_query"])
    rng = np.random.default_rng(SIZES_SEED)
    mean = n / q
    raw = rng.lognormal(np.log(mean) - 0.5, 1.0, q)
    sizes = np.clip(np.round(raw * n / raw.sum()), 1, longest).astype(
        np.int64)
    sizes[int(np.argmax(sizes))] = longest
    # trim or pad the largest-but-not-longest queries to the exact total
    gap = n - int(sizes.sum())
    order = np.argsort(-sizes, kind="stable")[1:]
    i = 0
    while gap != 0:
        j = order[i % order.size]
        step = 1 if gap > 0 else -1
        if 1 <= sizes[j] + step <= longest - 1:
            sizes[j] += step
            gap -= step
        i += 1
    return sizes


def features(n: int, q_latent: torch.Tensor, gen: torch.Generator,
             device) -> torch.Tensor:
    """``(n, 136)`` float32 features, some correlated with ``q_latent``."""
    F = 136
    z = torch.randn((n, F), generator=gen, device=device)
    u = torch.rand((n, F), generator=gen, device=device)
    x = torch.empty((n, F), dtype=torch.float32, device=device)
    ql = q_latent[:, None]
    j = torch.arange(40, device=device, dtype=torch.float32)
    # integer counts with means from 0.5 to ~40
    mu = torch.log(0.5 + j)[None, :]
    x[:, :40] = torch.floor(torch.exp(mu + 0.8 * z[:, :40] + 0.4 * ql))
    # heavy-tailed positive values
    x[:, 40:80] = torch.exp(z[:, 40:80] + 0.3 * ql)
    # scores correlated with relevance
    x[:, 80:120] = z[:, 80:120] + 0.8 * ql
    # small codes with 2..6 values
    k = (2 + torch.arange(16, device=device) % 5).to(torch.float32)
    x[:, 120:] = torch.floor(u[:, 120:] * k[None, :])
    return x


def make(config: dict, seed: int, device) -> dict:
    """``X`` ``(n, 136)``, relevance ``y`` and ``group_ptr`` (host int64,
    ``num_queries + 1`` bounds; rows of a query are contiguous)."""
    sizes = query_sizes(config)
    order = np.random.default_rng(int(seed) % (1 << 63)).permutation(
        sizes.size)
    sizes = sizes[order]
    group_ptr = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    n = int(group_ptr[-1])
    gen = generator(seed, device)
    offset = torch.randn((sizes.size,), generator=gen, device=device) * 0.5
    qid = torch.repeat_interleave(
        torch.arange(sizes.size, device=device),
        torch.from_numpy(sizes).to(device))
    latent = torch.randn((n,), generator=gen, device=device) + offset[qid]
    x = features(n, latent, gen, device)
    # relevance by the configured shares of the latent's distribution
    shares = np.asarray(config["relevance_shares"], np.float64)
    cuts = torch.distributions.Normal(0.0, float(np.sqrt(1.25))).icdf(
        torch.tensor(np.cumsum(shares)[:-1], dtype=torch.float32))
    y = torch.bucketize(latent, cuts.to(device)).to(torch.float32)
    return {"X": x, "y": y, "group_ptr": group_ptr}
