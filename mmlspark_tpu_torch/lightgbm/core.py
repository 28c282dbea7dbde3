"""GBDT training core in PyTorch (port of ``mmlspark_tpu/lightgbm/core.py``,
the single-shard subset).

One boosting iteration: objective gradients (binary, multiclass, the L2
regression and the six other regression objectives, with the GOSS, RF or
DART adjustments and the bagging mask; or LambdaRank's pairwise lambdas,
``make_lambdarank_grad_fn``), per-row quantization
(``ops.histogram.quantize_gradients``), then one tree per class (``K =
num_class`` for multiclass, stored round-robin: tree ``t`` scores class
``t % K``).  Two growers share
the fused frontier step (``ops.cuda_histogram.frontier_step``: a histogram
build, the integer sibling subtraction and the split-gain scan, on the two
Hopper kernels):

- level-wise (``make_tree_grower``): one step per level while the frontier
  has at most ``FUSED_MAX_NODES`` parents — the JAX package's per-level
  gate — and a histogram build plus a torch gain scan past it;
- leaf-wise (``make_leafwise_grower``, the estimators' default): one step
  at the root and one per split, ``num_leaves`` in all, with the stored
  per-leaf histograms in an int16 carry where the row bound allows.

Categorical features leave the fused step, as in the JAX package: their
histograms come from ``build_quantized`` (the same kernels, gains off) and
the one-vs-rest and sorted-subset split search runs in torch
(``_CatTools``).  Edges are found on the host; ``train()`` applies the
bins on the card.  The host drives a plain per-iteration loop; tree
arrays stay on the device until the end.  ``train()`` checkpoints,
honours preemption and resumes (``io.checkpoint``, the JAX package's file
format).  ``train_streamed()`` is the out-of-core driver: host-RAM tiles
through pinned memory on a copy stream into ``build_quantized``, both
growers, with the same checkpoints and an elastic (re-tiled) resume.
Both drivers serve the live training monitor (``monitor_port``,
``monitor_stall_timeout_s``: ``observability.trainwatch``) and mark their
phases with ``ambient_phase`` as the JAX package's do.  Both read the
histogram knobs once per call (``MMLSPARK_TPU_HIST_BACKEND`` picks
``cuda``, ``matmul`` or ``scatter`` for the growers and the tile builds,
``MMLSPARK_TPU_HIST_QUANT`` overrides ``use_quantized_grad``), and the
streamed driver books every staged tile's bytes under
``mmlspark_device_transfer_bytes_total{site="lightgbm.ooc_tile"}``.  Not
ported yet, raising ``NotImplementedError`` that names its ROADMAP.md
entry: row sharding and voting.
The JAX package's scan-chunked multi-iteration path exists to amortize a
device relay's per-dispatch latency; the port launches per iteration and
has no counterpart.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import math
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .._device import DeviceLike, default_quantized, resolve_device
from ..io.checkpoint import (CheckpointManager, book_reshard,
                             check_resume_arg, resume_required_error,
                             topology_stanza)
from ..models.gbdt import GBDTBooster, children_depth_bound, \
    perfect_tree_children
from ..ops import cuda_histogram
from ..observability.compute import device_put
from ..observability.tracing import ambient_phase
from ..ops import histogram as hist_ops
from ..utils.resilience import PreemptionToken, preemption_scope
from .binning import BinMapper


@dataclasses.dataclass
class GBDTParams:
    num_iterations: int = 100
    learning_rate: float = 0.1
    max_depth: int = 0               # leaf-wise: depth cap (0 = uncapped);
    #                                  level-wise: tree depth (0 -> 5)
    num_leaves: Optional[int] = None  # leaf-wise leaf budget
    growth: str = "auto"             # leaf | level | auto (leaf iff
    #                                  num_leaves given, else level)
    max_bin: int = 255
    objective: str = "binary"
    num_class: int = 1
    boosting_type: str = "gbdt"      # gbdt | rf | dart | goss
    lambda_l1: float = 0.0
    lambda_l2: float = 0.0
    min_data_in_leaf: int = 20
    min_sum_hessian_in_leaf: float = 1e-3
    min_gain_to_split: float = 0.0
    bagging_fraction: float = 1.0
    bagging_freq: int = 0
    feature_fraction: float = 1.0
    # goss
    top_rate: float = 0.2
    other_rate: float = 0.1
    # dart
    drop_rate: float = 0.1
    max_drop: int = 50
    skip_drop: float = 0.5
    # misc
    max_delta_step: float = 0.0
    sigmoid: float = 1.0
    alpha: float = 0.9
    tweedie_variance_power: float = 1.5
    early_stopping_round: int = 0
    metric: str = ""
    seed: int = 0
    verbosity: int = -1
    categorical_features: Optional[Tuple[int, ...]] = None
    max_cat_to_onehot: int = 4
    cat_smooth: float = 10.0
    cat_l2: float = 10.0
    max_cat_threshold: int = 32
    cat_subset: Optional[Tuple[int, ...]] = None
    voting_k: int = 0
    # quantized training (LightGBM 4.x): None = on for the card, off on
    # the CPU (train() resolves it, as the JAX package does)
    use_quantized_grad: Optional[bool] = None
    num_grad_quant_bins: int = 16

    def resolve(self) -> "GBDTParams":
        """Normalize growth mode, as the JAX package does."""
        p = dataclasses.replace(self)
        if p.growth == "auto":
            p.growth = "leaf" if p.num_leaves else "level"
        if p.growth == "level":
            if p.max_depth <= 0:
                p.max_depth = max(1, int(math.ceil(math.log2(
                    max(2, p.num_leaves))))) if p.num_leaves else 5
            p.num_leaves = 2 ** p.max_depth
        elif p.growth == "leaf":
            p.num_leaves = p.num_leaves or 31
            if p.num_leaves < 2:
                raise ValueError("num_leaves must be >= 2")
        else:
            raise ValueError(f"growth must be leaf|level|auto, got "
                             f"{p.growth!r}")
        if p.boosting_type == "rf" and p.bagging_freq == 0:
            p.bagging_freq, p.bagging_fraction = 1, min(p.bagging_fraction,
                                                        0.632)
        if not 4 <= p.num_grad_quant_bins <= 128:
            raise ValueError("num_grad_quant_bins must be in [4, 128] "
                             f"(int8 operand lanes), got "
                             f"{p.num_grad_quant_bins}")
        return p

    @property
    def depth_bound(self) -> int:
        """Walk-iteration bound for trees grown under these params (call on
        a resolved instance)."""
        if self.growth == "level":
            return max(1, self.max_depth)
        cap = self.max_depth if self.max_depth > 0 \
            else (self.num_leaves or 31) - 1
        return max(1, min(cap, (self.num_leaves or 31) - 1))


# ---------------------------------------------------------------------------
# objectives: (scores (n, K), y, w) -> grad, hess (n, K)
# ---------------------------------------------------------------------------

def make_objective(params: GBDTParams) -> Optional[Callable]:
    """The objective's ``(scores, y, w) -> (grad, hess)``, each ``(n, K)``
    (``K = num_class`` for multiclass, else 1), with the JAX package's clips
    and hessian floors.  ``lambdarank`` has no pointwise objective (None):
    its gradients come from ``make_lambdarank_grad_fn``."""
    obj, K = params.objective, params.num_class
    sig, alpha = params.sigmoid, params.alpha
    rho = params.tweedie_variance_power

    def ones(g, w):
        return (w * torch.ones_like(g))[:, None]

    def binary(scores, y, w):
        p = 1.0 / (1.0 + torch.exp(-sig * scores[:, 0]))
        g = sig * (p - y)
        h = torch.clamp(sig * sig * p * (1.0 - p), min=1e-16)
        return (g * w)[:, None], (h * w)[:, None]

    def multiclass(scores, y, w):
        z = scores - scores.max(dim=1, keepdim=True).values
        e = torch.exp(z)
        p = e / e.sum(dim=1, keepdim=True)
        onehot = (y[:, None] == torch.arange(K, device=y.device)[None, :]) \
            .to(p.dtype)
        g = p - onehot
        h = torch.clamp(2.0 * p * (1.0 - p), min=1e-16)
        return g * w[:, None], h * w[:, None]

    def l2(scores, y, w):
        g = scores[:, 0] - y
        return (g * w)[:, None], ones(g, w)

    def l1(scores, y, w):
        g = torch.sign(scores[:, 0] - y)
        return (g * w)[:, None], ones(g, w)

    def huber(scores, y, w):
        g = torch.clamp(scores[:, 0] - y, -alpha, alpha)
        return (g * w)[:, None], ones(g, w)

    def quantile(scores, y, w):
        d = scores[:, 0] - y
        g = torch.where(d >= 0, 1.0 - alpha, -alpha)
        return (g * w)[:, None], ones(g, w)

    def poisson(scores, y, w):
        # log link: the raw score models log(mean); nll grad = exp(s) - y
        mu = torch.exp(torch.clamp(scores[:, 0], -30.0, 30.0))
        g = mu - y
        h = torch.clamp(mu, min=1e-16)
        return (g * w)[:, None], (h * w)[:, None]

    def tweedie(scores, y, w):
        # compound-Poisson deviance with log link, variance power rho in
        # (1, 2): grad = -y*e^{(1-rho)s} + e^{(2-rho)s}
        s_ = torch.clamp(scores[:, 0], -30.0, 30.0)
        a = torch.exp((1.0 - rho) * s_)
        b = torch.exp((2.0 - rho) * s_)
        g = -y * a + b
        h = torch.clamp(-(1.0 - rho) * y * a + (2.0 - rho) * b, min=1e-16)
        return (g * w)[:, None], (h * w)[:, None]

    def gamma(scores, y, w):
        # gamma nll with log link: grad = 1 - y*e^{-s}, hess = y*e^{-s}
        e = torch.exp(-torch.clamp(scores[:, 0], -30.0, 30.0))
        g = 1.0 - y * e
        h = torch.clamp(y * e, min=1e-16)
        return (g * w)[:, None], (h * w)[:, None]

    table = {"binary": binary, "multiclass": multiclass, "regression": l2,
             "regression_l1": l1, "huber": huber, "quantile": quantile,
             "poisson": poisson, "tweedie": tweedie, "gamma": gamma}
    if obj not in table and obj != "lambdarank":
        raise ValueError(f"unknown objective {obj!r}")
    return table.get(obj)


# The pairwise pass holds a few (queries, Gmax, Gmax) float32 temporaries at
# once; queries go through it in chunks of whole queries so that those
# temporaries together stay under this many bytes.  A query's lambdas do not
# depend on the chunking: every chunk is padded to the same Gmax.
_LAMBDA_PAIR_BYTES = 2 << 30
# the float32-sized (q, Gmax, Gmax) temporaries live at the pass's peak
# (the bool pair mask counted as a quarter of one)
_LAMBDA_PAIR_TEMPS = 6


def _lambda_chunk(S, Y, M, sigmoid: float):
    """LambdaRank's ``(G, H)`` for a chunk of padded queries, ``(q, Gmax)``
    each: the JAX package's |ΔNDCG|-weighted pairwise lambdas
    (``mmlspark_tpu/lightgbm/core.py:273-301``), term for term.  The rank
    sort is stable, as ``jnp.argsort``: at an all-tied first iteration the
    ranks come from the tie order alone."""
    q, gmax = S.shape
    dev = S.device
    gain = (torch.pow(2.0, Y) - 1.0) * M
    key = -torch.where(M > 0, S, torch.full_like(S, -math.inf))
    order = torch.argsort(key, dim=1, stable=True)
    slots = torch.arange(gmax, device=dev)
    ranks = torch.empty_like(order).scatter_(
        1, order, slots.expand(q, gmax)).to(torch.float32)   # 0-based rank
    disc = 1.0 / torch.log2(ranks + 2.0)
    ideal_gain = -torch.sort(-gain, dim=1).values
    ideal_disc = 1.0 / torch.log2(slots.to(torch.float32) + 2.0)
    idcg = torch.clamp((ideal_gain * ideal_disc).sum(dim=1, keepdim=True),
                       min=1e-9)
    on = M > 0
    better = (Y[:, :, None] > Y[:, None, :]) & on[:, :, None] & on[:, None, :]
    # P(j beats i), in place: 1 / (1 + exp(sigmoid * (S_i - S_j)))
    rho = (S[:, :, None] - S[:, None, :]).mul_(sigmoid).exp_().add_(1.0) \
        .reciprocal_()
    delta = (gain[:, :, None] - gain[:, None, :]).mul_(
        disc[:, :, None] - disc[:, None, :]).abs_().div_(idcg[:, :, None])
    lam = torch.where(better, -sigmoid * rho * delta, 0.0)
    G = lam.sum(dim=2) - lam.sum(dim=1)
    del lam
    hess = torch.where(better, sigmoid * sigmoid * rho * (1 - rho) * delta,
                       0.0)
    H = torch.clamp(hess.sum(dim=2) + hess.sum(dim=1), min=1e-16)
    return G, H


def make_lambdarank_grad_fn(y: np.ndarray, group_ptr: np.ndarray,
                            sigmoid: float = 1.0, device: DeviceLike = None):
    """LambdaRank gradients with |ΔNDCG| weighting, resident on the device
    (the JAX package's ``make_lambdarank_grad_fn``).

    Queries are packed to ``(Q, Gmax)`` by index gathers built once on the
    host; the returned ``fn(scores) -> (g, h)``, each ``(n, 1)``, stays on
    the device: no host round trip and no wait for the card per iteration.
    Rows outside ``group_ptr`` are inert (g = 0, h = 1e-16).  The pairwise
    pass runs in chunks of whole queries (``_LAMBDA_PAIR_BYTES``): the
    ``(first, end)`` query bounds of each are ``fn.chunks``."""
    dev = resolve_device(device)
    gp = np.asarray(group_ptr, np.int64)
    n = len(y)
    sizes = np.diff(gp)
    gmax = int(sizes.max())
    slots = np.arange(gmax)
    M_np = slots[None, :] < sizes[:, None]
    pack_np = np.where(M_np, gp[:-1, None] + slots[None, :], 0)
    row_q = np.zeros(n, np.int64)              # row -> (query, slot)
    row_slot = np.zeros(n, np.int64)
    covered_np = np.zeros(n, bool)
    qq, ss = np.nonzero(M_np)
    rows = pack_np[qq, ss]
    row_q[rows], row_slot[rows], covered_np[rows] = qq, ss, True
    M_f = M_np.astype(np.float32)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    Y = t(np.asarray(y, np.float32)[pack_np] * M_f)
    M, pack = t(M_f), t(pack_np)
    rq, rs, covered = t(row_q), t(row_slot), t(covered_np)
    Q = M.shape[0]
    step = max(1, _LAMBDA_PAIR_BYTES // (_LAMBDA_PAIR_TEMPS * gmax * gmax
                                         * 4))
    bounds = [(a, min(Q, a + step)) for a in range(0, Q, step)]

    def fn(scores: torch.Tensor):
        S = scores[:, 0][pack] * M
        G = torch.empty((Q, gmax), dtype=torch.float32, device=dev)
        H = torch.empty_like(G)
        for a, b in bounds:
            G[a:b], H[a:b] = _lambda_chunk(S[a:b], Y[a:b], M[a:b], sigmoid)
        g_row = torch.where(covered, G[rq, rs], 0.0)
        h_row = torch.where(covered, H[rq, rs], 1e-16)
        return g_row[:, None], h_row[:, None]

    fn.chunks = bounds
    return fn


def lambdarank_grads(scores: np.ndarray, y: np.ndarray, group_ptr: np.ndarray,
                     sigmoid: float = 1.0, trunc: int = 30,
                     device: DeviceLike = None) -> Tuple[np.ndarray,
                                                         np.ndarray]:
    """One-shot host-facing wrapper over ``make_lambdarank_grad_fn``.
    ``trunc`` is accepted and not used, as in the JAX package."""
    dev = resolve_device(device)
    fn = make_lambdarank_grad_fn(y, group_ptr, sigmoid, dev)
    s = torch.from_numpy(np.asarray(scores, np.float32)
                         .reshape(len(y), -1)).to(dev)
    g, h = fn(s)
    return g.cpu().numpy(), h.cpu().numpy()


def init_score_of(objective: str, y: np.ndarray, w: np.ndarray,
                  sigmoid: float = 1.0) -> float:
    """The starting score (BoostFromAverage analogue), as the JAX package's
    ``train()`` computes it on the host."""
    if objective == "binary":
        pbar = float(np.clip(np.average(y, weights=w), 1e-6, 1 - 1e-6))
        return math.log(pbar / (1 - pbar)) / sigmoid
    if objective in ("regression", "huber"):
        return float(np.average(y, weights=w))
    if objective in ("poisson", "tweedie", "gamma"):       # log link
        return float(np.log(max(np.average(y, weights=w), 1e-9)))
    if objective == "regression_l1":
        return float(np.median(y))
    return 0.0


def check_labels(p: GBDTParams, y: np.ndarray, F: int) -> None:
    """The JAX package's ``ValueError``s for the categorical index range,
    the labels of the log-link objectives and the tweedie power."""
    if p.categorical_features:
        bad = [i for i in p.categorical_features if not 0 <= int(i) < F]
        if bad:
            raise ValueError(f"categorical_features indices {bad} out of "
                             f"range [0, {F}) — negative indices are not "
                             f"interpreted pythonically")
    if p.objective in ("poisson", "tweedie") and (y < 0).any():
        raise ValueError(f"objective {p.objective!r} requires non-negative "
                         f"labels (min label {float(y.min())})")
    if p.objective == "gamma" and (y <= 0).any():
        raise ValueError("objective 'gamma' requires strictly positive "
                         f"labels (min label {float(y.min())})")
    if p.objective == "tweedie" and not 1.0 < p.tweedie_variance_power < 2.0:
        raise ValueError(
            f"tweedie_variance_power must be in (1, 2), got "
            f"{p.tweedie_variance_power}; use objective='poisson' for the "
            f"rho=1 limit")


# ---------------------------------------------------------------------------
# tree grower
# ---------------------------------------------------------------------------

def _check_quant_psum_bound(use_quant: bool, quant_bins: int,
                            axis_name, psum_row_bound) -> None:
    """Sharded overflow guard: the quantized builds check int32 overflow
    against their LOCAL shard's rows, but the psum accumulates GLOBAL sums
    — a root-level cell can hold up to the total row count, so the grower,
    which knows the global bound, checks it (the JAX package's guard)."""
    if not use_quant or axis_name is None or psum_row_bound is None:
        return
    qh_cap = max(1, quant_bins - 1)
    if int(psum_row_bound) * qh_cap >= (1 << 31):
        raise ValueError(
            "quantized histograms overflow int32 after the cross-shard "
            f"psum above {(1 << 31) // qh_cap} total rows at "
            f"{quant_bins} quantization bins — lower num_grad_quant_bins "
            "or disable use_quantized_grad")


def _use_fused_frontier(use_quant: bool, has_cat: bool, num_bins: int,
                        quant_bins: int, backend: str = "cuda",
                        axis_name=None) -> bool:
    """One eligibility predicate for the fused frontier step: the quantized
    numerical-split path on one shard, with the histogram backend resolved
    to ``cuda`` (the JAX package's ``pallas``: the Hopper kernels for a
    CUDA tensor, their plain PyTorch versions for a CPU tensor).  Sharded,
    the gains must run on the summed (global) histogram, so the step's
    builds go through ``build_quantized`` and the scan runs in torch, as
    in the JAX package."""
    return (use_quant and axis_name is None and not has_cat
            and backend == "cuda"
            and cuda_histogram.supported(num_bins, quant_bins))


def _grow_backend(backend: str, use_quant: bool, has_cat: bool,
                  num_bins: int, quant_bins: int, device, axis_name=None):
    """``(backend, fused, kernel_scan)`` for one tree on ``device``: the
    resolved histogram backend, whether the fused frontier step runs, and
    whether a step the ``cuda`` backend would have fused instead builds
    through ``backend`` and scans its gains in the finish kernel's op
    order (so every backend grows the ``cuda`` backend's tree)."""
    bk = hist_ops.resolve_quantized_backend(backend, device)
    fused = _use_fused_frontier(use_quant, has_cat, num_bins, quant_bins, bk,
                                axis_name)
    kernel_scan = not fused and _use_fused_frontier(
        use_quant, has_cat, num_bins, quant_bins, axis_name=axis_name)
    return bk, fused, kernel_scan


def _top_k(x: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last dim: the k largest, the lower index
    first among equals (a stable descending sort; ``torch.topk`` promises
    no order for ties, and votes tie all the time)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _sharded_ops(use_quant: bool, quant_bins: int, axis_name, psum_row_bound,
                 mesh):
    """The growers' two sums over the axis: ``psum_hist`` (a histogram:
    the packed integer allreduce, or a float sum) and ``psum`` (ballots,
    anything else)."""
    from ..parallel.collectives import histogram_psum, psum

    def psum_hist(h):
        if use_quant:
            return histogram_psum(h, axis_name, row_bound=psum_row_bound,
                                  quant_bins=quant_bins, mesh=mesh)
        return psum(h, axis_name, mesh)

    def psum_any(x):
        return psum(x, axis_name, mesh)

    return psum_hist, psum_any


def _votes(per_feat: torch.Tensor, voting_k: int, k2: int, psum_any):
    """Voting-parallel's feature pick per node from ``(nodes, F)`` LOCAL
    best gains: each rank ballots its top ``voting_k`` (a rank with fewer
    valid candidates casts no ballot for the tie-broken rest), ballots sum
    over the axis, and the global top ``k2`` win.  Returns ``(nodes, k2)``
    feature ids, the same on every rank."""
    top_gain, top_idx = _top_k(per_feat, voting_k)
    ballot = (top_gain > -math.inf).to(torch.float32)
    votes = torch.zeros(per_feat.shape, dtype=torch.float32,
                        device=per_feat.device).scatter_add_(1, top_idx,
                                                             ballot)
    _, sel = _top_k(psum_any(votes), k2)
    return sel


class Tree(NamedTuple):
    """One grown tree as array-of-nodes children (leaves encoded ``~leaf``;
    the level-wise grower's is the perfect BFS layout) plus each row's
    leaf."""
    left_child: torch.Tensor       # (I,) int32
    right_child: torch.Tensor
    split_feature: torch.Tensor    # (I,) int32, -1 = no split
    threshold: torch.Tensor        # (I,) float32 (a category's code)
    threshold_bin: torch.Tensor    # (I,) int32
    split_gain: torch.Tensor       # (I,) float32
    internal_value: torch.Tensor   # (I,) float32
    internal_count: torch.Tensor   # (I,) float32
    leaf_value: torch.Tensor       # (L,) float32
    leaf_count: torch.Tensor       # (L,) float32
    leaf_of_row: torch.Tensor      # (n,) int64
    # (I, B) bool LEFT category set of each categorical split; None
    # without categorical features
    cat_bitset: Optional[torch.Tensor] = None


def _device_mask(F: int, idx, dev: torch.device) -> torch.Tensor:
    """(F,) bool with the indices ``idx`` set, built on ``dev`` from
    scalars, one range of consecutive indices at a time: no host-to-card
    copy, which would wait for the card inside the leaf-wise loop."""
    ar = torch.arange(F, device=dev)
    mask = torch.zeros((F,), dtype=torch.bool, device=dev)
    idx = sorted(int(i) for i in idx)
    start = 0
    for k in range(1, len(idx) + 1):
        if k == len(idx) or idx[k] != idx[k - 1] + 1:
            mask |= (ar >= idx[start]) & (ar <= idx[k - 1])
            start = k
    return mask


class _CatTools:
    """Categorical split machinery both growers share (the JAX package's
    ``_CatTools``, ``mmlspark_tpu/lightgbm/core.py:382-454``): the masks,
    the cat_l2-regularised score, the ratio sort of a node's categories
    (the many-vs-many candidate scan) and the winner's membership.

    The sort is stable (as ``jnp.argsort``): unseen bins and the NaN
    catch-all all sort last at +inf and equal ratios tie, so an unstable
    sort would order them differently on the card than on the CPU."""

    def __init__(self, params: GBDTParams, F: int, B: int):
        self.B = B
        self.cat_np = np.zeros((F,), bool)
        if params.categorical_features:
            self.cat_np[list(params.categorical_features)] = True
        self.sub_np = np.zeros((F,), bool)
        if params.cat_subset:
            self.sub_np[list(params.cat_subset)] = True
        self.has_cat = bool(self.cat_np.any())
        self.has_subset = bool(self.sub_np.any())
        self.cat_smooth = params.cat_smooth
        self.cat_l2 = params.cat_l2
        self.maxcat = float(params.max_cat_threshold)
        self.l1, self.l2 = params.lambda_l1, params.lambda_l2
        self._masks: Dict[torch.device, tuple] = {}

    def masks(self, dev: torch.device):
        """``(cat_b, sub_b)`` (F,) bool on ``dev``."""
        if dev not in self._masks:
            F = self.cat_np.shape[0]
            self._masks[dev] = tuple(
                _device_mask(F, np.nonzero(m)[0], dev)
                for m in (self.cat_np, self.sub_np))
        return self._masks[dev]

    def edge_ok(self, edges: torch.Tensor) -> torch.Tensor:
        """(F, B) split candidates: a numerical split needs a finite edge;
        every code of a categorical feature is a candidate except the last
        bin, the NaN/overflow catch-all (a split on it would route missing
        rows left at train but right at predict)."""
        F, dev = edges.shape[0], edges.device
        ok = torch.cat([torch.isfinite(edges),
                        torch.zeros((F, 1), dtype=torch.bool, device=dev)],
                       dim=1)
        if self.has_cat:
            cat_b, _ = self.masks(dev)
            codes = (torch.arange(self.B, device=dev) != self.B - 1)[None]
            ok = torch.where(cat_b[:, None], codes, ok)
        return ok

    def leaf_score_cat(self, G, H):
        # subset splits score under extra regularisation (LightGBM cat_l2)
        t = torch.sign(G) * torch.clamp(G.abs() - self.l1, min=0.0)
        return t ** 2 / (H + self.l2 + self.cat_l2)

    def sort_order(self, hist_d: torch.Tensor):
        """Bins of ``(..., B, 3)`` float histograms sorted ascending by
        grad/hess ratio (cat_smooth in the denominator); unseen bins and
        the NaN catch-all sort last (+inf).  Returns ``(order, seen)``."""
        B = self.B
        seenable = torch.arange(B, device=hist_d.device) != B - 1
        seen = (hist_d[..., 2] > 0) & seenable
        G, H = hist_d[..., 0], hist_d[..., 1]
        ratio = torch.where(seen, G / (H + self.cat_smooth),
                            torch.full_like(G, math.inf))
        return torch.argsort(ratio, dim=-1, stable=True), seen

    def sorted_prefix(self, hist_raw, hist_d, prefix):
        """Sorted-subset candidate stats: the prefix sums (``prefix`` of the
        ratio-sorted raw histograms) at position k are the stats of the best
        k+1 seen categories.  Returns ``(prefix sums, valid)``."""
        order, seen = self.sort_order(hist_d)
        subcum = prefix(torch.take_along_dim(hist_raw, order[..., None],
                                             dim=-2))
        nseen = seen.sum(dim=-1, keepdim=True).to(torch.float32)
        k1 = torch.arange(1, self.B + 1, device=hist_d.device,
                          dtype=torch.float32)
        # a prefix must leave >= 1 seen category right, and the smaller side
        # stays under max_cat_threshold (LightGBM's subset-size cap)
        sub_ok = (k1 < nseen) & ((k1 <= self.maxcat)
                                 | (nseen - k1 <= self.maxcat))
        return subcum, sub_ok

    def winner_member(self, win_hist_d, bf, bb):
        """(nodes, B) membership of each node's winning split, from its
        ``(nodes, B, 3)`` float histogram: a subset winner takes the first
        bb+1 bins of the ratio sort, a one-vs-rest winner the code bb.  Only
        read where the winning feature is categorical."""
        B, dev = self.B, win_hist_d.device
        ar = torch.arange(B, device=dev)[None, :]
        onehot_m = ar == bb[:, None]
        if not self.has_subset:
            return onehot_m
        order, _ = self.sort_order(win_hist_d)
        member_sub = torch.zeros_like(onehot_m).scatter(
            1, order, ar <= bb[:, None])
        _, sub_b = self.masks(dev)
        return torch.where(sub_b.index_select(0, bf)[:, None], member_sub,
                           onehot_m)


def _split_math(params: GBDTParams, ct: _CatTools, float_prefix=None):
    """The split arithmetic the growers share: ``(leaf_output,
    split_gains)``.  ``float_prefix(h)`` sums float histograms over dim -2
    (default ``torch.cumsum``; the streamed driver passes the kernel's
    sequential bin order)."""
    l1, l2 = params.lambda_l1, params.lambda_l2
    min_data = float(params.min_data_in_leaf)
    min_hess = params.min_sum_hessian_in_leaf
    max_delta = params.max_delta_step
    if float_prefix is None:
        def float_prefix(h):
            return torch.cumsum(h, dim=-2)

    def thresh(G):
        return torch.sign(G) * torch.clamp(G.abs() - l1, min=0.0)

    def leaf_score(G, H):
        return thresh(G) ** 2 / (H + l2)

    def leaf_output(G, H):
        v = -thresh(G) / (H + l2)
        if max_delta > 0:
            v = torch.clamp(v, -max_delta, max_delta)
        return v

    def split_gains(hist, feat_mask, edge_ok, depth_ok=None, scales=None,
                    kernel_scan: bool = False, feats=None, tot_raw=None):
        """(nodes, F, B, 3) histograms -> (gain, left stats, node totals).
        ``hist`` holds float sums, or with ``scales = (g_scale, h_scale)``
        the quantized int32 sums: those are summed over bins in int32,
        which is exact in any order, and only then rescaled, so the card
        and the CPU get the same floats.  ``kernel_scan`` (quantized,
        numerical) takes the finish kernel's op order instead: dequantize
        each bin, scan in float32 from bin 0, node totals from the exact
        integer sums of feature 0, so the gains and stats equal
        ``frontier_finish``'s bit for bit.  LEFT stats: a numerical split
        at bin t takes bins <= t; a categorical one-vs-rest at code c
        takes bin c alone; a sorted-subset candidate k takes the best k+1
        ratio-sorted categories.  A ``depth_ok`` of False gates every
        candidate.  ``feats`` (voting-parallel: ``(nodes, Fs)`` feature ids)
        says which features ``hist``'s dim 1 holds, default all of them in
        order; ``tot_raw`` (``(nodes, 1, 3)``, in ``hist``'s units) gives
        the node totals instead of feature 0's sums."""
        if scales is None:
            def deq(h):
                return h

            prefix = float_prefix
        else:
            def deq(h):
                return hist_ops.dequantize_histogram(h, *scales)

            def prefix(h):
                if kernel_scan:
                    return cuda_histogram._cumsum_bins(deq(h))
                return deq(torch.cumsum(h, dim=-2, dtype=torch.int32))
        cum = prefix(hist)
        if tot_raw is not None:
            tot = deq(tot_raw)
        elif kernel_scan:
            tot = deq(hist[:, :1].sum(dim=2, dtype=torch.int32))
        else:
            tot = cum[:, :1, -1, :]                # (nodes, 1, 3)
        if feats is None:
            fmask3, edge3 = feat_mask[None, :, None], edge_ok[None]
        else:
            fmask3, edge3 = feat_mask[feats][..., None], edge_ok[feats]
        left3 = cum
        if ct.has_cat:
            cat_b, sub_b = ct.masks(hist.device)
            if feats is not None:
                cat_b, sub_b = cat_b[feats], sub_b[feats]
            hist_d = deq(hist)
            left3 = torch.where(cat_b[..., None, None], hist_d, cum)
            if ct.has_subset:
                subcum, sub_ok = ct.sorted_prefix(hist, hist_d, prefix)
                left3 = torch.where(sub_b[..., None, None], subcum, left3)
                edge3 = torch.where(sub_b[..., None], sub_ok & edge3, edge3)
        GL, HL, CL = left3[..., 0], left3[..., 1], left3[..., 2]
        Gp, Hp, Cp = tot[..., 0], tot[..., 1], tot[..., 2]
        GR, HR, CR = (Gp[:, :, None] - GL, Hp[:, :, None] - HL,
                      Cp[:, :, None] - CL)
        gain = (leaf_score(GL, HL) + leaf_score(GR, HR)
                - leaf_score(Gp, Hp)[:, :, None])
        if ct.has_subset:
            gain_cat = (ct.leaf_score_cat(GL, HL) + ct.leaf_score_cat(GR, HR)
                        - ct.leaf_score_cat(Gp, Hp)[:, :, None])
            gain = torch.where(sub_b[..., None], gain_cat, gain)
        valid = ((CL >= min_data) & (CR >= min_data)
                 & (HL >= min_hess) & (HR >= min_hess)
                 & fmask3 & edge3)
        if depth_ok is not None:
            valid = valid & depth_ok
        gain = torch.where(valid, gain, torch.full_like(gain, -math.inf))
        return gain, left3, (Gp[:, 0], Hp[:, 0], Cp[:, 0])

    return leaf_output, split_gains


def _kernel_gains(params: GBDTParams, g_scale, h_scale, feat_mask,
                  edge_ok) -> cuda_histogram.GainParams:
    """The gain scan's inputs in the kernels' types, built once per tree."""
    return cuda_histogram.gain_params(
        g_scale, h_scale, feat_mask, edge_ok, l1=params.lambda_l1,
        l2=params.lambda_l2, min_data=float(params.min_data_in_leaf),
        min_hess=params.min_sum_hessian_in_leaf)


def make_tree_grower(max_depth: int, num_features: int, num_bins: int,
                     params: GBDTParams, backend: str = "auto",
                     axis_name: Optional[str] = None,
                     psum_row_bound: Optional[int] = None, mesh=None):
    """Level-wise grower.  Returns ``grow(binned, grad, hess, hist_mask,
    feat_mask, edges, *, generator=None, noise=None) -> Tree``.

    ``binned`` is ``(n, F)`` uint8 (the trainer passes the transposed view
    of a feature-major matrix); ``noise`` (``(2, n)`` uniforms) or
    ``generator`` feeds the quantizer's stochastic rounding.  ``backend``
    is the histogram backend (``ops.histogram.resolve_quantized_backend``,
    resolved on ``binned``'s device per tree).  With ``cuda`` (auto on the
    card), levels whose frontier has at most
    ``cuda_histogram.FUSED_MAX_NODES`` parents take the fused frontier step
    (read per call, so a test can lower it); deeper levels, every level of
    a tree with categorical features, and every level under ``matmul`` or
    ``scatter`` build the smaller child's histogram through
    ``build_quantized`` and scan gains in torch — in the finish kernel's op
    order where ``cuda`` would have fused, so the trees are the same.

    With ``axis_name`` the grower is one rank of a row-sharded ``mesh``
    (default: the active one) and ``binned`` its contiguous block of rows:
    local histograms are summed over the axis (``histogram_psum``, the
    LGBM_NetworkInit ring's replacement) and every split decision is the
    same on every rank.  ``psum_row_bound`` is the GLOBAL (padded) row
    count: it bounds the summed cells and gates the packed allreduce.  The
    quantizer's scales are maxima over the axis and its noise is keyed on
    each row's global id, so a tree does not depend on the shard count.
    ``params.voting_k`` in ``(0, F)`` engages voting-parallel under an
    axis (and only there, as in the JAX package): each rank ranks features
    by its LOCAL gains, the ranks vote, and only the top ``2 * voting_k``
    features' histograms cross the axis; the sibling subtraction then runs
    on the local histograms."""
    use_quant = bool(params.use_quantized_grad)
    quant_bins = params.num_grad_quant_bins
    _check_quant_psum_bound(use_quant, quant_bins, axis_name, psum_row_bound)
    D, F, B = max_depth, num_features, num_bins
    I, L = 2 ** D - 1, 2 ** D
    ct = _CatTools(params, F, B)
    has_cat = ct.has_cat
    min_gain = params.min_gain_to_split
    leaf_output, split_gains = _split_math(params, ct)
    lc_np, rc_np = perfect_tree_children(D)
    voting_k = params.voting_k
    # voting engages only under an axis, and where it means something
    # (F > k); with 2k >= F the vote picks every feature: no saving, the
    # same splits, which the tests use
    use_voting = axis_name is not None and 0 < voting_k < F
    k2 = min(2 * voting_k, F)
    psum_hist, psum_any = _sharded_ops(use_quant, quant_bins, axis_name,
                                       psum_row_bound, mesh)

    def grow(binned, grad, hess, hist_mask, feat_mask, edges, *,
             generator: Optional[torch.Generator] = None,
             noise: Optional[torch.Tensor] = None) -> Tree:
        dev = binned.device
        n = binned.shape[0]
        rows = torch.arange(n, device=dev)
        bk, use_fused, kernel_scan = _grow_backend(
            backend, use_quant, has_cat, B, quant_bins, dev, axis_name)
        scales = None
        if use_quant:
            # quantize once per tree: every level's histogram is an exact
            # integer function of the same per-row ints, so the sibling
            # subtraction never leaves integer space.  Sharded, the noise
            # is keyed on each row's GLOBAL id
            row_ids = hist_ops.global_row_ids(axis_name, n, mesh, dev)
            qg, qh, g_scale, h_scale = hist_ops.quantize_gradients(
                grad, hess, quant_bins, generator=generator, noise=noise,
                row_ids=row_ids, seed=params.seed, axis_name=axis_name,
                mesh=mesh)
            scales = (g_scale, h_scale)

        def build_local(node_a, num_nodes, max_rows=None):
            if use_quant:
                return hist_ops.build_quantized(
                    binned, qg, qh, node_a, num_nodes, B,
                    quant_bins=quant_bins, backend=bk, max_rows=max_rows,
                    node_rows_bound=max_rows)
            return hist_ops.build(binned, grad, hess, node_a, num_nodes, B,
                                  backend=bk, max_rows=max_rows)

        def hist(node_a, num_nodes, max_rows=None):
            out = build_local(node_a, num_nodes, max_rows)
            return out if axis_name is None else psum_hist(out)

        def dehist(h_):
            if not use_quant:
                return h_
            return hist_ops.dequantize_histogram(h_, g_scale, h_scale)

        node = torch.zeros((n,), dtype=torch.int64, device=dev)
        split_feature = torch.full((I,), -1, dtype=torch.int32, device=dev)
        threshold_bin = torch.zeros((I,), dtype=torch.int32, device=dev)
        threshold = torch.zeros((I,), dtype=torch.float32, device=dev)
        split_gain = torch.zeros((I,), dtype=torch.float32, device=dev)
        internal_value = torch.zeros((I,), dtype=torch.float32, device=dev)
        internal_count = torch.zeros((I,), dtype=torch.float32, device=dev)
        edge_ok2 = ct.edge_ok(edges)
        if has_cat:
            cat_b, _ = ct.masks(dev)
            # per internal node, the LEFT category set of a categorical split
            cat_member = torch.zeros((I, B), dtype=torch.bool, device=dev)
        if use_fused:
            # the kernels' inputs, converted once per tree
            qg8, qh8 = cuda_histogram.to_int8(qg), cuda_histogram.to_int8(qh)
            gains = _kernel_gains(params, g_scale, h_scale, feat_mask,
                                  edge_ok2)
        prev_hist = small_left = best_stats = None
        for d in range(D):
            nodes_d = 2 ** d
            off = nodes_d - 1                       # BFS offset of the level
            nd = torch.arange(nodes_d, device=dev)
            if d > 0 and not use_voting:
                # LightGBM's smaller-child rule: rebuild only each parent's
                # smaller child, sibling = parent - small (sharded, by the
                # global counts: every rank picks the same child)
                is_left = node % 2 == 0
                in_small = is_left == small_left[node // 2]
                small_node = torch.where(hist_mask & in_small, node // 2, -1)
            fusable = max(1, nodes_d // 2) <= cuda_histogram.FUSED_MAX_NODES
            sel = None
            if use_voting:
                # the stored histograms stay LOCAL (local right = local
                # parent - local left, exact); only the voted features'
                # histograms are summed
                if d == 0:
                    local = build_local(torch.where(hist_mask, node, -1), 1)
                else:
                    left_node = torch.where(hist_mask & (node % 2 == 0),
                                            node // 2, -1)
                    left_local = build_local(left_node, nodes_d // 2)
                    local = torch.stack(
                        [left_local, hist_ops.histogram_subtraction(
                            prev_hist, left_local)],
                        dim=1).reshape(nodes_d, F, B, 3)
                gain_l, _, _ = split_gains(local, feat_mask, edge_ok2,
                                           scales=scales)
                sel = _votes(gain_l.amax(dim=2), voting_k, k2, psum_any)
                hist_d = psum_hist(torch.take_along_dim(
                    local, sel[:, :, None, None], dim=1))
                gain, pick, (Gp0, Hp0, Cp0) = split_gains(
                    hist_d, feat_mask, edge_ok2, scales=scales, feats=sel)
                flat = gain.reshape(nodes_d, k2 * B)
                best = torch.argmax(flat, dim=1)
                best_gain = torch.gather(flat, 1, best[:, None])[:, 0]
                bf_local, bb = best // B, best % B
                bf = sel[nd, bf_local]
                bsel = pick[nd, bf_local, bb, :]
                win = hist_d[nd, bf_local]
                hist_d = local
            elif use_fused and fusable:
                if d == 0:
                    hist_d, fused_best = cuda_histogram.frontier_step(
                        binned, qg8, qh8,
                        torch.where(hist_mask, node, -1).to(torch.int32), 1,
                        B, gains, quant_bins=quant_bins)
                else:
                    hist_d, fused_best = cuda_histogram.frontier_step(
                        binned, qg8, qh8, small_node.to(torch.int32),
                        nodes_d // 2, B, gains, quant_bins=quant_bins,
                        parent_hist=prev_hist, small_left=small_left,
                        node_rows_bound=n // 2 + nodes_d)
                best_gain, bf, bb, bsel, tot3f = fused_best
                bf, bb = bf.to(torch.int64), bb.to(torch.int64)
                Gp0, Hp0, Cp0 = tot3f[:, 0], tot3f[:, 1], tot3f[:, 2]
            else:
                if d == 0:
                    hist_d = hist(torch.where(hist_mask, node, -1), 1)
                else:
                    # at most floor(n/2) rows are in smaller children (one
                    # shard's rows may crowd into globally smaller
                    # children: no bound when sharded)
                    hist_small = hist(small_node, nodes_d // 2,
                                      max_rows=None if axis_name is not None
                                      else n // 2 + nodes_d)
                    hist_sib = hist_ops.histogram_subtraction(prev_hist,
                                                              hist_small)
                    sl4 = small_left[:, None, None, None]
                    hist_d = torch.stack(
                        [torch.where(sl4, hist_small, hist_sib),
                         torch.where(sl4, hist_sib, hist_small)],
                        dim=1).reshape(nodes_d, F, B, 3)
                gain, pick, (Gp0, Hp0, Cp0) = split_gains(
                    hist_d, feat_mask, edge_ok2, scales=scales,
                    kernel_scan=kernel_scan and fusable)
                flat = gain.reshape(nodes_d, F * B)
                best = torch.argmax(flat, dim=1)
                best_gain = torch.gather(flat, 1, best[:, None])[:, 0]
                bf, bb = best // B, best % B
                bsel = pick[nd, bf, bb, :]
                win = hist_d[nd, bf]
            prev_hist = hist_d
            do_split = best_gain > min_gain

            idx = off + nd
            thr = edges[bf, torch.clamp(bb, 0, B - 2)]
            if has_cat:
                member = ct.winner_member(dehist(win), bf, bb)
                is_cat = cat_b[bf]
                cat_member[idx] = member & (do_split & is_cat)[:, None]
                # the raw threshold of a categorical split is the code
                thr = torch.where(is_cat, bb.to(torch.float32), thr)
            split_feature[idx] = torch.where(do_split, bf, -1) \
                .to(torch.int32)
            threshold_bin[idx] = bb.to(torch.int32)
            threshold[idx] = thr
            split_gain[idx] = torch.where(do_split, best_gain,
                                          torch.zeros_like(best_gain))
            internal_value[idx] = leaf_output(Gp0, Hp0)
            internal_count[idx] = Cp0

            # left/right child stats at the chosen split -> the last level's
            # leaf values come straight from here (no extra leaf pass)
            tot3 = torch.stack([Gp0, Hp0, Cp0], dim=-1)
            left_stats = torch.where(do_split[:, None], bsel, tot3)
            right_stats = tot3 - left_stats
            best_stats = (left_stats, right_stats)
            # the next level rebuilds only each parent's smaller child
            small_left = left_stats[:, 2] <= right_stats[:, 2]

            # route every row (masked rows too: they need leaf ids); a
            # categorical split sends the members of its set left
            f_row = bf[node]
            row_bin = binned[rows, f_row].to(torch.int64)
            right = row_bin > bb[node]
            if has_cat:
                right = torch.where(cat_b[f_row], ~member[node, row_bin],
                                    right)
            node = 2 * node + (do_split[node] & right).to(torch.int64)

        left_stats, right_stats = best_stats
        lv = torch.stack([leaf_output(left_stats[:, 0], left_stats[:, 1]),
                          leaf_output(right_stats[:, 0], right_stats[:, 1])],
                         dim=1).reshape(L)
        lc = torch.stack([left_stats[:, 2], right_stats[:, 2]],
                         dim=1).reshape(L)
        leaf_value = torch.where(lc > 0, lv, torch.zeros_like(lv))
        return Tree(torch.from_numpy(lc_np).to(dev),
                    torch.from_numpy(rc_np).to(dev), split_feature,
                    threshold, threshold_bin, split_gain, internal_value,
                    internal_count, leaf_value, lc, node,
                    cat_member if has_cat else None)

    return grow


def leafwise_store_dtype(n_bound, use_quant: bool, quant_bins: int,
                         enabled: bool = True) -> torch.dtype:
    """Storage dtype of the leaf-wise grower's per-leaf histogram carry (the
    ``(L, F, B, 3)`` buffer that sibling subtraction reads).  A quantized
    cell holds at most ``n_bound * (quant_bins - 1)`` (the hess field, the
    widest), so when that fits int16 the carry halves with no loss; the
    arithmetic stays int32 and only the carry narrows.  Float histograms
    and an unknown bound keep the wide dtypes."""
    if not use_quant:
        return torch.float32
    qh_cap = max(1, quant_bins - 1)
    if enabled and n_bound is not None and int(n_bound) * qh_cap < (1 << 15):
        return torch.int16
    return torch.int32


def make_leafwise_grower(num_leaves: int, depth_cap: int, num_features: int,
                         num_bins: int, params: GBDTParams, *,
                         store16: bool = True, backend: str = "auto",
                         axis_name: Optional[str] = None,
                         psum_row_bound: Optional[int] = None, mesh=None):
    """Leaf-wise (best-first) grower, LightGBM's default growth: one tree is
    ``num_leaves - 1`` split steps.  Each step splits the live leaf with the
    global best stored gain (the left child keeps the leaf's slot, the right
    child takes slot ``step + 1``), rebuilds the left child's histogram and
    takes its sibling by subtraction from the stored parent, then scores
    both children's best splits for the later steps.  A step whose best
    gain fails ``min_gain_to_split`` still runs and writes nothing, as the
    JAX package's ``lax.scan`` does, so a tree always launches each kernel
    ``num_leaves`` times (on the fused path one ``frontier_step`` per step;
    with categorical features one histogram build per step, whose split
    search runs in torch).

    The step loop never waits for the card: the chosen leaf, the gate and
    every index stay device tensors, and a gated write goes to a trash slot
    one past the end of its array.  ``depth_cap`` > 0 forbids splits at
    that depth; ``store16`` allows the int16 histogram carry.  ``backend``
    is the histogram backend, resolved per tree as the level-wise grower
    resolves it: under ``matmul`` or ``scatter`` a step builds the left
    child through ``build_quantized`` and scans both children in the finish
    kernel's op order, launching neither kernel and growing the ``cuda``
    backend's tree.  Returns ``grow(...)`` with the level-wise grower's
    signature; the ``Tree`` holds array-of-nodes children with leaves
    encoded ``~leaf``.

    ``axis_name``, ``psum_row_bound`` and ``mesh`` shard the rows as in
    ``make_tree_grower``: each step's left-child histogram is summed over
    the axis and the stored per-leaf histograms are global; with
    voting-parallel (``0 < voting_k < F`` under an axis) they stay local
    and each leaf's split search sums only the voted features'
    histograms.  The summed step waits for the collective, so the sharded
    loop does sync with the card."""
    use_quant = bool(params.use_quantized_grad)
    quant_bins = params.num_grad_quant_bins
    _check_quant_psum_bound(use_quant, quant_bins, axis_name, psum_row_bound)
    L, M, F, B = num_leaves, num_leaves - 1, num_features, num_bins
    ct = _CatTools(params, F, B)
    has_cat = ct.has_cat
    min_gain = params.min_gain_to_split
    leaf_output, split_gains = _split_math(params, ct)
    voting_k = params.voting_k
    use_voting = axis_name is not None and 0 < voting_k < F
    k2 = min(2 * voting_k, F)
    psum_hist, psum_any = _sharded_ops(use_quant, quant_bins, axis_name,
                                       psum_row_bound, mesh)
    # the stored histograms are summed ones unless unsharded or voting
    stored_global = axis_name is not None and not use_voting

    def grow(binned, grad, hess, hist_mask, feat_mask, edges, *,
             generator: Optional[torch.Generator] = None,
             noise: Optional[torch.Tensor] = None) -> Tree:
        dev = binned.device
        n = binned.shape[0]
        bk, use_fused, kernel_scan = _grow_backend(
            backend, use_quant, has_cat, B, quant_bins, dev, axis_name)
        edge_ok = ct.edge_ok(edges)
        # depth_ok of every depth a child can reach, looked up per step
        depth_ok = torch.arange(L + 1, device=dev) < depth_cap \
            if depth_cap > 0 else torch.ones(L + 1, dtype=torch.bool,
                                              device=dev)
        scales = None
        if use_quant:
            row_ids = hist_ops.global_row_ids(axis_name, n, mesh, dev)
            qg, qh, g_scale, h_scale = hist_ops.quantize_gradients(
                grad, hess, quant_bins, generator=generator, noise=noise,
                row_ids=row_ids, seed=params.seed, axis_name=axis_name,
                mesh=mesh)
            scales = (g_scale, h_scale)
        if use_fused:
            # the kernels' inputs, converted once per tree
            qg8, qh8 = cuda_histogram.to_int8(qg), cuda_histogram.to_int8(qh)
            gains = _kernel_gains(params, g_scale, h_scale, feat_mask,
                                  edge_ok)
            left = torch.ones((1,), dtype=torch.bool, device=dev)

        def fused(node_ids, dok, out, out_slots, parent_slot=None):
            # one call writes the children (and their best splits) into the
            # carry; subtract mode rebuilds the left child
            cuda_histogram.frontier_step(
                binned, qg8, qh8, node_ids, 1, B,
                gains._replace(depth_ok=dok), quant_bins=quant_bins,
                small_left=None if parent_slot is None else left, out=out,
                out_slots=out_slots, parent_slot=parent_slot)

        def local_hist(mask):
            ids = torch.where(mask, 0, -1)
            if use_quant:
                h_ = hist_ops.build_quantized(binned, qg, qh, ids, 1, B,
                                              quant_bins=quant_bins,
                                              backend=bk)
            else:
                h_ = hist_ops.build(binned, grad, hess, ids, 1, B,
                                    backend=bk)
            return psum_hist(h_) if stored_global else h_

        def leaf_best(hist_1f3, dok):
            """Best split of one leaf from its ``(1, F, B, 3)`` histogram:
            ``(gain, feat, bin, left (G, H, C), totals, member)``, each with
            a leading axis of 1 (``member``, the winner's ``(1, B)``
            category set, only with categorical features).  Under voting
            ``hist_1f3`` is the leaf's LOCAL histogram: the ranks vote on
            its features by local gain, and the search runs on the sums of
            the voted features' histograms and of the leaf's totals."""
            feats = tot_raw = None
            h_ = hist_1f3
            Fs = F
            if use_voting:
                gain_l, _, _ = split_gains(hist_1f3, feat_mask, edge_ok, dok,
                                           scales=scales)
                feats = _votes(gain_l.amax(dim=2), voting_k, k2, psum_any)
                h_ = psum_hist(torch.take_along_dim(
                    hist_1f3, feats[:, :, None, None], dim=1))
                tot_raw = psum_hist(hist_1f3[:, :1].sum(
                    dim=2, dtype=hist_1f3.dtype))
                Fs = k2
            gain, left3, tot = split_gains(h_, feat_mask, edge_ok, dok,
                                           scales=scales,
                                           kernel_scan=kernel_scan,
                                           feats=feats, tot_raw=tot_raw)
            flat = gain.reshape(-1)
            best = torch.argmax(flat).reshape(1)
            bfs, bb = best // B, best % B
            bf = bfs if feats is None else feats[0].index_select(0, bfs)
            member = None
            if has_cat:
                win = h_[0].index_select(0, bfs)              # (1, B, 3)
                if use_quant:
                    win = hist_ops.dequantize_histogram(win, g_scale,
                                                        h_scale)
                member = ct.winner_member(win, bf, bb)
            return (flat.index_select(0, best), bf.to(torch.int32),
                    bb.to(torch.int32),
                    left3.reshape(Fs * B, 3).index_select(0, best),
                    torch.stack(tot, dim=-1), member)

        # ---- carry: each array padded by a trash slot (M or L) that takes
        # the writes of a step whose gate is off; int16 when the bound of
        # the stored cells allows (the global rows when they are summed)
        st_dtype = leafwise_store_dtype(
            psum_row_bound if stored_global else n, use_quant, quant_bins,
            store16)
        i32, f32 = torch.int32, torch.float32

        def full(size, value, dtype):
            return torch.full((size,), value, dtype=dtype, device=dev)

        leaf_of_row = torch.zeros((n,), dtype=torch.int64, device=dev)
        lc_arr, rc_arr, sf = full(M + 1, -1, i32), full(M + 1, -1, i32), \
            full(M + 1, -1, i32)
        th, sg, iv, ic = (full(M + 1, 0, f32) for _ in range(4))
        tb = full(M + 1, 0, i32)
        hists = torch.zeros((L + 1, F, B, 3), dtype=st_dtype, device=dev)
        best_gain = full(L + 1, -math.inf, f32)
        best_feat, best_bin = full(L + 1, 0, i32), full(L + 1, 0, i32)
        best_left = torch.zeros((L + 1, 3), dtype=f32, device=dev)
        leaf_tot = torch.zeros((L + 1, 3), dtype=f32, device=dev)
        if has_cat:
            cat_b, _ = ct.masks(dev)
            # per internal node its LEFT category set; per live leaf the
            # category set of its best candidate
            cbs = torch.zeros((M + 1, B), dtype=torch.bool, device=dev)
            best_member = torch.zeros((L + 1, B), dtype=torch.bool,
                                      device=dev)

        # ---- root, into slot 0
        if use_fused:
            carry = cuda_histogram.FinishOut(hists, best_gain, best_feat,
                                             best_bin, best_left)
            fused(torch.where(hist_mask, 0, -1).to(torch.int32),
                  depth_ok[:1], carry._replace(tot=leaf_tot),
                  (torch.zeros((1,), dtype=torch.int64, device=dev),))
        else:
            h_root = local_hist(hist_mask)
            g0, f0, b0, lp0, tot0, m0 = leaf_best(h_root, depth_ok[:1])
            hists[:1] = h_root.to(st_dtype)
            best_gain[:1], best_feat[:1], best_bin[:1] = g0, f0, b0
            best_left[:1], leaf_tot[:1] = lp0, tot0
            if has_cat:
                best_member[:1] = m0
        leaf_depth, leaf_side = full(L + 1, 0, i32), full(L + 1, 0, i32)
        leaf_parent = full(L + 1, -1, i32)
        created = torch.arange(L + 1, device=dev) == 0
        binned_fm = binned.t()          # (F, n): one feature's row is a view
        e_stride = edges.shape[1]
        edges_flat = edges.reshape(-1)
        steps = torch.arange(M + 1, dtype=i32, device=dev)

        def put(arr, idx, val):
            arr.index_copy_(0, idx.to(torch.int64), val.to(arr.dtype))

        for s in range(M):
            new_leaf = s + 1
            j = torch.argmax(best_gain[:L]).reshape(1)
            gmax = best_gain.index_select(0, j)
            do = gmax > min_gain
            at_s = torch.where(do, s, M)
            at_j = torch.where(do, j, L)
            at_new = torch.where(do, new_leaf, L)
            f = best_feat.index_select(0, j).to(torch.int64)
            b = best_bin.index_select(0, j).to(torch.int64)
            tot = leaf_tot.index_select(0, j)                    # (1, 3)
            s_val = steps[s:s + 1]
            thr = edges_flat.index_select(
                0, f * e_stride + torch.clamp(b, 0, B - 2))
            if has_cat:
                is_cat = cat_b.index_select(0, f)                # (1,)
                member_j = best_member.index_select(0, j)        # (1, B)
                put(cbs, at_s, member_j & is_cat[:, None])
                # the raw threshold of a categorical split is the code
                thr = torch.where(is_cat, b.to(f32), thr)

            put(sf, at_s, f)
            put(tb, at_s, b)
            put(th, at_s, thr)
            put(sg, at_s, gmax)
            put(iv, at_s, leaf_output(tot[:, 0], tot[:, 1]))
            put(ic, at_s, tot[:, 2])
            # re-point the edge that led to leaf j at internal node s
            pn = leaf_parent.index_select(0, j)
            side = leaf_side.index_select(0, j)
            put(lc_arr, torch.where(do & (pn >= 0) & (side == 0), pn, M),
                s_val)
            put(rc_arr, torch.where(do & (pn >= 0) & (side == 1), pn, M),
                s_val)
            # node s's own children: left keeps slot j, right takes new_leaf
            put(lc_arr, at_s, ~j)
            put(rc_arr, at_s, torch.full_like(j, ~new_leaf))
            put(leaf_parent, at_j, s_val)
            put(leaf_side, at_j, torch.zeros_like(s_val))
            put(leaf_parent, at_new, s_val)
            put(leaf_side, at_new, torch.ones_like(s_val))
            put(created, at_new, torch.ones_like(do))

            # route the rows of leaf j: bins above b go right, or for a
            # categorical split the codes outside its set
            row_bin = binned_fm.index_select(0, torch.clamp(f, min=0))[0] \
                .to(torch.int64)
            right = row_bin > b
            if has_cat:
                right = torch.where(is_cat, ~member_j[0][row_bin], right)
            go_right = do & (leaf_of_row == j) & right
            leaf_of_row = torch.where(go_right, new_leaf, leaf_of_row)

            left_stats = best_left.index_select(0, j)
            put(leaf_tot, at_j, left_stats)
            put(leaf_tot, at_new, tot - left_stats)
            d_new = leaf_depth.index_select(0, j) + 1
            put(leaf_depth, at_j, d_new)
            put(leaf_depth, at_new, d_new)
            dok = depth_ok.index_select(0, d_new)

            # the left child's rows, rebuilt; the right child by subtraction
            # from the parent read in the carry at slot j
            in_left = hist_mask & (leaf_of_row == j)
            if use_fused:
                fused(torch.where(in_left, 0, -1).to(torch.int32), dok,
                      carry, (at_j, at_new), parent_slot=j)
                continue
            hl = local_hist(in_left)
            hr = hist_ops.histogram_subtraction(
                hists.index_select(0, j).to(hl.dtype), hl)
            for at, h_child in ((at_j, hl), (at_new, hr)):
                g_c, f_c, b_c, lp_c, _, m_c = leaf_best(h_child, dok)
                put(hists, at, h_child)
                put(best_gain, at, g_c)
                put(best_feat, at, f_c)
                put(best_bin, at, b_c)
                put(best_left, at, lp_c)
                if has_cat:
                    put(best_member, at, m_c)

        created, leaf_tot = created[:L], leaf_tot[:L]
        zero = torch.zeros((L,), dtype=f32, device=dev)
        leaf_value = torch.where(
            created, leaf_output(leaf_tot[:, 0], leaf_tot[:, 1]), zero)
        leaf_count = torch.where(created, leaf_tot[:, 2], zero)
        return Tree(lc_arr[:M], rc_arr[:M], sf[:M], th[:M], tb[:M], sg[:M],
                    iv[:M], ic[:M], leaf_value, leaf_count, leaf_of_row,
                    cbs[:M] if has_cat else None)

    return grow


def _make_grower(p: GBDTParams, F: int, B: int, backend: str = "auto",
                 axis_name: Optional[str] = None,
                 psum_row_bound: Optional[int] = None, mesh=None):
    """Growth-mode dispatch (call with resolved params)."""
    if p.growth == "leaf":
        return make_leafwise_grower(p.num_leaves, p.max_depth, F, B, p,
                                    backend=backend, axis_name=axis_name,
                                    psum_row_bound=psum_row_bound, mesh=mesh)
    return make_tree_grower(p.max_depth, F, B, p, backend=backend,
                            axis_name=axis_name,
                            psum_row_bound=psum_row_bound, mesh=mesh)


def _resolve_hist_backend() -> Tuple[str, str]:
    """``(MMLSPARK_TPU_HIST_BACKEND, MMLSPARK_TPU_HIST_QUANT)``, read once
    per ``train()`` / ``train_streamed()`` call, where the JAX package
    reads its histogram knobs (the matmul build's own knobs are read where
    it runs, as there)."""
    import os
    return (os.environ.get("MMLSPARK_TPU_HIST_BACKEND", "auto"),
            os.environ.get("MMLSPARK_TPU_HIST_QUANT", ""))


def _resolve_quantized(dev: torch.device, use_quantized_grad,
                       quant_env: str) -> bool:
    """``use_quantized_grad`` after the ``MMLSPARK_TPU_HIST_QUANT``
    override, then the device's default.  The override reads as the JAX
    package's does: case-insensitive, 0/false/off/no turn quantization
    off (an operator's QUANT=OFF never fails open into forcing it on) and
    any other value turns it on."""
    uq = use_quantized_grad
    if quant_env.strip():
        uq = quant_env.strip().lower() not in ("0", "false", "off", "no")
    return default_quantized(dev, uq)


# ---------------------------------------------------------------------------
# binned tree walk (valid-set scoring and warm-start replay)
# ---------------------------------------------------------------------------

def make_binned_walker(depth_bound: int,
                       categorical_features: Optional[Tuple[int, ...]] = None):
    """Binned-space pointer chase over one array-of-nodes tree (leaf slots
    encoded ``~leaf_id``; leaves self-loop, so ``depth_bound`` rounds
    resolve every shape).  Returns ``walk(binned, split_feature,
    threshold_bin, left_child, right_child, bitset=None) -> (n,) leaf
    ids``.  At a categorical node a code in the node's ``bitset`` row
    (``(M, B)``) goes left; without a bitset, the code ``threshold_bin``
    alone goes left (one-vs-rest)."""
    D = max(1, depth_bound)
    cats = sorted(int(i) for i in (categorical_features or ()))

    def walk(binned, split_feature, threshold_bin, left_child, right_child,
             bitset=None):
        n, F = binned.shape
        dev = binned.device
        rows = torch.arange(n, device=dev)
        sf = split_feature.to(torch.int64)
        tb = threshold_bin.to(torch.int64)
        lc = left_child.to(torch.int64)
        rc = right_child.to(torch.int64)
        if cats:
            cat_b = _device_mask(F, cats, dev)
        node = torch.zeros((n,), dtype=torch.int64, device=dev)
        for _ in range(D):
            j = node.clamp(min=0)
            f = sf[j]
            row_bin = binned[rows, f.clamp(min=0)].to(torch.int64)
            right = row_bin > tb[j]
            if cats:
                left_set = bitset[j, row_bin] if bitset is not None \
                    else row_bin == tb[j]
                right = torch.where(cat_b[f.clamp(min=0)], ~left_set, right)
            child = torch.where((f >= 0) & right, rc[j], lc[j])
            node = torch.where(node >= 0, child, node)
        return ~node

    return walk


# ---------------------------------------------------------------------------
# metrics (host numpy, as in the JAX package)
# ---------------------------------------------------------------------------

def _metric_binary_logloss(y, raw, w=None):
    p = 1.0 / (1.0 + np.exp(-raw[:, 0]))
    p = np.clip(p, 1e-15, 1 - 1e-15)
    ll = -(y * np.log(p) + (1 - y) * np.log(1 - p))
    return float(np.average(ll, weights=w))


def _metric_auc(y, raw, w=None):
    s = raw[:, 0]
    order = np.argsort(s)
    y_s = y[order]
    w_s = np.ones_like(y_s, dtype=np.float64) if w is None \
        else np.asarray(w)[order]
    pos = (y_s > 0).astype(np.float64) * w_s
    neg = (1.0 - (y_s > 0)) * w_s
    cum_neg = np.cumsum(neg)
    return float(np.sum(pos * (cum_neg - 0.5 * neg)) /
                 max(1e-12, np.sum(pos) * np.sum(neg)))


def _metric_multi_logloss(y, raw, w=None):
    z = raw - raw.max(axis=1, keepdims=True)
    p = np.exp(z)
    p /= p.sum(axis=1, keepdims=True)
    p = np.clip(p[np.arange(len(y)), y.astype(int)], 1e-15, None)
    return float(np.average(-np.log(p), weights=w))


def _metric_l2(y, raw, w=None):
    return float(np.average((raw[:, 0] - y) ** 2, weights=w))


def _metric_rmse(y, raw, w=None):
    return math.sqrt(_metric_l2(y, raw, w))


def _metric_l1(y, raw, w=None):
    return float(np.average(np.abs(raw[:, 0] - y), weights=w))


def _metric_poisson_nll(y, raw, w=None):
    mu = np.exp(np.clip(raw[:, 0], -30, 30))
    return float(np.average(mu - y * np.log(np.maximum(mu, 1e-12)),
                            weights=w))


def _metric_gamma_nll(y, raw, w=None):
    s_ = np.clip(raw[:, 0], -30, 30)
    return float(np.average(s_ + y * np.exp(-s_), weights=w))


def _metric_pinball(y, raw, alpha, w=None):
    e = y - raw[:, 0]
    return float(np.average(np.maximum(alpha * e, (alpha - 1.0) * e),
                            weights=w))


def _metric_tweedie_nll(y, raw, rho, w=None):
    """Tweedie deviance NLL with log link (raw = log mean), 1 < rho < 2."""
    s_ = np.clip(raw[:, 0], -30, 30)
    nll = (-y * np.exp((1.0 - rho) * s_) / (1.0 - rho)
           + np.exp((2.0 - rho) * s_) / (2.0 - rho))
    return float(np.average(nll, weights=w))


METRICS = {"binary_logloss": (_metric_binary_logloss, False),
           "poisson_nll": (_metric_poisson_nll, False),
           "gamma_nll": (_metric_gamma_nll, False),
           "auc": (_metric_auc, True),
           "multi_logloss": (_metric_multi_logloss, False),
           "l2": (_metric_l2, False), "mse": (_metric_l2, False),
           "rmse": (_metric_rmse, False), "l1": (_metric_l1, False),
           "mae": (_metric_l1, False)}


def resolve_metric(metric_name: str, p: GBDTParams):
    """(metric_fn, larger_better) for a requested or default metric name.
    tweedie_nll and pinball take the variance power and alpha, so they
    resolve to closures here instead of living in METRICS; unknown names
    fall back to the objective's default (closures included)."""
    def closures(name):
        if name == "tweedie_nll":
            rho_m = p.tweedie_variance_power
            return (lambda y_, raw_, w_=None:
                    _metric_tweedie_nll(y_, raw_, rho_m, w_), False)
        if name == "pinball":
            a_m = p.alpha
            return (lambda y_, raw_, w_=None:
                    _metric_pinball(y_, raw_, a_m, w_), False)
        return None

    got = closures(metric_name)
    if got is not None:
        return got
    if metric_name in METRICS:
        return METRICS[metric_name]
    fallback = default_metric(p.objective)
    got = closures(fallback)
    if got is not None:
        return got
    return METRICS.get(fallback, METRICS["l2"])


def default_metric(objective: str) -> str:
    return {"binary": "binary_logloss", "multiclass": "multi_logloss",
            "regression": "l2", "regression_l1": "l1", "huber": "l2",
            "quantile": "pinball", "lambdarank": "l2",
            "poisson": "poisson_nll", "tweedie": "tweedie_nll",
            "gamma": "gamma_nll"}.get(objective, "l2")


# ---------------------------------------------------------------------------
# training driver
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TrainResult:
    booster: GBDTBooster
    evals: List[Dict[str, float]]
    bin_mapper: BinMapper
    # host wall seconds per phase: binning (= edges + bin_apply), transfer,
    # boosting
    extras: Optional[Dict[str, float]] = None


_TREE_KEYS = ("left_child", "right_child", "split_feature", "threshold",
              "threshold_bin", "split_gain", "internal_value",
              "internal_count", "leaf_value", "leaf_count")


def _start_monitor(job: str, p: GBDTParams, n: int, monitor_port,
                   monitor_stall_timeout_s, callbacks, prefetch_fn=None):
    """The live training monitor both drivers wire as the JAX package's
    do: a ``TrainingRun`` (heartbeat and stall watchdog) and, with a
    ``monitor_port``, its HTTP sidecar.  Ticks ride the callbacks seam the
    loop already calls, with the eval value as the loss.  Returns ``(run,
    server, callbacks)``; ``run`` is None when no monitor was asked for.
    The caller stops the server, then closes the run."""
    if monitor_port is None and monitor_stall_timeout_s is None:
        return None, None, callbacks
    from ..observability.trainwatch import start_training_monitor
    run, server = start_training_monitor(
        job, total_steps=p.num_iterations, rows_per_step=n,
        monitor_port=monitor_port, stall_timeout_s=monitor_stall_timeout_s,
        driver=job)
    run.set_phase("boosting")
    if prefetch_fn is not None:
        run.set_prefetch_fn(prefetch_fn)

    def watch_cb(i, ev):
        # the eval entry (when present) carries {metric_name: value,
        # "iteration": it}: the metric value feeds the loss tail
        val = None
        if isinstance(ev, dict):
            for k, v in ev.items():
                if k != "iteration" and isinstance(v, (int, float)):
                    val = float(v)
                    break
        run.tick(step=i + 1, loss=val)

    return run, server, list(callbacks or []) + [watch_cb]


def _stop_monitor(run, server) -> None:
    if server is not None:
        server.stop()
    if run is not None:
        run.close()


def _params_sig(p: GBDTParams) -> tuple:
    """The params half of a checkpoint's fingerprint (the JAX package's
    ``_params_sig``, without its histogram-backend entry)."""
    return (p.growth, p.num_leaves, p.max_depth, p.max_bin, p.objective,
            p.num_class, p.boosting_type,
            p.learning_rate, p.lambda_l1, p.lambda_l2, p.min_data_in_leaf,
            p.min_sum_hessian_in_leaf, p.min_gain_to_split, p.max_delta_step,
            p.sigmoid, p.alpha, p.tweedie_variance_power,
            p.top_rate, p.other_rate, p.feature_fraction,
            p.bagging_fraction, p.bagging_freq,
            tuple(p.categorical_features or ()), tuple(p.cat_subset or ()),
            p.max_cat_to_onehot, p.cat_smooth, p.cat_l2, p.max_cat_threshold,
            p.voting_k, p.use_quantized_grad, p.num_grad_quant_bins,
            p.seed)


def _content_fingerprint(arr: np.ndarray) -> int:
    """Cheap strided content hash for cache keys: crc32 over ~4k strided
    elements.  Catches in-place mutation of a cached array that id()/shape
    keys alone cannot, at O(4k) cost regardless of array size.  Mutations
    confined to the skipped strides are (by design) not detected — it is a
    guard rail, not a cryptographic digest."""
    import zlib
    if arr.size == 0:
        return 0
    step = max(1, arr.size // 4096)
    # arr.flat[::step] materializes ONLY the ~4k sampled elements; ravel()
    # would copy the whole array whenever it is not C-contiguous
    sample = arr.flat[::step]
    return zlib.crc32(np.ascontiguousarray(sample).tobytes())


# ---------------------------------------------------------------------------
# checkpoints (both drivers share the format of the JAX package's)
# ---------------------------------------------------------------------------

def _host_array(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _booster_ckpt_arrays(trees: Dict[str, list], tree_weights: list,
                         bag_mask) -> Callable[[], Dict[str, np.ndarray]]:
    """Snapshot-arrays callable shared by ``train`` and ``train_streamed``
    (one copy so the two drivers' checkpoint formats cannot drift).  The
    training thread pays only list copies; the host copies of device
    tensors, ``np.stack`` and ``np.packbits`` run on the manager's writer
    thread.  Tree arrays and the bag mask are immutable once captured (the
    loop REBINDS them rather than mutating, and each tree's arrays are
    fresh tensors), so the deferred reads are safe."""
    tl = {k: list(v) for k, v in trees.items()}
    tw = list(tree_weights)

    def _arrays(tl=tl, tw=tw, bm=bag_mask):
        out = {k: np.stack([_host_array(a) for a in v])
               for k, v in tl.items()}
        out["tree_weight"] = np.asarray(tw, np.float32)
        if bm is not None:
            out["bag_mask"] = np.packbits(_host_array(bm).astype(bool))
        return out

    return _arrays


def _booster_ckpt_meta(completed_iter: int, n_init_trees: int, rng,
                       best_metric, best_iter: int, rounds_no_improve: int,
                       evals: list, init_score: float, fingerprint: str,
                       finished: bool, num_iterations: int,
                       fmt: str, topology: Optional[Dict] = None) -> Dict:
    """Snapshot meta shared by both drivers.  ``completed_iter`` is the
    ONE convention both must use: boosting iterations completed beyond the
    user's warm-start trees, derived from the tree count (robust to early
    stopping, where loop counters and completed work can disagree at the
    break).  ``topology`` is the recorded-but-not-identity stanza: a resume
    onto a changed tile geometry diffs it instead of rejecting it."""
    meta = {"iteration": int(completed_iter),
            "n_init_trees": int(n_init_trees),
            "rng_state": rng.bit_generator.state,
            "best_metric": best_metric, "best_iter": int(best_iter),
            "rounds_no_improve": int(rounds_no_improve),
            "evals": [dict(e) for e in evals],
            "init_score": float(init_score),
            "fingerprint": fingerprint, "finished": bool(finished),
            "num_iterations": int(num_iterations), "format": fmt}
    if topology is not None:
        meta["topology"] = topology
    return meta


_CKPT_FINGERPRINT_MISMATCH = (
    "checkpoint_dir holds a snapshot for different data or params "
    "(fingerprint mismatch) — point checkpoint_dir at a fresh directory, "
    "or pass resume='never' (docs/RESILIENCE.md: training fault tolerance)")


def _booster_of_snapshot(arrs: Dict[str, np.ndarray], meta: Dict,
                         p: GBDTParams, F: int, K: int) -> GBDTBooster:
    """The booster a ``train()`` snapshot holds (it replaces any user
    ``init_booster``: the snapshot already contains those trees)."""
    return GBDTBooster(
        np.asarray(arrs["split_feature"]), np.asarray(arrs["threshold"]),
        np.asarray(arrs["threshold_bin"]), np.asarray(arrs["split_gain"]),
        np.asarray(arrs["internal_value"]),
        np.asarray(arrs["internal_count"]), np.asarray(arrs["leaf_value"]),
        np.asarray(arrs["leaf_count"]),
        np.asarray(arrs["tree_weight"], np.float32),
        left_child=np.asarray(arrs["left_child"]),
        right_child=np.asarray(arrs["right_child"]),
        max_depth=children_depth_bound(arrs["left_child"],
                                       arrs["right_child"]),
        num_features=F, objective=p.objective, num_class=K,
        init_score=float(meta["init_score"]),
        average_output=(p.boosting_type == "rf"), sigmoid=p.sigmoid,
        categorical_features=list(p.categorical_features or []),
        cat_bitset=(np.asarray(arrs["cat_bitset"], bool)
                    if "cat_bitset" in arrs else None))


def _bin(mapper: BinMapper, X: np.ndarray, dev: torch.device) -> torch.Tensor:
    """The ``(n, F)`` bins of ``X`` on ``dev``, as the transposed view of a
    feature-major matrix (a warp of the histogram kernel reads consecutive
    rows of one feature).  On the card ``X`` crosses once as float32 and
    the bins are applied there, with the semantics of the host route the
    JAX package's ``transform`` takes for ``X``; on the CPU the host route
    itself runs."""
    if dev.type == "cuda":
        return mapper.bin_on_device(X, dev).t()
    return torch.from_numpy(mapper.transform(X)).t().contiguous().t()


def _cat_subset(p: GBDTParams, binned: torch.Tensor, B: int,
                mesh=None) -> Tuple:
    """The categorical features with more than ``max_cat_to_onehot``
    observed codes (the NaN bin aside): they take the sorted-subset search,
    the rest one-vs-rest (LightGBM ``max_cat_to_onehot``).  With a row
    ``mesh`` the codes are counted over every rank's rows."""
    sub = []
    for f in p.categorical_features:
        seen = torch.bincount(binned[:, f].to(torch.int64), minlength=B)
        if mesh is not None:
            from ..parallel.collectives import psum
            from ..parallel.mesh import AXIS_DATA
            seen = psum(seen, AXIS_DATA, mesh)
        if int((seen[:B - 1] > 0).sum()) > p.max_cat_to_onehot:
            sub.append(int(f))
    return tuple(sub)


def _sharded_lambdas(lambda_fn, scores: torch.Tensor, n: int, n_data: int,
                     lo: int, axis: str, mesh):
    """LambdaRank's gradients of this rank's rows under ``shard_rows``: a
    query may span ranks, so the whole score vector is assembled (each
    rank's block summed into zeros over the axis: exact) and the lambdas
    of the unpadded rows taken from it; pad rows get 0."""
    from ..parallel.collectives import psum
    full = torch.zeros((n,) + tuple(scores.shape[1:]), dtype=scores.dtype,
                       device=scores.device)
    full[lo:lo + scores.shape[0]] = scores
    g, h = lambda_fn(psum(full, axis, mesh)[:n_data])
    pad = (0, 0, 0, n - n_data)
    sl = slice(lo, lo + scores.shape[0])
    return (torch.nn.functional.pad(g, pad)[sl],
            torch.nn.functional.pad(h, pad)[sl])


def train(X: np.ndarray, y: np.ndarray, params: GBDTParams,
          sample_weight: Optional[np.ndarray] = None,
          valid: Optional[Tuple[np.ndarray, np.ndarray]] = None,
          group_ptr: Optional[np.ndarray] = None,
          init_booster: Optional[GBDTBooster] = None,
          feature_names: Optional[List[str]] = None,
          callbacks: Optional[List[Callable]] = None,
          shard_rows: bool = False,
          bin_cache: Optional[Dict] = None,
          checkpoint_dir: Optional[str] = None,
          checkpoint_every: int = 0,
          checkpoint_keep_last: int = 3,
          resume: str = "auto",
          monitor_port: Optional[int] = None,
          monitor_stall_timeout_s: Optional[float] = None,
          device: DeviceLike = None) -> TrainResult:
    """Boosting loop (the JAX package's ``train``: both growers, numerical
    and categorical splits, the binary,
    multiclass, regression and lambdarank objectives, boosting types
    gbdt/rf/dart/goss and bagging).  Multiclass grows ``num_class`` trees
    per iteration, one per class from that class's gradient column, with
    the iteration's feature, bag and DART draws shared by the classes.
    ``lambdarank`` needs ``group_ptr`` (ignored for other objectives, as in
    the JAX package) and keeps the reference's rules: its lambdas take no
    GOSS sample, no DART drop (nor its ``skip_drop`` draw), no RF gradient
    scale and no sample weights.
    Runs on the card unless ``device="cpu"``; ``use_quantized_grad=None``
    turns quantized histograms on for the card and off on the CPU, and
    ``MMLSPARK_TPU_HIST_QUANT`` overrides it; ``MMLSPARK_TPU_HIST_BACKEND``
    picks the histogram backend of an ``auto`` grower (both read once per
    call: ``_resolve_hist_backend``).  Edges
    are found on the host; on the card the bins are applied there
    (``BinMapper.bin_on_device``).  Per iteration the GOSS draw and the
    quantizer's noise come from a ``torch.Generator`` seeded with ``seed *
    1000003 + iteration``; the feature-fraction, bagging and DART draws
    come from the host ``np.random.default_rng(seed)`` in the JAX package's
    order, so a seed gives both packages the same masks.  A ``valid`` set
    is scored after every tree and drives early stopping; ``init_booster``
    warm-starts from an existing booster.

    ``bin_cache`` (a dict the caller keeps across calls) memoizes the
    mapper and the bins on ``dev``, as the JAX package's does: keyed on
    ``(id(X), shape, strided content fingerprint, binning params)`` and the
    device, it pins X so the id cannot be recycled, and a miss drops every
    entry before refilling.  A mutation of X in place is caught by the
    ~4k-element strided fingerprint unless it touches only skipped
    elements; callers that rewrite X wholesale should pass a fresh dict.

    Fault tolerance, as in the JAX package: with ``checkpoint_dir`` the run
    snapshots its booster so far, the completed iteration count, the host
    ``rng`` state, the bag mask and the early-stopping state every
    ``checkpoint_every`` iterations and once at the end, serialized on the
    ``io.checkpoint.CheckpointManager``'s writer thread (the loop pays only
    for list copies).  ``resume="auto"`` restores the newest valid snapshot
    through the warm-start path (the snapshot's booster replaces any
    ``init_booster``); ``"must"`` raises without one, ``"never"`` ignores
    it.  SIGTERM/SIGINT (or ``utils.resilience.request_preemption``) during
    the loop writes one last snapshot at the next iteration boundary and
    returns with ``extras["preempted"]`` set.  The snapshot file format is
    the JAX package's, so either package reads the other's files; the
    fingerprint, though, is built from each package's own params signature,
    so one package does not resume the other's run.

    ``shard_rows`` shards the rows over the active mesh's ``data`` axis
    (``parallel.get_active_mesh``: a process group's world, or one
    position): every rank calls ``train`` with the same full ``X`` and
    ``y``, as the JAX package puts the whole array on its mesh, keeps its
    contiguous block of the rows (padded to a multiple of the width; pad
    rows weigh 0 and enter no histogram) on its device, and grows the
    trees with local histograms summed over the axis
    (``parallel.collectives.histogram_psum``).  Every rank returns the
    same booster.  The host statistics, the init score and the bagging
    draw are taken over the unpadded rows, identically on every rank, and
    the quantizer's noise is keyed on each row's global id, so a quantized
    fit is the same at any width.  ``parallelism="voting_parallel"``
    (``voting_k``) engages only here.  Rank 0 alone writes the snapshots;
    a preemption on any rank stops every rank at the same boundary.  A
    resume onto another width (elastic resume) re-pads the rows and the
    bag mask, re-keys the packed allreduce's bound, books
    ``mmlspark_reshard_total`` and sets ``extras["resharded"]``.  A valid
    set is scored whole on every rank.  As in the JAX package, GOSS draws
    no sample under ``shard_rows`` (its sharded loop takes the plain
    gradients), and LambdaRank's lambdas are taken over the whole score
    vector (summed from the ranks' blocks)."""
    dev = resolve_device(device)
    p = params.resolve()
    # the histogram backend and quantization, read once per call
    hist_backend, quant_env = _resolve_hist_backend()
    p = dataclasses.replace(p, use_quantized_grad=_resolve_quantized(
        dev, p.use_quantized_grad, quant_env))
    check_resume_arg(resume, checkpoint_dir=checkpoint_dir)
    is_rank = p.objective == "lambdarank"
    if is_rank and group_ptr is None:
        raise ValueError("lambdarank requires group_ptr")
    objective = make_objective(p)
    rng = np.random.default_rng(p.seed)
    X = np.asarray(X, np.float32)
    y = np.asarray(y, np.float32)
    n, F = X.shape
    K = p.num_class if p.objective == "multiclass" else 1
    w = np.ones(n, np.float32) if sample_weight is None \
        else np.asarray(sample_weight, np.float32)
    check_labels(p, y, F)
    n_data = n              # the unpadded rows: host statistics and draws
    y_data, w_data = y, w   # never depend on the mesh's width
    mesh = axis = None
    lo, hi = 0, n
    if shard_rows:
        from ..parallel.mesh import AXIS_DATA, get_active_mesh
        from ..parallel.sharding import batch_sharded, pad_to_multiple
        mesh, axis = get_active_mesh(), AXIS_DATA
        width = mesh.shape[axis]
        X_pad, _ = pad_to_multiple(X, width)
        n = X_pad.shape[0]
        blk = batch_sharded(mesh, axis).block(n)
        lo, hi = blk.start, blk.stop
    n_loc = hi - lo

    # opt-in binning memo: many train() calls over the SAME X with fresh
    # labels (edges and bins depend on X only)
    bin_sig = (id(X), X.shape, _content_fingerprint(X), p.max_bin,
               tuple(p.categorical_features or ()), str(dev), lo, hi)
    t_edges = t_apply = 0.0
    if bin_cache is not None and bin_cache.get("sig") == bin_sig:
        mapper, binned = bin_cache["mapper"], bin_cache["binned_dev"]
    else:
        t0 = time.perf_counter()
        with ambient_phase("lightgbm.binning"):
            mapper = BinMapper(
                p.max_bin,
                categorical_features=p.categorical_features).fit(X)
        t_edges = time.perf_counter() - t0
        t0 = time.perf_counter()
        with torch.profiler.record_function("train.bin_apply"), \
                ambient_phase("lightgbm.binning"):
            # sharded: this rank's block of the padded rows (pad rows
            # repeat the last row, as the JAX package pads)
            binned = _bin(mapper, X_pad[lo:hi] if shard_rows else X, dev)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        t_apply = time.perf_counter() - t0
        if bin_cache is not None:
            bin_cache.clear()
            bin_cache.update(sig=bin_sig, X=X, mapper=mapper,
                             binned_dev=binned)
    B = mapper.num_bins
    if p.categorical_features and p.cat_subset is None:
        p = dataclasses.replace(p, cat_subset=_cat_subset(p, binned, B,
                                                          mesh))

    # ---- checkpoints: the fingerprint is the data/params identity (must
    # match); the topology stanza is recorded and may differ
    fingerprint = repr((_params_sig(p), n_data, F, B, K, shard_rows,
                        _content_fingerprint(X)))
    topology = topology_stanza(mesh=mesh, shard_count=mesh.shape[axis]) \
        if shard_rows else topology_stanza(shard_count=1, device_count=1)
    # one writer per checkpoint directory: rank 0 of a sharded run
    writer = not shard_rows or mesh.axis_index(axis) == 0
    mgr = CheckpointManager(checkpoint_dir, site="lightgbm.train",
                            keep_last=checkpoint_keep_last) \
        if checkpoint_dir else None
    resume_meta, resume_bag, resharded = None, None, False
    n_user_init = init_booster.num_trees if init_booster is not None else 0
    if mgr is not None and resume in ("auto", "must"):
        got = mgr.load_latest(current_topology=topology)
        if got is None and resume == "must":
            raise resume_required_error(checkpoint_dir)
        if got is not None:
            _, arrs, resume_meta = got
            if resume_meta.get("fingerprint") != fingerprint:
                raise ValueError(_CKPT_FINGERPRINT_MISMATCH)
            delta = resume_meta.get("topology_delta")
            if delta is not None and delta["changed"]:
                book_reshard("lightgbm.train", delta)
                resharded = True
            init_booster = _booster_of_snapshot(arrs, resume_meta, p, F, K)
            n_user_init = int(resume_meta.get("n_init_trees", 0))
            resume_bag = arrs.get("bag_mask")

    if shard_rows:
        y, _ = pad_to_multiple(y, mesh.shape[axis])
        w, _ = pad_to_multiple(w, mesh.shape[axis], fill=0.0)
    t0 = time.perf_counter()
    edges = torch.from_numpy(mapper.edges).to(dev)
    y_dev = torch.from_numpy(y[lo:hi]).to(dev)
    w_dev = torch.from_numpy(w[lo:hi]).to(dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_transfer = time.perf_counter() - t0

    # sharded: the psum's row bound is the GLOBAL padded row count
    grow = _make_grower(p, F, B, backend=hist_backend, axis_name=axis,
                        psum_row_bound=n if shard_rows else None, mesh=mesh)
    D = p.depth_bound
    L = p.num_leaves

    init_score = init_score_of(p.objective, y_data, w_data, p.sigmoid)
    scores = torch.full((n_loc, K), init_score, dtype=torch.float32,
                        device=dev)

    # subset splits need each node's category set; a warm-start booster
    # that carries sets keeps them through the continuation
    store_bitset = bool(p.categorical_features) and (
        bool(p.cat_subset) or (init_booster is not None
                               and init_booster.cat_bitset is not None))
    tree_keys = _TREE_KEYS + (("cat_bitset",) if store_bitset else ())
    trees: Dict[str, List[torch.Tensor]] = {k: [] for k in tree_keys}
    tree_weights: List[float] = []
    walk_bound = max(D, init_booster.max_depth if init_booster is not None
                     else 0)
    walker = make_binned_walker(walk_bound, p.categorical_features)

    def walk_tree(binned_x, t):
        return walker(binned_x, *(trees[k][t] for k in (
            "split_feature", "threshold_bin", "left_child", "right_child")),
            bitset=trees["cat_bitset"][t] if store_bitset else None)

    if init_booster is not None:
        if init_booster.num_leaves != L or init_booster.num_features != F:
            raise ValueError("init_booster must have the same num_leaves "
                             f"({L}) and num_features ({F})")
        # one-vs-rest warm-start trees get one-bit sets, so the continued
        # booster's trees are uniform
        init_cbs = init_booster.resolve_cat_bitset(B) if store_bitset \
            else None
        for t in range(init_booster.num_trees):
            for k in _TREE_KEYS:
                trees[k].append(torch.from_numpy(
                    np.asarray(getattr(init_booster, k)[t])).to(dev))
            if store_bitset:
                trees["cat_bitset"].append(
                    torch.from_numpy(init_cbs[t]).to(dev))
            tree_weights.append(float(init_booster.tree_weight[t]))
            scores[:, t % K] += trees["leaf_value"][t][
                walk_tree(binned, t)] * tree_weights[t]
        # continue against the incoming booster's base score
        scores = scores + (init_booster.init_score - init_score)
        init_score = init_booster.init_score

    metric_name = p.metric or default_metric(p.objective)
    metric_fn, larger_better = resolve_metric(metric_name, p)
    evals: List[Dict[str, float]] = []
    has_valid = valid is not None
    if has_valid:
        Xv = np.asarray(valid[0], np.float32)
        yv = np.asarray(valid[1], np.float32)
        binned_v = _bin(mapper, Xv, dev)
        scores_v = torch.full((Xv.shape[0], K), init_score,
                              dtype=torch.float32, device=dev)
        if resume_meta is not None:
            # the trees grown before the snapshot score the valid set, the
            # user's warm-start trees do not (as in the uninterrupted run)
            for t in range(n_user_init, len(tree_weights)):
                scores_v[:, t % K] += trees["leaf_value"][t][
                    walk_tree(binned_v, t)] * tree_weights[t]
    best_metric = -np.inf if larger_better else np.inf
    best_iter = -1
    rounds_no_improve = 0
    if resume_meta is not None:
        # the host loop state: the rng (feature, bag and DART draws), the
        # early-stopping scalars and the evals.  The quantizer's and the
        # GOSS draw's torch.Generator is re-seeded every iteration from
        # (seed, iteration), so no torch generator state is snapshotted.
        rng.bit_generator.state = resume_meta["rng_state"]
        best_metric = float(resume_meta["best_metric"])
        best_iter = int(resume_meta["best_iter"])
        rounds_no_improve = int(resume_meta["rounds_no_improve"])
        evals[:] = [dict(e) for e in resume_meta.get("evals", [])]

    feat_mask_full = torch.ones((F,), dtype=torch.bool, device=dev)
    # sharded: pad rows (weight 0) enter no histogram, nor, as in the JAX
    # package, do rows the caller weighted 0
    hist_mask_full = w_dev > 0 if shard_rows \
        else torch.ones((n,), dtype=torch.bool, device=dev)
    bag_mask = bag_host = None
    if resume_bag is not None:
        # the snapshot's bits cover ITS padded width: the real rows are
        # the same at any width, and pad rows never enter a histogram
        bits = np.unpackbits(resume_bag)
        bag_host = np.pad(bits, (0, max(0, n - bits.size)))[:n].astype(bool)
        bag_mask = torch.from_numpy(bag_host[lo:hi]).to(dev)
    gen = torch.Generator(device=dev)
    shrink = 1.0 if p.boosting_type == "rf" else p.learning_rate
    # the JAX package's sharded loop takes no GOSS sample
    is_goss = p.boosting_type == "goss" and not shard_rows
    a_n = int(p.top_rate * n) if is_goss else 0
    b_n = int(p.other_rate * n) if is_goss else 0
    goss_amp = (1.0 - p.top_rate) / max(p.other_rate, 1e-12)
    # the packing gathers, built once; the lambdas stay on the device
    lambda_fn = make_lambdarank_grad_fn(y_data, group_ptr, p.sigmoid, dev) \
        if is_rank else None

    start_iter = len(tree_weights) // K
    done_before = 0
    if resume_meta is not None:
        done_before = int(resume_meta["iteration"])
        if resume_meta.get("finished") and p.num_iterations <= int(
                resume_meta.get("num_iterations", done_before)):
            # the snapshot IS the finished run: return its booster; a
            # larger num_iterations keeps training
            done_before = p.num_iterations
    end_iter = start_iter + max(0, p.num_iterations - done_before)
    preempted = False
    last_ckpt_iter = start_iter
    trees_at_loop_start = len(tree_weights)

    def save_ckpt(finished: bool, block: bool = False) -> None:
        # the one completed-iteration convention: trees beyond the user's
        # warm start, from the tree count
        if not writer:
            return
        done = len(tree_weights) // K - n_user_init // K
        meta = _booster_ckpt_meta(done, n_user_init, rng, best_metric,
                                  best_iter, rounds_no_improve, evals,
                                  init_score, fingerprint, finished,
                                  p.num_iterations, "booster_v1",
                                  topology=topology)
        mgr.save(done, _booster_ckpt_arrays(
            trees, tree_weights, bag_host if shard_rows else bag_mask),
            meta, block=block)

    # the preemption scope only when checkpointing is on: without a
    # snapshot to write, a SIGTERM keeps its default behaviour
    scope = preemption_scope() if mgr is not None \
        else contextlib.nullcontext(PreemptionToken())
    # the live training monitor: opt-in heartbeat, stall watchdog and HTTP
    # sidecar, ticked from the callbacks seam
    watch, watch_srv, callbacks = _start_monitor(
        "lightgbm.train", p, n, monitor_port, monitor_stall_timeout_s,
        callbacks)
    t0 = time.perf_counter()
    # a profiler range (a no-op unless a profiler runs) that lets a trace
    # tell the loop's device work from the binning kernels before it
    with contextlib.ExitStack() as stack:
        stack.callback(_stop_monitor, watch, watch_srv)
        stack.enter_context(
            torch.profiler.record_function("train.boosting"))
        token = stack.enter_context(scope)
        if watch is not None:
            watch.set_preemption_token(token)
        for it in range(start_iter, end_iter):
            requested = token.requested
            if shard_rows and mgr is not None:
                # a signal may reach one rank: all stop at one boundary
                from ..parallel.collectives import pmax
                requested = bool(pmax(torch.tensor(
                    [int(requested)], device=dev), axis, mesh)[0])
            if requested:
                # one last snapshot at this iteration boundary, then a
                # clean partial return the caller can resume from
                save_ckpt(finished=False, block=True)
                preempted = True
                break
            if mgr is not None and checkpoint_every > 0 \
                    and it - last_ckpt_iter >= checkpoint_every:
                save_ckpt(finished=False)
                last_ckpt_iter = it
            # host-side draws, in the JAX package's order: features, bag, DART
            feat_mask = feat_mask_full
            if p.feature_fraction < 1.0:
                keep = max(1, int(round(p.feature_fraction * F)))
                sel = rng.choice(F, size=keep, replace=False)
                feat_mask = torch.zeros((F,), dtype=torch.bool, device=dev)
                feat_mask[torch.from_numpy(sel).to(dev)] = True
            hist_mask = hist_mask_full
            if not is_goss and p.bagging_freq > 0 and p.bagging_fraction < 1.0:
                # resample on schedule, and on the first iteration of a warm
                # start that begins off schedule
                if it % p.bagging_freq == 0 or bag_mask is None:
                    # drawn over the unpadded rows: the rng stream, and so
                    # every later draw, does not depend on the width
                    bag_host = np.pad(rng.random(n_data) < p.bagging_fraction,
                                      (0, n - n_data))
                    bag_mask = torch.from_numpy(bag_host[lo:hi]).to(dev)
                hist_mask = hist_mask_full & bag_mask if shard_rows \
                    else bag_mask
            dropped: List[int] = []
            # ranking draws no drop (the reference's elif): rng unchanged
            if p.boosting_type == "dart" and not is_rank and tree_weights \
                    and rng.random() >= p.skip_drop:
                k_drop = min(p.max_drop, max(1, int(round(
                    p.drop_rate * len(tree_weights)))))
                dropped = sorted(rng.choice(
                    len(tree_weights), size=min(k_drop, len(tree_weights)),
                    replace=False).tolist())
            gen.manual_seed(p.seed * 1000003 + it)
            if is_rank:
                # precomputed lambdas: no GOSS, no RF scale, no weights
                g, h = lambda_fn(scores) if not shard_rows \
                    else _sharded_lambdas(lambda_fn, scores, n, n_data, lo,
                                          axis, mesh)
            elif dropped:
                # DART: gradients against the scores without the dropped trees
                drop_delta = torch.zeros_like(scores)
                for t in dropped:
                    drop_delta[:, t % K] += trees["leaf_value"][t][
                        walk_tree(binned, t)] * tree_weights[t]
                g, h = objective(scores - drop_delta, y_dev, w_dev)
            else:
                grad_scale = float(max(1, len(tree_weights) // K)) \
                    if p.boosting_type == "rf" and tree_weights else 1.0
                g, h = objective(scores / grad_scale, y_dev, w_dev)
                if is_goss:
                    # the top a_n rows by |g|, b_n of the rest at random,
                    # amplified by (1 - top_rate) / other_rate
                    order = torch.argsort(-g.abs().sum(dim=1), stable=True)
                    rest = order[a_n:]
                    perm = torch.randperm(rest.shape[0], generator=gen,
                                          device=dev)
                    small_idx = rest[perm[:b_n]]
                    keep_rows = torch.zeros((n,), dtype=torch.bool, device=dev)
                    keep_rows.index_fill_(0, order[:a_n], True)
                    keep_rows.index_fill_(0, small_idx, True)
                    amp = torch.ones((n,), dtype=torch.float32, device=dev)
                    amp.index_fill_(0, small_idx, goss_amp)
                    hist_mask = hist_mask & keep_rows
                    g, h = g * amp[:, None], h * amp[:, None]
            new_w = 1.0 / (1.0 + len(dropped)) if dropped else 1.0
            # one tree per class, from the class's (strided) gradient column
            for c in range(K):
                with ambient_phase("lightgbm.histogram"):
                    tree = grow(binned, g[:, c], h[:, c], hist_mask,
                                feat_mask, edges, generator=gen)
                lv_s = tree.leaf_value * shrink
                scores[:, c] += lv_s[tree.leaf_of_row] * new_w
                for k in tree_keys:
                    trees[k].append(lv_s if k == "leaf_value"
                                    else getattr(tree, k))
                tree_weights.append(new_w)
                if has_valid:
                    leaf_v = walker(
                        binned_v, tree.split_feature, tree.threshold_bin,
                        tree.left_child, tree.right_child,
                        bitset=tree.cat_bitset if store_bitset else None)
                    scores_v[:, c] += lv_s[leaf_v] * new_w
            if dropped:
                # DART: shrink each dropped tree by k / (1 + k), on the train
                # and valid scores alike
                factor = len(dropped) / (1.0 + len(dropped))
                for t in dropped:
                    scale = tree_weights[t] * (factor - 1.0)
                    scores[:, t % K] += trees["leaf_value"][t][
                        walk_tree(binned, t)] * scale
                    if has_valid:
                        scores_v[:, t % K] += trees["leaf_value"][t][
                            walk_tree(binned_v, t)] * scale
                    tree_weights[t] *= factor
            if has_valid:
                with ambient_phase("lightgbm.eval"):
                    m = metric_fn(yv,
                                  scores_v.cpu().numpy().astype(np.float64))
                evals.append({metric_name: m, "iteration": it})
                improved = m > best_metric if larger_better \
                    else m < best_metric
                if improved:
                    best_metric, best_iter, rounds_no_improve = m, it, 0
                else:
                    rounds_no_improve += 1
                if p.early_stopping_round > 0 and \
                        rounds_no_improve >= p.early_stopping_round:
                    break
            if callbacks:
                for cb in callbacks:
                    cb(it, evals[-1] if evals else None)

        if mgr is not None:
            if not preempted and (len(tree_weights) > trees_at_loop_start
                                  or resume_meta is None):
                # terminal snapshot (early stopping too); a finished-run
                # restore that grew nothing skips the re-save
                save_ckpt(finished=True, block=True)
            mgr.close()
        # one sync, after the loop
        trees_np = {k: np.stack([t.cpu().numpy() for t in v])
                    for k, v in trees.items()}
        # before the monitor stops: its server's shutdown waits up to one
        # poll interval of the serving loop
        t_boost = time.perf_counter() - t0
    if p.growth == "leaf":
        # the tight walk bound: leaf-wise trees are usually far shallower
        # than the num_leaves - 1 chain (warm-start trees included)
        D = children_depth_bound(trees_np["left_child"],
                                 trees_np["right_child"])
    elif init_booster is not None:
        D = max(D, init_booster.max_depth)
    booster = GBDTBooster(
        trees_np["split_feature"], trees_np["threshold"],
        trees_np["threshold_bin"], trees_np["split_gain"],
        trees_np["internal_value"], trees_np["internal_count"],
        trees_np["leaf_value"], trees_np["leaf_count"],
        np.asarray(tree_weights, np.float32),
        left_child=trees_np["left_child"], right_child=trees_np["right_child"],
        max_depth=D, num_features=F, objective=p.objective, num_class=K,
        init_score=init_score, average_output=(p.boosting_type == "rf"),
        feature_names=feature_names, best_iteration=best_iter,
        sigmoid=p.sigmoid,
        categorical_features=list(p.categorical_features or []),
        cat_bitset=trees_np.get("cat_bitset"))
    extras = {"binning_s": t_edges + t_apply, "edges_s": t_edges,
              "bin_apply_s": t_apply, "transfer_s": t_transfer,
              "boosting_s": t_boost}
    if shard_rows:
        extras.update(shard_count=float(mesh.shape[axis]),
                      shard_rows=float(n_loc))
    if mgr is not None:
        extras.update(_ckpt_extras(preempted, resume_meta, mgr, resharded))
    return TrainResult(booster=booster, evals=evals, bin_mapper=mapper,
                       extras=extras)


def _ckpt_extras(preempted: bool, resume_meta, mgr, resharded: bool
                 ) -> Dict[str, float]:
    return {"preempted": float(preempted),
            "resumed_from_iteration": float(resume_meta["iteration"])
            if resume_meta is not None else -1.0,
            "checkpoint_saves": float(mgr.saves_ok),
            "resharded": float(resharded)}


# ---------------------------------------------------------------------------
# out-of-core streamed training: host-RAM tiles -> the card
# ---------------------------------------------------------------------------

def _check_quant_tile_bound(use_quant: bool, quant_bins: int,
                            total_rows: int) -> None:
    """Tile-accumulation twin of the per-build overflow guard: each
    per-tile build guards int32 overflow against its OWN tile's rows, but
    the driver accumulates decoded partials across every tile — a
    root-level cell can hold the full dataset's sums, so the guard must
    see the total."""
    if not use_quant:
        return
    qh_cap = max(1, quant_bins - 1)
    if int(total_rows) * qh_cap >= (1 << 31):
        raise ValueError(
            "quantized histograms overflow int32 when accumulated across "
            f"tiles above {(1 << 31) // qh_cap} total rows at {quant_bins} "
            "quantization bins — lower num_grad_quant_bins or disable "
            "use_quantized_grad")


def _quant_mix(g_host: np.ndarray, h_host: np.ndarray) -> np.int32:
    """Per-iteration quantization key mix for the streamed driver: an
    exact INTEGER fold of the bitcast |grad|/hess magnitudes over the
    whole host row space (``ops.histogram.quant_mix``).  Integer adds are
    associative and the host arrays are tile-independent, so the mix — and
    every row's stochastic rounding — survives a resume onto a different
    tile width bit-for-bit."""
    return np.int32(hist_ops.quant_mix(torch.from_numpy(g_host),
                                       torch.from_numpy(h_host)))


def _np_walk_tree(binned: np.ndarray, sf: np.ndarray, tb: np.ndarray,
                  lch: np.ndarray, rch: np.ndarray,
                  depth_bound: int) -> np.ndarray:
    """Host twin of ``make_binned_walker`` for numerical splits: per-row
    leaf index of ONE tree over host-resident binned data.  Integer
    compares and gathers only, so the leaf assignment is exactly the one
    the device walker (and the streamed router) produces — which is what
    lets resume replay reconstruct training scores bit-for-bit without
    ever putting the full binned matrix on the device."""
    n = binned.shape[0]
    node = np.zeros((n,), np.int64)
    rows = np.arange(n)
    sf = np.asarray(sf, np.int64)
    tb = np.asarray(tb, np.int64)
    lch = np.asarray(lch, np.int64)
    rch = np.asarray(rch, np.int64)
    for _ in range(max(1, int(depth_bound))):
        j = np.maximum(node, 0)
        f = sf[j]
        go_right = (f >= 0) & (binned[rows, np.maximum(f, 0)].astype(np.int64)
                               > tb[j])
        child = np.where(go_right, rch[j], lch[j])
        node = np.where(node >= 0, child, node)
    return ~node


def _np_leaf_output(G, H, l1: float, l2: float, max_delta: float):
    """Host-side twin of the growers' leaf_output (f32 in, f32 out).
    Empty nodes (G=H=0, l2=0) yield NaN exactly like the device version —
    callers mask them behind a count check, so the numpy warning is
    suppressed rather than papered over with a fake value."""
    with np.errstate(invalid="ignore", divide="ignore"):
        t = np.sign(G) * np.maximum(np.abs(G) - l1, 0.0)
        v = (-t / (H + l2)).astype(np.float32)
    if max_delta > 0:
        v = np.clip(v, -max_delta, max_delta)
    return v


#: the transfer-bytes site of the streamed tiles (the reference's
#: ``OOC_SITE``): every staged tile is booked there by ``device_put``
OOC_SITE = "lightgbm.ooc_tile"


class _TileStager:
    """The host -> device leg of one tile.  A payload is a list of
    ``(host slice, fill)`` pairs whose last axis is the tile's real rows;
    each lands padded to ``T`` rows.  On the card the slices are copied
    into one of two pinned staging buffers (alternating; a buffer is
    refilled only after the copy out of its previous use has finished),
    then to the card with non-blocking copies on a dedicated copy stream,
    after which an event is recorded.  ``ready`` (on the consumer's
    thread) makes the consumer's current stream wait on that event and
    ties each device tensor to that stream (``record_stream``), so the
    caching allocator does not hand a tile's memory to the next tile while
    a kernel still reads it.  On the CPU the padded host arrays are handed
    over as tensors.  Books the bytes copied (``self.bytes``, and through
    ``device_put`` under ``mmlspark_device_transfer_bytes_total{site=
    OOC_SITE}``: the padded tile as it is staged) and, on the card, the
    copy stream's time (CUDA events, read at the consumer's sync
    points)."""

    def __init__(self, dev: torch.device, T: int):
        self.dev, self.T = dev, T
        self.cuda = dev.type == "cuda"
        self.bytes = 0
        self.copy_s = 0.0
        if self.cuda:
            self.stream = torch.cuda.Stream(dev)
            self._pinned = [{}, {}]
            self._done = [None, None]
            self._slot = 0
            self._timing = collections.deque()

    def _padded(self, bufs, key, src: np.ndarray, fill) -> torch.Tensor:
        shape = src.shape[:-1] + (self.T,)
        buf = bufs.get(key) if bufs is not None else None
        if buf is None:
            buf = torch.empty(shape, dtype=torch.from_numpy(src[..., :0])
                              .dtype, pin_memory=bufs is not None)
            if bufs is not None:
                bufs[key] = buf
        m = src.shape[-1]
        buf[..., :m].copy_(torch.from_numpy(src))
        if m < self.T:
            buf[..., m:].fill_(fill)
        return buf

    def load(self, parts):
        """Runs on the prefetch worker thread."""
        if not self.cuda:
            out = device_put([self._padded(None, k, src, fill)
                              for k, (src, fill) in enumerate(parts)],
                             self.dev, site=OOC_SITE)
            self.bytes += sum(t.nbytes for t in out)
            return out, None
        slot = self._slot
        self._slot ^= 1
        if self._done[slot] is not None:
            self._done[slot].synchronize()      # its last copy has left
        host = [self._padded(self._pinned[slot], (k, src.shape[:-1],
                                                  src.dtype), src, fill)
                for k, (src, fill) in enumerate(parts)]
        with torch.cuda.stream(self.stream):
            start = torch.cuda.Event(enable_timing=True)
            start.record(self.stream)
            out = device_put(host, self.dev, site=OOC_SITE,
                             non_blocking=True)
            done = torch.cuda.Event(enable_timing=True)
            done.record(self.stream)
        self._done[slot] = done
        self._timing.append((start, done))
        self.bytes += sum(h.nbytes for h in host)
        return out, done

    def ready(self, tile):
        """The tile's device tensors, safe to use on the current stream."""
        out, done = tile
        if done is not None:
            cur = torch.cuda.current_stream(self.dev)
            cur.wait_event(done)
            for t in out:
                t.record_stream(cur)
        return out

    def drain(self) -> None:
        """Book the copy time of every copy that has finished."""
        if not self.cuda:
            return
        while self._timing and self._timing[0][1].query():
            start, done = self._timing.popleft()
            self.copy_s += start.elapsed_time(done) / 1e3


def _quantize_rows(g_host: np.ndarray, h_host: np.ndarray, quant_bins: int,
                   g_scale: float, h_scale: float, seed: int, mix: int,
                   dev: torch.device, chunk: int
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Every row's quantized gradient and hessian, once per iteration:
    ``quantize_gradients`` on ``dev`` in chunks of ``chunk`` rows (one
    tile's worth, so nothing row-sized stays there), with the noise keyed
    per GLOBAL row.  Returns host int8 ``(qg, qh)``; each row's values
    depend on nothing but its own gradient, the scales and (seed, mix,
    row), so any tiling of them sums to the same histograms."""
    n = g_host.shape[0]
    qg_h = np.empty((n,), np.int8)
    qh_h = np.empty((n,), np.int8)
    gs = torch.tensor(g_scale, dtype=torch.float32, device=dev)
    hs = torch.tensor(h_scale, dtype=torch.float32, device=dev)
    for lo in range(0, n, chunk):
        hi = min(n, lo + chunk)
        qg, qh, _, _ = hist_ops.quantize_gradients(
            torch.from_numpy(g_host[lo:hi]).to(dev),
            torch.from_numpy(h_host[lo:hi]).to(dev), quant_bins,
            g_scale=gs, h_scale=hs,
            row_ids=torch.arange(lo, hi, device=dev), seed=seed, mix=mix)
        qg_h[lo:hi] = qg.to(torch.int8).cpu().numpy()
        qh_h[lo:hi] = qh.to(torch.int8).cpu().numpy()
    return qg_h, qh_h


def _stream_bins(cd, max_bin: int, sample_cnt: int = 200_000
                 ) -> Tuple[BinMapper, np.ndarray]:
    """Streamed binning: the sketch pass fed the dataset's tiles, then
    host uint8 bins tile by tile, each tile by the host route its own cell
    count picks (as the JAX package bins: a short last tile may take the
    numpy route while the others take the C++ one), stored feature-major
    ``(F, n)``.  The sketch sees the chunks the JAX package's
    ``train_streamed`` gives it, so the edges are the reference's at every
    tile width: below the sample cap they do not depend on the width;
    above it the reservoir's draws follow the chunks, and the edges move
    with ``tile_rows`` as the reference's do."""
    mapper = BinMapper(max_bin).fit_streaming(
        (cd.X[slice(*cd.tile_slice(i))] for i in range(cd.num_tiles)),
        sample_cnt=sample_cnt)
    binned_fm = np.empty((cd.num_features, cd.n_rows), np.uint8)
    for i in range(cd.num_tiles):
        lo, hi = cd.tile_slice(i)
        binned_fm[:, lo:hi] = mapper.transform(cd.X[lo:hi]).T
    return mapper, binned_fm


def train_streamed(X, y: Optional[np.ndarray] = None,
                   params: GBDTParams = None,
                   sample_weight: Optional[np.ndarray] = None,
                   valid: Optional[Tuple[np.ndarray, np.ndarray]] = None,
                   tile_rows: Optional[int] = None,
                   memory_budget_bytes: Optional[int] = None,
                   feature_names: Optional[List[str]] = None,
                   init_booster: Optional[GBDTBooster] = None,
                   callbacks: Optional[List[Callable]] = None,
                   checkpoint_dir: Optional[str] = None,
                   checkpoint_every: int = 0,
                   checkpoint_keep_last: int = 3,
                   resume: str = "auto",
                   monitor_port: Optional[int] = None,
                   monitor_stall_timeout_s: Optional[float] = None,
                   device: DeviceLike = None) -> TrainResult:
    """Out-of-core boosting (the JAX package's ``train_streamed``): the
    dataset lives in host RAM and streams through the device in
    fixed-shape tiles with double-buffered prefetch (``io.chunked``).
    Nothing row-sized is ever resident on the device except the two live
    tiles, so the trainable dataset is bounded by host RAM, not by the
    card's memory.  Runs on the card unless ``device="cpu"``.

    The host holds the bins feature-major, ``(F, n)`` uint8, so a tile is
    ``F`` contiguous row runs and lands on the card as the feature-major
    matrix ``hist_accumulate`` reads.  Each tile is copied into one of two
    pinned staging buffers and to the card on a dedicated copy stream; the
    consumer's stream waits on the copy's event (``_TileStager``).

    Numerics: bin edges come from a streaming quantile sketch fed the
    tiles, as the JAX package feeds it (identical to the in-memory fit
    whenever the stream fits the sample budget; above it the edges depend
    on the tile width, the reference's at each width); the
    gradient pass evaluates the objective in float64 and rounds once to
    float32 (the card's and the CPU's float32 ``exp`` differ in the last
    place; the rounded float64 results agree), and the quantization scales
    come from the global grad/hess maxima of that pass, so each tile
    quantizes in IDENTICAL units.  Every row is quantized once per
    iteration (``_quantize_rows``, a tile's worth of rows at a time on the
    device), its rounding noise keyed on its GLOBAL row
    (``ops.histogram.row_noise``) and a per-iteration integer mix of the
    host gradients (``_quant_mix``); the tiles carry the int8 values, and the per-tile int32 partials (``build_quantized``: both
    Hopper kernels on the card, the plain build on the CPU) accumulate to
    the same integers under any tile width.
    Split search runs on the accumulated histograms on the device, with
    the in-memory growers' arithmetic (``_split_math``): the quantized
    path scans them in integer (exact and order-free) and dequantizes the
    prefix sums, the float path scans in the sequential order of
    ``cuda_histogram._cumsum_bins``, so the card and the CPU pick the same
    splits; row routing and the tree bookkeeping run on the host.

    Both grower families stream: ``growth="level"`` runs one accumulate ->
    decide -> route cycle per level (D passes over the tiles per tree, the
    routing of a level riding the prefetch worker of the next pass);
    ``growth="leaf"`` rebuilds the split leaf's left child per step and
    derives the sibling by exact integer subtraction from a host-resident
    stored-histogram table (``1 + (num_leaves - 1)`` passes per tree).

    ``X`` may be a raw ``(n, F)`` array or a prebuilt
    ``io.chunked.ChunkedDataset`` (then ``y``/``w`` ride its columns).
    Tile size resolves from ``tile_rows`` / ``memory_budget_bytes`` /
    ``MMLSPARK_TPU_TILE_ROWS`` (``io.chunked.resolve_tile_rows``).

    Warm start: ``init_booster`` continues a single-output gbdt booster;
    its trees replay on the host (exact integer walks + the same float32
    score adds training performs).

    Checkpoints, preemption and resume as the JAX package's: with
    ``checkpoint_dir`` the run snapshots its booster, iteration, host rng
    and bag mask every ``checkpoint_every`` iterations and at the end (the
    writer thread serializes); ``resume="auto"`` restores the newest valid
    snapshot and replays it, ``"must"`` raises without one.
    SIGTERM/SIGINT or ``utils.resilience.request_preemption`` writes one
    last snapshot at the next iteration boundary and returns with
    ``extras["preempted"]``.  The tile geometry is recorded, not identity:
    a resume may re-tile (``extras["resharded"]``).  With quantized
    histograms the resumed booster is bit-identical to an uninterrupted
    run at the same width, and at either width while the rows fit the
    edge sketch's sample cap (200,000): above it the edges follow the tile
    width, as the reference's do (the snapshot holds no edges; the resume
    re-bins).  Snapshot files share the JAX package's format;
    the fingerprints do not match across packages (each hashes its own
    params signature), so one package does not resume the other's run.

    ``extras``: tile geometry, the prefetch overlap (``prefetch_wait_s``,
    ``tile_compute_s``, ``prefetch_overlap_pct``: host-visible times),
    ``binning_s`` and ``boosting_s``, the host -> device bytes per
    histogram pass (``hist_pass_bytes``) and in all (``h2d_bytes``), the
    copy stream's time (``h2d_s``, 0 on the CPU) and the pass counts.

    Not streamed (``ValueError``, as in the JAX package): multiclass,
    lambdarank, dart/goss/rf and categorical features.

    Live monitoring, as in the JAX package: ``monitor_port`` (0 =
    ephemeral) serves ``/progress`` (the prefetcher's overlap totals and
    live state included), ``/metrics``, ``/stats``, ``/health`` and
    ``/debug/{dump,profile}`` for the duration of the loop; either
    monitor arg arms a stall watchdog that books
    ``mmlspark_training_stalls_total`` and a ``train_stall`` flight dump
    when no iteration completes in time (a hung tile load included).
    """
    from ..io.chunked import ChunkedDataset, TilePrefetcher

    if params is None:
        raise ValueError("params is required")
    dev = resolve_device(device)
    p = params.resolve()
    if p.objective in ("lambdarank", "multiclass"):
        raise ValueError(f"streamed training does not support objective="
                         f"{p.objective!r} yet (see docs/out_of_core.md)")
    if p.boosting_type != "gbdt":
        raise ValueError("streamed training supports boosting_type='gbdt' "
                         f"only (got {p.boosting_type!r})")
    if p.categorical_features:
        raise ValueError("streamed training does not support categorical "
                         "features yet (see docs/out_of_core.md)")

    # ---- dataset geometry
    if isinstance(X, ChunkedDataset):
        cd = X
        if tile_rows is not None or memory_budget_bytes is not None:
            raise ValueError("tile sizing belongs to the ChunkedDataset "
                             "when one is passed directly")
        y = cd.columns.get("y") if y is None else np.asarray(y, np.float32)
        w = cd.columns.get("w")
        if w is not None and sample_weight is not None:
            raise ValueError("sample weights belong to the ChunkedDataset "
                             "('w' column) when one is passed directly")
    else:
        cd = ChunkedDataset(np.asarray(X, np.float32), tile_rows=tile_rows,
                            memory_budget_bytes=memory_budget_bytes)
        w = None
    if y is None:
        raise ValueError("labels are required (y= or a 'y' dataset column)")
    y = np.asarray(y, np.float32)
    n, F = cd.n_rows, cd.num_features
    T = cd.tile_rows
    if w is None:
        w = np.ones(n, np.float32) if sample_weight is None \
            else np.asarray(sample_weight, np.float32)
    w = np.asarray(w, np.float32)
    if len(y) != n or len(w) != n:
        raise ValueError("X, y and sample_weight row counts disagree")
    if p.objective in ("poisson", "tweedie") and (y < 0).any():
        raise ValueError(f"objective {p.objective!r} requires non-negative "
                         "labels")
    if p.objective == "gamma" and (y <= 0).any():
        raise ValueError("objective 'gamma' requires strictly positive "
                         "labels")
    if init_booster is not None:
        if init_booster.num_class != 1 or \
                init_booster.objective == "multiclass":
            raise ValueError(
                "streamed continuation supports single-output boosters only "
                f"(init_booster.num_class={init_booster.num_class}); use "
                "train() for multiclass continuation (docs/out_of_core.md)")
        if bool(getattr(init_booster, "average_output", False)):
            raise ValueError(
                "streamed training does not support rf-averaged boosters "
                "(boosting_type='rf' is not streamed; docs/out_of_core.md)")
        if getattr(init_booster, "categorical_features", None) \
                or getattr(init_booster, "cat_bitset", None) is not None:
            raise ValueError(
                "streamed training does not support categorical features "
                "yet, so a categorical booster cannot continue here "
                "(docs/out_of_core.md)")
        if int(init_booster.num_features) != F:
            raise ValueError(
                f"init_booster was trained on {init_booster.num_features} "
                f"features, dataset has {F}")

    hist_backend, quant_env = _resolve_hist_backend()   # as in train()
    p = dataclasses.replace(p, use_quantized_grad=_resolve_quantized(
        dev, p.use_quantized_grad, quant_env))
    use_quant = p.use_quantized_grad
    qb = p.num_grad_quant_bins
    qg_cap = max(1, qb // 2)
    qh_cap = max(1, qb - 1)
    _check_quant_tile_bound(use_quant, qb, n)
    check_resume_arg(resume, checkpoint_dir=checkpoint_dir)

    t0 = time.perf_counter()
    with ambient_phase("ooc.binning"):
        mapper, binned_fm = _stream_bins(cd, p.max_bin)
    B = mapper.num_bins
    binned_h = binned_fm.T                 # (n, F) view for the host walks
    t_binning = time.perf_counter() - t0
    edges_np = mapper.edges
    ct = _CatTools(p, F, B)
    edge_ok = ct.edge_ok(torch.from_numpy(edges_np).to(dev))

    l1, l2 = p.lambda_l1, p.lambda_l2
    min_gain = p.min_gain_to_split
    max_delta = p.max_delta_step
    lr = p.learning_rate
    objective = make_objective(p)
    D = p.depth_bound
    rng = np.random.default_rng(p.seed)
    f32 = torch.float32

    # the in-memory growers' split arithmetic; the float path scans in the
    # kernel's sequential bin order, so the card and the CPU round alike
    _, split_gains = _split_math(p, ct,
                                 float_prefix=cuda_histogram._cumsum_bins)

    def best_splits(hist, scales, fmask, depth_ok: bool = True):
        """Best split of each of the ``(N, F, B, 3)`` histograms, on their
        device; one host sync.  Returns host arrays (gain, feature, bin,
        left stats (N, 3), node totals (N, 3))."""
        N = hist.shape[0]
        gain, left3, tot = split_gains(hist, fmask, edge_ok, depth_ok,
                                       scales if use_quant else None)
        flat = gain.reshape(N, F * B)
        best = torch.argmax(flat, dim=1)
        rows = torch.arange(N, device=hist.device)
        bf, bb = best // B, best % B
        rec = torch.cat([flat[rows, best][:, None], bf[:, None].to(f32),
                         bb[:, None].to(f32), left3[rows, bf, bb],
                         torch.stack(tot, dim=1)], dim=1).cpu().numpy()
        return (rec[:, 0], rec[:, 1].astype(np.int32),
                rec[:, 2].astype(np.int32), rec[:, 3:6], rec[:, 6:9])

    # ---- prefetch plumbing: payloads built AND staged on the worker
    # thread (routing for the next tile rides there too, overlapped with
    # the consumer's histogram launches on the current tile)
    stager = _TileStager(dev, T)
    totals = {"wait_s": 0.0, "compute_s": 0.0, "tiles": 0.0,
              "grad_passes": 0, "hist_passes": 0, "hist_bytes": 0}
    live_pf: Dict[str, Optional[TilePrefetcher]] = {"pf": None}

    def stream(make_tile):
        def load(i):
            # the prefetch worker's samples go to tile load, apart from the
            # consumer's accumulate launches
            with ambient_phase("ooc.tile_load"):
                lo, hi = cd.tile_slice(i)
                return i, lo, hi, stager.load(make_tile(i, lo, hi))
        pf = TilePrefetcher(range(cd.num_tiles), load, site=OOC_SITE)
        live_pf["pf"] = pf
        return pf

    def prefetch_state() -> Dict[str, object]:
        """The monitor's view: cumulative overlap totals and the live
        pass."""
        busy = totals["wait_s"] + totals["compute_s"]
        d: Dict[str, object] = {
            "wait_s": round(totals["wait_s"], 6),
            "compute_s": round(totals["compute_s"], 6),
            "tiles": totals["tiles"],
            "overlap_pct": round(100.0 * totals["compute_s"] / busy, 2)
            if busy > 0 else 100.0,
        }
        pf = live_pf["pf"]
        if pf is not None:
            d["live"] = pf.snapshot()
        return d

    def finish_stream(pf):
        st = pf.overlap_stats()
        totals["wait_s"] += st["wait_s"]
        totals["compute_s"] += st["compute_s"]
        totals["tiles"] += st["tiles"]

    init_score = init_score_of(p.objective, y, w, p.sigmoid)
    scores_h = np.full((n,), init_score, np.float32)
    g_host = np.empty((n,), np.float32)
    h_host = np.empty((n,), np.float32)

    # ---- valid set (in memory: the heldout set is driver-sized)
    metric_name = p.metric or default_metric(p.objective)
    metric_fn, larger_better = resolve_metric(metric_name, p)
    evals: List[Dict[str, float]] = []
    has_valid = valid is not None
    if has_valid:
        Xv = np.asarray(valid[0], np.float32)
        yv = np.asarray(valid[1], np.float32)
        binned_v_h = mapper.transform(Xv)   # host copy: resume replay walks
        binned_v = torch.from_numpy(binned_v_h).to(dev)
        scores_v = np.full((Xv.shape[0], 1), init_score, np.float32)
        walker = make_binned_walker(D)
    best_metric = -np.inf if larger_better else np.inf
    best_iter = -1
    rounds_no_improve = 0

    level_growth = p.growth == "level"
    L = p.num_leaves
    I = L - 1
    if level_growth:
        lc_const, rc_const = perfect_tree_children(D)

    trees: Dict[str, List[np.ndarray]] = {k: [] for k in _TREE_KEYS}
    tree_weights: List[float] = []
    bag_on = p.bagging_freq > 0 and p.bagging_fraction < 1.0
    ff_on = p.feature_fraction < 1.0
    mask_h = np.ones((n,), bool)
    bag_mask = None

    # ---- checkpoints: identity carries data and params; the tile
    # geometry is the topology stanza, recorded and allowed to differ
    fingerprint = repr((_params_sig(p), n, F, B,
                        _content_fingerprint(cd.X)))
    topology = topology_stanza(shard_count=1, num_tiles=int(cd.num_tiles),
                               tile_rows=int(T))
    manager = CheckpointManager(checkpoint_dir,
                                site="lightgbm.train_streamed",
                                keep_last=checkpoint_keep_last) \
        if checkpoint_dir else None
    n_init_trees = 0
    start_iter = 0
    resumed_from = -1
    resharded = False
    preempted = False

    def replay_range(t0_: int, t1_: int, valid_too: bool) -> None:
        """Replay stored trees [t0_, t1_) into the running scores with the
        EXACT float32 adds the live loop performs (host walks are pure
        integer ops), so a resumed run's state is bit-identical to the
        uninterrupted one's at the same iteration."""
        if t1_ <= t0_:
            return
        depth_b = children_depth_bound(
            np.stack(trees["left_child"][t0_:t1_]),
            np.stack(trees["right_child"][t0_:t1_]))
        for t in range(t0_, t1_):
            sf_t, tb_t = trees["split_feature"][t], trees["threshold_bin"][t]
            lch_t, rch_t = trees["left_child"][t], trees["right_child"][t]
            lv_t = np.asarray(trees["leaf_value"][t], np.float32)
            w_t = float(tree_weights[t])
            leaf = _np_walk_tree(binned_h, sf_t, tb_t, lch_t, rch_t, depth_b)
            contrib = lv_t[leaf]
            if w_t != 1.0:
                contrib = (contrib * np.float32(w_t)).astype(np.float32)
            np.add(scores_h, contrib, out=scores_h)
            if valid_too and has_valid:
                leaf_v = _np_walk_tree(binned_v_h, sf_t, tb_t, lch_t, rch_t,
                                       depth_b)
                contrib_v = lv_t[leaf_v]
                if w_t != 1.0:
                    contrib_v = (contrib_v * np.float32(w_t)) \
                        .astype(np.float32)
                scores_v[:, 0] += contrib_v

    def save_ckpt(finished: bool, block: bool = False) -> None:
        # list copies and the rng state here; stacking and the atomic
        # publish on the manager's writer thread
        done = len(tree_weights) - n_init_trees
        meta = _booster_ckpt_meta(done, n_init_trees, rng, best_metric,
                                  best_iter, rounds_no_improve, evals,
                                  init_score, fingerprint, finished,
                                  p.num_iterations, "streamed_booster_v1",
                                  topology=topology)
        manager.save(done, _booster_ckpt_arrays(trees, tree_weights,
                                                bag_mask), meta,
                     block=block)

    resumed = False
    if manager is not None and resume in ("auto", "must"):
        got = manager.load_latest(current_topology=topology)
        if got is None and resume == "must":
            raise resume_required_error(checkpoint_dir)
        if got is not None:
            _, arrs, meta = got
            if meta.get("fingerprint") != fingerprint:
                raise ValueError(_CKPT_FINGERPRINT_MISMATCH)
            delta = meta.get("topology_delta")
            if delta is not None and delta["changed"]:
                # re-tiled resume: the row-keyed rounding keeps the booster
                # bit-identical to an uninterrupted run at either width
                # while the rows fit the sketch's cap (the edges re-bin)
                book_reshard("lightgbm.train_streamed", delta)
                resharded = True
            t_done = int(arrs["split_feature"].shape[0])
            for k in _TREE_KEYS:
                trees[k] = [np.asarray(arrs[k][t]) for t in range(t_done)]
            tree_weights[:] = [float(x) for x in arrs["tree_weight"]]
            n_init_trees = int(meta.get("n_init_trees", 0))
            rng.bit_generator.state = meta["rng_state"]
            if "bag_mask" in arrs:
                bag_mask = np.unpackbits(arrs["bag_mask"])[:n].astype(bool)
            best_metric = float(meta["best_metric"])
            best_iter = int(meta["best_iter"])
            rounds_no_improve = int(meta["rounds_no_improve"])
            evals[:] = [dict(e) for e in meta.get("evals", [])]
            replay_range(0, n_init_trees, valid_too=False)
            if float(meta["init_score"]) != float(init_score):
                scores_h += np.float32(float(meta["init_score"])
                                       - init_score)
                init_score = float(meta["init_score"])
                if has_valid:
                    scores_v[:] = init_score
            replay_range(n_init_trees, t_done, valid_too=True)
            resumed_from = int(meta["iteration"])
            start_iter = resumed_from
            if meta.get("finished") and p.num_iterations <= int(
                    meta.get("num_iterations", resumed_from)):
                # the snapshot IS the finished run: return its booster
                start_iter = p.num_iterations
            resumed = True
    if not resumed and init_booster is not None:
        # warm start: replay the incoming booster's trees on the host
        for t in range(init_booster.num_trees):
            for k in _TREE_KEYS:
                trees[k].append(np.asarray(getattr(init_booster, k)[t]))
            tree_weights.append(float(init_booster.tree_weight[t]))
        n_init_trees = init_booster.num_trees
        replay_range(0, n_init_trees, valid_too=False)
        if float(init_booster.init_score) != float(init_score):
            # shift the base score AFTER the replay (train()'s order)
            scores_h += np.float32(init_booster.init_score - init_score)
            init_score = float(init_booster.init_score)
            if has_valid:
                scores_v[:] = init_score

    def grad_pass():
        """Gradients per tile on the device, stored on the host, and the
        global grad/hess maxima every tile's quantization shares."""
        pf = stream(lambda i, lo, hi: [(scores_h[lo:hi], 0.0),
                                       (y[lo:hi], 0.0), (w[lo:hi], 0.0)])
        gmax = hmax = 0.0

        def grads(m, sc_t, y_t, w_t):
            g_t, h_t = objective(sc_t.double()[:, None], y_t.double(),
                                 w_t.double())
            return torch.stack([g_t[:m, 0], h_t[:m, 0]]).to(f32).cpu() \
                .numpy()

        with ambient_phase("ooc.gradients"):
            for i, lo, hi, tile in pf:
                gh = grads(hi - lo, *stager.ready(tile))
                del tile                    # see hist_pass
                g_host[lo:hi], h_host[lo:hi] = gh
                gmax = max(gmax, float(np.abs(gh[0]).max()))
                hmax = max(hmax, float(gh[1].max()))
        finish_stream(pf)
        stager.drain()
        totals["grad_passes"] += 1
        g_scale = max(gmax, 1e-12) / qg_cap
        h_scale = max(hmax, 1e-12) / qh_cap
        return g_scale, h_scale

    def route(lo, hi, bf, bb, do):
        """Host row routing (numerical splits): node -> 2*node + right,
        the level-wise grower's order."""
        node = node_h[lo:hi]
        f = np.maximum(bf[node], 0)
        rb = binned_fm[f, np.arange(lo, hi)].astype(np.int32)
        go_right = do[node] & (rb > bb[node])
        node_h[lo:hi] = 2 * node + go_right

    # the tiles' gradient columns: int8 quantized values (filled once per
    # iteration) or the float32 gradients themselves
    grad_cols = {"g": g_host, "h": h_host}

    def hist_pass(nodes_d, scales, decisions, node_of):
        """One accumulate pass over every tile: this level's routing (when
        ``decisions`` carries the previous level's splits) runs on the
        prefetch worker, then the consumer folds the tile's partial into
        the accumulator on the device; no host sync inside the loop."""
        gc, hc = grad_cols["g"], grad_cols["h"]

        def make_tile(i, lo, hi):
            if decisions is not None:
                route(lo, hi, *decisions)
            node_t = np.where(mask_h[lo:hi], node_of(lo, hi),
                              -1).astype(np.int32)
            return [(binned_fm[:, lo:hi], 0), (gc[lo:hi], 0),
                    (hc[lo:hi], 0), (node_t, -1)]

        acc = torch.zeros((nodes_d, F, B, 3),
                          dtype=torch.int32 if use_quant else f32,
                          device=dev)

        def partial(b_t, g_t, h_t, n_t):
            bins_t = b_t.t()                   # (T, F) feature-major view
            if use_quant:
                return hist_ops.build_quantized(
                    bins_t, g_t, h_t, n_t, nodes_d, B, quant_bins=qb,
                    backend=hist_backend, node_rows_bound=T)
            return hist_ops.build(bins_t, g_t, h_t, n_t, nodes_d, B,
                                  backend=hist_backend)

        bytes0 = stager.bytes
        pf = stream(make_tile)
        with ambient_phase("ooc.histogram"):
            for i, lo, hi, tile in pf:
                acc += partial(*stager.ready(tile))
                # taking tile k + 1 lets the worker stage k + 2 at once:
                # the loop holds nothing of tile k by then, so two tiles
                # are live
                del tile
        finish_stream(pf)
        totals["hist_passes"] += 1
        totals["hist_bytes"] = stager.bytes - bytes0
        return acc

    # the live monitor: one tick per boosting iteration.  The stall
    # watchdog covers the streamed passes too: a hung tile load freezes
    # the ticks and trips as ``train_stall`` with the live prefetcher in
    # the dump
    watch, watch_srv, callbacks = _start_monitor(
        "lightgbm.train_streamed", p, n, monitor_port,
        monitor_stall_timeout_s, callbacks, prefetch_fn=prefetch_state)
    scope = preemption_scope() if manager is not None \
        else contextlib.nullcontext(PreemptionToken())
    last_ckpt_iter = start_iter
    trees_at_loop_start = len(tree_weights)
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        stack.callback(_stop_monitor, watch, watch_srv)
        token = stack.enter_context(scope)
        if watch is not None:
            watch.set_preemption_token(token)
        for it in range(start_iter, p.num_iterations):
            if token.requested:
                save_ckpt(finished=False, block=True)
                preempted = True
                break
            # ---- per-iteration host randomness (train()'s order)
            feat_mask = np.ones((F,), bool)
            if ff_on:
                keep = max(1, int(round(p.feature_fraction * F)))
                feat_mask[:] = False
                feat_mask[rng.choice(F, size=keep, replace=False)] = True
            if bag_on and (it % p.bagging_freq == 0 or bag_mask is None):
                bag_mask = rng.random(n) < p.bagging_fraction
            mask_h = bag_mask if bag_on else np.ones((n,), bool)
            fm_dev = torch.from_numpy(feat_mask).to(dev)

            g_scale, h_scale = grad_pass()
            scales = torch.tensor([g_scale, h_scale], dtype=f32, device=dev)
            if use_quant:
                grad_cols["g"], grad_cols["h"] = _quantize_rows(
                    g_host, h_host, qb, g_scale, h_scale, p.seed,
                    int(_quant_mix(g_host, h_host)), dev, T)
            node_h = np.zeros((n,), np.int32)

            if level_growth:
                sf = np.full((I,), -1, np.int32)
                tb = np.zeros((I,), np.int32)
                th = np.zeros((I,), np.float32)
                sg = np.zeros((I,), np.float32)
                iv = np.zeros((I,), np.float32)
                ic = np.zeros((I,), np.float32)
                decisions = None
                for d in range(D):
                    nodes_d = 2 ** d
                    off = nodes_d - 1
                    acc = hist_pass(nodes_d, scales, decisions,
                                    lambda lo, hi: node_h[lo:hi])
                    gain_d, bf_d, bb_d, left_d, tot_d = best_splits(
                        acc, scales, fm_dev)
                    stager.drain()
                    do_d = gain_d > min_gain
                    left_d = np.where(do_d[:, None], left_d, tot_d)
                    right_d = tot_d - left_d
                    idx = off + np.arange(nodes_d)
                    sf[idx] = np.where(do_d, bf_d, -1)
                    tb[idx] = bb_d
                    th[idx] = edges_np[bf_d, np.clip(bb_d, 0, B - 2)]
                    sg[idx] = np.where(do_d, gain_d, 0.0)
                    iv[idx] = _np_leaf_output(tot_d[:, 0], tot_d[:, 1], l1,
                                              l2, max_delta)
                    ic[idx] = tot_d[:, 2]
                    decisions = (bf_d, bb_d, do_d)
                # the last level's routing over the whole host array
                route(0, n, *decisions)
                lv2 = np.stack([_np_leaf_output(left_d[:, 0], left_d[:, 1],
                                                l1, l2, max_delta),
                                _np_leaf_output(right_d[:, 0], right_d[:, 1],
                                                l1, l2, max_delta)],
                               axis=1).reshape(L)
                lc2 = np.stack([left_d[:, 2], right_d[:, 2]],
                               axis=1).reshape(L)
                leaf_value = np.where(lc2 > 0, lv2, 0.0).astype(np.float32)
                leaf_count = lc2.astype(np.float32)
                leaf_of_row = node_h
                lch, rch = lc_const, rc_const
            else:
                (sf, tb, th, sg, iv, ic, leaf_value, leaf_count, lch, rch,
                 leaf_of_row) = _grow_leafwise_streamed(
                    p, F, B, scales, fm_dev, node_h, binned_fm, edges_np,
                    hist_pass, best_splits, stager, l1, l2, max_delta)

            lv_s = (leaf_value * lr).astype(np.float32)
            scores_h += lv_s[leaf_of_row]
            for k_name, arr in zip(
                    _TREE_KEYS,
                    (lch, rch, sf, th, tb, sg, iv, ic, lv_s, leaf_count)):
                trees[k_name].append(np.asarray(arr))
            tree_weights.append(1.0)

            if has_valid:
                with ambient_phase("ooc.eval"):
                    leaf_v = walker(
                        binned_v, torch.from_numpy(sf).to(dev),
                        torch.from_numpy(tb).to(dev),
                        torch.from_numpy(np.asarray(lch, np.int32)).to(dev),
                        torch.from_numpy(np.asarray(rch, np.int32)).to(dev)
                    ).cpu().numpy()
                    scores_v[:, 0] += lv_s[leaf_v]
                    m = metric_fn(yv, scores_v.astype(np.float64))
                evals.append({metric_name: m, "iteration": it})
                improved = m > best_metric if larger_better \
                    else m < best_metric
                if improved:
                    best_metric, best_iter, rounds_no_improve = m, it, 0
                else:
                    rounds_no_improve += 1
                if p.early_stopping_round > 0 and \
                        rounds_no_improve >= p.early_stopping_round:
                    break
            if callbacks:
                for cb in callbacks:
                    cb(it, evals[-1] if evals else None)
            if manager is not None and checkpoint_every > 0 \
                    and it + 1 - last_ckpt_iter >= checkpoint_every:
                save_ckpt(finished=False)
                last_ckpt_iter = it + 1
        # before the monitor stops (see train())
        t_boost = time.perf_counter() - t0

    if manager is not None:
        if not preempted and (len(tree_weights) > trees_at_loop_start
                              or not resumed):
            # terminal snapshot (early stopping too); a finished-run
            # restore that grew nothing skips the re-save
            save_ckpt(finished=True, block=True)
        manager.close()

    if p.growth == "leaf":
        D = children_depth_bound(np.stack(trees["left_child"]),
                                 np.stack(trees["right_child"]))
    booster = GBDTBooster(
        np.stack(trees["split_feature"]), np.stack(trees["threshold"]),
        np.stack(trees["threshold_bin"]), np.stack(trees["split_gain"]),
        np.stack(trees["internal_value"]),
        np.stack(trees["internal_count"]),
        np.stack(trees["leaf_value"]), np.stack(trees["leaf_count"]),
        np.asarray(tree_weights, np.float32),
        left_child=np.stack(trees["left_child"]),
        right_child=np.stack(trees["right_child"]),
        max_depth=D, num_features=F, objective=p.objective, num_class=1,
        init_score=init_score, feature_names=feature_names,
        best_iteration=best_iter, sigmoid=p.sigmoid)

    stager.drain()
    busy = totals["wait_s"] + totals["compute_s"]
    extras = {
        "num_tiles": float(cd.num_tiles), "tile_rows": float(T),
        "prefetch_wait_s": round(totals["wait_s"], 6),
        "tile_compute_s": round(totals["compute_s"], 6),
        "tiles_streamed": totals["tiles"],
        "prefetch_overlap_pct": round(
            100.0 * totals["compute_s"] / busy, 2) if busy > 0 else 100.0,
        "quantized": float(use_quant),
        "binning_s": t_binning, "boosting_s": t_boost,
        "grad_passes": float(totals["grad_passes"]),
        "hist_passes": float(totals["hist_passes"]),
        "hist_pass_bytes": float(totals["hist_bytes"]),
        "h2d_bytes": float(stager.bytes), "h2d_s": stager.copy_s,
    }
    if manager is not None:
        extras.update({"preempted": float(preempted),
                       "resumed_from_iteration": float(resumed_from),
                       "checkpoint_saves": float(manager.saves_ok),
                       "resharded": float(resharded)})
    return TrainResult(booster=booster, evals=evals, bin_mapper=mapper,
                       extras=extras)


def _grow_leafwise_streamed(p, F, B, scales, fm_dev, node_h, binned_fm,
                            edges_np, hist_pass, best_splits, stager, l1,
                            l2, max_delta):
    """One leaf-wise tree over the tile stream: LightGBM's best-first
    growth with the histogram passes streamed.  Per split step the LEFT
    child's histogram is rebuilt with one accumulate pass over every tile
    (``hist_pass`` with a single node) and the sibling comes from exact
    integer subtraction against a host-resident stored-histogram table,
    ``(num_leaves, F, B, 3)``.  The bookkeeping runs in host numpy, as in
    the JAX package; a step whose best gain fails ``min_gain_to_split``
    ends the tree (later steps could only see smaller global-best gains).
    Both children's candidates come from one ``best_splits`` call on the
    device."""
    L, M = p.num_leaves, p.num_leaves - 1
    depth_cap = p.max_depth
    min_gain = p.min_gain_to_split
    dev = fm_dev.device
    stored = np.zeros((L, F, B, 3),
                      np.int32 if p.use_quantized_grad else np.float32)

    lc_arr = np.full((M,), -1, np.int32)
    rc_arr = np.full((M,), -1, np.int32)
    sf = np.full((M,), -1, np.int32)
    tb = np.zeros((M,), np.int32)
    th = np.zeros((M,), np.float32)
    sg = np.zeros((M,), np.float32)
    iv = np.zeros((M,), np.float32)
    ic = np.zeros((M,), np.float32)
    leaf_tot = np.zeros((L, 3), np.float32)
    leaf_depth = np.zeros((L,), np.int32)
    created = np.zeros((L,), bool)
    created[0] = True
    leaf_parent = np.full((L,), -1, np.int32)
    leaf_side = np.zeros((L,), np.int32)
    best_gain = np.full((L,), -np.inf, np.float32)
    best_feat = np.zeros((L,), np.int32)
    best_bin = np.zeros((L,), np.int32)
    best_left = np.zeros((L, 3), np.float32)

    def depth_ok_of(d):
        return True if depth_cap <= 0 else bool(d < depth_cap)

    def candidates(hists, slots, dok):
        g, f, b, left, tot = best_splits(hists, scales, fm_dev, dok)
        stager.drain()
        best_gain[slots], best_feat[slots], best_bin[slots] = g, f, b
        best_left[slots] = left
        return tot

    # root: one streamed pass with a single node id
    h_root = hist_pass(1, scales, None,
                       lambda lo, hi: np.zeros((hi - lo,), np.int32))
    stored[0] = h_root[0].cpu().numpy()
    leaf_tot[0] = candidates(h_root, [0], depth_ok_of(0))[0]

    for s in range(M):
        j = int(np.argmax(best_gain))
        if not best_gain[j] > min_gain:
            break
        new_leaf = s + 1
        f, b = int(best_feat[j]), int(best_bin[j])
        tot = leaf_tot[j].copy()

        sf[s] = f
        tb[s] = b
        th[s] = edges_np[f, min(max(b, 0), B - 2)]
        sg[s] = best_gain[j]
        iv[s] = _np_leaf_output(tot[0:1], tot[1:2], l1, l2, max_delta)[0]
        ic[s] = tot[2]

        pn, side = leaf_parent[j], leaf_side[j]
        if pn >= 0:
            (lc_arr if side == 0 else rc_arr)[pn] = s
        lc_arr[s] = -(j + 1)
        rc_arr[s] = -(new_leaf + 1)
        leaf_parent[j], leaf_side[j] = s, 0
        leaf_parent[new_leaf], leaf_side[new_leaf] = s, 1
        created[new_leaf] = True

        # route leaf j's rows (whole host array: one vectorized pass)
        go_right = (node_h == j) & (binned_fm[f] > b)
        node_h[go_right] = new_leaf

        left_stats = best_left[j].copy()
        leaf_tot[j] = left_stats
        leaf_tot[new_leaf] = tot - left_stats
        d_new = leaf_depth[j] + 1
        leaf_depth[j] = leaf_depth[new_leaf] = d_new

        # left child rebuilt over the stream; sibling by exact subtraction
        hl = hist_pass(1, scales, None,
                       lambda lo, hi: np.where(node_h[lo:hi] == j, 0, -1)
                       .astype(np.int32))
        hl_h = hl[0].cpu().numpy()
        hr_h = stored[j] - hl_h
        stored[j], stored[new_leaf] = hl_h, hr_h
        pair = torch.cat([hl, torch.from_numpy(hr_h)[None].to(dev)])
        candidates(pair, [j, new_leaf], depth_ok_of(d_new))

    lv = _np_leaf_output(leaf_tot[:, 0], leaf_tot[:, 1], l1, l2, max_delta)
    leaf_value = np.where(created, lv, 0.0).astype(np.float32)
    leaf_count = np.where(created, leaf_tot[:, 2], 0.0).astype(np.float32)
    return (sf, tb, th, sg, iv, ic, leaf_value, leaf_count, lc_arr, rc_arr,
            node_h.copy())
