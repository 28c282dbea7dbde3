"""AccessAnomaly — anomalous user->resource access detection (the port of
``mmlspark_tpu/cyber/anomaly.py``).

Reference: ``core/src/main/python/mmlspark/cyber/anomaly/
collaborative_filtering.py`` (988 LoC): per-tenant ALS collaborative
filtering over (user, resource) access counts, implicit-CF by default
(``default_apply_implicit_cf``), complement sampling of unobserved pairs as
explicit negatives otherwise, and score standardisation so higher output =
more anomalous.

SPARSE: observations stay in COO form end to end.  Each ALS half-step
builds per-row normal equations on the estimator's ``device`` from the
nonzeros, a chunk of at most ``_CHUNK_NNZ`` at a time (so the ``(chunk, k,
k)`` outer products never exceed a fixed budget): each chunk's outer
products times ``(c-1)`` (implicit) or ``c`` (explicit) are summed per row
with ``index_add_`` into ``(n_rows, k, k)`` and ``(n_rows, k)`` buffers,
and the chunk's sums are added to running sums that stay on the device
across chunks.  One batched solve of ``A + gram + reg I`` then gives every
row's factors.  O(nnz k^2 + rows k^3) per sweep, never O(users x
resources).  Implicit mode is Hu-Koren confidence weighting: the all-pairs
term collapses to the k x k gram matrix V^T V, so unobserved pairs cost
nothing.  The init draws (numpy, seeded), the duplicate-pair aggregation,
the complement negatives and the standardisation stats are the JAX
package's, on the host; scoring (hash-map index lookups and a factor dot
per row) is host code, as there.

The chunk's accumulation and the batched solve are the reference's two
plain-``jax.jit`` programs, here two unbooked programs
(``observability.compute.captured``) kept by the estimator
(``_ALSPrograms``): on the card ``cyber.als_accumulate`` is a CUDA graph
per (chunk length, rows, k, implicit), reading the other side's factors
in place and adding into the running sums, which are donated state at
fixed storage, and ``cyber.als_solve`` a graph per (rows, k) writing the
factors into their fixed buffer.  The solve is ``torch.linalg.solve_ex``
without its error check (a host sync, which a capture cannot hold); its
``info`` is read after each half-sweep and a singular system raises the
``LinAlgError`` ``torch.linalg.solve`` raises.  On the CPU both run
eagerly.  The buffers are kept per (device, rows, k, side), so a second
fit of the same shape reuses them and replays.
"""
from __future__ import annotations

import collections
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .._device import DeviceLike, float32_exact, resolve_device
from ..core import (ComplexParam, DataFrame, Estimator, Model, Param)
from ..core.dataframe import _as_column
from ..observability.compute import captured

_CHUNK_NNZ = 250_000  # caps the (chunk, k, k) outer-product buffer


def _accumulate(other: torch.Tensor, col: torch.Tensor, tgt: torch.Tensor,
                cf: torch.Tensor, seg: torch.Tensor, A: torch.Tensor,
                B: torch.Tensor, implicit: bool) -> None:
    """One chunk of nonzeros into the running sums ``A`` ``(n_rows, k, k)``
    and ``B`` ``(n_rows, k)``, in place: implicit ``A += (c-1) f f^T, B +=
    c*t*f``; explicit ``A += c f f^T``, with ``f = other[col]``.  The
    chunk's per-row sums are formed apart and then added to the running
    sums, the order in which the JAX package adds its jitted chunk sums on
    the host; within a chunk the card's ``index_add_`` adds in atomic
    order, so the last bits of a row's sum can change from run to run
    there (the CPU adds in index order, as XLA's ``segment_sum`` does on
    the CPU)."""
    F = other[col]
    w_outer = cf - 1.0 if implicit else cf
    outer = (F[:, :, None] * F[:, None, :]) * w_outer[:, None, None]
    A += torch.zeros_like(A).index_add_(0, seg, outer)
    B += torch.zeros_like(B).index_add_(0, seg, F * (cf * tgt)[:, None])


def _solve_all(A: torch.Tensor, B: torch.Tensor, base: torch.Tensor,
               out: torch.Tensor) -> torch.Tensor:
    """``out = (A + base)^-1 B`` row by row, in place; returns the LU's
    ``info`` per row (0: solved), unchecked."""
    X, info = torch.linalg.solve_ex(A + base, B, check_errors=False)
    out.copy_(X)
    return info


class _ALSPrograms:
    """The half-sweep's two programs and the fixed buffers they read and
    write in place, kept across fits by the estimator that owns them (one
    ``(A, B, X)`` per device, rows, rank and side, the
    ``MAX_BUFFER_SETS`` most recently used)."""

    MAX_BUFFER_SETS = 8

    def __init__(self):
        self.accumulate = captured(
            _accumulate, name="cyber.als_accumulate", inplace_argnums=(0,),
            donate_argnums=(5, 6), static_argnames=("implicit",))
        self.solve = captured(_solve_all, name="cyber.als_solve",
                              inplace_argnums=(0, 1), donate_argnums=(3,))
        self._buffers: "collections.OrderedDict" = collections.OrderedDict()

    def buffers(self, dev: torch.device, n_rows: int, k: int, side: str):
        """``(A, B, X)`` for one side: the running sums and the factors."""
        key = (str(dev), n_rows, k, side)
        bufs = self._buffers.get(key)
        if bufs is None:
            def z(*shape):
                return torch.zeros(shape, dtype=torch.float32, device=dev)
            bufs = self._buffers[key] = (z(n_rows, k, k), z(n_rows, k),
                                         z(n_rows, k))
            while len(self._buffers) > self.MAX_BUFFER_SETS:
                self._buffers.popitem(last=False)
        self._buffers.move_to_end(key)
        return bufs


def _solve_side(other: torch.Tensor, row_idx: torch.Tensor,
                col_idx: torch.Tensor, target: torch.Tensor,
                conf: torch.Tensor, n_rows: int, reg: float,
                gram: Optional[torch.Tensor],
                programs: Optional[_ALSPrograms] = None,
                side: str = "rows") -> torch.Tensor:
    """One ALS half-sweep from COO triples, on the device of ``other``.

    For each row r: solve (gram? + sum_nnz c f f^T + reg I) x = b with
    per-row summed normal equations.  ``gram`` is the implicit-CF all-pairs
    term V^T V (None for explicit mode, where only the nonzeros carry
    weight and ``conf`` is the per-entry weight directly).  ``row_idx`` and
    ``col_idx`` are int64, ``target`` and ``conf`` float32, all on that
    device.  Runs ``programs`` (fresh ones when None) on their ``side``
    buffers and returns the factors' buffer: its values change with the
    next half-sweep of that side."""
    programs = programs if programs is not None else _ALSPrograms()
    dev = other.device
    k = other.shape[1]
    implicit = gram is not None
    A, B, X = programs.buffers(dev, n_rows, k, side)
    A.zero_()
    B.zero_()
    for s in range(0, len(row_idx), _CHUNK_NNZ):
        e = s + _CHUNK_NNZ
        programs.accumulate(other, col_idx[s:e], target[s:e], conf[s:e],
                            row_idx[s:e], A, B, implicit=implicit)
    base = reg * torch.eye(k, dtype=torch.float32, device=dev)
    if implicit:
        base = gram + base
    info = programs.solve(A, B, base, X).cpu().numpy()
    bad = np.flatnonzero(info)
    if len(bad):
        raise torch.linalg.LinAlgError(
            f"torch.linalg.solve: (Batch element {int(bad[0])}): The solver "
            "failed because the input matrix is singular.")
    return X


def sparse_als(u_idx: np.ndarray, r_idx: np.ndarray, counts: np.ndarray,
               n_u: int, n_i: int, rank: int, reg: float, iters: int,
               seed: int, implicit: bool = True, alpha: float = 10.0,
               neg_u: Optional[np.ndarray] = None,
               neg_r: Optional[np.ndarray] = None,
               neg_score: float = 0.0, neg_weight: float = 0.5,
               pos_score: float = 1.0, device: DeviceLike = None,
               programs: Optional[_ALSPrograms] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-tenant ALS over COO observations on ``device`` (``None``: the
    card, an error without one; ``"cpu"``: the host).

    implicit=True: Hu-Koren implicit CF (reference
    ``default_apply_implicit_cf``) — confidence c = 1 + alpha*count on
    observed pairs, preference p = 1; unobserved pairs enter only through
    the k x k gram term.
    implicit=False: explicit ridge ALS over observed entries (target
    ``pos_score`` scaled by count) plus the supplied complement-sampled
    negatives at ``neg_score`` with weight ``neg_weight``.
    ``programs``: the half-sweep's programs and buffers (fresh ones when
    None).  Returns the host float32 factors ``(U, V)``.
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    U = rng.normal(scale=0.1, size=(n_u, rank)).astype(np.float32)
    V = rng.normal(scale=0.1, size=(n_i, rank)).astype(np.float32)
    counts = np.asarray(counts, np.float32)

    if implicit:
        conf = 1.0 + alpha * counts
        tgt = np.ones_like(conf)
        uu, rr = u_idx, r_idx
    else:
        tgt = np.maximum(counts, pos_score)
        conf = np.ones_like(tgt)
        uu, rr = u_idx, r_idx
        if neg_u is not None and len(neg_u):
            # exclude sampled pairs the user actually accessed — a collision
            # would append a contradictory zero target for an observed cell
            obs_keys = np.unique(u_idx.astype(np.int64) * n_i + r_idx)
            neg_keys = neg_u.astype(np.int64) * n_i + neg_r
            keep = ~np.isin(neg_keys, obs_keys)
            neg_u, neg_r = neg_u[keep], neg_r[keep]
            uu = np.concatenate([u_idx, neg_u])
            rr = np.concatenate([r_idx, neg_r])
            tgt = np.concatenate([tgt, np.full(len(neg_u), neg_score, np.float32)])
            conf = np.concatenate([conf, np.full(len(neg_u), neg_weight, np.float32)])

    def put(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=dev)

    programs = programs if programs is not None else _ALSPrograms()
    with torch.inference_mode(), float32_exact(dev.type == "cuda"):
        uu_d, rr_d = put(uu, torch.int64), put(rr, torch.int64)
        tgt_d = put(np.asarray(tgt, np.float32), torch.float32)
        conf_d = put(np.asarray(conf, np.float32), torch.float32)
        U_d = programs.buffers(dev, n_u, rank, "users")[2]
        V_d = programs.buffers(dev, n_i, rank, "resources")[2]
        U_d.copy_(put(U, torch.float32))
        V_d.copy_(put(V, torch.float32))
        for _ in range(iters):
            gram_v = V_d.T @ V_d if implicit else None
            _solve_side(V_d, uu_d, rr_d, tgt_d, conf_d, n_u, reg, gram_v,
                        programs, "users")
            gram_u = U_d.T @ U_d if implicit else None
            _solve_side(U_d, rr_d, uu_d, tgt_d, conf_d, n_i, reg, gram_u,
                        programs, "resources")
        # copies: the buffers are the next fit's
        return (U_d.to("cpu", copy=True).numpy(),
                V_d.to("cpu", copy=True).numpy())


class ComplementAccessTransformer:
    """Sample unobserved (user, resource) pairs — the implicit negatives
    (reference ``ComplementAccessTransformer``)."""

    def __init__(self, tenant_col: str = "tenant", user_col: str = "user",
                 res_col: str = "res", complement_factor: int = 2, seed: int = 0):
        self.tenant_col, self.user_col, self.res_col = tenant_col, user_col, res_col
        self.factor = complement_factor
        self.seed = seed

    def transform(self, df: DataFrame) -> DataFrame:
        data = df.collect()
        rng = np.random.default_rng(self.seed)
        tc, uc, rc = self.tenant_col, self.user_col, self.res_col
        tenants = data[tc].astype(str) if tc in data else np.full(len(data[uc]), "_")
        rows = []
        for t in sorted(set(tenants.tolist())):
            sel = tenants == t
            users = sorted(set(data[uc][sel].astype(str).tolist()))
            ress = sorted(set(data[rc][sel].astype(str).tolist()))
            seen = set(zip(data[uc][sel].astype(str), data[rc][sel].astype(str)))
            want = min(self.factor * int(sel.sum()),
                       max(0, len(users) * len(ress) - len(seen)))
            tries = 0
            got = set()
            while len(got) < want and tries < want * 20:
                u = users[rng.integers(0, len(users))]
                r = ress[rng.integers(0, len(ress))]
                if (u, r) not in seen and (u, r) not in got:
                    got.add((u, r))
                tries += 1
            for u, r in sorted(got):
                rows.append({tc: t, uc: u, rc: r})
        return DataFrame.from_rows(rows)


class AccessAnomaly(Estimator):
    tenant_col = Param("tenant_col", "tenant column", "string", default="tenant")
    user_col = Param("user_col", "user column", "string", default="user")
    res_col = Param("res_col", "resource column", "string", default="res")
    likelihood_col = Param("likelihood_col", "access count column (optional)",
                           "string", default=None)
    rank = Param("rank", "latent factor rank", "int", default=10)
    max_iter = Param("max_iter", "ALS iterations", "int", default=10)
    reg_param = Param("reg_param", "ridge regularization", "float", default=0.1)
    implicit_cf = Param("implicit_cf", "Hu-Koren implicit CF (reference "
                        "default_apply_implicit_cf); False = explicit targets "
                        "with sampled complement negatives", "bool", default=True)
    alpha = Param("alpha", "implicit-CF confidence scale", "float", default=10.0)
    complementset_factor = Param("complementset_factor", "negatives per positive "
                                 "(explicit mode)", "int", default=2)
    neg_score = Param("neg_score", "implicit negative target", "float", default=0.0)
    pos_score = Param("pos_score", "observed access target", "float", default=1.0)
    seed = Param("seed", "random seed", "int", default=0)
    device = Param("device", "where the ALS sweeps run: unset = the CUDA "
                   "card (an error without one), 'cpu' = the host", "string",
                   default=None)

    def _programs(self) -> _ALSPrograms:
        """The estimator's half-sweep programs and buffers (made at first
        use, kept across fits, never pickled)."""
        progs = self.__dict__.get("_als")
        if progs is None:
            progs = self._als = _ALSPrograms()
        return progs

    def __getstate__(self):
        """Pickled and copied without its programs and buffers."""
        state = dict(self.__dict__)
        state.pop("_als", None)
        return state

    def _fit(self, df: DataFrame) -> "AccessAnomalyModel":
        data = df.collect()
        tc = self.get("tenant_col")
        uc, rc = self.get("user_col"), self.get("res_col")
        tenants = data[tc].astype(str) if tc in data else np.full(len(data[uc]), "_")
        factors: Dict[str, Dict] = {}
        for t in sorted(set(tenants.tolist())):
            sel = tenants == t
            users, u_idx = np.unique(data[uc][sel].astype(str), return_inverse=True)
            ress, r_idx = np.unique(data[rc][sel].astype(str), return_inverse=True)
            n_u, n_i = len(users), len(ress)
            lc = self.get("likelihood_col")
            counts = np.asarray(data[lc], np.float64)[sel].astype(np.float32) \
                if lc and lc in data else np.ones(int(sel.sum()), np.float32)
            # aggregate duplicate (user, resource) observations: implicit CF
            # SUMS counts (c = 1 + alpha * total accesses, Hu-Koren);
            # explicit mode AVERAGES the rating (d log lines at rating v are
            # one observation of v, matching the old dense assignment)
            keys = u_idx.astype(np.int64) * n_i + r_idx
            uniq_keys, inv = np.unique(keys, return_inverse=True)
            sums = np.bincount(inv, weights=counts)
            if self.get("implicit_cf"):
                counts = sums.astype(np.float32)
            else:
                counts = (sums / np.bincount(inv)).astype(np.float32)
            u_idx = (uniq_keys // n_i).astype(np.int64)
            r_idx = (uniq_keys % n_i).astype(np.int64)
            rank = min(self.get("rank"), min(n_u, n_i))
            rng = np.random.default_rng(self.get("seed"))
            neg_u = neg_r = None
            if not self.get("implicit_cf"):
                n_neg = min(self.get("complementset_factor") * int(sel.sum()),
                            n_u * n_i)
                neg_u = rng.integers(0, n_u, n_neg).astype(np.int32)
                neg_r = rng.integers(0, n_i, n_neg).astype(np.int32)
            U, V = sparse_als(u_idx.astype(np.int32), r_idx.astype(np.int32),
                              counts, n_u, n_i, rank,
                              self.get("reg_param"), self.get("max_iter"),
                              self.get("seed"),
                              implicit=self.get("implicit_cf"),
                              alpha=self.get("alpha"),
                              neg_u=neg_u, neg_r=neg_r,
                              neg_score=self.get("neg_score"),
                              pos_score=self.get("pos_score"),
                              device=self.get("device"),
                              programs=self._programs())
            # standardisation stats over OBSERVED pairs only — a gather, not
            # a dense (n_u, n_i) matmul
            obs = np.einsum("nk,nk->n", U[u_idx], V[r_idx])
            mu, sd = float(obs.mean()), float(obs.std()) or 1.0
            factors[t] = {"users": users.tolist(), "ress": ress.tolist(),
                          "U": U, "V": V, "mean": mu, "std": sd}
        m = AccessAnomalyModel()
        m.set("factors", factors)
        for pcol in ("tenant_col", "user_col", "res_col"):
            m.set(pcol, self.get(pcol))
        return m


class AccessAnomalyModel(Model):
    tenant_col = Param("tenant_col", "tenant column", "string", default="tenant")
    user_col = Param("user_col", "user column", "string", default="user")
    res_col = Param("res_col", "resource column", "string", default="res")
    output_col = Param("output_col", "anomaly score column", "string",
                       default="anomaly_score")
    factors = ComplexParam("factors", "per-tenant factor matrices")

    def _post_load(self):
        self._lookup_cache = None

    def _lookups(self, factors) -> Dict[str, Tuple[Dict, Dict]]:
        """Hash-map index lookups built once per tenant (round-1 weak item
        4: scoring did a Python list.index PER ROW — O(n*m)).  Keyed by the
        factors object so a ``set("factors", ...)`` invalidates the cache."""
        cached = getattr(self, "_lookup_cache", None)
        if cached is not None and cached[0] is factors:
            return cached[1]
        maps = {t: ({u: i for i, u in enumerate(f["users"])},
                    {r: i for i, r in enumerate(f["ress"])})
                for t, f in factors.items()}
        self._lookup_cache = (factors, maps)
        return maps

    def _transform(self, df: DataFrame) -> DataFrame:
        factors = self.get_or_fail("factors")
        lookups = self._lookups(factors)
        tc, uc, rc = self.get("tenant_col"), self.get("user_col"), self.get("res_col")

        def per_part(p):
            n = len(p[uc])
            out = np.zeros(n, np.float64)
            for i in range(n):
                t = str(p[tc][i]) if tc in p else "_"
                f = factors.get(t)
                if f is None:
                    out[i] = 0.0
                    continue
                umap, rmap = lookups[t]
                ui = umap.get(str(p[uc][i]))
                ri = rmap.get(str(p[rc][i]))
                if ui is None or ri is None:  # unseen user/resource: max anomaly
                    out[i] = 3.0
                    continue
                score = float(f["U"][ui] @ f["V"][ri])
                # higher score = more expected => anomaly = negative z
                out[i] = -(score - f["mean"]) / f["std"]
            return {**p, self.get("output_col"): out}

        return df.map_partitions(per_part)
