"""VowpalWabbit-equivalent online learners on the card — the port of
``mmlspark_tpu/vw/learners.py``.

Reference: ``vw/src/main/scala/.../VowpalWabbitBase.scala`` — per-partition
native VW training (``trainRow`` hot loop :261-292) with spanning-tree
allreduce between passes (``trainInternalDistributed:434-462``), and
``VowpalWabbitClassifier/Regressor/ContextualBandit``.

The model is a dense weight vector over the 2^b hash space on the device;
examples arrive as padded (indices, values) minibatches.  The JAX package
runs one jitted XLA step per minibatch; here the step is a function on
tensors (``_make_trainer``): a gather for the prediction, ``scatter_
reduce_("amax")`` for the normalizer, ``index_add_`` for the AdaGrad sums
and the weights, and the L1 shrink written back with ``index_put_``, as
one unbooked program (``observability.compute.captured``, the twin of the
plain ``jax.jit``): on the card a CUDA graph per (partition width,
batch size), the state ``(weights, gsq, xmax)`` donated and updated in
place, each minibatch's slices copied into the graph's inputs; on the CPU
the step runs eagerly.  Each partition's packed arrays go to the device
once (``device_put``, site ``vw.ingest``) and every minibatch is a slice
of them.  ``--bfgs`` keeps its line search's decisions on the host
(``vw.lbfgs``) and runs its device work as two unbooked programs kept by
the estimator (``_BFGSPrograms``; the reference runs one ``jax.jit`` per
L-BFGS iteration): ``vw.bfgs_direction``, the memory's update and the
two-loop direction, the memory donated at fixed storage, and
``vw.bfgs_trial``, the objective's value, gradient and slope at a trial
point, the examples borrowed from fixed storage that a second fit of the
same shape refills, so it captures nothing.  ``index_add_`` on
CUDA adds through atomics, so sums over a duplicated index come in another
order than the CPU's: the card equals the CPU within rounding.

The update rule follows VW's ``--adaptive --normalized`` defaults: AdaGrad
per-weight step sizes with per-weight scale normalization; ``--bfgs``
switches to full-batch L-BFGS over the cached examples (``vw.lbfgs``, a
copy of the ``optax.lbfgs`` algorithm the JAX package runs).  TrainingStats
diagnostics mirror the reference's per-partition stats DataFrame
(``VowpalWabbitBase.scala:27-49``).  Estimators and models take ``device``:
unset is the card (an error without one), ``"cpu"`` the host.  A run over
several processes (ranks of a ``torch.distributed`` world, e.g.
``parallel.executor.run_local_cluster``) averages its ranks' states at
every pass end (``_allreduce_pass_end``).
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from .._device import resolve_device
from ..core import (ComplexParam, DataFrame, Estimator, HasFeaturesCol,
                    HasLabelCol, HasPredictionCol, HasProbabilityCol,
                    HasRawPredictionCol, HasWeightCol, Model, Param)
from ..core.schema import ColumnType
from ..observability.compute import captured, device_put
from ..utils.stopwatch import StopWatch
from .lbfgs import LBFGS, new_memory, trial_of, two_loop, value_and_grad

#: transfer-bytes sites of the examples' host -> device copies
INGEST_SITE = "vw.ingest"
SCORE_SITE = "vw.score"


def pack_sparse_column(col: np.ndarray, max_nnz: Optional[int] = None,
                       mask: Optional[int] = None):
    """Object column of {'indices','values'} dicts -> padded (n, k) arrays.
    Padding uses value 0.0 so padded slots contribute nothing.  ``mask``
    folds indices into the learner's weight space (VW masks hashes into the
    2^b table at example-parse time, so a featurizer hashed with more bits
    than the learner's ``-b`` still trains)."""
    n = len(col)
    if max_nnz is None:
        max_nnz = max((len(v["indices"]) for v in col), default=1) or 1
    idx = np.zeros((n, max_nnz), np.int32)
    val = np.zeros((n, max_nnz), np.float32)
    for i, v in enumerate(col):
        k = min(len(v["indices"]), max_nnz)
        idx[i, :k] = v["indices"][:k]
        val[i, :k] = v["values"][:k]
    if mask is not None:
        idx &= mask
    return idx, val


@dataclasses.dataclass
class TrainingStats:
    """Reference ``TrainingStats`` (VowpalWabbitBase.scala:27-49)."""
    partition_id: int
    rows: int
    features_per_example: float
    passes: int
    total_time_s: float
    ingest_time_s: float
    learn_time_s: float

    def as_row(self) -> Dict:
        return dataclasses.asdict(self)


def _allreduce_pass_end(state):
    """End-of-pass weight averaging across executor processes — the
    spanning-tree allreduce replacement (``trainInternalDistributed``,
    VowpalWabbitBase.scala:434-462).  Each rank trains its own partition
    shard; at pass end, the weights AND the AdaGrad accumulators are
    averaged over the ``torch.distributed`` world (a sum over the default
    group, then a divide) and the normalizer's ``xmax`` takes the world's
    max, so every rank continues the next pass from the same model.  A
    single process returns the state untouched."""
    from ..parallel.collectives import pmax, psum
    from ..parallel.mesh import data_parallel_mesh, world_size
    n = world_size()
    if n <= 1:
        return state
    mesh = data_parallel_mesh()
    weights, gsq, xmax = state
    mean = psum(torch.stack([weights, gsq]), "data", mesh) / n
    return mean[0], mean[1], pmax(xmax, "data", mesh)


def _interaction_features(part: Dict, base_col: np.ndarray, specs: List[str],
                          mask: int) -> np.ndarray:
    """VW ``-q ab`` semantics: cross every namespace whose name starts with
    'a' against every one starting with 'b' and append the crossed features
    to each example.  Namespaces are sparse-dict columns of the frame (the
    featurizer's namespace=column convention); the pair hash matches
    ``VowpalWabbitInteractions`` (h_a * 16777619 + h_b)."""
    ns_cols = {name: col for name, col in part.items()
               if len(col) and isinstance(col[0], dict) and "indices" in col[0]}
    prime = np.uint32(16777619)
    n = len(base_col)
    out = np.empty(n, dtype=object)
    for i in range(n):
        idx_list = [np.asarray(base_col[i]["indices"], np.int32)]
        val_list = [np.asarray(base_col[i]["values"], np.float32)]
        for spec in specs:
            if len(spec) < 2:
                continue
            a_cols = [c for c in ns_cols if c.startswith(spec[0])]
            b_cols = [c for c in ns_cols if c.startswith(spec[1])]
            for ca in a_cols:
                for cb in b_cols:
                    fa, fb = ns_cols[ca][i], ns_cols[cb][i]
                    ia = np.asarray(fa["indices"]).astype(np.uint32)
                    ib = np.asarray(fb["indices"]).astype(np.uint32)
                    with np.errstate(over="ignore"):
                        hh = (ia[:, None] * prime + ib[None, :]).reshape(-1)
                    vv = (np.asarray(fa["values"])[:, None]
                          * np.asarray(fb["values"])[None, :]).reshape(-1)
                    idx_list.append((hh & mask).astype(np.int32))
                    val_list.append(vv.astype(np.float32))
        out[i] = {"indices": np.concatenate(idx_list),
                  "values": np.concatenate(val_list)}
    return out


def _loss_values(loss: str, quantile_tau: float):
    """Loss VALUES (for the --bfgs batch objective; grads below for SGD).
    ``torch.maximum`` splits its gradient at a tie as ``jnp.maximum``
    does."""

    def logistic(pred, y):
        return torch.logaddexp(torch.zeros_like(pred), -y * pred)

    def squared(pred, y):
        return 0.5 * (pred - y) ** 2

    def hinge(pred, y):
        return torch.maximum(torch.zeros_like(pred), 1.0 - y * pred)

    def quantile(pred, y):
        e = y - pred
        return torch.maximum(quantile_tau * e, (quantile_tau - 1.0) * e)

    return {"logistic": logistic, "squared": squared, "hinge": hinge,
            "quantile": quantile}[loss]


def _loss_grads(loss: str, quantile_tau: float):

    def logistic(pred, y):   # y in {-1, +1}
        return -y / (1.0 + torch.exp(y * pred))

    def squared(pred, y):
        return pred - y

    def hinge(pred, y):
        return torch.where(y * pred < 1.0, -y, torch.zeros_like(y))

    def quantile(pred, y):
        return torch.where(pred > y, torch.full_like(y, quantile_tau),
                           torch.full_like(y, quantile_tau - 1.0))

    return {"logistic": logistic, "squared": squared, "hinge": hinge,
            "quantile": quantile}[loss]


def _abs_jax(w: torch.Tensor) -> torch.Tensor:
    """``|w|`` whose gradient at 0 is +1, as ``jax.grad(jnp.abs)`` gives
    (``torch.abs``'s is 0): the L1 term of the --bfgs objective then steps
    exactly as the JAX package's does from the all-zero start."""
    return torch.where(w >= 0, w, -w)


def _bfgs_objective(weights, idx, val, y, w, loss_name: str, l1: float,
                    l2: float) -> torch.Tensor:
    """The --bfgs objective of ``weights`` over the examples ``(idx, val,
    y, w)`` (float64 ``val``, ``y``, ``w``): its sums (and through autograd
    its gradient's) run in float64 and the value rounds to float32, the
    JAX package's type: rounded alike on every device whatever the
    summation order.  The weights are gathered with ``index_select``,
    whose gradient is one ``index_add_``: the gradient of ``w64[idx]``
    (``index_put_`` with accumulation) sorts the indices and adds each
    index's duplicates one after another, 186 ms a trial point on an H100
    at 100,000 tweets, where a stopword's weight is read by most rows."""
    w_sum = torch.clamp(w.sum(), min=1e-9)
    w64 = weights.double()
    pred = torch.sum(w64.index_select(0, idx.reshape(-1)).view(idx.shape)
                     * val, dim=1)
    base = torch.sum(_loss_values(loss_name, 0.5)(pred, y) * w) / w_sum
    return (base + 0.5 * l2 * torch.sum(w64 * w64)
            + l1 * torch.sum(_abs_jax(w64))).to(torch.float32)


def _bfgs_trial(params, updates, stepsize, idx, val, y, w, loss_name: str,
                l1: float, l2: float):
    """``vw.lbfgs.trial_of`` the --bfgs objective: ``(value and slope,
    grad)`` at ``params + updates * stepsize``."""
    def objective(weights):
        return _bfgs_objective(weights, idx, val, y, w, loss_name, l1, l2)
    return trial_of(value_and_grad(objective))(params, updates, stepsize)


class _BFGSPrograms:
    """--bfgs's two programs and the fixed storage they read in place,
    kept across fits by the estimator that owns them: the examples per
    (device, shapes) and the L-BFGS memory per (device, weights), the
    ``MAX_SETS`` most recently used of each.  ``last_run``: the last fit's
    iterations, trial points and host reads."""

    MAX_SETS = 4

    def __init__(self):
        self.trial = captured(_bfgs_trial, name="vw.bfgs_trial",
                              inplace_argnums=(3, 4, 5, 6),
                              static_argnums=(7, 8, 9))
        self.direction = captured(two_loop, name="vw.bfgs_direction",
                                  donate_argnums=(0,), static_argnums=(4,))
        self._examples: "collections.OrderedDict" = collections.OrderedDict()
        self._memories: "collections.OrderedDict" = collections.OrderedDict()
        self.last_run: Optional[Dict] = None

    @classmethod
    def _kept(cls, table, key, make):
        got = table.get(key)
        if got is None:
            got = table[key] = make()
            while len(table) > cls.MAX_SETS:
                table.popitem(last=False)
        table.move_to_end(key)
        return got

    def examples(self, idx, val, y, w, dev: torch.device):
        """The packed examples on ``dev`` in their fixed storage (int64
        ``idx``; float64 ``val``, ``y``, ``w``), moved in one transfer."""
        staged = device_put([idx.astype(np.int64), val, y, w], dev,
                            site=INGEST_SITE)
        staged = [staged[0]] + [t.double() for t in staged[1:]]
        key = (str(dev),) + tuple(tuple(t.shape) for t in staged)
        kept = self._kept(self._examples, key, lambda: staged)
        if kept is not staged:
            for dst, src in zip(kept, staged):
                dst.copy_(src)
        return kept

    def memory(self, w: torch.Tensor, m: int):
        key = (str(w.device), tuple(w.shape), m)
        return self._kept(self._memories, key, lambda: new_memory(w, m))


class _Staged:
    """One partition's examples on the device, padded to whole minibatches
    (padded rows: index 0, value 0, label 0, weight 0 — the JAX package's
    short-batch padding), with the host counts the stats need."""

    def __init__(self, idx, val, y, w, bs: int, dev: torch.device):
        n = len(y)
        pad = -n % bs
        if pad:
            idx = np.pad(idx, ((0, pad), (0, 0)))
            val = np.pad(val, ((0, pad), (0, 0)))
            y = np.pad(y, (0, pad))
            w = np.pad(w, (0, pad))
        self.n = n
        self.nnz = int((val != 0).sum())
        self.idx, self.val, self.y, self.w = device_put(
            [idx.astype(np.int64), val, y, w], dev, site=INGEST_SITE)

    def batches(self, bs: int):
        for s in range(0, self.n, bs):
            yield (min(bs, self.n - s), self.idx[s:s + bs],
                   self.val[s:s + bs], self.y[s:s + bs], self.w[s:s + bs])


class _VWBase(Estimator, HasFeaturesCol, HasLabelCol, HasWeightCol):
    num_bits = Param("num_bits", "hash space bits (VW -b)", "int", default=18)
    learning_rate = Param("learning_rate", "base learning rate (VW -l)", "float", default=0.5)
    power_t = Param("power_t", "lr decay exponent", "float", default=0.5)
    initial_t = Param("initial_t", "initial example-count t (VW --initial_t); "
                      "the non-adaptive lr denominator is t^power_t", "float",
                      default=0.0)
    num_passes = Param("num_passes", "passes over the data", "int", default=1)
    l1 = Param("l1", "L1 regularization", "float", default=0.0)
    l2 = Param("l2", "L2 regularization", "float", default=0.0)
    adaptive = Param("adaptive", "AdaGrad per-weight rates (VW --adaptive)", "bool", default=True)
    normalized = Param("normalized", "scale-normalized updates (VW --normalized)", "bool", default=True)
    batch_size = Param("batch_size", "device minibatch size", "int", default=256)
    initial_model = Param("initial_model", "warm-start model bytes", "object")
    optimizer = Param("optimizer", "sgd (online adaptive/normalized updates) "
                      "| bfgs (full-batch L-BFGS, the VW --bfgs batch mode)",
                      "string", default="sgd",
                      validator=lambda v: v in ("sgd", "bfgs"))
    args = Param("args", "VW-style passthrough arg string (subset parsed: "
                         "-b -l --l1 --l2 --passes --loss_function --power_t "
                         "--initial_t --(no)adaptive --(no)normalized -q "
                         "--interactions --cb_type --quiet)", "string", default="")
    interactions = Param("interactions", "namespace-pair interaction specs "
                         "(VW -q/--interactions)", "list", default=None)
    use_barrier_execution_mode = Param("use_barrier_execution_mode",
                                       "parity param (gang scheduling is implicit "
                                       "in XLA collectives)", "bool", default=False)
    device = Param("device", "where training runs: unset = the CUDA card "
                   "(an error without one), 'cpu' = the host", "string",
                   None)

    def _parse_args(self):
        """Reference builds its native command line from Params and a raw
        passthrough string (``VowpalWabbitBase.buildCommandLineArguments``,
        VowpalWabbitBase.scala:237, args param :80).  Parsed flags land in
        this INSTANCE's Params only — never in class state."""
        toks = (self.get("args") or "").split()
        i = 0
        while i < len(toks):
            t = toks[i]
            def nxt():
                return toks[i + 1] if i + 1 < len(toks) else None
            if t in ("-b", "--bit_precision") and nxt():
                self.set("num_bits", int(nxt())); i += 1
            elif t in ("-l", "--learning_rate") and nxt():
                self.set("learning_rate", float(nxt())); i += 1
            elif t == "--l1" and nxt():
                self.set("l1", float(nxt())); i += 1
            elif t == "--l2" and nxt():
                self.set("l2", float(nxt())); i += 1
            elif t == "--passes" and nxt():
                self.set("num_passes", int(nxt())); i += 1
            elif t == "--power_t" and nxt():
                self.set("power_t", float(nxt())); i += 1
            elif t == "--initial_t" and nxt():
                self.set("initial_t", float(nxt())); i += 1
            elif t == "--loss_function" and nxt():
                if "loss_function" in type(self)._params:
                    self.set("loss_function", nxt())
                i += 1
            elif t == "--adaptive":
                self.set("adaptive", True)
            elif t == "--noadaptive":
                self.set("adaptive", False)
            elif t == "--normalized":
                self.set("normalized", True)
            elif t == "--nonormalized":
                self.set("normalized", False)
            elif t in ("-q", "--quadratic", "--interactions") and nxt():
                pairs = list(self.get("interactions") or [])
                if nxt() not in pairs:  # idempotent across re-parses
                    pairs.append(nxt())
                self.set("interactions", pairs); i += 1
            elif t == "--cb_type" and nxt():
                if "cb_type" in type(self)._params:
                    self.set("cb_type", nxt())
                elif nxt() != "ips":
                    raise NotImplementedError(
                        f"--cb_type {nxt()} on a non-bandit learner")
                i += 1
            elif t == "--quiet":
                pass
            elif t == "--bfgs":
                self.set("optimizer", "bfgs")
            i += 1

    def _make_trainer(self, loss_name: str):
        """``step(state, idx, val, y, w, t)``: one minibatch's predict and
        VW update, in place on ``state = (weights, gsq, xmax)`` ((2^b,)
        float32 tensors); ``t`` is a 0-d float32 tensor (read only by the
        non-adaptive rate) or None.  Returns the predictions.  The step is
        a program of its own per fit (``captured``): every minibatch of a
        partition has one shape, so the card captures it once per
        (width, batch size) and replays it, the state donated."""
        D = 1 << self.get("num_bits")
        lr = self.get("learning_rate")
        adaptive = self.get("adaptive")
        normalized = self.get("normalized")
        l1, l2 = self.get("l1"), self.get("l2")
        power_t = self.get("power_t")
        grad_fn = _loss_grads(loss_name, 0.5)

        def step(state, idx, val, y, w, t):
            weights, gsq, xmax = state
            pred = torch.sum(weights[idx] * val, dim=1)         # (bs,)
            g = grad_fn(pred, y) * w                            # (bs,)
            gv = g[:, None] * val                               # (bs, k)
            flat_idx = idx.reshape(-1)
            flat_gv = gv.reshape(-1)
            if normalized:
                xmax.scatter_reduce_(0, flat_idx, val.abs().reshape(-1),
                                     "amax")
            if adaptive:
                gsq.index_add_(0, flat_idx, flat_gv * flat_gv)
                denom = torch.sqrt(gsq[flat_idx]) + 1e-8
            else:
                denom = torch.pow(t, power_t)
            if normalized:
                xm = xmax[flat_idx]
                scale = torch.where(xm > 0, xm, torch.ones_like(xm))
            else:
                scale = 1.0
            delta = lr * flat_gv / (denom * scale)
            if l2:
                delta = delta + lr * l2 * weights[flat_idx]
            weights.index_add_(0, flat_idx, -delta)
            if l1:
                wv = weights[flat_idx]
                weights.index_put_((flat_idx,), torch.sign(wv) * torch.clamp(
                    torch.abs(wv) - lr * l1, min=0.0))
            return pred

        return captured(step, name="vw.step", donate_argnums=(0,)), D

    def _step_times(self, t: float, staged: _Staged, bs: int,
                    dev: torch.device) -> Optional[torch.Tensor]:
        """The example count ``t`` each minibatch of ``staged`` sees, as
        float32 (the JAX package passes ``jnp.float32(t)``), in one
        transfer; None under the adaptive rate, which never reads it."""
        if self.get("adaptive"):
            return None
        starts = t + np.arange(0, staged.n, bs, dtype=np.float64)
        return device_put(starts.astype(np.float32), dev, site=INGEST_SITE)

    def _initial_weights(self, D: int) -> np.ndarray:
        init = self.get("initial_model")
        if init is not None:
            return VowpalWabbitModelBase.bytes_to_weights(init, D)
        return np.zeros(D, np.float32)

    def _fit_bfgs(self, df: DataFrame, loss_name: str, y_transform):
        """VW ``--bfgs``: batch optimization over the cached examples
        (reference: VW's bfgs reduction runs L-BFGS passes over the cache
        file).  One padded (n, k) gather turns the hashed-sparse model into
        a dense objective; the copy of ``optax.lbfgs`` drives it."""
        dev = resolve_device(self.get("device"))
        D = 1 << self.get("num_bits")
        mask = D - 1
        fc, lc = self.get("features_col"), self.get("label_col")
        wc = self.get("weight_col")
        specs = self.get("interactions") or []
        sw = StopWatch()
        parts_idx, part_ids, ys, ws = [], [], [], []
        max_nnz = 1
        with sw.measure("ingest"):
            for pid, part in enumerate(df.partitions):
                if fc not in part or len(part[fc]) == 0:
                    continue
                feats = part[fc]
                if specs:
                    feats = _interaction_features(part, feats, specs, mask)
                max_nnz = max(max_nnz, max((len(v["indices"]) for v in feats),
                                           default=1))
                parts_idx.append(feats)
                part_ids.append(pid)
                ys.append(y_transform(np.asarray(part[lc], np.float64)))
                ws.append(np.asarray(part[wc], np.float32) if wc
                          else np.ones(len(feats), np.float32))
            cols = np.concatenate([np.asarray(c, dtype=object) for c in parts_idx]) \
                if parts_idx else np.empty(0, dtype=object)
            idx, val = pack_sparse_column(cols, max_nnz=max_nnz, mask=mask)
            y = np.concatenate(ys).astype(np.float32) if ys else np.zeros(0, np.float32)
            w = np.concatenate(ws) if ws else np.zeros(0, np.float32)
            progs = self._bfgs_programs()
            idx_d, val_d, y_d, w_d = progs.examples(idx, val, y, w, dev)
        loss = (loss_name, float(self.get("l1")), float(self.get("l2")))

        def trial(params, updates, stepsize):
            return progs.trial(params, updates, stepsize, idx_d, val_d, y_d,
                               w_d, *loss)

        w0 = torch.from_numpy(self._initial_weights(D)).to(dev)
        # respect an explicit --passes; default to 20 L-BFGS iterations when
        # the user didn't set one (num_passes' online default of 1 would be
        # a single line-search step)
        iters = self.get("num_passes") if "num_passes" in self._paramMap else 20
        with sw.measure("learn"):
            opt = LBFGS(None, trial=trial, direction=progs.direction)
            opt.memory = progs.memory(w0, opt.m)
            weights = opt.run(w0, iters)
        progs.last_run = {"iterations": iters, "trials": opt.trials,
                          "host_reads": opt.host_reads}
        zeros = torch.zeros(D, device=dev)
        state = _allreduce_pass_end((weights, zeros, zeros))
        # features/example from pre-padding index lengths: explicit zero
        # values count, all-padding rows don't; one stats row per source
        # partition with its true id, mirroring the online path
        stats = []
        for pid, feats in zip(part_ids, parts_idx):
            rows_p = len(feats)
            nnz_p = sum(len(v["indices"]) for v in feats)
            stats.append(TrainingStats(
                partition_id=pid, rows=rows_p,
                features_per_example=float(nnz_p / max(rows_p, 1)),
                passes=iters, total_time_s=sw.total_elapsed(),
                ingest_time_s=sw.elapsed("ingest"),
                learn_time_s=sw.elapsed("learn")))
        if not stats:
            stats = [TrainingStats(partition_id=0, rows=0,
                                   features_per_example=0.0, passes=iters,
                                   total_time_s=sw.total_elapsed(),
                                   ingest_time_s=sw.elapsed("ingest"),
                                   learn_time_s=sw.elapsed("learn"))]
        return state[0].cpu().numpy(), stats

    def _bfgs_programs(self) -> _BFGSPrograms:
        """The estimator's --bfgs programs and storage (made at first use,
        kept across fits, never pickled)."""
        progs = self.__dict__.get("_bfgs")
        if progs is None:
            progs = self._bfgs = _BFGSPrograms()
        return progs

    def __getstate__(self):
        """Pickled and copied without its --bfgs programs and storage."""
        state = dict(self.__dict__)
        state.pop("_bfgs", None)
        return state

    def _fit_weights(self, df: DataFrame, loss_name: str, y_transform):
        self._parse_args()
        if self.get("optimizer") == "bfgs":
            return self._fit_bfgs(df, loss_name, y_transform)
        dev = resolve_device(self.get("device"))
        step, D = self._make_trainer(loss_name)
        fc, lc = self.get("features_col"), self.get("label_col")
        wc = self.get("weight_col")
        bs = self.get("batch_size")
        sw = StopWatch()

        weights0 = torch.from_numpy(self._initial_weights(D)).to(dev)
        state = (weights0, torch.zeros(D, dtype=torch.float32, device=dev),
                 torch.zeros(D, dtype=torch.float32, device=dev))

        stats: List[TrainingStats] = []
        specs = self.get("interactions") or []
        mask = (1 << self.get("num_bits")) - 1
        t = 1.0 + self.get("initial_t")
        staged: Dict[int, _Staged] = {}
        for pass_i in range(self.get("num_passes")):
            for pid, part in enumerate(df.partitions):
                n = len(part[fc]) if fc in part else 0
                if n == 0:
                    continue
                with sw.measure("ingest"):
                    if pid not in staged:   # packed and moved once
                        feats = part[fc]
                        if specs:
                            feats = _interaction_features(part, feats, specs,
                                                          mask)
                        idx, val = pack_sparse_column(feats, mask=mask)
                        y = y_transform(np.asarray(part[lc], np.float64)) \
                            .astype(np.float32)
                        w = np.asarray(part[wc], np.float32) if wc \
                            else np.ones(n, np.float32)
                        staged[pid] = _Staged(idx, val, y, w, bs, dev)
                    sp = staged[pid]
                    ts = self._step_times(t, sp, bs, dev)
                with sw.measure("learn"):
                    for b, (m, bidx, bval, by, bw) in enumerate(
                            sp.batches(bs)):
                        step(state, bidx, bval, by, bw,
                             None if ts is None else ts[b])
                        t += m
                if pass_i == self.get("num_passes") - 1:
                    stats.append(TrainingStats(
                        partition_id=pid, rows=n,
                        features_per_example=float(sp.nnz / max(n, 1)),
                        passes=self.get("num_passes"),
                        total_time_s=sw.total_elapsed(),
                        ingest_time_s=sw.elapsed("ingest"),
                        learn_time_s=sw.elapsed("learn")))
            # end of pass: average weights across executor processes — the
            # reference's spanning-tree allreduce (VowpalWabbitBase.scala:
            # 434-462).  No-op in a single-process run.
            state = _allreduce_pass_end(state)
        return state[0].cpu().numpy(), stats

    def _attach_common(self, model, stats):
        model.set("features_col", self.get("features_col"))
        model.set("num_bits", self.get("num_bits"))
        model.set("interactions", self.get("interactions"))
        model.set("stats", [s.as_row() for s in stats])
        for pc in ("prediction_col",):
            if pc in type(model)._params and pc in type(self)._params:
                model.set(pc, self.get(pc))
        if self.is_set("device"):   # scoring runs where training ran
            model.set("device", self.get("device"))
        return model


class VowpalWabbitModelBase(Model, HasFeaturesCol, HasPredictionCol):
    weights_param = ComplexParam("weights", "dense hash-space weights")
    num_bits = Param("num_bits", "hash space bits", "int", default=18)
    stats = Param("stats", "per-partition training stats rows", "list")
    interactions = Param("interactions", "namespace-pair interaction specs "
                         "applied at scoring time", "list", default=None)
    device = Param("device", "where scoring runs: unset = the CUDA card, "
                   "'cpu' = the host", "string", None)

    def _effective_features(self, part: Dict) -> np.ndarray:
        """Feature column with any trained ``-q`` interactions appended —
        scoring must hash exactly what training hashed."""
        col = part[self.get("features_col")]
        specs = self.get("interactions") or []
        if specs:
            col = _interaction_features(part, col, specs,
                                        (1 << self.get("num_bits")) - 1)
        return col

    @property
    def weights(self) -> np.ndarray:
        return self.get_or_fail("weights")

    def get_performance_statistics(self) -> DataFrame:
        """Reference diagnostics DataFrame (VowpalWabbitBase.scala:475-489)."""
        return DataFrame.from_rows(self.get("stats") or [])

    # model-bytes interop (reference ByteArrayParam model, :137)
    def model_bytes(self) -> bytes:
        return self.weights.astype(np.float32).tobytes()

    @staticmethod
    def bytes_to_weights(b: bytes, dim: int) -> np.ndarray:
        w = np.frombuffer(b, np.float32)
        if len(w) != dim:
            raise ValueError(f"model bytes hold {len(w)} weights, expected {dim}")
        return w.copy()

    def _device_weights(self) -> torch.Tensor:
        """The weights on the model's device: moved once per ``transform``
        (site ``vw.score``)."""
        dev = resolve_device(self.get("device"))
        return device_put(np.asarray(self.weights, np.float32), dev,
                          site=SCORE_SITE)

    def _raw_scores(self, col: np.ndarray,
                    w: Optional[torch.Tensor] = None) -> np.ndarray:
        """``sum(w[idx] * val)`` per row: the gather and the sum on the
        device of ``w`` (default: the model's), float32 back on the host."""
        if w is None:
            w = self._device_weights()
        idx, val = pack_sparse_column(col, mask=(1 << self.get("num_bits")) - 1)
        idx_d, val_d = device_put([idx.astype(np.int64), val], w.device,
                                  site=SCORE_SITE)
        return torch.sum(w[idx_d] * val_d, dim=1).cpu().numpy()


class VowpalWabbitClassifier(_VWBase, HasPredictionCol, HasProbabilityCol,
                             HasRawPredictionCol):
    """Binary classifier, logistic loss (reference VowpalWabbitClassifier)."""
    loss_function = Param("loss_function", "logistic|hinge", "string", default="logistic")

    def _fit(self, df: DataFrame) -> "VowpalWabbitClassificationModel":
        self._parse_args()  # --loss_function etc. must land before reads
        weights, stats = self._fit_weights(
            df, self.get("loss_function"),
            lambda y: np.where(y > 0, 1.0, -1.0))
        model = VowpalWabbitClassificationModel()
        model.set("weights", weights)
        model.set("probability_col", self.get("probability_col"))
        model.set("raw_prediction_col", self.get("raw_prediction_col"))
        return self._attach_common(model, stats)


class VowpalWabbitClassificationModel(VowpalWabbitModelBase, HasProbabilityCol,
                                      HasRawPredictionCol):
    def _transform(self, df: DataFrame) -> DataFrame:
        w = self._device_weights()

        def per_part(p):
            raw = self._raw_scores(self._effective_features(p), w)
            # clipped sigmoid: extreme margins would overflow np.exp (the
            # probability saturates at float precision well before |30|)
            prob = 1.0 / (1.0 + np.exp(-np.clip(raw, -30.0, 30.0)))
            prob_col = np.empty(len(raw), dtype=object)
            raw_col = np.empty(len(raw), dtype=object)
            for i in range(len(raw)):
                prob_col[i] = np.asarray([1 - prob[i], prob[i]])
                raw_col[i] = np.asarray([-raw[i], raw[i]])
            return {**p, self.get("prediction_col"): (raw > 0).astype(np.float64),
                    self.get("probability_col"): prob_col,
                    self.get("raw_prediction_col"): raw_col}

        return df.map_partitions(per_part)

    def transform_schema(self, schema):
        schema.require(self.get("features_col"))
        return schema.add(self.get("prediction_col"), ColumnType.DOUBLE)


class VowpalWabbitRegressor(_VWBase, HasPredictionCol):
    loss_function = Param("loss_function", "squared|quantile", "string", default="squared")

    def _fit(self, df: DataFrame) -> "VowpalWabbitRegressionModel":
        self._parse_args()  # --loss_function etc. must land before reads
        weights, stats = self._fit_weights(df, self.get("loss_function"), lambda y: y)
        model = VowpalWabbitRegressionModel()
        model.set("weights", weights)
        return self._attach_common(model, stats)


class VowpalWabbitRegressionModel(VowpalWabbitModelBase):
    def _transform(self, df: DataFrame) -> DataFrame:
        w = self._device_weights()

        def per_part(p):
            return {**p, self.get("prediction_col"):
                    self._raw_scores(self._effective_features(p), w)}

        return df.map_partitions(per_part)

    def transform_schema(self, schema):
        schema.require(self.get("features_col"))
        return schema.add(self.get("prediction_col"), ColumnType.DOUBLE)


class VowpalWabbitContextualBandit(_VWBase):
    """Contextual bandit via IPS-weighted cost regression.

    Reference: ``VowpalWabbitContextualBandit`` (376 LoC; DataFrame-of-actions
    API).  Columns: shared features, per-action features (object column of
    lists of sparse dicts), chosen action (1-based), cost, probability.
    Learns a scorer s(shared, action); ``predict`` emits per-action scores
    (lower = better, VW cost semantics).
    """

    shared_col = Param("shared_col", "shared-context sparse features column", "string",
                       default="shared_features")
    action_col = Param("action_col", "per-action features column (list of sparse "
                       "dicts per row)", "string", default="action_features")
    chosen_action_col = Param("chosen_action_col", "1-based chosen action", "string",
                              default="chosen_action")
    cost_col = Param("cost_col", "observed cost of chosen action", "string", default="cost")
    probability_col = Param("probability_col", "logging policy probability", "string",
                            default="probability")
    cb_type = Param("cb_type", "bandit estimator: ips (inverse-propensity "
                    "weights) | mtr (regress observed costs unweighted)",
                    "string", default="ips")

    def _fit(self, df: DataFrame) -> "VowpalWabbitContextualBanditModel":
        self._parse_args()
        if self.get("optimizer") == "bfgs":
            raise NotImplementedError(
                "--bfgs is not supported for the contextual bandit (the IPS "
                "objective is trained online); use the default sgd optimizer")
        dev = resolve_device(self.get("device"))
        step, D = self._make_trainer("squared")
        sw = StopWatch()
        shared_c = self.get("shared_col")
        act_c = self.get("action_col")
        bs = self.get("batch_size")

        state = tuple(torch.zeros(D, dtype=torch.float32, device=dev)
                      for _ in range(3))
        t = 1.0 + self.get("initial_t")
        stats: List[TrainingStats] = []
        for pass_i in range(self.get("num_passes")):
            for pid, part in enumerate(df.partitions):
                n = len(part[act_c])
                if n == 0:
                    continue
                rows_idx, rows_val, targets, ws = [], [], [], []
                cbt = self.get("cb_type")
                if cbt not in ("ips", "mtr"):
                    raise NotImplementedError(
                        f"--cb_type {cbt}: only ips/mtr on this backend")
                with sw.measure("ingest"):
                    chosen = np.asarray(part[self.get("chosen_action_col")], np.int64) - 1
                    cost = np.asarray(part[self.get("cost_col")], np.float64)
                    prob = np.asarray(part[self.get("probability_col")], np.float64)
                    for i in range(n):
                        a = part[act_c][i][int(chosen[i])]
                        sh = part[shared_c][i] if shared_c in part else \
                            {"indices": np.empty(0, np.int32), "values": np.empty(0, np.float32)}
                        rows_idx.append(np.concatenate([sh["indices"], a["indices"]]))
                        rows_val.append(np.concatenate([sh["values"], a["values"]]))
                        targets.append(cost[i])
                        ws.append(1.0 / max(prob[i], 1e-6) if cbt == "ips" else 1.0)
                    col = np.empty(n, dtype=object)
                    for i in range(n):
                        col[i] = {"indices": rows_idx[i], "values": rows_val[i]}
                    idx, val = pack_sparse_column(col, mask=(1 << self.get("num_bits")) - 1)
                    y = np.asarray(targets, np.float32)
                    w = np.asarray(ws, np.float32)
                    w = w / w.mean()
                    sp = _Staged(idx, val, y, w, bs, dev)
                    ts = self._step_times(t, sp, bs, dev)
                with sw.measure("learn"):
                    for b, (m, bidx, bval, by, bw) in enumerate(
                            sp.batches(bs)):
                        step(state, bidx, bval, by, bw,
                             None if ts is None else ts[b])
                        t += m
                if pass_i == self.get("num_passes") - 1:
                    stats.append(TrainingStats(pid, n, float(np.mean([len(r) for r in rows_idx])),
                                               self.get("num_passes"), sw.total_elapsed(),
                                               sw.elapsed("ingest"), sw.elapsed("learn")))
        model = VowpalWabbitContextualBanditModel()
        model.set("weights", state[0].cpu().numpy())
        model.set("shared_col", shared_c)
        model.set("action_col", act_c)
        return self._attach_common(model, stats)


class VowpalWabbitContextualBanditModel(VowpalWabbitModelBase):
    shared_col = Param("shared_col", "shared features column", "string", default="shared_features")
    action_col = Param("action_col", "per-action features column", "string", default="action_features")

    def _transform(self, df: DataFrame) -> DataFrame:
        w = self._device_weights()
        shared_c, act_c = self.get("shared_col"), self.get("action_col")

        def per_part(p):
            n = len(p[act_c])
            # every (row, action) pair and every row's shared features in
            # one gather-sum each: score = actions' dot + shared dot
            flat = [a for i in range(n) for a in p[act_c][i]]
            counts = [len(p[act_c][i]) for i in range(n)]
            s_act = self._raw_scores(flat, w) if flat \
                else np.zeros(0, np.float32)
            s_sh = self._raw_scores(p[shared_c], w) if shared_c in p and n \
                else None
            out = np.empty(n, dtype=object)
            off = 0
            for i in range(n):
                scores = [float(s) for s in s_act[off:off + counts[i]]]
                off += counts[i]
                if s_sh is not None:
                    scores = [s + float(s_sh[i]) for s in scores]
                out[i] = np.asarray(scores)
            return {**p, self.get("prediction_col"): out}

        return df.map_partitions(per_part)

    def transform_schema(self, schema):
        schema.require(self.get("action_col"))
        return schema.add(self.get("prediction_col"), ColumnType.VECTOR)
