"""Driver kind ``fit``: a closed loop of whole estimator fits on one
DataFrame, as a tuning loop refits it.

Set-up draws the configuration's rows on the device from the seed, hands
them to a host DataFrame as float64 vectors (Spark's dense vectors), and
runs one warm fit, which builds the kernels and captures the programs.
An item of the window is one ``fit`` from the DataFrame to the booster on
the host.  The check judges one fit drawn from the seed against the
reference tree by tree, and every other fit's edges and row counts.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..harness import bench
from ..reference import judge

#: the configuration's keys that are estimator params
PARAMS = ("num_iterations", "learning_rate", "num_leaves", "max_bin",
          "min_data_in_leaf", "min_sum_hessian_in_leaf",
          "use_quantized_grad", "num_grad_quant_bins", "seed")
ESTIMATORS = {"binary": "LightGBMClassifier", "lambdarank": "LightGBMRanker"}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def estimator(cfg: dict, dev: torch.device):
    from mmlspark_tpu_torch.lightgbm import estimators
    est = getattr(estimators, ESTIMATORS[cfg["objective"]])()
    est.set_params(**{k: cfg[k] for k in PARAMS},
                   device=None if dev.type == "cuda" else dev.type)
    if cfg["objective"] == "lambdarank":
        est.set_params(group_col="query")
    return est


def setup(run: bench.Run) -> None:
    from mmlspark_tpu_torch.core import DataFrame
    cfg, dev = run.config, run.device
    data = bench.module("datasets", cfg["dataset"]).make(cfg, run.seed, dev)
    run.mark("rows")
    cols = {"features": data["X"].cpu().numpy().astype(np.float64),
            "label": data["y"].cpu().numpy().astype(np.float64)}
    gp = data.get("group_ptr")
    if gp is not None:
        cols["query"] = np.repeat(np.arange(gp.size - 1), np.diff(gp))
    run.state.update(df=DataFrame.from_dict(cols), X=data["X"],
                     y=data["y"], group_ptr=gp, est=estimator(cfg, dev),
                     rows=int(data["X"].shape[0]))
    run.mark("host frame")
    run.state["est"].fit(run.state["df"])
    _sync(dev)
    run.mark("warm fit")


def item(run: bench.Run, i: int) -> dict:
    from mmlspark_tpu_torch.ops import cuda_histogram
    before = cuda_histogram.launch_counts()
    t0 = time.perf_counter()
    model = run.state["est"].fit(run.state["df"])
    _sync(run.device)
    t1 = time.perf_counter()
    after = cuda_histogram.launch_counts()
    return {"t0": t0, "t1": t1, "rows": run.state["rows"],
            "iterations": int(model.booster.num_iterations),
            "booster": model.booster,
            "launches": {k: after[k] - before.get(k, 0) for k in after}}


def trace_ok(run: bench.Run, tracer, spans, recs) -> bool:
    """Every launch of the two kernels in the traced fits has a record."""
    from ..harness import trace
    for (lo, hi), rec in zip(spans, recs):
        for name, n in rec["launches"].items():
            if trace.kernel_count(tracer, [(lo, hi)], name + "_kernel") != n:
                return False
    return True


def end_to_end(run: bench.Run) -> dict:
    recs = [r for r in run.records if "error" not in r]
    done = sum(r["rows"] * r["iterations"] for r in recs)
    span = max(r["t1"] for r in recs) - run.window_start
    return {"fit_row_iters_per_s": done / span}


def release(run: bench.Run) -> None:
    """Drop the estimator, the DataFrame and the program's cached fit
    buffers and graphs before the reference runs."""
    from mmlspark_tpu_torch.lightgbm import core
    from mmlspark_tpu_torch.observability import compute
    for k in ("est", "df"):
        run.state.pop(k, None)
    core.release_programs()
    compute.release_graphs()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()


def _trees(booster) -> dict:
    return {k: np.asarray(getattr(booster, k)) for k in judge.TREE_KEYS}


def check(run: bench.Run) -> dict:
    return judge_fits(run, ("program",))["program"]


def judge_fits(run: bench.Run, candidates) -> dict:
    """Readings of one fit of the window drawn from the seed, for each of
    ``candidates`` (``reference.judge.CANDIDATES``) in the program's
    place; the program's readings also cover the other fits' edges, row
    counts and starting scores."""
    cfg, dev = run.config, run.device
    fits = [r for r in run.records if "error" not in r]
    if not fits:
        return {c: {} for c in candidates}
    rng = np.random.default_rng(int(run.seed) % (1 << 63))
    judged = fits[int(rng.integers(len(fits)))]
    X, y, gp = run.state["X"], run.state["y"], run.state["group_ptr"]
    n = X.shape[0]
    rows = np.sort(rng.choice(n, min(n, int(run.traffic["raw_rows"])),
                              replace=False))
    raw_rows = X[torch.from_numpy(rows).to(dev)].cpu().numpy()
    prog_raw = judged["booster"].raw_scores(
        raw_rows, device=None if dev.type == "cuda" else dev)[:, 0]
    release(run)
    seed = int(cfg["seed"])

    def noise(t: int) -> torch.Tensor:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed * 1000003 + t)
        return torch.rand((2, n), generator=gen, device=dev,
                          dtype=torch.float32)

    binned = judge.binned(X, cfg)
    booster = judged["booster"]
    out = {c: judge.fit_readings(
        X, y, gp, cfg, _trees(booster), booster.init_score, noise,
        booster.num_trees, raw_rows, prog_raw, candidate=c,
        binned_xy=binned) for c in candidates}
    if "program" in out:
        for rec in fits:
            if rec is judged:
                continue
            other = judge.fit_readings(
                X, y, gp, cfg, _trees(rec["booster"]),
                rec["booster"].init_score, noise, 0, binned_xy=binned)
            for k in ("edge_mismatch", "count_mismatch", "init_gap"):
                out["program"][k] = max(out["program"][k], other[k])
    return out
