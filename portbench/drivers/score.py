"""Driver kind ``score``: a closed loop of
``LightGBMClassificationModel.transform(df).collect()`` calls, each on a
one-partition DataFrame of fresh rows, cycling through a pool made in
set-up.

The model is a seeded forest (``harness.forest``) of the configuration's
published tree count and leaves, loaded into the program's booster as a
user loads a model file: the benchmark makes it, so the reference walks
the very trees the program serves.  Set-up makes the pool and the model
and runs one warm call, which captures the walk's program.  The check
compares the raw scores, probabilities and predictions of a seed-drawn
share of the window's calls with the reference's walk.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..harness import bench, forest
from ..reference import judge


def _booster(trees: dict, cfg: dict, init_score: float):
    from mmlspark_tpu_torch.models.gbdt import GBDTBooster
    T, M = trees["split_feature"].shape
    L = trees["leaf_value"].shape[1]
    zeros_m = np.zeros((T, M), np.float32)
    zeros_l = np.zeros((T, L), np.float32)
    return GBDTBooster(
        trees["split_feature"], trees["threshold"],
        np.zeros((T, M), np.int32), zeros_m, zeros_m, zeros_m,
        trees["leaf_value"], zeros_l, np.ones(T, np.float32),
        max_depth=trees["max_depth"], num_features=int(cfg["num_features"]),
        objective="binary", init_score=init_score,
        left_child=trees["left_child"], right_child=trees["right_child"])


def setup(run: bench.Run) -> None:
    from mmlspark_tpu_torch.core import DataFrame
    from mmlspark_tpu_torch.lightgbm.estimators import (
        LightGBMClassificationModel)
    cfg, tr, dev = run.config, run.traffic, run.device
    data = bench.module("datasets", cfg["dataset"])
    R, P = int(tr["rows_per_call"]), int(tr["pool"])
    X = data.rows(cfg, run.seed, dev, R * P)
    host = X.cpu().numpy().astype(np.float64)
    run.mark("rows")
    pool = [DataFrame.from_dict({"features": host[i * R:(i + 1) * R]})
            for i in range(P)]
    run.mark("host frames")
    gen = torch.Generator(device=dev)
    gen.manual_seed((int(run.seed) * 31 + 7) % (1 << 63))
    trees = forest.generate(data.quantile_table(cfg, run.seed, dev),
                            int(cfg["published"]["num_iterations"]),
                            int(cfg["num_leaves"]), gen, cfg["score_forest"])
    trees["init_score"] = float(tr["init_score"])
    model = LightGBMClassificationModel()
    model.set("booster", _booster(trees, cfg, trees["init_score"]))
    model.set("classes", [0.0, 1.0])
    model.set("device", None if dev.type == "cuda" else dev.type)
    # a seed-drawn residue: the calls kept for the check
    keep = int(tr["check_every"])
    run.state.update(X=X, pool=pool, model=model, trees=trees, rows=R,
                     keep=(keep, int(run.seed) % keep), kept={},
                     walk_shape={
                         "rows": R, "features": int(X.shape[1]),
                         "trees": trees["split_feature"].shape[0],
                         "nodes": trees["split_feature"].shape[1],
                         "leaves": trees["leaf_value"].shape[1]})
    print(f"portbench: model of {trees['split_feature'].shape[0]} trees x "
          f"{int(cfg['num_leaves'])} leaves, max depth {trees['max_depth']}",
          flush=True)
    run.mark("model")
    model.transform(pool[0]).collect()
    run.mark("warm call")


def item(run: bench.Run, i: int) -> dict:
    st = run.state
    df = st["pool"][i % len(st["pool"])]
    t0 = time.perf_counter()
    out = st["model"].transform(df).collect()
    t1 = time.perf_counter()
    every, residue = st["keep"]
    if i % every == residue:
        st["kept"][i] = out
    st["last"] = (i, out)
    return {"t0": t0, "t1": t1, "rows": st["rows"], "call": i,
            "frame": i % len(st["pool"])}


def count_visits(run: bench.Run) -> dict:
    """Node visits of the traced calls' pool frames, by the reference's
    walk; counted once a run."""
    from ..reference import gbdt as ref
    st, R = run.state, run.state["rows"]
    if "visits" in st:
        return st["visits"]
    out = st["visits"] = {}
    for j in sorted({t["frame"] for t in run.traced}):
        tr = st["trees"]
        _, visits = ref.walk_raw(st["X"][j * R:(j + 1) * R],
                                 tr["split_feature"], tr["threshold"],
                                 tr["left_child"], tr["right_child"],
                                 tr["leaf_value"])
        out[j] = float(visits.sum())
    return out


def trace_ok(run: bench.Run, tracer, spans, recs) -> bool:
    from ..harness import trace
    return all(trace.busy_us(tracer, [sp]) > 0 for sp in spans)


def end_to_end(run: bench.Run) -> dict:
    recs = [r for r in run.records if "error" not in r]
    span = max(r["t1"] for r in recs) - run.window_start
    lat = np.array([(r["t1"] - r["t0"]) * 1e3 for r in recs])
    return {"score_rows_per_s": sum(r["rows"] for r in recs) / span,
            "score_p95_ms": float(np.percentile(lat, 95))}


def check(run: bench.Run) -> dict:
    return judge_calls(run, ("program",))["program"]


def judge_calls(run: bench.Run, candidates) -> dict:
    """Readings of the kept calls (and the window's last) for each of
    ``candidates``: ``"program"``, or ``"bfloat16"``, the control: the
    reference's walk in bfloat16 in the program's place."""
    st = run.state
    kept = st.pop("kept")
    # the last call of the window is always judged as well
    i_last, out_last = st.pop("last")
    kept[i_last] = out_last
    st.pop("model")
    from mmlspark_tpu_torch.observability import compute
    compute.release_graphs()
    R, P = st["rows"], len(st["pool"])
    out = {c: {"raw_gap": 0.0, "prob_gap": 0.0, "pred_mismatch": 0.0}
           for c in candidates}
    refs, lows = {}, {}
    for i, got in sorted(kept.items()):
        j = i % P
        x = st["X"][j * R:(j + 1) * R]
        if j not in refs:
            refs[j] = judge.score_reference(x, st["trees"])
        for c in candidates:
            if c == "program":
                made = (np.stack(got["raw_prediction"])[:, 0],
                        np.stack(got["probability"]),
                        np.asarray(got["prediction"]))
            else:
                if j not in lows:
                    lows[j] = judge.control_outputs(judge.score_reference(
                        x, st["trees"], precision=c))
                made = lows[j]
            r = judge.score_readings(refs[j], *made)
            for k, v in r.items():
                out[c][k] = max(out[c][k], v)
    return out
