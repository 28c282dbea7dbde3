"""The leaf-wise boosting loop of one checkout of the port, timed on the card.

    python3 tools/leaf_ab.py --repo PATH --label NAME [--rows 1000000]

Imports ``mmlspark_tpu_torch`` from ``PATH`` (a checkout of this
repository, e.g. an unpacked ``git archive`` of a parent commit), makes
``bench.py``'s GBDT data (N(0, 1) features, label ``x0 + 0.5 x1 + noise >
0``, 200 features, seed 0) and fits ``LightGBMClassifier()``'s defaults
(leaf-wise, 31 leaves, 255 bins) for 8 iterations through ``train()``
four times: the first builds the kernels and warms up, the next two give
``extras["boosting_s"]``, the last runs under ``torch.profiler`` for the
device's busy share, the ``cudaLaunchKernel`` calls per tree and the
``frontier_finish`` device time per fit.  Host binning is done once and
reused (it is not what is timed).  To compare two checkouts, run them in
one call in turns (A, B, B, A).  Prints one JSON line and appends it to
``chiprun_out/leaf_ab.jsonl``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repo", required=True)
    ap.add_argument("--label", required=True)
    ap.add_argument("--rows", type=int, default=1_000_000)
    args = ap.parse_args()
    repo = os.path.abspath(args.repo)
    sys.path.insert(0, repo)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("leaf_ab: no CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile
    from mmlspark_tpu_torch.lightgbm import GBDTParams, core, train
    if not core.__file__.startswith(repo):
        raise SystemExit(f"imported {core.__file__}, not from {repo}")

    class CachedMapper(core.BinMapper):    # bin once, reuse on repeats
        _memo: dict = {}

        def fit(self, X):
            key = ("fit", id(X))
            if key not in self._memo:
                self._memo[key] = super().fit(X)
            return self._memo[key]

        def transform(self, X):
            key = ("transform", id(self), id(X))
            if key not in self._memo:
                self._memo[key] = super().transform(X)
            return self._memo[key]

    core.BinMapper = CachedMapper
    rng = np.random.default_rng(0)
    X = rng.normal(size=(args.rows, 200)).astype(np.float32)
    y = (X[:, 0] + 0.5 * X[:, 1] + rng.normal(scale=0.3, size=args.rows)
         > 0).astype(np.float32)
    params = GBDTParams(num_iterations=8, num_leaves=31, objective="binary")
    boosting = []
    for _ in range(3):
        torch.cuda.synchronize()
        boosting.append(train(X, y, params).extras["boosting_s"])
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        res = train(X, y, params)
        torch.cuda.synchronize()
    device_ms = finish_ms = 0.0
    launches = 0
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and \
                "memcpy" not in e.key.lower():
            device_ms += e.self_device_time_total / 1e3
            if "frontier_finish" in e.key or "frontier_best" in e.key:
                finish_ms += e.self_device_time_total / 1e3
        if e.key == "cudaLaunchKernel":
            launches += e.count
    prof_boost = res.extras["boosting_s"]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    rec = {"label": args.label, "rows": args.rows, "card": card,
           "boosting_s": boosting[1:], "warmup_boosting_s": boosting[0],
           "host_ms_per_step": [b * 1e3 / (8 * 31) for b in boosting[1:]],
           "profiled_boosting_s": prof_boost,
           "device_kernel_ms": device_ms,
           "busy_share": device_ms / (prof_boost * 1e3),
           "frontier_finish_ms_per_fit": finish_ms,
           "cuda_launch_kernel_per_tree": launches / 8,
           "time": time.time()}
    line = json.dumps(rec)
    print(line, flush=True)
    out = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chiprun_out")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "leaf_ab.jsonl"), "a") as f:
        f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
