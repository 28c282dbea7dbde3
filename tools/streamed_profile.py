"""Where the out-of-core loop's time goes, on the card.

    python3 tools/streamed_profile.py [--rows 1000000] [--tile-rows 131072]

Makes ``bench.py``'s GBDT data (N(0, 1) features, label ``x0 + 0.5 x1 +
noise > 0``, 200 features, seed 0) and fits it with
``lightgbm.train_streamed`` on the card: leaf-wise (31 leaves) for 2
iterations and level-wise (``max_depth=5``) for 4, after one warm-up fit.
Around each fit it books, by the host clock, the prefetch worker's time
per tile (the whole load, of which the copies into pinned memory and the
host's node ids or routing) and the consumer's per tile (waiting on the
copy event, the launches); then one leaf-wise tree runs under
``torch.profiler`` for the ``cudaLaunchKernel`` calls, the host -> card
copies' device time and the two kernels' device time.  Development
instrumentation: it wraps the driver's functions and adds host clock
reads, so its fits run slightly slower than ``chip_smoke.py``'s.  Prints
one JSON line and writes it to ``chiprun_out/streamed_profile.json``.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--tile-rows", type=int, default=131_072)
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("streamed_profile: no CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile
    from mmlspark_tpu_torch.io import chunked
    from mmlspark_tpu_torch.lightgbm import GBDTParams, train_streamed
    from mmlspark_tpu_torch.lightgbm import core

    spent = collections.defaultdict(float)
    calls = collections.defaultdict(int)

    def timed(name, fn):
        def wrapped(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                spent[name] += time.perf_counter() - t0
                calls[name] += 1
        return wrapped

    core._TileStager.load = timed("stager_load", core._TileStager.load)
    core._TileStager._padded = timed("pinned_copy", core._TileStager._padded)
    core._TileStager.ready = timed("consumer_ready",
                                   core._TileStager.ready)
    prefetcher_init = chunked.TilePrefetcher.__init__

    def init(self, items, load_fn, **kw):
        prefetcher_init(self, items, timed("worker_load", load_fn), **kw)

    chunked.TilePrefetcher.__init__ = init

    rng = np.random.default_rng(0)
    X = rng.normal(size=(args.rows, 200)).astype(np.float32)
    y = (X[:, 0] + 0.5 * X[:, 1] + rng.normal(scale=0.3, size=args.rows)
         > 0).astype(np.float32)
    T = args.tile_rows
    train_streamed(X, y, GBDTParams(num_iterations=1, max_depth=2),
                   tile_rows=T)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    out = {"card": smi, "rows": args.rows, "tile_rows": T}
    for label, params in (
            ("leaf", GBDTParams(num_iterations=2, num_leaves=31,
                                objective="binary")),
            ("level", GBDTParams(num_iterations=4, max_depth=5,
                                 objective="binary"))):
        spent.clear()
        calls.clear()
        ex = train_streamed(X, y, params, tile_rows=T).extras
        tiles = calls["worker_load"]
        rec = {k: ex[k] for k in ("boosting_s", "binning_s",
                                  "prefetch_wait_s", "tile_compute_s",
                                  "prefetch_overlap_pct", "hist_passes",
                                  "grad_passes", "hist_pass_bytes", "h2d_s")}
        rec.update(
            tiles=tiles,
            worker_ms_per_tile=spent["worker_load"] / tiles * 1e3,
            pinned_copies_ms_per_tile=spent["pinned_copy"] / tiles * 1e3,
            make_tile_ms_per_tile=(spent["worker_load"]
                                   - spent["stager_load"]) / tiles * 1e3,
            consumer_ready_ms_per_tile=spent["consumer_ready"] / tiles * 1e3,
            h2d_GB_per_s=ex["h2d_bytes"] / max(ex["h2d_s"], 1e-9) / 1e9)
        out[label] = rec
        print(f"[{label}] " + ", ".join(f"{k} {v:.4g}" for k, v in
                                        rec.items()), flush=True)

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        train_streamed(X, y, GBDTParams(num_iterations=1, num_leaves=31,
                                        objective="binary"), tile_rows=T)
    launches = h2d_ms = acc_ms = fin_ms = 0.0
    for e in prof.events():
        if e.name == "cudaLaunchKernel":
            launches += 1
        elif e.device_type == torch.autograd.DeviceType.CUDA:
            ms = e.time_range.elapsed_us() / 1e3
            if "Memcpy HtoD" in e.name:
                h2d_ms += ms
            elif "hist_accumulate_kernel" in e.name:
                acc_ms += ms
            elif "frontier_finish_kernel" in e.name:
                fin_ms += ms
    out["leaf_tree_profile"] = {
        "cudaLaunchKernel": launches, "h2d_device_ms": h2d_ms,
        "hist_accumulate_ms": acc_ms, "frontier_finish_ms": fin_ms}
    print("[profile] one leaf-wise tree: " + json.dumps(
        out["leaf_tree_profile"]), flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "streamed_profile.json"),
              "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
