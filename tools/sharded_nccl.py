"""The sharded GBDT across cards over NCCL: one rank per card.

    python3 tools/sharded_nccl.py [--width 4]

Starts a world of ``--width`` ranks (``parallel.world.World``,
``backend="nccl"``, rank r on ``cuda:r``); each makes the bench data from
its seed (1M x 200 float32, 255 bins, 16 gradient levels) and fits
``train(shard_rows=True)`` for 8 iterations level-wise (``max_depth=5``)
and leaf-wise (31 leaves), as ``chip_smoke.py``'s sharded phase does on one
card over gloo.  Then this process fits the same on one card as a world of
one.  Fails unless every rank's booster equals world 1's bit for bit and
each rank launched both kernels.  Prints each rank's fit seconds, the
bytes all-reduced per tree and the seconds in ``all_reduce`` (timed
between device syncs), beside the cards' name and power limit; details go
to ``chiprun_out/sharded_nccl.json``.
"""
import argparse
import json
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < args.width:
        print(f"sharded_nccl: needs {args.width} CUDA cards", file=sys.stderr)
        return 2
    from mmlspark_tpu_torch.kernels import _build
    from mmlspark_tpu_torch.lightgbm import GBDTParams, train
    from mmlspark_tpu_torch.parallel.world import World
    _build.build()
    _build.load_library()
    _build.build_host()
    _build.load_host_library()
    smi = cs.nvidia_smi()
    fits = cs.SHARDED_FITS[:2]
    t0 = time.perf_counter()
    with World(args.width, backend="nccl", timeout_s=600) as w:
        ranks = w.run(cs.sharded_rank, fits=fits, held=False)
    world_s = time.perf_counter() - t0
    X, y = cs.bench_data(cs.N_ROWS, seed=0)
    rec = {"card": smi, "width": args.width, "world_s": world_s, "fits": {}}
    for label, kw in fits:
        per = [r["fits"][label] for r in ranks]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        one = train(X, y, GBDTParams(num_iterations=8, objective="binary",
                                     use_quantized_grad=True, **kw),
                    shard_rows=True)
        torch.cuda.synchronize()
        one_s = time.perf_counter() - t1
        arrays1 = {k: np.asarray(getattr(one.booster, k))
                   for k in cs.BOOSTER_ARRAYS}
        for r, f in enumerate(per):
            cs.same_arrays(arrays1, f["arrays"],
                           f"nccl ({label}) world 1 vs rank {r}")
            if min(f["launches"].values()) <= 0:
                raise AssertionError(f"nccl ({label}) rank {r} launched "
                                     f"{f['launches']}")
        trees = per[0]["trees"]
        rec["fits"][label] = {
            "world_1_s": one_s,
            "ranks": [{k: v for k, v in f.items() if k != "arrays"}
                      for f in per]}
        print(f"[nccl] {smi} x{args.width} | ({label}) fit "
              + ", ".join(f"rank {r} {f['fit_s']:.2f} s"
                          for r, f in enumerate(per))
              + f" (world 1 {one_s:.2f} s); every rank = world 1 bit for "
              f"bit; accuracy {per[0]['accuracy']:.4f}; all_reduce "
              f"{per[0]['allreduce']['all_reduce_calls']} calls, "
              f"{per[0]['allreduce']['all_reduce_bytes'] / trees / 1e6:.3f}"
              f" MB a tree a rank, "
              + ", ".join(f"rank {r} {f['allreduce']['all_reduce_s']:.3f} s"
                          for r, f in enumerate(per)), flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "sharded_nccl.json"),
              "w") as f:
        json.dump(rec, f, indent=1, default=str)
    print(f"[nccl] world of {args.width} (start, data, 2 fits) "
          f"{world_s:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
