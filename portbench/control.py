#!/usr/bin/env python3
"""Readings of a cell's comparisons for the program and for what can
stand in its place, seed after seed in one process: the numbers each
limit in ``limits/<cell>.json`` is set from.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3
        [--candidates program,bfloat16] [--seconds 5]

For each seed the cell's driver makes the inputs and warms up, and runs
a short window (at least one item), by ``run.py``'s own ``measure``; the
reference then judges
what the window produced and, in the program's place, each other
candidate: the control one precision below the configuration's
(``bfloat16``) and, for fit cells, the planted faults (``stale``,
``half``, ``altered``; ``reference/judge.py``).  One JSON line per seed
and candidate.  Nothing here runs in the benchmark's own runs.
"""
import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None, device=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--candidates", default="program,bfloat16")
    ap.add_argument("--seconds", type=float, default=0.0)
    args = ap.parse_args(argv)
    from portbench.run import CACHES, measure, start
    for var, sub in CACHES.items():
        os.environ[var] = os.path.join(ROOT, ".portbench_cache", sub)
    import torch
    from portbench.harness import bench
    spec = bench.benchmark(ROOT)
    if device is None:
        if not torch.cuda.is_available():
            print("control: no CUDA card", file=sys.stderr)
            return 2
        device = "cuda"
    device = torch.device(device)
    candidates = tuple(args.candidates.split(","))
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        run, driver = start(spec, args.workload, seed, args.seconds, False,
                            device)
        measure(run, driver, t0)
        i = len(run.records)
        judge = getattr(driver, "judge_fits", None) or driver.judge_calls
        t1 = time.perf_counter()
        readings = judge(run, candidates)
        for c in candidates:
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "candidate": c, "items": i,
                              "readings": readings[c],
                              "setup_window_s": t1 - t0,
                              "judge_s": time.perf_counter() - t1}),
                  flush=True)
        del run, driver, readings
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
