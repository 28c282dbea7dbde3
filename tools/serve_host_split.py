"""Where the continuous engine's host time goes, on the card.

    python3 tools/serve_host_split.py [--reps 3]

Replays ``chip_smoke.py``'s serve trace (bench.py's continuous trace at
bench.py's decode LM) through the ticked drain and through
``ContinuousDecoder``, and books the continuous engine's wall time per
join (``_join``: the arrival's prefill and its token fetch), per batch
step (``_advance``: extends, uploads, the forward and the token fetch)
and the rest of the loop (admission, leaves, ``drive_stream``), beside
the ticked drain's wall per forward.  Each engine runs ``--reps`` times in
turns (ticked, continuous, continuous, ticked, ...) after one warm run;
every number is printed per run.  Needs one card.
"""
from __future__ import annotations

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
from mmlspark_tpu_torch.models import (ModelRunner,  # noqa: E402
                                       TransformerEncoder)
from mmlspark_tpu_torch.models.runner import ContinuousDecoder  # noqa: E402


def ticked(runner, reqs):
    torch.cuda.synchronize()
    t0, clock_steps, i, forwards = time.perf_counter(), 0, 0, 0
    while i < len(reqs):
        clock_steps = max(clock_steps, reqs[i][3])
        group = []
        while i < len(reqs) and reqs[i][3] <= clock_steps \
                and len(group) < cs.SERVE_SLOTS:
            group.append(reqs[i])
            i += 1
        gmax = max(r[2] for r in group)
        stacked = np.zeros((len(group), cs.SERVE_PROMPT), np.int32)
        for j, r in enumerate(group):
            stacked[j, :r[1]] = r[0]
        res = runner.decode(stacked, lengths=[r[1] for r in group],
                            max_new_tokens=gmax, kv_layout="paged",
                            page_size=cs.SERVE_PAGE,
                            batch_bucket=cs.SERVE_SLOTS,
                            prompt_bucket=cs.SERVE_PROMPT)
        forwards += 1 + res.steps
        clock_steps += gmax
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return {"wall_s": wall, "forwards": forwards,
            "ms_per_forward": wall * 1e3 / forwards}


def continuous(runner, reqs):
    spent = {"_join": [0.0, 0], "_advance": [0.0, 0]}
    originals = {name: getattr(ContinuousDecoder, name) for name in spent}

    def timed(name):
        def wrapper(self, *args):
            t0 = time.perf_counter()
            try:
                return originals[name](self, *args)
            finally:
                spent[name][0] += time.perf_counter() - t0
                spent[name][1] += len(args[0]) if name == "_join" else 1
        return wrapper

    dec = runner.decode_stream(slots=cs.SERVE_SLOTS,
                               prompt_bucket=cs.SERVE_PROMPT,
                               max_new_tokens=cs.SERVE_NEW,
                               page_size=cs.SERVE_PAGE)
    dec.warmup()
    try:
        for name in spent:
            setattr(ContinuousDecoder, name, timed(name))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cs.drive_stream(dec, reqs, lambda r: {"max_new_tokens": r[2]})
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for name, fn in originals.items():
            setattr(ContinuousDecoder, name, fn)
        dec.close()
    joins, j_n = spent["_join"]
    steps, s_n = spent["_advance"]
    return {"wall_s": wall, "joins": j_n, "steps": s_n,
            "ms_per_forward": wall * 1e3 / (j_n + s_n),
            "ms_per_join": joins * 1e3 / j_n,
            "ms_per_step": steps * 1e3 / s_n,
            "rest_ms": (wall - joins - steps) * 1e3}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("serve_host_split: no CUDA device", file=sys.stderr)
        return 2
    print(cs.nvidia_smi(), flush=True)
    lm = TransformerEncoder(**cs.SEQ_LM,
                            generator=torch.Generator().manual_seed(60))
    runner = ModelRunner(module=lm, name="split")
    reqs = cs.serve_trace(cs.SEQ_LM["vocab_size"])
    ticked(runner, reqs)
    continuous(runner, reqs)                                   # warm
    runs = []
    for rep in range(args.reps):
        order = ("ticked", "continuous") if rep % 2 == 0 else \
            ("continuous", "ticked")
        for name in order:
            rec = (ticked if name == "ticked" else continuous)(runner, reqs)
            runs.append({"engine": name, **rec})
            print(json.dumps(runs[-1]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
