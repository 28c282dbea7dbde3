"""How many tiles the out-of-core loop holds on the card at its peak.

    python3 tools/streamed_peak.py [--tree DIR --label NAME] [--where]

Makes ``bench.py``'s GBDT data (1M x 200, N(0, 1) features, label
``x0 + 0.5 x1 + noise > 0``, seed 0) and fits it with
``lightgbm.train_streamed`` on the card at 131,072 rows a tile, level-wise
(``max_depth=5``) and leaf-wise (31 leaves), 3 iterations, twice each, as
they run and with the consumer slowed by 5 ms between taking a tile and
using it (which gives the prefetch worker time to stage the next tile
first).  For every fit it reads ``torch.cuda.max_memory_allocated`` above
what was allocated before the fit, and divides it by one tile's bytes
(uint8 bins, int8 quantized gradients and hessians, int32 node ids:
27.0 MB).  ``--tree`` imports ``mmlspark_tpu_torch`` from another
checkout (an A/B on one card).  ``--where`` fits once per case instead,
under ``torch.cuda.memory._record_memory_history``, and lists what was
allocated at the peak (size, and the innermost frame of this package
that allocated it), counting a block as freed when its tensor is
(``free_requested``), as ``max_memory_allocated`` does.  Prints one
JSON line and writes it to ``chiprun_out/streamed_peak*.json``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=ROOT)
    ap.add_argument("--label", default="")
    ap.add_argument("--where", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("streamed_peak: no CUDA device", file=sys.stderr)
        return 2
    from mmlspark_tpu_torch.lightgbm import GBDTParams, train_streamed
    from mmlspark_tpu_torch.lightgbm import core

    rows, feats, T = 1_000_000, 200, 131_072
    rng = np.random.default_rng(0)
    X = rng.normal(size=(rows, feats)).astype(np.float32)
    y = (X[:, 0] + 0.5 * X[:, 1] + rng.normal(scale=0.3, size=rows)
         > 0).astype(np.float32)
    # uint8 bins, int8 quantized g and h, int32 node ids
    tile_bytes = T * feats + 2 * T + T * 4
    ready = core._TileStager.ready

    def slow_ready(self, tile):
        time.sleep(0.005)
        return ready(self, tile)

    train_streamed(X[:T], y[:T], GBDTParams(num_iterations=1, max_depth=2),
                   tile_rows=T // 4)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    out = {"card": smi, "tree": args.label or args.tree, "rows": rows,
           "tile_rows": T, "tile_bytes": tile_bytes, "fits": []}
    for slowed in (False, True):
        core._TileStager.ready = slow_ready if slowed else ready
        for growth, shape in (("level", {"max_depth": 5}),
                              ("leaf", {"num_leaves": 31})):
            params = GBDTParams(num_iterations=3,
                                objective="binary", **shape)
            for rep in range(1 if args.where else 2):
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                if args.where:
                    torch.cuda.memory._record_memory_history(
                        stacks="python", max_entries=1_000_000)
                train_streamed(X, y, params, tile_rows=T)
                torch.cuda.synchronize()
                above = torch.cuda.max_memory_allocated() - base
                rec = {"growth": growth, "slowed_ms": 5 if slowed else 0,
                       "rep": rep, "base_bytes": base, "above_bytes": above,
                       "tiles": above / tile_bytes}
                if args.where:
                    snap = torch.cuda.memory._snapshot()
                    torch.cuda.memory._record_memory_history(enabled=None)
                    rec["at_peak"] = live_at_peak(snap)
                    for row in rec["at_peak"]["blocks"]:
                        print(f"    {row['bytes'] / 1e6:8.2f} MB x "
                              f"{row['count']} {row['site']}", flush=True)
                out["fits"].append(rec)
                print(f"[{out['tree']}] {growth} slowed {rec['slowed_ms']} "
                      f"ms rep {rep}: {above / 1e6:.1f} MB above "
                      f"{base / 1e6:.1f} MB = {rec['tiles']:.2f} tiles",
                      flush=True)
    core._TileStager.ready = ready
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    name = f"streamed_peak{'_' + args.label if args.label else ''}.json"
    with open(os.path.join(ROOT, "chiprun_out", name), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)
    return 0


def live_at_peak(snap) -> dict:
    """Replay the allocator's trace: the blocks allocated at the moment
    the allocated total peaked, grouped by size and allocating frame."""
    live, total, peak, at_peak = {}, 0, 0, {}
    for ev in snap["device_traces"][0]:
        if ev["action"] == "alloc":
            live[ev["addr"]] = (ev["size"], site_of(ev.get("frames", [])))
            total += ev["size"]
            if total > peak:
                peak, at_peak = total, dict(live)
        elif ev["action"] == "free_requested" and ev["addr"] in live:
            total -= live.pop(ev["addr"])[0]
    groups = {}
    for size, site in at_peak.values():
        key = (size, site)
        groups[key] = groups.get(key, 0) + 1
    blocks = sorted(({"bytes": s, "count": c, "site": site}
                     for (s, site), c in groups.items()),
                    key=lambda r: -r["bytes"] * r["count"])
    return {"peak_bytes": peak, "blocks": blocks[:12]}


def site_of(frames) -> str:
    """The innermost frame in this package, else the innermost frame."""
    for f in frames:
        if "mmlspark_tpu_torch" in f["filename"]:
            name = f["filename"].split("mmlspark_tpu_torch")[-1]
            return f"mmlspark_tpu_torch{name}:{f['line']} {f['name']}"
    return f"{frames[0]['filename']}:{frames[0]['line']}" if frames else "?"


if __name__ == "__main__":
    sys.exit(main())
