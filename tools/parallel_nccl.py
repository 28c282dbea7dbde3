"""The rest of ``parallel/`` across cards over NCCL: one rank per card.

    python3 tools/parallel_nccl.py [--width 4] [--legs bcde]

Runs legs (b)-(e) of ``chip_smoke.py``'s ``parallel`` phase in a world of
``--width`` ranks (``parallel.world.World``, ``backend="nccl"``, rank r on
``cuda:r``), where ``all_gather`` and ``ppermute`` take NCCL's own
``all_gather`` and send/recv instead of the slot all_reduce of ranks that
share a card: (b) ResNet-50 trained data-parallel at full width (32 images
a rank), preempted and resumed at the same width and at world 1; (c) ring
attention over ``seq`` = width against dense attention, and the
sequence-parallel step on bench.py's LM against world 1's blockwise step;
(d) a pipeline of ``width`` stages; (e) ``MoELayer(E=8)`` over ``expert``
= width against world 1.  Each leg is held as in ``chip_smoke.py``; each
prints one JSON line beside the cards' name and power limit.  Details go
to ``chiprun_out/parallel_nccl.json``.
"""
import argparse
import json
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=4)
    ap.add_argument("--legs", default="bcde")
    args = ap.parse_args()
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < args.width:
        print(f"parallel_nccl: needs {args.width} CUDA cards",
              file=sys.stderr)
        return 2
    smi = cs.nvidia_smi()
    t0 = time.perf_counter()
    cs.parallel_legs(torch.device("cuda"), smi, width=args.width,
                     backend="nccl", legs=args.legs)
    rec = cs.DETAIL["parallel_nccl"]
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "parallel_nccl.json"),
              "w") as f:
        json.dump(rec, f, indent=1, default=str)
    print(f"[nccl] {smi} x{args.width} | legs {args.legs} held in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
