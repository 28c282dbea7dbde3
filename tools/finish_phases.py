"""Where the time of one ``frontier_finish`` launch goes, phase by phase.

    python3 tools/finish_phases.py SOURCE.cu [SOURCE.cu ...]

Each source is a ``frontier.cu`` of the one-launch finish design (the
repository's ``mmlspark_tpu_torch/csrc/frontier.cu``, or a development copy
of it).  The script builds two libraries from each with ``nvcc``: the
source as it is, and a copy with a clock read at each phase boundary of
``frontier_finish_kernel`` (thread 0 of every block writes ``clock64()``
into a buffer, and ``%globaltimer`` at the block's start and end).  With
each library in place of the package's, it calls the package's
``frontier_finish`` wrapper on the card at the bench's two shapes (1M
rows x 200 features, 255 bins, wide lanes): the leaf-wise N = 1 step in
the slot form (int32 carry) and the level-4 step (8 parents, dense).  It
reports the untraced kernel's device time from ``torch.profiler`` and,
from the traced copy, the mean and largest SM cycles of each phase over
the blocks, the last block's reduction, and the launch's span on the
global timer.  Phases: setup, decode/subtract/store, scan, gains, the
block's first max, counting in (the record, its fence and the atomic),
and the last block's reduction over the groups.  Writes ``chiprun_out/finish_phases.json``.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# marker k goes after its anchor, which the source must hold once
MARKS = [
    ("  const int row = blockIdx.y, grp = blockIdx.x;\n", 0),
    ("  const float hsc = gains ? a.scales[1] : 0.f;\n", 1),
    ("  if (!gains) return;\n  __syncthreads();\n", 2),
    ("      s_par[o][fl_c][3] = leaf_score(tg, th, a.l1, a.l2);\n    }\n"
     "  }\n  __syncthreads();\n", 3),
    ("  const int G = gridDim.x;\n", 4),
    ("    // the last block of the row to finish reduces over the feature "
     "groups\n", 5),
    ("  if (!s_last) return;\n", 6),
]
END = "  if (tid == 0) a.counter[row] = 0;"
PHASES = ["setup", "decode_store", "scan", "gains", "block_reduce",
          "count", "last_block_reduce"]
SLOTS = 12      # per block: clock64 at marks 0..7, globaltimer at 0, 5, 7
PRELUDE = r"""
__device__ long long* g_trace;
__device__ __forceinline__ long long g_now() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define TRACE(k)                                                        \
  if (threadIdx.x == 0) {                                               \
    long long* t_ = g_trace +                                           \
        ((long long)blockIdx.y * gridDim.x + blockIdx.x) * 12;          \
    t_[k] = clock64();                                                  \
    if (k == 0) t_[8] = g_now();                                        \
    if (k == 5) t_[9] = g_now();                                        \
    if (k == 7) t_[10] = g_now();                                       \
  }
"""
SETTER = r"""
extern "C" int finish_set_trace(void* p) {
  return (int)cudaMemcpyToSymbol(g_trace, &p, sizeof(p));
}
"""


def traced(text: str) -> str:
    for anchor, k in MARKS:
        if text.count(anchor) != 1:
            raise SystemExit(f"the anchor of marker {k} is not found once")
        text = text.replace(anchor, anchor + f"  TRACE({k});\n")
    if text.count(END) != 1:
        raise SystemExit("end anchor not found")
    text = text.replace(END, "  TRACE(7);\n" + END)
    head = "#include <stdint.h>\n"
    return text.replace(head, head + PRELUDE, 1) + SETTER


def build_all(sources, out_dir):
    from mmlspark_tpu_torch.kernels._build import NVCC_FLAGS, _nvcc
    jobs = {}
    for idx, src in enumerate(sources):
        with open(src) as f:
            text = f.read()
        for kind, body in (("plain", text), ("traced", traced(text))):
            path = os.path.join(out_dir, f"s{idx}_{kind}.cu")
            with open(path, "w") as f:
                f.write(body)
            lib = path[:-3] + ".so"
            jobs[(src, kind)] = (lib, subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", lib, path],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    from mmlspark_tpu_torch.kernels._build import _SIGNATURES
    for key, (path, proc) in jobs.items():
        out = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {key}:\n{out[-3000:]}")
        lib = ctypes.CDLL(path)
        for name, argtypes in _SIGNATURES.items():
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = ctypes.c_int
        lib.frontier_error_string.argtypes = [ctypes.c_int]
        lib.frontier_error_string.restype = ctypes.c_char_p
        if key[1] == "traced":
            lib.finish_set_trace.argtypes = [ctypes.c_void_p]
        regs = [ln.strip() for ln in out.splitlines() if "registers" in ln]
        libs[key] = (lib, regs)
    return libs


def device_ms(fn, reps=50) -> float:
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and "frontier_finish" in e.key) / 1e3 / reps


def main() -> int:
    if not torch.cuda.is_available():
        print("finish_phases: no CUDA device", file=sys.stderr)
        return 2
    sources = sys.argv[1:] or [os.path.join(
        ROOT, "mmlspark_tpu_torch", "csrc", "frontier.cu")]
    from mmlspark_tpu_torch.ops import cuda_histogram as CH
    from mmlspark_tpu_torch.ops.histogram import quantize_gradients
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,"
                          "clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True,
                         check=True).stdout.strip()
    libs = build_all(sources, tempfile.mkdtemp(prefix="finish_phases_"))
    dev = torch.device("cuda")
    n, F, B = 1_000_000, 200, 255
    gen = torch.Generator(device=dev).manual_seed(0)
    binned = torch.randint(0, B, (F, n), generator=gen, device=dev,
                           dtype=torch.uint8).t()
    g = torch.randn(n, generator=gen, device=dev)
    h = torch.rand(n, generator=gen, device=dev) * 0.25 + 1e-3
    qg, qh, gs, hs = quantize_gradients(g, h, 16, generator=gen)
    qg, qh = CH.to_int8(qg), CH.to_int8(qh)
    edge = torch.ones((F, B), dtype=torch.bool, device=dev)
    edge[:, B - 1] = False
    gp = CH.gain_params(gs, hs, torch.ones(F, dtype=torch.bool, device=dev),
                        edge, True, l2=1.0, min_data=20.0, min_hess=1e-3)
    lay = CH.lane_layout(n, n, 16)
    half = torch.rand(n, generator=gen, device=dev) < 0.5
    # N = 1: the parent (every row) in slot 2 of an int32 carry
    root = CH.hist_accumulate_plain(binned, qg, qh, torch.zeros(
        n, dtype=torch.int32, device=dev), 1, B, lay)
    L = 7
    carry = CH.FinishOut(
        torch.zeros((L + 1, F, B, 3), dtype=torch.int32, device=dev),
        torch.zeros(L + 1, device=dev),
        torch.zeros(L + 1, dtype=torch.int32, device=dev),
        torch.zeros(L + 1, dtype=torch.int32, device=dev),
        torch.zeros((L + 1, 3), device=dev))
    carry.hist[2] = CH.frontier_finish_plain(root, *lay)[0][0]
    acc1 = CH.hist_accumulate_plain(binned, qg, qh, torch.where(
        half, 0, -1).to(torch.int32), 1, B, lay)
    slot = {s: torch.tensor([s], device=dev) for s in (2, 5, L)}
    left = torch.ones((1,), dtype=torch.bool, device=dev)
    # level 4: 8 parents, the smaller children
    pid = torch.randint(0, 8, (n,), generator=gen, device=dev,
                        dtype=torch.int32)
    parent = CH.frontier_finish_plain(CH.hist_accumulate_plain(
        binned, qg, qh, pid, 8, B, lay), *lay)[0]
    acc8 = CH.hist_accumulate_plain(binned, qg, qh, torch.where(
        half, pid, -1).to(torch.int32), 8, B, lay)
    sl8 = torch.rand(8, generator=gen, device=dev) < 0.5
    calls = {
        "leaf_N1_slot": (lambda: CH.frontier_finish(
            acc1, *lay, None, left, gp, out=carry,
            out_slots=(slot[5], slot[L]), parent_slot=slot[2]), 1),
        "level4": (lambda: CH.frontier_finish(
            acc8, *lay, parent, sl8, gp, out=CH.dense_out(16, F, B, dev)), 8),
    }
    report = {"card": smi, "sources": {}}
    for src in sources:
        rec = {"registers": libs[(src, "plain")][1]}
        for name, (call, rows) in calls.items():
            CH._library = lambda lib=libs[(src, "plain")][0]: lib
            r = {"device_ms": device_ms(call)}
            lib = libs[(src, "traced")][0]
            CH._library = lambda lib=lib: lib
            blocks = rows * -(-F // CH._finish_plan(rows, F, CH._num_sms(
                dev.index)))
            buf = torch.zeros(blocks * SLOTS, dtype=torch.int64, device=dev)
            if lib.finish_set_trace(buf.data_ptr()) != 0:
                raise SystemExit("cudaMemcpyToSymbol failed")
            for _ in range(3):          # the last of three calls is kept
                buf.zero_()
                call()
            torch.cuda.synchronize()
            t = buf.view(blocks, SLOTS).cpu().numpy().astype(np.float64)
            d = np.diff(t[:, :6], axis=1)
            r["blocks"] = blocks
            r["cycles_mean"] = dict(zip(PHASES[:5], d.mean(0).tolist()))
            r["cycles_max"] = dict(zip(PHASES[:5], d.max(0).tolist()))
            last = t[:, 7] > 0
            r["last_blocks"] = int(last.sum())
            r["last_cycles_mean"] = {
                PHASES[5]: float((t[last, 6] - t[last, 5]).mean()),
                PHASES[6]: float((t[last, 7] - t[last, 6]).mean())}
            r["span_ns"] = float(t[:, 10][last].max() - t[:, 8].min())
            r["block_life_ns_mean"] = float((t[:, 9] - t[:, 8]).mean())
            r["first_block_start_to_last_start_ns"] = float(
                t[:, 8].max() - t[:, 8].min())
            rec[name] = r
            print(os.path.basename(src), name, json.dumps(r), flush=True)
        report["sources"][src] = rec
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "finish_phases.json"),
              "w") as f:
        json.dump(report, f, indent=1)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
