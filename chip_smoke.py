"""Drive the PyTorch/CUDA port (``mmlspark_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases; any failure exits nonzero and prints no result line:

1. card   — ``nvidia-smi`` name and power limit, the torch device name.
2. build  — compile ``mmlspark_tpu_torch/csrc``: the kernels with nvcc,
   the host binning plane ``binning.cpp`` with g++ (each timed).
3. kernels against their plain PyTorch versions on the card, at the GBDT
   bench shapes (1M rows x 200 features, 255 bins): ``hist_accumulate`` at
   N = 1, 8, 16, 64 nodes in every lane layout and at its edges (128-bin
   gradients at their extremes, every row in one node and one bin, an
   all-inactive frontier, a ragged row count, and one streamed tile of
   131,072 rows whose last 48,576 are padded with node -1, at N = 1 and
   16, also timed); ``frontier_finish`` in
   direct, subtract and depth-gated modes, in the leaf-wise slot form (the
   parent read from the carry and both children written into it; int32
   and int16 carries, the step's gate on and off) and at its edges (2 and
   256 bins, one feature, 203 features, ungated 0/0 gains), each dense
   with 8 parents and in the slot form.  Histograms must be bit-identical;
   best splits equal, except where the two best gains are within 1e-6
   relative (an f32 near-tie), with left stats within rtol 1e-5; the slot
   form and the edges bit-identical in every array.  Then each kernel is
   timed at the main path's level-4 frontier step (8 parents, smaller
   children only; ``frontier_finish`` into dense arrays, the form
   ``frontier_step`` gives the level-wise grower), ``frontier_finish``
   also at the leaf-wise N = 1 step in the slot form, and both at every
   level of a depth-5 tree: device
   time from ``torch.profiler`` (``ms``) beside CUDA events around
   back-to-back wrapper calls (``wrapper_ms``), with the plain version
   and one library call timed by CUDA events.
4. slice  — ``LightGBMClassifier(max_depth=5, num_iterations=8)`` fits on
   1M x 200 binary data (the label of ``bench.py``'s GBDT phase), then
   transforms 100k fresh rows.  The kernels' launch counts are zeroed just
   before the fit and read just after the transform: each kernel must have
   run (8 trees x 5 levels = 40 launches each).  Accuracy must reach 0.9;
   the card's leaf walk must equal the CPU's; one depth-5 tree grown on the
   card must equal the same tree grown by the plain versions on the CPU.
5. leaf   — the leaf-wise grower and the boosting modes.  31-leaf trees
   grown on the card (50k x 20 uncapped and at ``max_depth=4``, int32
   carry; 2,000 rows, int16 carry) equal the CPU plain-version trees, and
   the card's growth runs under ``torch.cuda.set_sync_debug_mode("error")``
   (the step loop never waits for the card).  ``LightGBMClassifier()`` with
   its defaults (leaf-wise, 31 leaves) fits 8 iterations on the bench data
   with exactly 8 x 31 = 248 launches of each kernel, reaches accuracy 0.9
   on 100k fresh rows, and its card and CPU leaf walks agree; ``train()``
   phases and a profiled fit give the busy share, the top kernels, the
   ``cudaLaunchKernel`` calls per tree and the per-step kernel times of one
   tree beside each step's bound.  Bagging,
   GOSS, RF and DART each fit leaf-wise at 200k x 200 for 4 iterations and
   reach accuracy 0.85 on 50k fresh rows.
6. data   — edges on the host and bins on the card at 1M x 208 (the bench
   features plus NaN, +inf, -inf, integer codes, the leading -inf edge,
   a mix, ±inf alone and a constant): the card's train-route bins
   bit-identical to the port's host route, the numpy route's semantics on
   the card bit-identical to numpy's, ``bin_matrix`` on the card
   bit-identical to its CPU run; the edges, the transfer, the card apply
   and the C++ and numpy host applies timed.  (Every fit above already
   bins this way; ``fit_phases`` prints ``binning_s`` and its parts.)
7. cat    — categorical splits and the regression objectives.  50k x 20
   categorical trees (one-vs-rest and sorted-subset columns) grown on the
   card equal the CPU trees in every array, the leaf-wise one under sync
   debug mode "error";  ``LightGBMClassifier(categorical_features=...)``
   on the bench data with 10 columns of codes (5 of 3, 5 of 64) and a
   planted category subset in the label, leaf-wise defaults and then
   ``max_depth=5``, 8 iterations each: 248 and 40 launches of each kernel
   (one histogram build per step or level), accuracy 0.9 on 100k fresh
   rows, card walk = CPU walk, then each fit's ``train()`` phases and
   profile as in the leaf phase; one fit per new regression objective at
   200k x 200 for 4 iterations, its default metric finite and falling.
8. multiclass — K = 3 trees per iteration at 50k x 20 grown from the
   columns of the (n, 3) gradients equal the CPU trees in every array
   (leaf-wise under sync debug mode "error", and level-wise);
   ``LightGBMClassifier()`` on 7-class labels (UCI Covertype's class count;
   the argmax of 7 fixed linear projections of the first 4 bench features
   plus noise) at 1M x 200, leaf-wise defaults and then ``max_depth=5``, 8
   iterations each: 8 x 7 x 31 = 1,736 and 8 x 7 x 5 = 280 launches of
   each kernel, accuracy 0.8 on 100k fresh rows, ``multi_logloss`` on them
   falling at every iteration, card walk = CPU walk; both fits profiled.
9. ranker — LambdaRank at 1M x 136 (MSLR-WEB30K's width) in ragged queries
   of 16-256 rows (~7,400), relevance 0-4 planted from two features: the
   lambdas on the card equal the CPU's within rtol 1e-5, atol 1e-6 at
   all-tied scores, after one tree and with rows outside every query (the
   card's pass under sync debug mode "error"); the pass timed (CUDA events)
   with its peak memory; one tree from the card's tied lambdas at the full
   1M x 136 x 255 with each of its 31 + 31 kernel calls bit-identical to
   the plain version on the same inputs, and one from the first ~50k rows'
   queries at 136 features on the card (sync debug mode "error") equal to
   the CPU tree in every array; ``LightGBMRanker()`` defaults for 8 iterations:
   248 launches of each kernel, NDCG@10 0.9 on 200 held-out queries, above
   a random ranking's; the fit profiled.
10. streamed — out-of-core ``train_streamed`` and checkpoints.  One tile
   (131,072 x 200 uint8) staged host -> card in three layouts, each
   timed with the kernel on it (PERF.md says which the driver keeps);
   50k x 20 in tiles of 8,192 (7 tiles, the last padded): 3 quantized
   iterations level-wise (``max_depth=4``) and leaf-wise
   (``num_leaves=15``) on the card equal the CPU's in every booster
   array; the bench data at 1M x 200 in tiles of 131,072 (8 tiles, the
   last with 82,496 real rows), level-wise ``max_depth=5`` (5 passes x 8
   tiles x 8 iterations = 320 launches of each kernel) and leaf-wise
   ``num_leaves=31`` (one launch per tile per pass, up to 1,984), each
   with its binning and boosting times, prefetch wait and overlap, bytes
   per pass and the copy stream's rate, accuracy >= 0.9 on 100k fresh
   rows, and the leaf-wise fit's peak device memory under 150 MB; the
   level-wise fit at 262,144 rows a tile (4 tiles, 5 x 4 x 8 = 160
   launches of each kernel, accuracy >= 0.9) with edges equal to the
   host sketch fed those same tiles (1M rows are above the sketch's
   200,000-row sample cap, where the edges follow the tile width, as the
   JAX package's do; whether its booster differs from the 131,072-row
   fit's is printed, not gated); the leaf-wise fit preempted after
   iteration 3 (``request_preemption``) and resumed at the same width,
   bit-identical to the uninterrupted one; below the cap, the bench
   data's first 196,608 rows preempted at 32,768 rows a tile and resumed
   at 65,536, bit-identical to the uninterrupted fit; a leaf-wise
   ``train()`` fit preempted and resumed: tree structure equal, leaf
   values within 1e-6.
11. dnn    — deep-learning scoring, no JAX on the card: the committed
   ``artifacts/model_repo/ShapesResNet20`` through the port's repo and
   ``JaxModel`` (batch 256) on the trainer's 8,000-image holdout,
   accuracy within 0.002 of ``eval.json``, logits card = CPU on 512
   images; ResNet-50 at full width (224 x 224 x 3, 1000 classes, 2048-d
   features, every weight and BN statistic seeded): features of 8 images
   card = CPU in float32 (TF32 off) and bfloat16 = float32 on the card,
   each within its stated tolerance; backbone images/s at batch 256 in
   float32 and bfloat16 (CUDA events around normalize + ``features=True``),
   FLOPs per image from the layer shapes, the share of the dtype's dense
   peak and the peak memory; ``ImageFeaturizer`` end to end on 10,000
   seeded 32 x 32 x 3 uint8 images (resize to 224 and normalize on the
   card, bfloat16 backbone, batch 256): wall images/s and its split (host
   stacking, host -> card, device, card -> host), the first 4 images'
   features = the backbone's on the same resized input; the committed
   ONNX ``DigitsMLP``: logits card = CPU on 256 seeded inputs.  One
   summary line; details in the detail file.
12. seq    — the sequence models, no JAX on the card.  (a) Decode at
   ``bench.py``'s LM (vocab 512, embed 256, 4 heads, 4 layers, mlp 512,
   max_len 4096, causal, float32, seeded weights) through
   ``ModelRunner.decode``: bench.py's arm (8 x 16-token prompts, 32 new
   tokens) and 64 ragged prompts of 16-128 tokens with 128 new tokens
   and ``eos_id`` the token the model emits most, each dense and paged at
   page sizes 64 and 16: greedy tokens dense = paged bit-identical,
   collected logits within 1e-4 of dense, the card's tokens = the CPU's
   (except from a near-tie step, where the CPU's top two logits lie
   within 1e-4, reported) and logits within 1e-4, every page back in its
   pool; tokens/s (CUDA events around the call, and wall), steps,
   ``pages_peak``, cache bytes per sequence, peak memory; the dense and
   16-token-page decodes profiled (device time per forward, busy share,
   launches per forward, top kernels).  (b)
   ``TransformerEncoder`` at its defaults (vocab 512) on 8 x 4,096 tokens
   through ``JaxModel``: dense = blockwise = ring and card = CPU (2
   sequences) within 1e-4 of the outputs' largest magnitude;
   sequences/s and peak memory per mode.  (c) BASELINE config 5:
   ``BiLSTMTagger`` defaults, vocab 200, 3 tags, ``JaxModel`` at batch
   256 on 16,384 x 24 and 1,024 x 512 tokens: tokens/s, card = CPU
   within 1e-4 on 256 sequences each.  (d) ``export_gbdt`` of a booster
   fitted on the card, imported on the card, = ``raw_scores`` within
   1e-5; ``export_resnet`` of seeded ResNet-50 weights, imported, within
   1e-4 of the port's ResNet-50; a small torch CNN through
   ``torch_to_jax_model`` within 1e-5 of the module's own output.
13. results — one ``{"kernels": [...]}`` line (``launches`` sums the
   level-wise fit + transform, the leaf-wise fit, the two categorical
   fits, the two multiclass fits, the ranker fit and the two streamed
   fits, split in ``launches_by_path``; the dnn and seq phases run no
   kernel of this repository: the JAX package runs those paths in XLA,
   outside any Pallas kernel, and the port in cuDNN/cuBLAS and eager
   PyTorch), the card's name and power limit, and the last line
   ``{"ok": true, "device": {...}}``.

Details (per-level and per-step kernel times, every comparison) go to
``chiprun_out/chip_smoke_detail.json``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
N_ROWS, N_FEAT, N_BINS, QUANT_BINS = 1_000_000, 200, 255, 16
STREAM_TILE = 131_072           # train_streamed's tile rows at 1M x 200
HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
SCALAR_OPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
SOURCE = "mmlspark_tpu_torch/csrc/frontier.cu"
REPLACES = {"hist_accumulate": "mmlspark_tpu/ops/pallas_histogram.py:199",
            "frontier_finish": "mmlspark_tpu/ops/pallas_histogram.py:240"}
DETAIL = {}


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls, after
    one warm-up call, between two CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: float, ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / SCALAR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def leaf_finish_bytes(C: int, F: int, B: int, width: int,
                      root: bool = False) -> int:
    """Bytes a leaf-wise ``frontier_finish`` call must move: the lane sums,
    the parent read from the carry and the children written into it (both
    at the carry's dtype ``width``), the masks, scales and slots, and each
    child's best split (gain, feature, bin, left sums; the root also its
    totals)."""
    if root:
        return (C * F * B * 4 + F * B * 3 * width + F + F * B + 1 + 8 + 8
                + 36)
    return (C * F * B * 4 + 3 * F * B * 3 * width + F + F * B + 1 + 8
            + 1 + 24 + 2 * 24)


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def best_error(kernel_best, plain_best) -> float:
    """Compare two (N_out, 9) best-split records; raise unless the picks are
    equal or an f32 near-tie.  Returns the max abs difference."""
    k, p = kernel_best.double().cpu(), plain_best.double().cpu()
    same = (k[:, 1] == p[:, 1]) & (k[:, 2] == p[:, 2])
    tie = (k[:, 0] - p[:, 0]).abs() <= 1e-6 * p[:, 0].abs()
    if not bool((same | tie).all()):
        raise AssertionError(f"best splits differ:\n{k}\n{p}")
    np.testing.assert_array_equal(k[:, 6:].numpy(), p[:, 6:].numpy())
    ks, ps = k[same], p[same]
    fin = torch.isfinite(ps[:, 0])
    np.testing.assert_allclose(ks[fin][:, [0, 3, 4, 5]].numpy(),
                               ps[fin][:, [0, 3, 4, 5]].numpy(), rtol=1e-5,
                               atol=1e-6)
    d = (ks - ps).abs()
    d[~torch.isfinite(d)] = 0.0          # -inf == -inf at gated nodes
    return float(d.max()) if d.numel() else 0.0


def device_ms(fn, reps: int, names) -> float:
    """Mean device time per call of ``fn`` spent in the kernels named by
    ``names``, from ``torch.profiler`` over ``reps`` calls after one
    warm-up: kernel time only, without the wrapper's host work or the
    allocations and memsets around the launch.  The profiler has been seen
    to drop a kernel record of a window (49 of 50 on an H100); such a
    window is profiled once more, and a second short one raises.  Each
    short window and the one after it go to ``DETAIL["short_profiler_
    windows"]`` with their launch counts."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    seen = []
    for attempt in range(2):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total, calls = 0.0, 0
        for evt in prof.key_averages():
            if evt.device_type == torch.autograd.DeviceType.CUDA and any(
                    name in evt.key for name in names):
                total += evt.self_device_time_total
                calls += evt.count
        seen.append(calls)
        if attempt:
            DETAIL.setdefault("short_profiler_windows", []).append(
                {"kernels": list(names), "calls": reps,
                 "launches_seen": seen})
        if calls >= reps:
            return total / 1e3 / reps
        log(f"[profiler] saw {calls} launches of {names} in {reps} calls"
            + ("; profiling the window again" if attempt == 0 else ""))
    raise AssertionError(f"the profiler saw {calls} launches of {names} in "
                         f"{reps} calls, twice")


KERNEL_NAMES = {"hist_accumulate": ("hist_accumulate_kernel",),
                "frontier_finish": ("frontier_finish_kernel",)}


def same_record(a, b) -> bool:
    """Bit-identical, with NaN equal to NaN (ungated 0/0 gains)."""
    if a.is_floating_point():
        return torch.equal(a.isnan(), b.isnan()) and torch.equal(
            a.nan_to_num(nan=7.0), b.nan_to_num(nan=7.0))
    return torch.equal(a, b)


def slot_step(CH, acc, lay, carry, gp, j, at_j, at_new):
    """The leaf-wise N = 1 step in the slot form, on the kernel and on the
    plain version, each from its own copy of ``carry``; raises unless every
    array of the two copies is bit-identical.  Returns the kernel's copy."""
    left = torch.ones((1,), dtype=torch.bool, device=acc.device)
    got = CH.FinishOut(*(x.clone() for x in carry[:5]))
    ref = CH.FinishOut(*(x.clone() for x in carry[:5]))
    CH.frontier_finish(acc, *lay, None, left, gp, out=got,
                       out_slots=(at_j, at_new), parent_slot=j)
    CH.frontier_finish_plain(acc, *lay, None, left, gp, out=ref,
                             out_slots=(at_j, at_new), parent_slot=j)
    torch.cuda.synchronize()
    for name, x, y in zip(got._fields[:5], got, ref):
        if not same_record(x, y):
            raise AssertionError(f"frontier_finish slot form: {name} "
                                 f"differs")
    return got


def kernel_phase(dev):
    from mmlspark_tpu_torch.ops import cuda_histogram as CH
    from mmlspark_tpu_torch.ops.histogram import _pack_lanes, \
        quantize_gradients

    n, F, B = N_ROWS, N_FEAT, N_BINS
    gen = torch.Generator(device=dev).manual_seed(0)
    binned = torch.randint(0, B, (F, n), generator=gen, device=dev,
                           dtype=torch.uint8).t()       # feature-major
    g = torch.randn(n, generator=gen, device=dev)
    h = torch.rand(n, generator=gen, device=dev) * 0.25 + 1e-3
    qg, qh, gs, hs = quantize_gradients(g, h, QUANT_BINS, generator=gen)
    qg, qh = CH.to_int8(qg), CH.to_int8(qh)
    errs = {"hist_accumulate": 0.0, "frontier_finish": 0.0}
    checks = []

    def node_ids(N, per_node, rows=n):
        if per_node is None:
            return torch.randint(0, N, (rows,), generator=gen, device=dev,
                                 dtype=torch.int32)
        ids = torch.full((rows,), -1, dtype=torch.int32, device=dev)
        sel = torch.randperm(rows, generator=gen, device=dev)[:per_node * N]
        ids[sel] = (torch.arange(per_node * N, device=dev) % N) \
            .to(torch.int32)
        return ids

    def check_accumulate(name, bins, q_g, q_h, ids, N, bound, quant_bins,
                         decode=False):
        lay = CH.lane_layout(bins.shape[0], bound, quant_bins)
        acc = CH.hist_accumulate(bins, q_g, q_h, ids, N, B, lay)
        acc_p = CH.hist_accumulate_plain(bins, q_g, q_h, ids, N, B, lay)
        torch.cuda.synchronize()
        if not torch.equal(acc, acc_p):
            raise AssertionError(f"hist_accumulate differs: {name} "
                                 f"{lay.mode}")
        if decode:
            hist, _ = CH.frontier_finish(acc, *lay)
            hist_p, _ = CH.frontier_finish_plain(acc, *lay)
            torch.cuda.synchronize()
            if not torch.equal(hist, hist_p):
                raise AssertionError(f"decode differs: {name} {lay.mode}")
        checks.append({"kernel": "hist_accumulate" + "+decode" * decode,
                       "case": name, "nodes": N, "layout": lay.mode,
                       "bit_identical": True})
        log(f"[kernels] hist_accumulate {name:22s} N={N:2d} {lay.mode:4s}: "
            f"bit-identical")
        return acc

    # hist_accumulate + decode, every lane layout, N = 1, 8, 16, 64
    for N in (1, 8, 16, 64):
        for per_node in (None, 4000, 128):        # wide, 2ch, all3
            check_accumulate("random", binned, qg, qh,
                             node_ids(N, per_node), N, per_node or n,
                             QUANT_BINS, decode=True)
    # the edges: 128-bin gradients at their extremes, every row on one
    # address, no active row, and a ragged row count
    qg128 = torch.randint(-64, 65, (n,), generator=gen, device=dev) \
        .to(torch.int8)
    qh128 = torch.randint(0, 128, (n,), generator=gen, device=dev) \
        .to(torch.int8)
    qg128[: n // 3], qh128[: n // 3] = -64, 127
    qg128[n // 3: n // 2], qh128[n // 3: n // 2] = 64, 127
    for per_node in (None, 4000, 60):
        check_accumulate("quant_bins=128 extremes", binned, qg128, qh128,
                         node_ids(8, per_node), 8, per_node or n, 128)
    one_bin = torch.full((F, n), 7, dtype=torch.uint8, device=dev).t()
    lo, hi = torch.full_like(qg128, -64), torch.full_like(qh128, 127)
    check_accumulate("one node, one bin", one_bin, lo, hi,
                     torch.full((n,), 5, dtype=torch.int32, device=dev), 8,
                     n, 128)
    del one_bin
    acc_none = check_accumulate(
        "all-inactive frontier", binned, qg, qh,
        torch.full((n,), -1, dtype=torch.int32, device=dev), 8, n // 2 + 16,
        QUANT_BINS)
    if acc_none.any():
        raise AssertionError("an all-inactive frontier must sum to zero")
    n_odd = n - 4017                               # no multiple of 4 x 1024
    check_accumulate("ragged rows", binned.t()[:, :n_odd].contiguous().t(),
                     qg[:n_odd].contiguous(), qh[:n_odd].contiguous(),
                     node_ids(8, None, n_odd), 8, n_odd, QUANT_BINS)
    # one tile of train_streamed: the bench width at 131,072 rows,
    # feature-major as it lands on the card, the last 48,576 rows padded
    # with node -1 (the 1M fit's last tile), lanes planned from the tile's
    # row bound; N = 1 (a leaf-wise pass) and N = 16 (level 4)
    T, real = STREAM_TILE, N_ROWS - 7 * STREAM_TILE
    tile = binned[:T].t().contiguous().t()
    qg_t, qh_t = qg[:T].contiguous(), qh[:T].contiguous()
    stream_tile = {}
    for N in (1, 16):
        ids_t = node_ids(N, None, T)
        ids_t[real:] = -1
        check_accumulate("streamed tile", tile, qg_t, qh_t, ids_t, N, T,
                         QUANT_BINS, decode=True)
        lay_t = CH.lane_layout(T, T, QUANT_BINS)
        Ct = CH._CHANNELS[lay_t.mode]

        def tile_call():
            return CH.hist_accumulate(tile, qg_t, qh_t, ids_t, N, B, lay_t)

        t_tile = device_ms(tile_call, 20, KERNEL_NAMES["hist_accumulate"])
        tb_ms, tb_by = bound_ms(T * 4 + real * (F + 2) + Ct * N * F * B * 4,
                                real * F * Ct)
        stream_tile[N] = {"ms": t_tile, "bound_ms": tb_ms, "bound_by": tb_by,
                          "layout": lay_t.mode, "active_rows": real,
                          "plain_ms": time_ms(lambda: CH.hist_accumulate_plain(
                              tile, qg_t, qh_t, ids_t, N, B, lay_t), 3)}
        log(f"[kernels] hist_accumulate streamed tile N={N}: {t_tile:.4f} "
            f"ms device, bound {tb_ms:.4f} ms ({tb_by}), plain "
            f"{stream_tile[N]['plain_ms']:.3f} ms")
    del tile

    # frontier_finish: direct (root), subtract (level 4), depth-gated
    fmask = torch.ones(F, dtype=torch.bool, device=dev)
    fmask[7] = False
    edge_ok = torch.ones((F, B), dtype=torch.bool, device=dev)
    edge_ok[:, B - 1] = False
    edge_ok[3, 100:] = False

    def gains(depth_ok=None):
        return CH.gain_params(gs, hs, fmask, edge_ok, depth_ok, l1=0.0,
                              l2=0.0, min_data=20.0, min_hess=1e-3)

    P = 8
    parent_ids = node_ids(P, None)
    small_left = torch.rand(P, generator=gen, device=dev) < 0.5
    in_small = torch.rand(n, generator=gen, device=dev) < 0.5
    small_ids = torch.where(in_small, parent_ids, -1).to(torch.int32)
    lay_n = CH.lane_layout(n, n, QUANT_BINS)
    parent = CH.frontier_finish_plain(
        CH.hist_accumulate_plain(binned, qg, qh, parent_ids, P, B, lay_n),
        *lay_n)[0]
    lay4 = CH.lane_layout(n, n // 2 + 2 * P, QUANT_BINS)
    acc4 = CH.hist_accumulate(binned, qg, qh, small_ids, P, B, lay4)
    root_ids = torch.zeros(n, dtype=torch.int32, device=dev)
    acc0 = CH.hist_accumulate(binned, qg, qh, root_ids, 1, B, lay_n)
    cases = {
        "direct": (acc0, lay_n, None, None, gains()),
        "subtract": (acc4, lay4, parent, small_left, gains()),
        "depth_ok=True": (acc4, lay4, parent, small_left, gains(True)),
        "depth_ok=False": (acc0, lay_n, None, None, gains(False)),
    }
    for name, (acc, lay, par, sl, gp) in cases.items():
        hist, best = CH.frontier_finish(acc, *lay, par, sl, gp)
        hist_p, best_p = CH.frontier_finish_plain(acc, *lay, par, sl, gp)
        torch.cuda.synchronize()
        if not torch.equal(hist, hist_p):
            raise AssertionError(f"frontier_finish {name}: histograms differ")
        err = best_error(best, best_p)
        errs["frontier_finish"] = max(errs["frontier_finish"], err)
        if name == "depth_ok=False" and not bool(
                torch.isneginf(best[:, 0]).all()):
            raise AssertionError("depth gate off must gate every candidate")
        checks.append({"kernel": "frontier_finish", "mode": name,
                       "hist_bit_identical": True, "best_max_abs_err": err,
                       "best_bit_identical": bool(torch.equal(best, best_p))})
        log(f"[kernels] frontier_finish {name:14s}: hist bit-identical, "
            f"best max|diff| {err:.3g}, "
            f"bit-identical={torch.equal(best, best_p)}")

    # the leaf-wise N = 1 step in the slot form: the parent read from the
    # carry and both children written into it, int32 and int16 carries,
    # the step's gate on (slots 2 and 5) and off (both to the trash slot 7)
    L = 7
    in_left = torch.rand(n, generator=gen, device=dev) < 0.5
    left_ids = torch.where(in_left, 0, -1).to(torch.int32)
    acc1 = CH.hist_accumulate(binned, qg, qh, left_ids, 1, B, lay_n)
    root_hist = CH.frontier_finish_plain(acc0, *lay_n)[0]
    slot = {s: torch.tensor([s], device=dev) for s in (2, 5, L)}
    for dtype in (torch.int32, torch.int16):
        hists = torch.randint(-999, 999, (L + 1, F, B, 3), generator=gen,
                              device=dev).to(dtype)
        hists[2] = root_hist[0].to(dtype)
        carry = CH.FinishOut(
            hists, torch.randn(L + 1, generator=gen, device=dev),
            torch.zeros(L + 1, dtype=torch.int32, device=dev),
            torch.zeros(L + 1, dtype=torch.int32, device=dev),
            torch.randn((L + 1, 3), generator=gen, device=dev))
        for do in (True, False):
            at_j, at_new = (slot[2], slot[5]) if do else (slot[L], slot[L])
            got = slot_step(CH, acc1, lay_n, carry, gains(True), slot[2],
                            at_j, at_new)
            if not do and not all(torch.equal(x[:L], y[:L])
                                  for x, y in zip(got[:5], carry)):
                raise AssertionError("a gated step wrote a real slot")
            name = f"slot N=1 {str(dtype)[6:]} gate {'on' if do else 'off'}"
            checks.append({"kernel": "frontier_finish", "mode": name,
                           "bit_identical": True})
            log(f"[kernels] frontier_finish {name}: carry bit-identical")
        if dtype == torch.int32:
            carry32 = carry

    # the edges: 2 and 256 bins, one feature, a feature count that is no
    # multiple of a block's five, and ungated 0/0 gains (NaN), each dense
    # (8 parents) and in the slot form (one parent)
    n_e = 200_000
    for name, B_e, F_e, ungated in (("B=2", 2, 24, False),
                                    ("B=256", 256, 24, False),
                                    ("F=1", 255, 1, False),
                                    ("F=203", 255, 203, False),
                                    ("ungated NaN", 255, 24, True)):
        b_e = torch.randint(0, B_e, (F_e, n_e), generator=gen, device=dev,
                            dtype=torch.int16).to(torch.uint8).t()
        qg_e, qh_e = qg[:n_e].contiguous(), qh[:n_e].contiguous()
        lay_e = CH.lane_layout(n_e, n_e, QUANT_BINS)
        fm_e = torch.ones(F_e, dtype=torch.bool, device=dev)
        ed_e = torch.ones((F_e, B_e), dtype=torch.bool, device=dev)
        gp_e = CH.gain_params(gs, hs, fm_e, ed_e, None, l2=0.0,
                              min_data=0.0, min_hess=0.0) if ungated else \
            CH.gain_params(gs, hs, fm_e, ed_e, True, l2=1.0, min_data=20.0,
                           min_hess=1e-3)
        pid = node_ids(8, None, n_e)
        par_e = CH.frontier_finish_plain(CH.hist_accumulate(
            b_e, qg_e, qh_e, pid, 8, B_e, lay_e), *lay_e)[0]
        sid = torch.where(in_small[:n_e], pid, -1).to(torch.int32)
        acc_e = CH.hist_accumulate(b_e, qg_e, qh_e, sid, 8, B_e, lay_e)
        sl_e = small_left.contiguous()
        hist, best = CH.frontier_finish(acc_e, *lay_e, par_e, sl_e, gp_e)
        hist_p, best_p = CH.frontier_finish_plain(acc_e, *lay_e, par_e,
                                                  sl_e, gp_e)
        torch.cuda.synchronize()
        if not (torch.equal(hist, hist_p) and same_record(best, best_p)):
            raise AssertionError(f"frontier_finish {name} (8 parents) "
                                 f"differs")
        if ungated and not bool(best.isnan().any()):
            raise AssertionError("the ungated case must have NaN gains")
        ids1 = torch.where(in_left[:n_e], 0, -1).to(torch.int32)
        acc_e1 = CH.hist_accumulate(b_e, qg_e, qh_e, ids1, 1, B_e, lay_e)
        hists_e = torch.zeros((L + 1, F_e, B_e, 3), dtype=torch.int32,
                              device=dev)
        hists_e[2] = CH.frontier_finish_plain(CH.hist_accumulate(
            b_e, qg_e, qh_e, torch.zeros(n_e, dtype=torch.int32, device=dev),
            1, B_e, lay_e), *lay_e)[0][0]
        carry_e = CH.FinishOut(
            hists_e, torch.zeros(L + 1, device=dev),
            torch.zeros(L + 1, dtype=torch.int32, device=dev),
            torch.zeros(L + 1, dtype=torch.int32, device=dev),
            torch.zeros((L + 1, 3), device=dev))
        slot_step(CH, acc_e1, lay_e, carry_e, gp_e, slot[2], slot[2],
                  slot[5])
        fb = CH._finish_plan(8, F_e, torch.cuda.get_device_properties(
            dev).multi_processor_count)
        checks.append({"kernel": "frontier_finish", "mode": name,
                       "features_per_block_8_parents": fb,
                       "bit_identical": True})
        log(f"[kernels] frontier_finish {name:11s}: dense (8 parents, {fb} "
            f"features a block) and slot form bit-identical")
        del b_e

    # timing at the level-4 frontier step of a depth-5 tree: device time
    # from the profiler, the wrapper's pace from CUDA events
    C = acc4.shape[0]
    active = int((small_ids >= 0).sum())

    def acc_call():
        return CH.hist_accumulate(binned, qg, qh, small_ids, P, B, lay4)

    t_acc = device_ms(acc_call, 20, KERNEL_NAMES["hist_accumulate"])
    w_acc = time_ms(acc_call, 20)
    t_acc_plain = time_ms(lambda: CH.hist_accumulate_plain(
        binned, qg, qh, small_ids, P, B, lay4), 3)
    S = P * F * B
    seg = (small_ids.to(torch.int64)[:, None] * F
           + torch.arange(F, device=dev)[None, :]) * B \
        + binned.to(torch.int64)
    seg = torch.where(small_ids[:, None] >= 0, seg, S).reshape(-1)
    lanes4 = torch.stack(_pack_lanes(qg, qh, *lay4))
    src = lanes4.t()[:, None, :].expand(n, F, C).reshape(n * F, C) \
        .contiguous()
    dst = torch.zeros((S + 1, C), dtype=torch.int32, device=dev)
    t_acc_lib = time_ms(lambda: dst.index_add_(0, seg, src), 5)
    del seg, src, dst, lanes4
    # node ids of every row; bins and int8 gradients of the active rows;
    # the int32 output
    acc_bytes = n * 4 + active * (F + 2) + C * P * F * B * 4
    acc_bound, acc_by = bound_ms(acc_bytes, active * F * C)

    gp = gains()

    # the level-wise grower's form (``frontier_step``): dense arrays
    def fin_call():
        CH.frontier_finish(acc4, *lay4, parent, small_left, gp,
                           out=CH.dense_out(2 * P, F, B, dev))

    t_fin = device_ms(fin_call, 50, KERNEL_NAMES["frontier_finish"])
    w_fin = time_ms(fin_call, 50)
    t_fin_plain = time_ms(lambda: CH.frontier_finish_plain(
        acc4, *lay4, parent, small_left, gp), 3)
    n_out = 2 * P
    fin_bytes = (C * P * F * B * 4 + P * F * B * 12 + n_out * F * B * 12
                 + F + F * B + P + 8 + n_out * 36)
    fin_bound, fin_by = bound_ms(fin_bytes, n_out * F * B * 24)

    # the leaf-wise N = 1 step in the slot form (int32 carry; the children
    # go to slots 5 and 7 so that the parent in slot 2 stays as it is)
    left1, gp1 = torch.ones((1,), dtype=torch.bool, device=dev), gains(True)

    def fin1_call():
        CH.frontier_finish(acc1, *lay_n, None, left1, gp1, out=carry32,
                           out_slots=(slot[5], slot[L]), parent_slot=slot[2])

    t_fin1 = device_ms(fin1_call, 50, KERNEL_NAMES["frontier_finish"])
    w_fin1 = time_ms(fin1_call, 50)
    C1 = acc1.shape[0]
    fin1_bound, fin1_by = bound_ms(leaf_finish_bytes(C1, F, B, 4),
                                   2 * F * B * 24)
    log(f"[kernels] frontier_finish leaf-wise N=1 slot step: {t_fin1:.4f} "
        f"ms device ({w_fin1:.4f} wrapper), bound {fin1_bound:.4f} ms "
        f"({fin1_by})")

    # per-level kernel times of one depth-5 tree (direct root, then the
    # smaller children of 1, 2, 4, 8 parents)
    levels = []
    for d in range(5):
        Pd = max(1, 2 ** d // 2)
        if d == 0:
            ids, bound = root_ids, n
        else:
            ids = torch.where(in_small, node_ids(Pd, None), -1) \
                .to(torch.int32)
            bound = n // 2 + 2 ** d
        lay_d = CH.lane_layout(n, bound, QUANT_BINS)
        acc_d = CH.hist_accumulate(binned, qg, qh, ids, Pd, B, lay_d)
        par_d = None if d == 0 else torch.zeros((Pd, F, B, 3),
                                                dtype=torch.int32, device=dev)
        sl_d = None if d == 0 else small_left[:Pd].contiguous()

        def acc_d_call():
            return CH.hist_accumulate(binned, qg, qh, ids, Pd, B, lay_d)

        def fin_d_call():
            CH.frontier_finish(acc_d, *lay_d, par_d, sl_d, gp,
                               out=CH.dense_out(2 * Pd if d else 1, F, B,
                                                dev))

        rec = {"level": d, "parents": Pd, "layout": lay_d.mode,
               "active_rows": int((ids >= 0).sum()),
               "hist_accumulate_ms": device_ms(
                   acc_d_call, 10, KERNEL_NAMES["hist_accumulate"]),
               "hist_accumulate_wrapper_ms": time_ms(acc_d_call, 10),
               "frontier_finish_ms": device_ms(
                   fin_d_call, 20, KERNEL_NAMES["frontier_finish"]),
               "frontier_finish_wrapper_ms": time_ms(fin_d_call, 20)}
        levels.append(rec)
        log(f"[kernels] level {d}: {Pd} parent(s), {lay_d.mode}: "
            f"hist_accumulate {rec['hist_accumulate_ms']:.4f} ms device "
            f"({rec['hist_accumulate_wrapper_ms']:.4f} wrapper), "
            f"frontier_finish {rec['frontier_finish_ms']:.4f} ms device "
            f"({rec['frontier_finish_wrapper_ms']:.4f} wrapper)")
    torch.cuda.synchronize()
    DETAIL["checks"] = checks
    DETAIL["levels"] = levels
    DETAIL["level4_active_rows"] = active
    return {
        "hist_accumulate": dict(max_abs_err=errs["hist_accumulate"],
                                ms=t_acc, wrapper_ms=w_acc,
                                plain_ms=t_acc_plain, bound_ms=acc_bound,
                                bound_by=acc_by, library_ms=t_acc_lib,
                                stream_tile=stream_tile),
        "frontier_finish": dict(max_abs_err=errs["frontier_finish"],
                                ms=t_fin, wrapper_ms=w_fin,
                                plain_ms=t_fin_plain, bound_ms=fin_bound,
                                bound_by=fin_by, library_ms=None,
                                leaf_step_ms=t_fin1,
                                leaf_step_wrapper_ms=w_fin1,
                                leaf_step_bound_ms=fin1_bound),
    }


# ---------------------------------------------------------------------------
# phase 4: the slice, through the estimator
# ---------------------------------------------------------------------------

def bench_data(n: int, seed: int):
    """bench.py's GBDT phase data: N(0, 1) features, noisy linear label."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, N_FEAT)).astype(np.float32)
    y = (X[:, 0] + 0.5 * X[:, 1] + rng.normal(scale=0.3, size=n)
         > 0).astype(np.float32)
    return X, y


def slice_phase(dev):
    from mmlspark_tpu_torch.core import DataFrame
    from mmlspark_tpu_torch.lightgbm import LightGBMClassifier
    from mmlspark_tpu_torch.ops import cuda_histogram as CH

    X, y = bench_data(N_ROWS, seed=0)
    Xt, yt = bench_data(100_000, seed=1)
    df = DataFrame.from_dict({"features": X, "label": y})
    df_t = DataFrame.from_dict({"features": Xt, "label": yt})
    clf = LightGBMClassifier().set_params(max_depth=5, num_iterations=8)
    torch.cuda.synchronize()
    CH.reset_launch_counts()
    t0 = time.perf_counter()
    model = clf.fit(df)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = model.transform(df_t).collect()
    torch.cuda.synchronize()
    transform_s = time.perf_counter() - t0
    launches = CH.launch_counts()
    log(f"[slice] launches during fit+transform: {launches}")
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"{name} never launched on the main path")
    prob = np.stack(out["probability"])
    if prob.shape != (100_000, 2) or not np.isfinite(prob).all():
        raise AssertionError(f"bad probabilities {prob.shape}")
    acc = float((out["prediction"] == yt).mean())
    log(f"[slice] accuracy on 100k fresh rows: {acc:.4f}")
    if acc < 0.9:
        raise AssertionError(f"accuracy {acc} < 0.9")
    booster = model.booster
    leaves_gpu = booster.predict_leaf(Xt[:20000])
    leaves_cpu = booster.predict_leaf(Xt[:20000], device="cpu")
    if not np.array_equal(leaves_gpu, leaves_cpu):
        raise AssertionError("card and CPU leaf walks differ")
    fit_rps = N_ROWS / fit_s
    transform_rps = 100_000 / transform_s
    log(f"[slice] fit {fit_s:.3f} s = {fit_rps:.0f} rows/s; transform "
        f"{transform_s:.3f} s = {transform_rps:.0f} rows/s")
    DETAIL["slice"] = {"fit_s": fit_s, "fit_rows_per_s": fit_rps,
                       "transform_s": transform_s,
                       "transform_rows_per_s": transform_rps,
                       "accuracy": acc, "launches": launches}
    return launches


def fit_phases(params, label: str, data=None, profile_iterations=None,
               **train_kw):
    """Where the fit's time goes: the trainer's own phase clocks, then a
    second fit under ``torch.profiler`` for the device time of the binning
    kernels and of each kernel in the boosting loop, and the loop's device
    busy share.  ``data`` defaults to the bench data; the profiled fit runs
    ``profile_iterations`` (default: all of them; the profiler's cost grows
    with the launches); ``train_kw`` goes to ``train()`` (a ranker's
    ``group_ptr``).  Returns the profiled run's booster and its
    ``hist_accumulate`` / ``frontier_finish`` device times per launch, in
    launch order."""
    from torch.profiler import ProfilerActivity, profile
    from mmlspark_tpu_torch.lightgbm import train
    X, y = data or bench_data(N_ROWS, seed=0)
    iters = params.num_iterations
    ex = dict(train(X, y, params, **train_kw).extras)
    ex["boosting_row_iterations_per_s"] = N_ROWS * iters / ex["boosting_s"]
    log(f"[{label}] train() phases: " + ", ".join(
        f"{k} {v:.4g}" for k, v in ex.items())
        + " (binning_s = edges_s + bin_apply_s; host numpy binning of this "
        "fit before the card applied the bins: 19.1-29.9 s, PERF.md)")

    t_prof = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        prof_res = train(X, y, dataclasses.replace(
            params, num_iterations=profile_iterations or iters), **train_kw)
    prof_ex = prof_res.extras
    events = prof.events()
    # train()'s profiler ranges: the card's binning kernels run (and are
    # waited for) inside "train.bin_apply", before "train.boosting" starts
    spans = {e.name: e.time_range for e in events
             if e.name in ("train.bin_apply", "train.boosting")}
    loop_start = spans["train.boosting"].start
    by_kernel, bin_ms = {}, 0.0
    for e in events:
        # skipped: the host-to-card copies, and the ranges themselves,
        # which the profiler also books on the card's timeline
        if e.device_type != torch.autograd.DeviceType.CUDA or \
                "memcpy" in e.name.lower() or e.name in spans:
            continue
        ms = e.time_range.elapsed_us() / 1e3
        if e.time_range.start >= loop_start:
            by_kernel[e.name] = by_kernel.get(e.name, 0.0) + ms
        elif e.time_range.start >= spans["train.bin_apply"].start:
            bin_ms += ms
    busy_ms = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    share = busy_ms / (prof_ex["boosting_s"] * 1e3)
    # every kernel the host enqueued in the loop, ours and PyTorch's: the
    # host's work
    runtime_launches = sum(1 for e in events if e.name == "cudaLaunchKernel"
                           and e.time_range.start >= loop_start)
    trees = prof_res.booster.num_trees
    log(f"[{label}] profiled fit of {trees} trees and its parse: "
        f"{time.perf_counter() - t_prof:.1f} s")
    log(f"[{label}] profiled fit: binning kernels on the card "
        f"{bin_ms:.3f} ms; boosting {prof_ex['boosting_s']:.4f} s, "
        f"device kernels {busy_ms:.3f} ms (busy share {share:.3f}), "
        f"{runtime_launches} cudaLaunchKernel calls "
        f"({runtime_launches / trees:.0f} per tree over {trees} trees; the "
        f"two-kernel finish with the grower's copies: 3,362 leaf-wise, 354 "
        f"level-wise)")
    for name, ms in top:
        log(f"[{label}]   {ms:9.3f} ms  {name[:90]}")
    per_launch = {}
    for kernel, names in KERNEL_NAMES.items():
        events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and any(nm in e.name for nm in names)]
        per_name = [sorted((e for e in events if nm in e.name),
                           key=lambda e: e.time_range.start)
                    for nm in names]
        per_launch[kernel] = [sum(e.time_range.elapsed_us() for e in evs)
                              / 1e3 for evs in zip(*per_name)]
    DETAIL[label + "_train_phases"] = ex
    DETAIL[label + "_profile"] = {
        "boosting_s": prof_ex["boosting_s"], "device_kernel_ms": busy_ms,
        "binning_kernel_ms": bin_ms, "train_phases": prof_ex,
        "busy_share": share, "top_kernels_ms": top, "trees": trees,
        "cuda_launch_kernel_calls": runtime_launches,
        "launches_profiled": {k: len(v) for k, v in per_launch.items()},
        "profiled_fit_and_parse_s": time.perf_counter() - t_prof}
    return prof_res.booster, per_launch


def grower_check(dev):
    """One depth-5 tree on the card equals the same tree grown by the plain
    versions on the CPU, from the same data and quantizer uniforms."""
    from mmlspark_tpu_torch.lightgbm import BinMapper, GBDTParams
    from mmlspark_tpu_torch.lightgbm.core import make_tree_grower
    rng = np.random.default_rng(5)
    n, F = 50_000, 20
    X = rng.normal(size=(n, F)).astype(np.float32)
    y = (X[:, 0] - X[:, 1] * X[:, 2] > 0).astype(np.float32)
    mapper = BinMapper(255).fit(X)
    binned = mapper.transform(X)
    p = 1 / (1 + np.exp(-rng.normal(scale=0.5, size=n)))
    g = (p - y).astype(np.float32)
    h = (p * (1 - p)).astype(np.float32)
    u = rng.random((2, n), dtype=np.float32)
    params = GBDTParams(max_depth=5, use_quantized_grad=True,
                        lambda_l2=1.0).resolve()
    grow = make_tree_grower(5, F, 255, params)
    trees = []
    for d in (dev, torch.device("cpu")):
        def t(a):
            return torch.from_numpy(a).to(d)
        trees.append(grow(t(binned).t().contiguous().t(), t(g), t(h),
                          torch.ones(n, dtype=torch.bool, device=d),
                          torch.ones(F, dtype=torch.bool, device=d),
                          t(mapper.edges), noise=t(u)))
    identical = card_equals_cpu(*trees, "depth-5 tree")
    log(f"[slice] depth-5 tree on the card equals the CPU plain-version "
        f"tree (bit-identical in {identical} arrays)")


def card_equals_cpu(card, cpu, what: str) -> str:
    """Raise unless a tree grown on the card equals the CPU's: integer
    arrays bit-identical, float arrays (f32 math on both) within rtol 1e-6.
    Returns how many arrays are bit-identical, as "k/n"."""
    identical = []
    for name, a, b in zip(card._fields, card, cpu):
        if a is None and b is None:
            continue
        a, b = a.cpu(), b.cpu()
        if a.is_floating_point():
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                       atol=0, err_msg=f"{what}: {name}")
        elif not torch.equal(a, b):
            raise AssertionError(f"{what} on the card differs in {name}")
        identical.append(bool(torch.equal(a, b)))
    return f"{sum(identical)}/{len(identical)}"


# ---------------------------------------------------------------------------
# phase 5: the leaf-wise grower and the boosting modes
# ---------------------------------------------------------------------------

def leafwise_grower_check(dev):
    """31-leaf trees grown on the card equal the same trees grown by the
    plain versions on the CPU: uncapped and capped at ``max_depth=4`` at
    50k x 20 (an int32 histogram carry), and uncapped at 2,000 rows (the
    int16 carry).  The card's growth runs under
    ``torch.cuda.set_sync_debug_mode("error")``: any call that waits for the
    card raises, so the step loop is shown never to sync."""
    from mmlspark_tpu_torch.lightgbm import BinMapper, GBDTParams
    from mmlspark_tpu_torch.lightgbm.core import (leafwise_store_dtype,
                                                  make_leafwise_grower)
    from mmlspark_tpu_torch.models.gbdt import children_depth_bound
    from mmlspark_tpu_torch.ops import cuda_histogram as CH
    rng = np.random.default_rng(6)
    n_all, F = 50_000, 20
    X = rng.normal(size=(n_all, F)).astype(np.float32)
    y = (X[:, 0] - X[:, 1] * X[:, 2] + 0.5 * X[:, 3] > 0).astype(np.float32)
    p = 1 / (1 + np.exp(-rng.normal(scale=0.5, size=n_all)))
    g_all = (p - y).astype(np.float32)
    h_all = (p * (1 - p)).astype(np.float32)
    u_all = rng.random((2, n_all), dtype=np.float32)
    results = []
    for n, max_depth in ((n_all, 0), (n_all, 4), (2_000, 0)):
        mapper = BinMapper(255).fit(X[:n])
        binned = mapper.transform(X[:n])
        params = GBDTParams(num_leaves=31, max_depth=max_depth,
                            use_quantized_grad=True, lambda_l2=1.0).resolve()
        grow = make_leafwise_grower(31, max_depth, F, 255, params)
        trees = []
        for d in (dev, torch.device("cpu")):
            def t(a):
                return torch.from_numpy(np.ascontiguousarray(a)).to(d)
            args = (t(binned).t().contiguous().t(), t(g_all[:n]),
                    t(h_all[:n]), torch.ones(n, dtype=torch.bool, device=d),
                    torch.ones(F, dtype=torch.bool, device=d),
                    t(mapper.edges))
            u = t(u_all[:, :n])
            torch.cuda.synchronize()
            CH.reset_launch_counts()
            if d.type == "cuda":
                torch.cuda.set_sync_debug_mode("error")
            try:
                tree = grow(*args, noise=u)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            if d.type == "cuda":
                torch.cuda.synchronize()
                launches = CH.launch_counts()
                if set(launches.values()) != {31}:
                    raise AssertionError(f"leaf-wise tree launched "
                                         f"{launches}, not 31 each")
            trees.append(tree)
        identical = card_equals_cpu(
            *trees, f"leaf-wise tree (n={n}, max_depth={max_depth})")
        card = trees[0]
        rec = {"rows": n, "max_depth": max_depth,
               "carry": str(leafwise_store_dtype(n, True, QUANT_BINS)),
               "splits": int((card.split_feature >= 0).sum()),
               "depth": children_depth_bound(card.left_child.cpu().numpy(),
                                             card.right_child.cpu().numpy()),
               "bit_identical_arrays": identical,
               "sync_debug_mode": "error"}
        results.append(rec)
        log(f"[leafwise] {n} x {F}, max_depth={max_depth}, {rec['carry']} "
            f"carry: {rec['splits']} splits, depth {rec['depth']}; the card "
            f"tree equals the CPU tree ({rec['bit_identical_arrays']} arrays "
            f"bit-identical), grown under sync debug mode 'error', 31 "
            f"launches of each kernel")
    DETAIL["leafwise_grower_check"] = results


def leaf_slice_phase(dev):
    """``LightGBMClassifier()`` with its defaults (leaf-wise, 31 leaves) for
    8 iterations on the bench data, then transform of 100k fresh rows."""
    from mmlspark_tpu_torch.core import DataFrame
    from mmlspark_tpu_torch.lightgbm import LightGBMClassifier
    from mmlspark_tpu_torch.ops import cuda_histogram as CH

    X, y = bench_data(N_ROWS, seed=0)
    Xt, yt = bench_data(100_000, seed=1)
    df = DataFrame.from_dict({"features": X, "label": y})
    df_t = DataFrame.from_dict({"features": Xt, "label": yt})
    clf = LightGBMClassifier().set_params(num_iterations=8)
    torch.cuda.synchronize()
    CH.reset_launch_counts()
    t0 = time.perf_counter()
    model = clf.fit(df)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = CH.launch_counts()
    log(f"[leaf] launches during the fit: {launches}")
    if launches != {"hist_accumulate": 248, "frontier_finish": 248}:
        raise AssertionError(f"the leaf-wise fit must launch each kernel "
                             f"8 x 31 = 248 times, got {launches}")
    t0 = time.perf_counter()
    out = model.transform(df_t).collect()
    torch.cuda.synchronize()
    transform_s = time.perf_counter() - t0
    prob = np.stack(out["probability"])
    if prob.shape != (100_000, 2) or not np.isfinite(prob).all():
        raise AssertionError(f"bad probabilities {prob.shape}")
    acc = float((out["prediction"] == yt).mean())
    booster = model.booster
    log(f"[leaf] accuracy on 100k fresh rows: {acc:.4f}; {booster.num_trees}"
        f" trees of {booster.num_leaves} leaves, walk depth "
        f"{booster.max_depth}")
    if acc < 0.9:
        raise AssertionError(f"accuracy {acc} < 0.9")
    leaves_gpu = booster.predict_leaf(Xt[:20000])
    leaves_cpu = booster.predict_leaf(Xt[:20000], device="cpu")
    if not np.array_equal(leaves_gpu, leaves_cpu):
        raise AssertionError("card and CPU leaf walks differ")
    fit_rps = N_ROWS / fit_s
    transform_rps = 100_000 / transform_s
    log(f"[leaf] fit {fit_s:.3f} s = {fit_rps:.0f} rows/s; transform "
        f"{transform_s:.3f} s = {transform_rps:.0f} rows/s; card and CPU "
        f"leaf walks equal")
    DETAIL["leaf_slice"] = {"fit_s": fit_s, "fit_rows_per_s": fit_rps,
                            "transform_s": transform_s,
                            "transform_rows_per_s": transform_rps,
                            "accuracy": acc, "launches": launches,
                            "walk_depth": booster.max_depth}
    return launches


def leaf_step_times(booster, per_launch):
    """Per-step device times of the first tree of the profiled leaf-wise
    fit, each beside the bound for that step's active rows: the root reads
    every row, step s >= 1 the rows of internal node s - 1's left child
    (the child each step rebuilds)."""
    from mmlspark_tpu_torch.lightgbm.core import leafwise_store_dtype
    from mmlspark_tpu_torch.ops import cuda_histogram as CH
    n, F, B = N_ROWS, N_FEAT, N_BINS
    for kernel, times in per_launch.items():
        if len(times) != booster.num_trees * booster.num_leaves:
            raise AssertionError(f"the profiler saw {len(times)} launches "
                                 f"of {kernel} in the leaf-wise fit")
    lc, ic, lcnt = (booster.left_child[0], booster.internal_count[0],
                    booster.leaf_count[0])
    M = lc.shape[0]
    C = CH._CHANNELS[CH.lane_layout(n, n, QUANT_BINS).mode]
    width = leafwise_store_dtype(n, True, QUANT_BINS).itemsize  # the carry
    steps = []
    for s in range(M + 1):
        if s == 0:
            active = n
        else:
            child = int(lc[s - 1])
            active = int(ic[child] if child >= 0 else lcnt[~child])
        n_out = 1 if s == 0 else 2
        acc_bound, acc_by = bound_ms(n * 4 + active * (F + 2)
                                     + C * F * B * 4, active * F * C)
        fin_bound, fin_by = bound_ms(
            leaf_finish_bytes(C, F, B, width, root=s == 0),
            n_out * F * B * 24)
        steps.append({
            "step": s, "active_rows": active,
            "hist_accumulate_ms": per_launch["hist_accumulate"][s],
            "hist_accumulate_bound_ms": acc_bound,
            "hist_accumulate_bound_by": acc_by,
            "frontier_finish_ms": per_launch["frontier_finish"][s],
            "frontier_finish_bound_ms": fin_bound,
            "frontier_finish_bound_by": fin_by})
        log(f"[leaf] step {s:2d}: {active:7d} rows, hist_accumulate "
            f"{steps[-1]['hist_accumulate_ms']:.4f} ms (bound "
            f"{acc_bound:.4f}, {acc_by}), frontier_finish "
            f"{steps[-1]['frontier_finish_ms']:.4f} ms (bound "
            f"{fin_bound:.4f})")
    tot = {k: sum(per_launch[k]) for k in per_launch}
    log(f"[leaf] profiled fit: hist_accumulate {tot['hist_accumulate']:.3f} "
        f"ms over {len(per_launch['hist_accumulate'])} launches, "
        f"frontier_finish {tot['frontier_finish']:.3f} ms over "
        f"{len(per_launch['frontier_finish'])}")
    DETAIL["leaf_steps_tree0"] = steps
    DETAIL["leaf_kernel_ms_per_fit"] = tot


MODES = {"bagging": dict(bagging_fraction=0.8, bagging_freq=1),
         "goss": dict(boosting_type="goss"),
         "rf": dict(boosting_type="rf"),
         "dart": dict(boosting_type="dart")}


def modes_phase(dev):
    """Bagging, GOSS, RF and DART, each leaf-wise through the estimator at
    200k x 200 for 4 iterations, scored on 50k fresh rows."""
    from mmlspark_tpu_torch.core import DataFrame
    from mmlspark_tpu_torch.lightgbm import LightGBMClassifier
    from mmlspark_tpu_torch.ops import cuda_histogram as CH
    X, y = bench_data(200_000, seed=2)
    Xt, yt = bench_data(50_000, seed=3)
    df = DataFrame.from_dict({"features": X, "label": y})
    df_t = DataFrame.from_dict({"features": Xt, "label": yt})
    results = {}
    for name, kw in MODES.items():
        torch.cuda.synchronize()
        CH.reset_launch_counts()
        t0 = time.perf_counter()
        model = LightGBMClassifier().set_params(num_iterations=4,
                                                **kw).fit(df)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = CH.launch_counts()
        out = model.transform(df_t).collect()
        acc = float((out["prediction"] == yt).mean())
        b = model.booster
        results[name] = {"accuracy": acc, "fit_s": fit_s,
                         "launches": launches,
                         "tree_weight": b.tree_weight.tolist(),
                         "root_rows": b.internal_count[:, 0].tolist(),
                         "average_output": b.average_output}
        log(f"[modes] {name:7s}: accuracy {acc:.4f}, fit {fit_s:.2f} s, "
            f"launches {launches}, root rows "
            f"{b.internal_count[:, 0].astype(int).tolist()}, tree weights "
            f"{[round(float(w), 4) for w in b.tree_weight]}")
        if acc < 0.85 or set(launches.values()) != {4 * 31}:
            raise AssertionError(f"{name}: accuracy {acc} < 0.85 or "
                                 f"launches {launches} != 124")
    DETAIL["modes"] = results


# ---------------------------------------------------------------------------
# phase 6: the data plane
# ---------------------------------------------------------------------------

def data_matrix(n: int, seed: int) -> np.ndarray:
    """The bench features plus 8 columns of the awkward values binning must
    keep: NaN, +inf, -inf, integer codes, the column whose first fitted
    edge is -inf (codes with -inf in every 7th row), all three mixed, ±inf
    alone and a constant."""
    X, _ = bench_data(n, seed)
    rng = np.random.default_rng(seed + 50)
    extra = np.empty((n, 8), np.float32)
    extra[:, 0] = np.where(rng.random(n) < 0.1, np.nan, rng.normal(size=n))
    extra[:, 1] = rng.exponential(size=n)
    extra[::13, 1] = np.inf
    extra[:, 2] = rng.normal(size=n)
    extra[::17, 2] = -np.inf
    extra[:, 3] = rng.integers(0, 10, n)
    extra[:, 4] = rng.integers(0, 5, n)
    extra[::7, 4] = -np.inf
    extra[:, 5] = rng.choice(np.array([np.nan, np.inf, -np.inf, 1.0, 2.0],
                                      np.float32), size=n)
    extra[:, 6] = np.where(rng.random(n) < 0.5, -np.inf, np.inf)
    extra[:, 7] = 3.0
    return np.concatenate([X, extra], axis=1)


def data_phase(dev):
    """Edges on the host, bins on the card, at the bench size plus the 8
    awkward columns: the card's train-route bins bit-identical to the
    port's host route (which the CPU tests hold equal to the JAX package's),
    the numpy route's semantics on the card bit-identical to numpy,
    ``bin_matrix`` on the card bit-identical to its CPU run; each part
    timed."""
    from mmlspark_tpu_torch.lightgbm.binning import BinMapper, host_route
    from mmlspark_tpu_torch.ops import histogram as H
    X = data_matrix(N_ROWS, seed=0)
    n, F = X.shape
    route = host_route(X.size)
    t0 = time.perf_counter()
    mapper = BinMapper(N_BINS).fit(X)
    edges_s = time.perf_counter() - t0
    if mapper.edges[N_FEAT + 4, 0] != -np.inf:
        raise AssertionError("the -inf column must fit a leading -inf edge")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x = torch.from_numpy(X).to(dev)
    torch.cuda.synchronize()
    transfer_s = time.perf_counter() - t0
    tables = {}
    for r in ("cxx", "numpy"):
        table, ascending = mapper.route_table(r)
        if not ascending.all():
            raise AssertionError(f"{r} route table not ascending")
        tables[r] = torch.from_numpy(table).to(dev)
    t_apply = {r: time_ms(lambda r=r: H.apply_bins(
        x, tables[r], nan_to_num=r == "numpy"), 5) for r in tables}
    del x
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = mapper.bin_on_device(X, dev)
    torch.cuda.synchronize()
    bin_on_device_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = mapper.transform(X)
    host_s = time.perf_counter() - t0
    if not torch.equal(card.t().cpu(), torch.from_numpy(host)):
        raise AssertionError("card bins differ from the host route's")
    t0 = time.perf_counter()
    numpy_bins = mapper._host_bins(X, "numpy", mapper.edges)
    numpy_s = time.perf_counter() - t0
    card_np = H.apply_bins(torch.from_numpy(X).to(dev), tables["numpy"],
                           nan_to_num=True)
    if not torch.equal(card_np.t().cpu(), torch.from_numpy(numpy_bins)):
        raise AssertionError("the numpy route on the card differs")
    differ = int((numpy_bins != host).any(axis=0).sum())
    del card_np, numpy_bins
    e_dev = torch.from_numpy(mapper.edges).to(dev)
    bm_card = H.bin_matrix(torch.from_numpy(X).to(dev), e_dev, N_BINS)
    t_bm = time_ms(lambda: H.bin_matrix(torch.from_numpy(X).to(dev), e_dev,
                                        N_BINS), 3)
    if not torch.equal(bm_card.cpu(), H.bin_matrix(
            torch.from_numpy(X), torch.from_numpy(mapper.edges), N_BINS)):
        raise AssertionError("bin_matrix on the card differs from the CPU")
    del bm_card, card
    rec = {"rows": n, "features": F, "host_route": route,
           "edges_s": edges_s, "transfer_s": transfer_s,
           "card_apply_ms": t_apply[route],
           "card_apply_ms_by_route": t_apply,
           "bin_on_device_s": bin_on_device_s,
           "train_route_binning_s": edges_s + bin_on_device_s,
           "host_apply_s": {route: host_s, "numpy": numpy_s},
           "bin_matrix_ms_with_transfer": t_bm,
           "features_where_the_routes_differ": differ}
    log(f"[data] {n} x {F} ({route} route): edges {edges_s:.3f} s, X to "
        f"the card {transfer_s:.3f} s, card apply {t_apply[route]:.2f} ms "
        f"(numpy route {t_apply['numpy']:.2f} ms), bin_on_device "
        f"{bin_on_device_s:.3f} s; host apply {route} {host_s:.3f} s, "
        f"numpy {numpy_s:.3f} s; bin_matrix with transfer {t_bm:.2f} ms")
    log(f"[data] train-route binning {edges_s + bin_on_device_s:.3f} s "
        f"(host numpy binning of a 1M x 200 fit before the card applied "
        f"the bins: 19.1-29.9 s, PERF.md); card bins "
        f"bit-identical to the host route, numpy route and bin_matrix "
        f"bit-identical on the card; the routes differ on {differ} "
        f"features")
    DETAIL["data"] = rec


# ---------------------------------------------------------------------------
# phase 7: categorical splits and the regression objectives
# ---------------------------------------------------------------------------

CAT_COLS = list(range(N_FEAT - 10, N_FEAT))       # 5 x 3 codes, 5 x 64
PLANTED = np.random.default_rng(7).permutation(64)[:32]


def cat_data(n: int, seed: int, F: int = N_FEAT):
    """The bench data with its last 10 columns replaced by codes (5 of 3
    codes, 5 of 64), the label the bench label plus a planted half of one
    64-code column's codes and one 3-code column's code 1."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, F)).astype(np.float32)
    cols = list(range(F - 10, F))
    X[:, cols[:5]] = rng.integers(0, 3, (n, 5))
    X[:, cols[5:]] = rng.integers(0, 64, (n, 5))
    in_set = np.isin(X[:, cols[5]], PLANTED)
    y = (X[:, 0] + 0.5 * X[:, 1] + 1.5 * (in_set - 0.5)
         + 0.8 * (X[:, cols[0]] == 1) + rng.normal(scale=0.3, size=n)
         > 0).astype(np.float32)
    return X, y, cols


def cat_grower_check(dev):
    """50k x 20 categorical trees (one-vs-rest and sorted-subset columns)
    grown on the card equal the CPU trees in every array, category sets
    included; the leaf-wise one under sync debug mode "error"."""
    from mmlspark_tpu_torch.lightgbm import BinMapper, GBDTParams
    from mmlspark_tpu_torch.lightgbm.core import (_cat_subset,
                                                  make_leafwise_grower,
                                                  make_tree_grower)
    from mmlspark_tpu_torch.ops import cuda_histogram as CH
    n, F = 50_000, 20
    X, y, cols = cat_data(n, seed=8, F=F)
    rng = np.random.default_rng(9)
    p = 1 / (1 + np.exp(-rng.normal(scale=0.5, size=n)))
    g = (p - y).astype(np.float32)
    h = (p * (1 - p)).astype(np.float32)
    u = rng.random((2, n), dtype=np.float32)
    mapper = BinMapper(N_BINS, categorical_features=cols).fit(X)
    binned = torch.from_numpy(mapper.transform(X))
    base = GBDTParams(categorical_features=tuple(cols),
                      use_quantized_grad=True, lambda_l2=1.0)
    subset = _cat_subset(base, binned, N_BINS)
    if subset != tuple(cols[5:]):
        raise AssertionError(f"cardinality split {subset}")
    results = []
    for growth in ("leaf", "level"):
        if growth == "leaf":
            params = dataclasses.replace(base, num_leaves=31,
                                         cat_subset=subset).resolve()
            grow = make_leafwise_grower(31, 0, F, N_BINS, params)
            launches = 31
        else:
            params = dataclasses.replace(base, max_depth=5,
                                         cat_subset=subset).resolve()
            grow = make_tree_grower(5, F, N_BINS, params)
            launches = 5
        trees = []
        for d in (dev, torch.device("cpu")):
            def t(a):
                return torch.from_numpy(np.ascontiguousarray(a)).to(d)
            args = (binned.to(d).t().contiguous().t(), t(g), t(h),
                    torch.ones(n, dtype=torch.bool, device=d),
                    torch.ones(F, dtype=torch.bool, device=d),
                    t(mapper.edges))
            noise = t(u)
            torch.cuda.synchronize()
            CH.reset_launch_counts()
            if d.type == "cuda" and growth == "leaf":
                torch.cuda.set_sync_debug_mode("error")
            try:
                tree = grow(*args, noise=noise)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            if d.type == "cuda":
                torch.cuda.synchronize()
                got = CH.launch_counts()
                if set(got.values()) != {launches}:
                    raise AssertionError(f"{growth}-wise categorical tree "
                                         f"launched {got}")
            trees.append(tree)
        identical = card_equals_cpu(*trees, f"{growth}-wise categorical "
                                            f"tree")
        sf = trees[0].split_feature.cpu().numpy()
        cat_splits = int(np.isin(sf, cols).sum())
        if not cat_splits:
            raise AssertionError(f"{growth}-wise tree made no categorical "
                                 f"split")
        results.append({"growth": growth, "bit_identical_arrays": identical,
                        "categorical_splits": cat_splits,
                        "splits": int((sf >= 0).sum())})
        log(f"[cat] {growth}-wise 50k x 20 tree on the card equals the CPU "
            f"tree ({identical} arrays bit-identical, {cat_splits} "
            f"categorical of {int((sf >= 0).sum())} splits"
            + (", sync debug mode 'error')" if growth == "leaf" else ")"))
    DETAIL["cat_grower_check"] = results


def cat_phase(dev):
    """``LightGBMClassifier(categorical_features=...)`` at 1M x 200, leaf-wise
    defaults and then ``max_depth=5``, 8 iterations each: accuracy on 100k
    fresh rows, the kernels' launches (the categorical path builds its
    histograms on both kernels and searches splits in torch: one build per
    leaf-wise step, one per level), card walk = CPU walk."""
    from mmlspark_tpu_torch.core import DataFrame
    from mmlspark_tpu_torch.lightgbm import GBDTParams, LightGBMClassifier
    from mmlspark_tpu_torch.ops import cuda_histogram as CH
    X, y, cols = cat_data(N_ROWS, seed=10)
    Xt, yt, _ = cat_data(100_000, seed=11)
    df = DataFrame.from_dict({"features": X, "label": y})
    df_t = DataFrame.from_dict({"features": Xt, "label": yt})
    out_launches, results = {}, {}
    for label, kw, per_tree in (("leaf", {}, 31),
                                ("level", dict(max_depth=5), 5)):
        clf = LightGBMClassifier().set_params(
            num_iterations=8, categorical_features=cols, **kw)
        torch.cuda.synchronize()
        CH.reset_launch_counts()
        t0 = time.perf_counter()
        model = clf.fit(df)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = CH.launch_counts()
        want = {"hist_accumulate": 8 * per_tree,
                "frontier_finish": 8 * per_tree}
        if launches != want:
            raise AssertionError(f"categorical {label}-wise fit launched "
                                 f"{launches}, not {want}")
        out = model.transform(df_t).collect()
        acc = float((out["prediction"] == yt).mean())
        b = model.booster
        leaves_gpu = b.predict_leaf(Xt[:20000])
        leaves_cpu = b.predict_leaf(Xt[:20000], device="cpu")
        if not np.array_equal(leaves_gpu, leaves_cpu):
            raise AssertionError("card and CPU categorical walks differ")
        cat_nodes = int(np.isin(b.split_feature, cols).sum())
        log(f"[cat] {label}-wise fit {fit_s:.3f} s, launches {launches}, "
            f"accuracy {acc:.4f} on 100k fresh rows, {cat_nodes} "
            f"categorical splits, category sets "
            f"{'stored' if b.cat_bitset is not None else 'none'}; card "
            f"and CPU walks equal")
        if acc < 0.9 or b.cat_bitset is None or not cat_nodes:
            raise AssertionError(f"categorical {label}-wise: accuracy {acc}"
                                 f", {cat_nodes} categorical splits")
        out_launches[label] = launches
        results[label] = {"fit_s": fit_s, "accuracy": acc,
                          "launches": launches,
                          "categorical_splits": cat_nodes}
    DETAIL["cat"] = results
    for label, kw in (("cat_leaf", dict(num_leaves=31)),
                      ("cat_level", dict(max_depth=5))):
        fit_phases(GBDTParams(num_iterations=8, objective="binary",
                              categorical_features=tuple(cols), **kw),
                   label, (X, y))
    return out_launches


REG_OBJECTIVES = ("regression_l1", "huber", "quantile", "poisson", "tweedie",
                  "gamma")


def objectives_phase(dev):
    """One fit per new regression objective at 200k x 200, 4 iterations,
    leaf-wise, with a 50k-row valid set: the default metric finite and
    falling."""
    from mmlspark_tpu_torch.lightgbm import GBDTParams, train
    from mmlspark_tpu_torch.lightgbm.core import default_metric
    n, nv = 200_000, 50_000
    X, _ = bench_data(n + nv, seed=12)
    rng = np.random.default_rng(13)
    counts = rng.poisson(np.exp(0.5 * X[:, 0] - 0.3 * X[:, 1] + 0.2)) \
        .astype(np.float32)
    cont = (X[:, 0] + 0.5 * X[:, 1] + rng.normal(scale=0.3, size=n + nv)) \
        .astype(np.float32)
    results = {}
    for obj in REG_OBJECTIVES:
        y = {"poisson": counts, "tweedie": counts + 0.5,
             "gamma": counts + 0.5}.get(obj, cont)
        t0 = time.perf_counter()
        r = train(X[:n], y[:n], GBDTParams(objective=obj, num_iterations=4,
                                           num_leaves=31),
                  valid=(X[n:], y[n:]))
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        name = default_metric(obj)
        vals = [e[name] for e in r.evals]
        log(f"[objectives] {obj:13s} {name:12s} "
            f"{' '.join(f'{v:.5f}' for v in vals)} (fit {fit_s:.2f} s)")
        if not (np.isfinite(vals).all() and vals[-1] < vals[0]):
            raise AssertionError(f"{obj}: {name} {vals} not finite and "
                                 f"falling")
        results[obj] = {"metric": name, "evals": vals, "fit_s": fit_s}
    DETAIL["objectives"] = results


# ---------------------------------------------------------------------------
# phase 8: multiclass
# ---------------------------------------------------------------------------

N_CLASSES = 7                                     # UCI Covertype's classes
W_CLASSES = np.random.default_rng(70).normal(size=(N_CLASSES, 4))


def mc_data(n: int, seed: int, F: int = N_FEAT, K: int = N_CLASSES):
    """The bench features; the label the argmax of K fixed linear
    projections of the first 4 features plus N(0, 0.1²) noise."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, F)).astype(np.float32)
    z = X[:, :4] @ W_CLASSES[:K].T + rng.normal(scale=0.1, size=(n, K))
    return X, np.argmax(z, axis=1).astype(np.float32)


def multiclass_grower_check(dev):
    """K = 3 trees per iteration at 50k x 20, grown from the columns of the
    (n, 3) multiclass gradients (views with stride 3, as ``train()`` hands
    them over), on the card and on the CPU: every array equal, leaf-wise
    (under sync debug mode "error", the three trees back to back) and
    level-wise."""
    from mmlspark_tpu_torch.lightgbm import BinMapper, GBDTParams
    from mmlspark_tpu_torch.lightgbm.core import _make_grower, make_objective
    from mmlspark_tpu_torch.ops import cuda_histogram as CH
    n, F, K = 50_000, 20, 3
    X, y = mc_data(n, seed=22, F=F, K=K)
    rng = np.random.default_rng(23)
    mapper = BinMapper(N_BINS).fit(X)
    binned = torch.from_numpy(mapper.transform(X))
    scores = torch.from_numpy(rng.normal(scale=0.5, size=(n, K))
                              .astype(np.float32))
    u = torch.from_numpy(rng.random((K, 2, n), dtype=np.float32))
    results = []
    for growth, kw, per_tree in (("leaf", dict(num_leaves=31), 31),
                                 ("level", dict(max_depth=5), 5)):
        params = GBDTParams(objective="multiclass", num_class=K,
                            use_quantized_grad=True, lambda_l2=1.0,
                            **kw).resolve()
        # made once on the host, so both devices quantize the same floats
        g_all, h_all = make_objective(params)(scores, torch.from_numpy(y),
                                              torch.ones(n))
        grow = _make_grower(params, F, N_BINS)
        out = []
        for d in (dev, torch.device("cpu")):
            g, h = g_all.to(d), h_all.to(d)
            if g.stride() != (K, 1):
                raise AssertionError(f"gradients not (n, K) row-major: "
                                     f"{g.stride()}")
            args = (binned.to(d).t().contiguous().t(),)
            rest = (torch.ones(n, dtype=torch.bool, device=d),
                    torch.ones(F, dtype=torch.bool, device=d),
                    torch.from_numpy(mapper.edges).to(d))
            ud = u.to(d)
            torch.cuda.synchronize()
            CH.reset_launch_counts()
            if d.type == "cuda" and growth == "leaf":
                torch.cuda.set_sync_debug_mode("error")
            try:
                trees = [grow(*args, g[:, c], h[:, c], *rest, noise=ud[c])
                         for c in range(K)]
            finally:
                torch.cuda.set_sync_debug_mode(0)
            if d.type == "cuda":
                torch.cuda.synchronize()
                got = CH.launch_counts()
                if set(got.values()) != {K * per_tree}:
                    raise AssertionError(f"{growth}-wise K={K} trees "
                                         f"launched {got}")
            out.append(trees)
        identical = [card_equals_cpu(a, b, f"{growth}-wise class {c} tree")
                     for c, (a, b) in enumerate(zip(*out))]
        splits = [tuple(t.split_feature.cpu().tolist()) for t in out[0]]
        if len(set(splits)) != K:
            raise AssertionError("the classes grew the same tree")
        results.append({"growth": growth, "classes": K,
                        "bit_identical_arrays": identical,
                        "launches_per_class": per_tree})
        log(f"[multiclass] {growth}-wise K={K} trees at {n} x {F} on the "
            f"card equal the CPU trees (arrays bit-identical per class: "
            f"{', '.join(identical)})"
            + (", grown under sync debug mode 'error'" if growth == "leaf"
               else ""))
    DETAIL["multiclass_grower_check"] = results


def multiclass_phase(dev):
    """``LightGBMClassifier()`` on 7-class labels at 1M x 200, leaf-wise
    defaults and then ``max_depth=5``, 8 iterations each (7 trees an
    iteration): the kernels' launches, accuracy on 100k fresh rows,
    ``multi_logloss`` on them after each iteration, card walk = CPU walk."""
    from mmlspark_tpu_torch.core import DataFrame
    from mmlspark_tpu_torch.lightgbm import GBDTParams, LightGBMClassifier
    from mmlspark_tpu_torch.lightgbm.core import _metric_multi_logloss
    from mmlspark_tpu_torch.ops import cuda_histogram as CH
    t0 = time.perf_counter()
    X, y = mc_data(N_ROWS, seed=20)
    Xt, yt = mc_data(100_000, seed=21)
    df = DataFrame.from_dict({"features": X, "label": y})
    df_t = DataFrame.from_dict({"features": Xt, "label": yt})
    out_launches, results = {}, {"data_s": time.perf_counter() - t0}
    for label, kw, per_tree in (("leaf", {}, 31),
                                ("level", dict(max_depth=5), 5)):
        clf = LightGBMClassifier().set_params(num_iterations=8, **kw)
        torch.cuda.synchronize()
        CH.reset_launch_counts()
        t0 = time.perf_counter()
        model = clf.fit(df)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = CH.launch_counts()
        n_launch = 8 * N_CLASSES * per_tree
        if launches != {"hist_accumulate": n_launch,
                        "frontier_finish": n_launch}:
            raise AssertionError(f"multiclass {label}-wise fit launched "
                                 f"{launches}, not {n_launch} of each")
        t0 = time.perf_counter()
        out = model.transform(df_t).collect()
        torch.cuda.synchronize()
        transform_s = time.perf_counter() - t0
        prob = np.stack(out["probability"])
        if prob.shape != (100_000, N_CLASSES) or \
                not np.isfinite(prob).all():
            raise AssertionError(f"bad probabilities {prob.shape}")
        acc = float((out["prediction"] == yt).mean())
        b = model.booster
        ll = [_metric_multi_logloss(yt, b.raw_scores(Xt, num_iteration=i))
              for i in range(1, 9)]
        leaves_gpu = b.predict_leaf(Xt[:20000])
        leaves_cpu = b.predict_leaf(Xt[:20000], device="cpu")
        if not np.array_equal(leaves_gpu, leaves_cpu):
            raise AssertionError("card and CPU multiclass walks differ")
        log(f"[multiclass] {label}-wise fit {fit_s:.3f} s, launches "
            f"{launches}, {b.num_trees} trees; accuracy {acc:.4f} on 100k "
            f"fresh rows; transform {transform_s:.3f} s; multi_logloss by "
            f"iteration {' '.join(f'{v:.4f}' for v in ll)}; card and CPU "
            f"walks equal")
        if acc < 0.8 or b.num_trees != 8 * N_CLASSES or \
                not all(b2 < a2 for a2, b2 in zip(ll, ll[1:])):
            raise AssertionError(f"multiclass {label}-wise: accuracy {acc}, "
                                 f"{b.num_trees} trees, logloss {ll}")
        out_launches[label] = launches
        results[label] = {"fit_s": fit_s, "fit_rows_per_s": N_ROWS / fit_s,
                          "transform_s": transform_s, "accuracy": acc,
                          "launches": launches, "multi_logloss": ll}
    DETAIL["multiclass"] = results
    # the leaf-wise profile holds 2 of the 8 iterations (14 trees, ~41k
    # launches): a profile's cost grows with its launches
    for label, kw, prof_it in (("multiclass_leaf", dict(num_leaves=31), 2),
                               ("multiclass_level", dict(max_depth=5), 8)):
        t0 = time.perf_counter()
        fit_phases(GBDTParams(num_iterations=8, objective="multiclass",
                              num_class=N_CLASSES, **kw), label, (X, y),
                   profile_iterations=prof_it)
        results[label + "_fit_phases_s"] = time.perf_counter() - t0
    return out_launches


# ---------------------------------------------------------------------------
# phase 9: the LambdaRank ranker
# ---------------------------------------------------------------------------

RANK_FEAT = 136                                   # MSLR-WEB30K's width


def rank_data(n: int, seed: int):
    """``n`` rows x 136 features in ragged queries of 16-256 rows (the last
    one cut to fit); relevance 0-4 planted from two features plus noise.
    Returns ``(X, rel, group_ptr)``."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(16, 257, n // 16 + 1)
    gp = np.concatenate([[0], np.cumsum(sizes)])
    gp = np.concatenate([gp[gp < n], [n]])
    X = rng.normal(size=(n, RANK_FEAT)).astype(np.float32)
    raw = 1.2 * X[:, 0] - 0.8 * X[:, 1] + 0.3 * rng.normal(size=n)
    rel = np.digitize(raw, [-0.5, 0.5, 1.3, 2.1]).astype(np.float32)
    return X, rel, gp


def ndcg_at_k(scores, rel, group_ptr, k=10):
    """Independent NDCG@k (a copy of ``_ndcg_at_k`` in
    ``tests/test_ranker_ndcg_gate.py``): gain 2^rel - 1, log2 discount,
    ideal DCG by brute-force descending-relevance sort per query."""
    vals = []
    for i in range(len(group_ptr) - 1):
        a, b = group_ptr[i], group_ptr[i + 1]
        order = np.argsort(-scores[a:b], kind="stable")
        g = (2.0 ** rel[a:b] - 1.0)
        disc = 1.0 / np.log2(np.arange(b - a) + 2.0)
        dcg = float((g[order][:k] * disc[:k]).sum())
        ideal = float((np.sort(g)[::-1][:k] * disc[:k]).sum())
        if ideal > 0:
            vals.append(dcg / ideal)
    return float(np.mean(vals))


@contextlib.contextmanager
def kernels_held_to_plain(CH, checked):
    """Within the block every ``hist_accumulate`` and ``frontier_finish``
    call also runs the kernel's plain version on the same inputs, on the
    card (the finish into a copy of the arrays it writes), and raises unless
    every output is bit-identical (NaN equal to NaN).  ``checked`` counts
    the calls held, by kernel.  The wrappers count their launches on the
    module's names, so the stand-ins carry the counts while they stand."""
    acc_kernel, fin_kernel = CH.hist_accumulate, CH.frontier_finish

    def acc(binned, qg, qh, ids, N, B, lay):
        got = acc_kernel(binned, qg, qh, ids, N, B, lay)
        if not torch.equal(got, CH.hist_accumulate_plain(binned, qg, qh, ids,
                                                         N, B, lay)):
            raise AssertionError(f"hist_accumulate differs at "
                                 f"{tuple(binned.shape)}, N={N}, {lay.mode}")
        checked["hist_accumulate"] += 1
        return got

    def fin(acc_, *args, out=None, **kw):
        ref = None if out is None else out._replace(
            **{k: v.clone() for k, v in out._asdict().items()
               if v is not None})
        got = fin_kernel(acc_, *args, out=out, **kw)
        want = CH.frontier_finish_plain(acc_, *args, out=ref, **kw)
        pairs = zip(out, ref) if out is not None else zip(got, want)
        for x, y in pairs:
            if x is not None and not same_record(x, y):
                raise AssertionError(f"frontier_finish differs at "
                                     f"{tuple(acc_.shape)}")
        checked["frontier_finish"] += 1
        return got

    acc.launches, fin.launches = acc_kernel.launches, fin_kernel.launches
    CH.hist_accumulate, CH.frontier_finish = acc, fin
    try:
        yield
    finally:
        CH.hist_accumulate, CH.frontier_finish = acc_kernel, fin_kernel
        acc_kernel.launches, fin_kernel.launches = acc.launches, fin.launches


def ranker_grower_check(dev, X, rel, gp):
    """One ranker tree from the card's lambdas at the all-tied first
    iteration, the first tree the fit grows: (1) at the phase's full
    1M x 136 x 255 on the card, every kernel call held against its plain
    version on the same inputs (``kernels_held_to_plain``); (2) from the
    queries of the first ~50k rows at the same 136 features, grown on the
    card (under sync debug mode "error") and on the CPU, every array of
    the two trees equal."""
    from mmlspark_tpu_torch.lightgbm import BinMapper, GBDTParams
    from mmlspark_tpu_torch.lightgbm.core import (_make_grower,
                                                  make_lambdarank_grad_fn)
    from mmlspark_tpu_torch.ops import cuda_histogram as CH
    n, F = X.shape
    params = GBDTParams(objective="lambdarank", num_leaves=31,
                        use_quantized_grad=True).resolve()
    grow = _make_grower(params, F, N_BINS)
    mapper = BinMapper(N_BINS).fit(X)
    binned = mapper.bin_on_device(X, dev).t()          # (n, F) feature-major
    edges = torch.from_numpy(mapper.edges)
    u = torch.from_numpy(np.random.default_rng(32).random((2, n),
                                                          dtype=np.float32))
    g, h = make_lambdarank_grad_fn(rel, gp, 1.0, device=dev)(
        torch.zeros((n, 1), device=dev))
    checked = {"hist_accumulate": 0, "frontier_finish": 0}
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    CH.reset_launch_counts()
    with kernels_held_to_plain(CH, checked):
        tree = grow(binned, g[:, 0], h[:, 0],
                    torch.ones(n, dtype=torch.bool, device=dev),
                    torch.ones(F, dtype=torch.bool, device=dev),
                    edges.to(dev), noise=u.to(dev))
    torch.cuda.synchronize()
    launches = CH.launch_counts()
    if checked != {"hist_accumulate": 31, "frontier_finish": 31} or \
            launches != checked:
        raise AssertionError(f"the held ranker tree checked {checked}, "
                             f"launched {launches}")
    splits = int((tree.split_feature >= 0).sum())
    held_s = time.perf_counter() - t0
    log(f"[ranker] tree at {n} x {F} x {N_BINS} from the card's lambdas: "
        f"{splits} splits, each of its 31 hist_accumulate and 31 "
        f"frontier_finish calls bit-identical to the plain version on the "
        f"same inputs ({held_s:.1f} s)")

    q = int(np.searchsorted(gp, 50_000, side="right")) - 1
    m = int(gp[q])
    g_s, h_s = make_lambdarank_grad_fn(rel[:m], gp[:q + 1], 1.0, device=dev)(
        torch.zeros((m, 1), device=dev))
    b_s = binned.t()[:, :m].contiguous()                # (F, m)
    trees = []
    for d in (dev, torch.device("cpu")):
        args = (b_s.to(d).t(), g_s[:, 0].to(d), h_s[:, 0].to(d),
                torch.ones(m, dtype=torch.bool, device=d),
                torch.ones(F, dtype=torch.bool, device=d), edges.to(d))
        ud = u[:, :m].contiguous().to(d)
        torch.cuda.synchronize()
        if d.type == "cuda":
            torch.cuda.set_sync_debug_mode("error")
        try:
            trees.append(grow(*args, noise=ud))
        finally:
            torch.cuda.set_sync_debug_mode(0)
    identical = card_equals_cpu(*trees, f"ranker tree ({m} x {F})")
    log(f"[ranker] tree from the card's lambdas at {m} x {F} ({q} queries) "
        f"on the card equals the CPU tree ({identical} arrays "
        f"bit-identical), grown under sync debug mode 'error'")
    return {"held_rows": n, "features": F, "held_splits": splits,
            "held_calls": checked, "held_s": held_s, "cpu_rows": m,
            "cpu_queries": q, "bit_identical_arrays": identical}


def ranker_phase(dev):
    """LambdaRank at 1M x 136 in ~7,400 ragged queries: the lambdas on the
    card against the CPU's (all-tied scores, after one tree, with rows
    outside every query), the pass's time and peak memory, then
    ``LightGBMRanker()`` with its defaults for 8 iterations (248 launches of
    each kernel) and NDCG@10 on 200 held-out queries."""
    from mmlspark_tpu_torch.core import DataFrame
    from mmlspark_tpu_torch.lightgbm import (GBDTParams, LightGBMRanker,
                                             train)
    from mmlspark_tpu_torch.lightgbm.core import make_lambdarank_grad_fn
    from mmlspark_tpu_torch.ops import cuda_histogram as CH
    X, rel, gp = rank_data(N_ROWS, seed=30)
    sizes = np.diff(gp)
    log(f"[ranker] {N_ROWS} x {RANK_FEAT}, {len(sizes)} queries of "
        f"{sizes.min()}-{sizes.max()} rows (mean {sizes.mean():.1f}), "
        f"relevance counts {np.bincount(rel.astype(int)).tolist()}")
    one = train(X, rel, GBDTParams(objective="lambdarank", num_iterations=1,
                                   num_leaves=31), group_ptr=gp).booster
    checks = {}
    for case, ptr, scores in (
            ("tied", gp, np.zeros((N_ROWS, 1), np.float32)),
            ("after one tree", gp,
             one.raw_scores(X).astype(np.float32)),
            # up to 1,000 queries from a quarter in: the rows before and
            # after them lie outside every query
            ("uncovered rows", gp[len(gp) // 4:len(gp) // 4 + 1001],
             one.raw_scores(X).astype(np.float32))):
        got = []
        for d in (dev, torch.device("cpu")):
            fn = make_lambdarank_grad_fn(rel, ptr, 1.0, device=d)
            s = torch.from_numpy(scores).to(d)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if d.type == "cuda":
                torch.cuda.set_sync_debug_mode("error")
            try:
                g, h = fn(s)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            g, h = g.cpu().numpy(), h.cpu().numpy()
            got.append((g, h, time.perf_counter() - t0))
        (gc, hc, _), (gp_, hp, cpu_s) = got
        np.testing.assert_allclose(gc, gp_, rtol=1e-5, atol=1e-6,
                                   err_msg=f"lambdas, {case}")
        np.testing.assert_allclose(hc, hp, rtol=1e-5, atol=1e-6,
                                   err_msg=f"lambda hessians, {case}")
        err = float(max(np.abs(gc - gp_).max(), np.abs(hc - hp).max()))
        if case == "uncovered rows":
            outside = np.ones(N_ROWS, bool)
            outside[ptr[0]:ptr[-1]] = False
            if not ((gc[outside] == 0).all() and (hc[outside] == 1e-16)
                    .all()):
                raise AssertionError("rows outside the queries not inert")
        checks[case] = {"max_abs_err": err, "cpu_s": cpu_s}
        log(f"[ranker] lambdas card = CPU ({case}): max |diff| {err:.3g} "
            f"(rtol 1e-5, atol 1e-6; CPU pass {cpu_s:.2f} s), under sync "
            f"debug mode 'error'")

    fn = make_lambdarank_grad_fn(rel, gp, 1.0, device=dev)
    s = torch.zeros((N_ROWS, 1), device=dev)
    fn(s)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn(s)
    torch.cuda.synchronize()
    peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    pass_ms = time_ms(lambda: fn(s), 5)
    gmax = int(sizes.max())
    chunk = fn.chunks[0][1] - fn.chunks[0][0]
    # the least time for the same work: the scores and labels read, g and
    # h written; ~27 f32 operations for each ordered pair of a query (the
    # score difference, exp and reciprocal, the pair mask, |ΔNDCG|, the two
    # weighted terms and their row and column sums)
    pairs = int((sizes.astype(np.int64) ** 2).sum())
    lam_bound, lam_by = bound_ms(N_ROWS * 4 * 4, pairs * 27)
    log(f"[ranker] lambda pass {pass_ms:.2f} ms (CUDA events, 5 calls), "
        f"peak {peak_gb:.3f} GB above its inputs; {len(sizes)} queries "
        f"padded to {gmax} in {len(fn.chunks)} chunks of up to {chunk} "
        f"queries; {pairs} pairs, "
        f"bound {lam_bound:.4f} ms ({lam_by})")
    n_chunks = len(fn.chunks)
    del fn, s
    tree_check = ranker_grower_check(dev, X, rel, gp)

    Xv, relv, gpv = rank_data(60_000, seed=31)       # ~440 queries
    gpv = gpv[:201]                                  # the first 200
    Xv, relv = Xv[:gpv[-1]], relv[:gpv[-1]]
    groups = np.repeat(np.arange(len(sizes)), sizes)
    df = DataFrame.from_dict({"features": X, "label": rel, "group": groups})
    torch.cuda.synchronize()
    CH.reset_launch_counts()
    t0 = time.perf_counter()
    model = LightGBMRanker().set_params(num_iterations=8).fit(df)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = CH.launch_counts()
    if launches != {"hist_accumulate": 248, "frontier_finish": 248}:
        raise AssertionError(f"the ranker fit must launch each kernel 8 x 31 "
                             f"= 248 times, got {launches}")
    pred = model.transform(DataFrame.from_dict(
        {"features": Xv})).collect()["prediction"]
    if pred.shape != (len(relv),) or not np.isfinite(pred).all():
        raise AssertionError(f"bad ranker scores {pred.shape}")
    ndcg = ndcg_at_k(pred, relv, gpv)
    ndcg_rand = ndcg_at_k(np.random.default_rng(0).normal(size=len(relv)),
                          relv, gpv)
    b = model.booster
    leaves_gpu = b.predict_leaf(Xv)
    if not np.array_equal(leaves_gpu, b.predict_leaf(Xv, device="cpu")):
        raise AssertionError("card and CPU ranker walks differ")
    log(f"[ranker] LightGBMRanker() fit {fit_s:.3f} s, launches {launches}; "
        f"NDCG@10 on 200 held-out queries {ndcg:.4f} (random ranking "
        f"{ndcg_rand:.4f}); card and CPU walks equal")
    if ndcg < 0.9 or not ndcg_rand < ndcg:
        raise AssertionError(f"NDCG@10 {ndcg} < 0.9 or random {ndcg_rand} "
                             f"not below it")
    DETAIL["ranker"] = {"queries": len(sizes), "gmax": gmax,
                        "lambda_checks": checks, "lambda_pass_ms": pass_ms,
                        "lambda_pairs": pairs, "lambda_bound_ms": lam_bound,
                        "lambda_peak_gb": peak_gb, "chunk_queries": chunk,
                        "chunks": n_chunks, "tree_check": tree_check,
                        "fit_s": fit_s, "fit_rows_per_s": N_ROWS / fit_s,
                        "launches": launches, "ndcg_at_10": ndcg,
                        "ndcg_at_10_random": ndcg_rand}
    t0 = time.perf_counter()
    fit_phases(GBDTParams(num_iterations=8, num_leaves=31,
                          objective="lambdarank"), "ranker", (X, rel),
               group_ptr=gp)
    DETAIL["ranker"]["fit_phases_s"] = time.perf_counter() - t0
    return launches


# ---------------------------------------------------------------------------
# phase 10: out-of-core train_streamed, checkpoints and resume
# ---------------------------------------------------------------------------

BOOSTER_ARRAYS = ("split_feature", "threshold", "threshold_bin",
                  "split_gain", "internal_value", "internal_count",
                  "leaf_value", "leaf_count", "left_child", "right_child",
                  "tree_weight")


def booster_diff(a, b, what: str, exact=BOOSTER_ARRAYS, atol=0.0) -> bool:
    """Raise unless the ``exact`` arrays of two boosters are equal and the
    rest agree within ``atol``; returns whether every array is equal."""
    same = True
    for k in BOOSTER_ARRAYS:
        x, y = getattr(a, k), getattr(b, k)
        if k in exact:
            if not np.array_equal(x, y):
                raise AssertionError(f"{what}: {k} differs")
        else:
            np.testing.assert_allclose(x, y, rtol=0, atol=atol,
                                       err_msg=f"{what}: {k}")
            same &= bool(np.array_equal(x, y))
    return same


def staging_layouts(dev):
    """One full tile (131,072 x 200 uint8) host -> card in three layouts
    the driver could stage: strided feature-major slices of an (F, n)
    host matrix (the driver's), contiguous (F, T) blocks of a tile-major
    host matrix, and row-major slices of an (n, F) one, transposed on the
    card; and the kernel on each form (a row-major tile without the
    transpose is read at stride F).  The host copy into pinned memory by
    the host clock (median of 5 rounds of 10, the layouts in turns), the
    copy to the card and the card's work (the kernel's wrapper) by CUDA
    events."""
    from mmlspark_tpu_torch.ops import cuda_histogram as CH
    T, F, B = STREAM_TILE, N_FEAT, N_BINS
    rng = np.random.default_rng(3)
    n = 4 * T
    fm = rng.integers(0, B, size=(F, n), dtype=np.uint8)
    tiles = np.ascontiguousarray(fm.reshape(F, 4, T).transpose(1, 0, 2))
    rm = np.ascontiguousarray(fm.T)
    ids = torch.zeros(T, dtype=torch.int32, device=dev)
    qg = torch.ones(T, dtype=torch.int8, device=dev)
    qh = torch.ones(T, dtype=torch.int8, device=dev)
    lay = CH.lane_layout(T, T, QUANT_BINS)
    forms = {"feature_major": (fm[:, T:2 * T], (F, T)),
             "tile_major": (tiles[1], (F, T)),
             "row_major": (rm[T:2 * T], (T, F))}
    pinned = {k: torch.empty(shape, dtype=torch.uint8, pin_memory=True)
              for k, (_, shape) in forms.items()}
    rounds = {k: [] for k in forms}
    for _ in range(5):
        for k, (host, _) in forms.items():
            src = torch.from_numpy(host)
            pinned[k].copy_(src)
            t0 = time.perf_counter()
            for _ in range(10):
                pinned[k].copy_(src)
            rounds[k].append((time.perf_counter() - t0) / 10 * 1e3)
    out = {}
    for k in forms:
        buf = pinned[k]
        h2d_ms = time_ms(lambda: buf.to(dev, non_blocking=True), 10)
        on_card = buf.to(dev)
        rec = {"host_copy_ms": float(np.median(rounds[k])),
               "host_copy_ms_rounds": rounds[k], "h2d_ms": h2d_ms,
               "h2d_GB_per_s": T * F / h2d_ms / 1e6}
        if k == "row_major":
            rec["card_transpose_ms"] = time_ms(
                lambda: on_card.t().contiguous(), 10)
            rec["kernel_row_major_ms"] = time_ms(
                lambda: CH.hist_accumulate(on_card, qg, qh, ids, 1, B, lay),
                10)
            bins = on_card.t().contiguous().t()
        else:
            bins = on_card.t()
        rec["kernel_ms"] = time_ms(
            lambda: CH.hist_accumulate(bins, qg, qh, ids, 1, B, lay), 10)
        rec["total_ms"] = rec["host_copy_ms"] + h2d_ms + rec["kernel_ms"] \
            + rec.get("card_transpose_ms", 0.0)
        out[k] = rec
        log(f"[streamed] staging {k}: " + ", ".join(
            f"{key} {v:.4f}" for key, v in rec.items()
            if not isinstance(v, list)) + " (host copy rounds "
            + " ".join(f"{v:.3f}" for v in rounds[k]) + ")")
    del fm, rm, tiles
    DETAIL["streamed_staging"] = out
    return out


def streamed_card_equals_cpu(dev):
    """50k x 20 in tiles of 8,192 (7 tiles, the last padded): 3 quantized
    iterations level-wise (max_depth=4) and leaf-wise (num_leaves=15) by
    ``train_streamed`` on the card and on the CPU; every booster array
    equal."""
    from mmlspark_tpu_torch.lightgbm import GBDTParams, train_streamed
    rng = np.random.default_rng(8)
    n, F = 50_000, 20
    X = rng.normal(size=(n, F)).astype(np.float32)
    y = (X[:, 0] - X[:, 1] * X[:, 2] + rng.normal(scale=0.3, size=n)
         > 0).astype(np.float32)
    for name, kw in (("level", dict(max_depth=4)),
                     ("leaf", dict(num_leaves=15))):
        p = GBDTParams(num_iterations=3, objective="binary", seed=3,
                       use_quantized_grad=True, **kw)
        card = train_streamed(X, y, p, tile_rows=8192)
        cpu = train_streamed(X, y, p, tile_rows=8192, device="cpu")
        if card.extras["num_tiles"] != 7.0:
            raise AssertionError(f"{card.extras['num_tiles']} tiles, not 7")
        booster_diff(card.booster, cpu.booster,
                     f"streamed {name}-wise card vs CPU")
        log(f"[streamed] {name}-wise 50k x 20 in 7 tiles: card = CPU in "
            f"{len(BOOSTER_ARRAYS)}/{len(BOOSTER_ARRAYS)} booster arrays")


def streamed_fit(label, X, y, Xt, yt, params, tile_rows=STREAM_TILE,
                 **kw):
    """One streamed fit at the bench width with its launch counts (zeroed
    just before, read just after) and its peak device memory."""
    from mmlspark_tpu_torch.lightgbm import train_streamed
    from mmlspark_tpu_torch.ops import cuda_histogram as CH
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    CH.reset_launch_counts()
    t0 = time.perf_counter()
    res = train_streamed(X, y, params, tile_rows=tile_rows, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = CH.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    ex = res.extras
    prob = np.asarray(res.booster.predict(Xt)).reshape(len(yt), -1)[:, 0]
    if not np.isfinite(prob).all():
        raise AssertionError(f"streamed {label}: non-finite predictions")
    acc = float(((prob > 0.5) == (yt > 0)).mean())
    passes = ex["hist_passes"]
    rec = dict(ex, wall_s=wall, fit_rows_per_s=len(y) / wall,
               boosting_row_iterations_per_s=len(y) * res.booster.num_trees
               / ex["boosting_s"], accuracy=acc, launches=launches,
               peak_bytes=peak, base_bytes=base,
               h2d_GB_per_s=ex["h2d_bytes"] / max(ex["h2d_s"], 1e-9) / 1e9,
               trees=res.booster.num_trees)
    log(f"[streamed] {label}: {res.booster.num_trees} trees, "
        f"{ex['num_tiles']:.0f} tiles of {ex['tile_rows']:.0f}; binning_s "
        f"{ex['binning_s']:.3f}, boosting_s {ex['boosting_s']:.3f}, fit "
        f"{wall:.3f} s = {rec['fit_rows_per_s']:.0f} rows/s; "
        f"prefetch_wait_s {ex['prefetch_wait_s']:.4f}, tile_compute_s "
        f"{ex['tile_compute_s']:.4f}, prefetch_overlap_pct "
        f"{ex['prefetch_overlap_pct']:.2f}; {passes:.0f} histogram passes of "
        f"{ex['hist_pass_bytes'] / 1e6:.1f} MB host -> card, "
        f"{ex['h2d_bytes'] / 1e9:.3f} GB in all at "
        f"{rec['h2d_GB_per_s']:.2f} GB/s on the copy stream "
        f"({ex['h2d_s']:.3f} s); accuracy on 100k fresh rows {acc:.4f}; "
        f"launches {launches}; peak device memory {peak / 1e6:.1f} MB "
        f"({base / 1e6:.1f} MB before the fit)")
    if acc < 0.9:
        raise AssertionError(f"streamed {label}: accuracy {acc} < 0.9")
    for name, count in launches.items():
        if count != passes * ex["num_tiles"]:
            raise AssertionError(f"streamed {label}: {count} launches of "
                                 f"{name}, not one per tile per pass")
    return res, rec


def streamed_phase(dev):
    import tempfile
    from mmlspark_tpu_torch.lightgbm import GBDTParams, train, \
        train_streamed
    from mmlspark_tpu_torch.lightgbm.binning import BinMapper
    from mmlspark_tpu_torch.utils.resilience import request_preemption

    staging_layouts(dev)
    streamed_card_equals_cpu(dev)
    X, y = bench_data(N_ROWS, seed=0)
    Xt, yt = bench_data(100_000, seed=1)
    level = GBDTParams(num_iterations=8, max_depth=5, objective="binary")
    leaf = GBDTParams(num_iterations=8, num_leaves=31, objective="binary")
    r_level, rec_level = streamed_fit("level-wise", X, y, Xt, yt, level)
    if rec_level["launches"]["hist_accumulate"] != 320:
        raise AssertionError("level-wise: not 5 x 8 tiles x 8 iterations")
    r_leaf, rec_leaf = streamed_fit("leaf-wise", X, y, Xt, yt, leaf)
    T = STREAM_TILE
    tile_bytes = rec_leaf["hist_pass_bytes"] / rec_leaf["num_tiles"]
    acc_bytes = {"level_N16": 16 * N_FEAT * N_BINS * 3 * 4,
                 "leaf_N1": N_FEAT * N_BINS * 3 * 4}
    log(f"[streamed] leaf-wise peak {rec_leaf['peak_bytes'] / 1e6:.1f} MB "
        f"against two live tiles of {2 * tile_bytes / 1e6:.1f} MB "
        f"({tile_bytes / 1e6:.1f} MB each: {T * N_FEAT / 1e6:.1f} MB bins, "
        f"{T / 1e6:.2f} MB each of int8 grad and hess, {T * 4 / 1e6:.2f} "
        f"MB of int32 node ids) and an "
        f"accumulator of {acc_bytes['leaf_N1'] / 1e6:.2f} MB (level-wise "
        f"N = 16: {acc_bytes['level_N16'] / 1e6:.2f} MB); the full binned "
        f"matrix is {N_ROWS * N_FEAT / 1e6:.0f} MB")
    if rec_leaf["peak_bytes"] >= 150e6:
        raise AssertionError(f"leaf-wise peak {rec_leaf['peak_bytes']} B "
                             f">= 150 MB")

    # above the sketch's cap the edges follow the tile width, as the
    # reference's do: at 262,144 rows a tile they are the host sketch's
    # fed those tiles; the booster is printed as differing or not
    t0 = time.perf_counter()
    wide, rec_wide = streamed_fit("level-wise at 262,144 rows a tile", X, y,
                                  Xt, yt, level, tile_rows=2 * T)
    if rec_wide["launches"]["hist_accumulate"] != 160:
        raise AssertionError("level-wise at 262,144: not 5 x 4 tiles x 8 "
                             "iterations")
    host = BinMapper(N_BINS).fit_streaming(
        X[lo:lo + 2 * T] for lo in range(0, N_ROWS, 2 * T))
    if not np.array_equal(wide.bin_mapper.edges, host.edges):
        raise AssertionError("level-wise at 262,144: edges differ from the "
                             "host sketch fed the same tiles")
    same = all(np.array_equal(getattr(r_level.booster, k),
                              getattr(wide.booster, k))
               for k in BOOSTER_ARRAYS)
    log(f"[streamed] level-wise at 262,144 rows a tile "
        f"({wide.extras['num_tiles']:.0f} tiles): edges = the host sketch "
        f"fed those tiles; 160 launches; booster "
        f"{'bit-identical to' if same else 'differs from'} 131,072's "
        f"(above the sketch's cap the edges follow the width) "
        f"({time.perf_counter() - t0:.1f} s)")

    def preempt_at(k):
        def cb(it, ev):
            if it == k:
                request_preemption("chip_smoke")
        return cb

    def preempt_resume(label, Xs, ys, ref, params, t_first, t_resume, d):
        t0 = time.perf_counter()
        r1 = train_streamed(Xs, ys, params, tile_rows=t_first,
                            checkpoint_dir=d, checkpoint_every=1,
                            callbacks=[preempt_at(3)])
        r2 = train_streamed(Xs, ys, params, tile_rows=t_resume,
                            checkpoint_dir=d, checkpoint_every=1)
        ex1, ex2 = r1.extras, r2.extras
        if not (ex1["preempted"] == 1.0 and r1.booster.num_trees == 4
                and ex2["resharded"] == float(t_first != t_resume)
                and ex2["resumed_from_iteration"] == 4.0):
            raise AssertionError(f"streamed preempt/resume {label}: {ex1} "
                                 f"{ex2}")
        booster_diff(ref.booster, r2.booster, label)
        log(f"[streamed] {label}: resumed_from_iteration 4, resharded "
            f"{ex2['resharded']:.0f}, booster bit-identical to the "
            f"uninterrupted fit ({time.perf_counter() - t0:.1f} s)")

    with tempfile.TemporaryDirectory() as d:
        # leaf-wise at 1M rows (above the cap), preempted after iteration 3
        # and resumed at the same width
        preempt_resume("leaf-wise preempted at 3, resumed at 131,072",
                       X, y, r_leaf, leaf, T, T, d + "/s")
        # below the cap a resume may re-tile: the bench data's first
        # 196,608 rows at 32,768 rows a tile, resumed at 65,536
        n_small = 196_608
        Xs, ys = X[:n_small], y[:n_small]
        small = train_streamed(Xs, ys, leaf, tile_rows=32_768)
        preempt_resume("leaf-wise 196,608 rows preempted at 3 in tiles of "
                       "32,768, resumed at 65,536", Xs, ys, small, leaf,
                       32_768, 65_536, d + "/r")

        # train() on the card: leaf-wise, checkpoint_every=2, preempted
        # after iteration 3 and resumed
        t0 = time.perf_counter()
        full = train(X, y, leaf)
        prob = np.asarray(full.booster.predict(Xt)).reshape(len(yt), -1)
        mem_acc = float(((prob[:, 0] > 0.5) == (yt > 0)).mean())
        log(f"[streamed] accuracy on 100k fresh rows, streamed beside in "
            f"memory: leaf-wise {rec_leaf['accuracy']:.4f} beside train() "
            f"{mem_acc:.4f}; level-wise {rec_level['accuracy']:.4f} beside "
            f"the slice phase's estimator "
            f"{DETAIL.get('slice', {}).get('accuracy', float('nan')):.4f}")
        t1 = train(X, y, leaf, checkpoint_dir=d + "/t", checkpoint_every=2,
                   callbacks=[preempt_at(3)])
        t2 = train(X, y, leaf, checkpoint_dir=d + "/t", checkpoint_every=2)
        if not (t1.extras["preempted"] == 1.0
                and t2.extras["resumed_from_iteration"] == 4.0
                and t2.booster.num_trees == 8):
            raise AssertionError(f"train() preempt/resume: {t1.extras} "
                                 f"{t2.extras}")
        bitwise = booster_diff(
            full.booster, t2.booster, "train() preempted and resumed",
            exact=("split_feature", "threshold_bin", "left_child",
                   "right_child", "leaf_count"), atol=1e-6)
        log(f"[streamed] train() leaf-wise preempted after iteration 3 and "
            f"resumed: tree structure equal, leaf values within 1e-6, "
            f"bitwise equal: {bitwise} ({time.perf_counter() - t0:.1f} s)")
    DETAIL["streamed"] = {"level": rec_level, "leaf": rec_leaf,
                          "level_262144": rec_wide,
                          "level_262144_booster_equal": same,
                          "accumulator_bytes": acc_bytes,
                          "in_memory_leaf_accuracy": mem_acc,
                          "train_resume_bitwise": bitwise}
    return {"level": rec_level["launches"], "leaf": rec_leaf["launches"]}


# ---------------------------------------------------------------------------
# phase 11: deep-learning scoring (ResNet family, JaxModel, ImageFeaturizer,
# the model repo, ONNX import)
# ---------------------------------------------------------------------------

#: dense peaks of one H100 SXM (data sheet) for the dtypes the backbone runs
#: in: bfloat16 on the tensor cores, float32 with TF32 off on the CUDA cores
DNN_PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
#: card vs CPU in float32 (TF32 off on the card): max |diff| over the
#: outputs' max |value|.  cuDNN picks other algorithms, and so other
#: summation orders, than the CPU; float32 rounds ~1e-7 per layer, and the
#: differences measured on narrow nets are ~1e-6 relative
F32_REL_TOL = 1e-4
#: bfloat16 against float32 on the card, same measure: bfloat16 keeps 8
#: significant bits and rounds every layer's output (0.4% measured on the
#: seeded ResNet-50 on the CPU).  It must also lie above BF16_REL_FLOOR:
#: a bfloat16 path that computed in float32 would agree within
#: F32_REL_TOL
BF16_REL_TOL = 2e-2
BF16_REL_FLOOR = 10 * F32_REL_TOL
#: the backbone's input side, batch, and timed calls per dtype
DNN_HW = 224
DNN_BATCH = 256
DNN_REPS = {"float32": 4, "bfloat16": 10}
#: the featurizer's images: CIFAR-10's test-set size
FEATURIZER_IMAGES = 10_000


def rel_err(a, b) -> float:
    a = a.detach().float().cpu() if isinstance(a, torch.Tensor) else \
        torch.as_tensor(a).float()
    b = b.detach().float().cpu() if isinstance(b, torch.Tensor) else \
        torch.as_tensor(b).float()
    return float((a - b).abs().max() / b.abs().max())


def seeded_resnet50(gen: torch.Generator):
    """ResNet-50 at full width (224 x 224 x 3 in, 1000 classes, 2048-d
    features) with every weight and BN statistic drawn from ``gen``:
    flax's initializers for the kernels, BN scales in [0.7, 1.1] ([0.2, 0.5]
    for the last BN of each block, so the residual branch is live but
    damped), biases and means N(0, 0.1^2), variances in [0.5, 1.5]."""
    from mmlspark_tpu_torch.models import resnet
    model = resnet.resnet50(generator=gen)

    def bn(m, lo, hi):
        c = m.weight.numel()
        m.weight.copy_(torch.empty(c).uniform_(lo, hi, generator=gen))
        m.bias.copy_(torch.randn(c, generator=gen) * 0.1)
        m.running_mean.copy_(torch.randn(c, generator=gen) * 0.1)
        m.running_var.copy_(torch.empty(c).uniform_(0.5, 1.5, generator=gen))

    with torch.no_grad():
        bn(model.bn_init, 0.7, 1.1)
        for block in model.blocks:
            for m in block.norms[:-1]:
                bn(m, 0.7, 1.1)
            bn(block.norms[-1], 0.2, 0.5)
            if block.proj:
                bn(block.norm_proj, 0.7, 1.1)
        model.head.bias.copy_(torch.randn(1000, generator=gen) * 0.1)
    return model


def conv_flops(model, hw: int) -> float:
    """FLOPs of one image through ``model(x, features=True)``, counted from
    the layer shapes as 2 x multiply-adds of every convolution (BN, ReLU,
    pooling and the residual adds are left out: < 0.5%)."""
    from mmlspark_tpu_torch.models import resnet
    total = []

    def hook(m, inp, out):
        o, i, kh, kw = m.weight.shape
        total.append(2.0 * out.shape[2] * out.shape[3] * o * i * kh * kw)

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, resnet.Conv)]
    with torch.inference_mode():
        model(torch.zeros(1, hw, hw, 3, device=model.head.weight.device),
              features=True)
    for h in handles:
        h.remove()
    return sum(total)


def dnn_checkpoint(dev, repo: str):
    """The committed ShapesResNet20 through the port's repo and JaxModel on
    the card: the trainer's holdout (``tools/train_backbone.py``:
    ``make_shapes(8000, seed=1)``, scored raw), accuracy within 0.002 of
    ``eval.json``; the card's logits = the CPU port's on the first 512."""
    from mmlspark_tpu_torch.core import DataFrame
    from mmlspark_tpu_torch.dl import JaxModel, ModelDownloader
    from mmlspark_tpu_torch.dl.procedural_shapes import make_shapes
    with open(os.path.join(repo, "ShapesResNet20", "eval.json")) as f:
        pinned = json.load(f)["shapes_holdout_acc"]
    t0 = time.perf_counter()
    X, y = make_shapes(8000, seed=1)
    data_s = time.perf_counter() - t0
    payload = ModelDownloader(local_cache=repo).download_by_name(
        "ShapesResNet20")
    jm = JaxModel(input_col="image", output_col="logits", batch_size=256,
                  input_shape=[32, 32, 3])
    jm.set("model", payload)
    if jm.runner().device.type != "cuda" or any(
            p.device.type != "cuda" for p in jm.runner().module.parameters()):
        raise AssertionError("ShapesResNet20 is not on the card")
    t0 = time.perf_counter()
    out = jm.transform(DataFrame.from_dict({"image": X})).collect()["logits"]
    score_s = time.perf_counter() - t0
    logits = np.stack(list(out))
    if logits.shape != (8000, 10) or not np.isfinite(logits).all():
        raise AssertionError(f"ShapesResNet20 logits {logits.shape}")
    acc = float((logits.argmax(1) == y).mean())
    cpu = ModelDownloader(local_cache=repo).download_by_name(
        "ShapesResNet20", device="cpu")
    with torch.inference_mode():
        ref = cpu.module(torch.from_numpy(X[:512])).numpy()
    err = rel_err(logits[:512], ref)
    rec = {"accuracy": acc, "pinned": pinned, "card_vs_cpu_rel": err,
           "max_abs_logit": float(np.abs(ref).max()),
           "make_shapes_s": data_s, "transform_s": score_s,
           "bucket_calls": dict(jm.runner().bucket_calls)}
    if abs(acc - pinned) > 0.002:
        raise AssertionError(f"ShapesResNet20 accuracy {acc} vs {pinned}")
    if err > F32_REL_TOL:
        raise AssertionError(f"ShapesResNet20 card vs CPU: {err}")
    return rec


def dnn_backbone(dev):
    """ResNet-50 at full width: features of 8 images card = CPU (float32,
    TF32 off) and bfloat16 = float32 on the card; backbone images/s at
    batch 256 for both dtypes (CUDA events around warm back-to-back calls
    of normalize + ``features=True``, as ``bench.py``'s ``phase_resnet``),
    FLOPs per image, the share of the dtype's dense peak, peak memory."""
    from mmlspark_tpu_torch.models import resnet
    from mmlspark_tpu_torch.ops import image
    gen = torch.Generator().manual_seed(50)
    cpu32 = seeded_resnet50(gen)
    width = cpu32.head.in_features
    models = {}
    for name, dtype in (("float32", torch.float32),
                        ("bfloat16", torch.bfloat16)):
        m = resnet.ResNet.from_config({**cpu32.config(),
                                       "dtype": str(dtype)[6:]})
        m.load_state_dict(cpu32.state_dict())
        models[name] = m.to(dev)
    imgs = torch.rand(8, DNN_HW, DNN_HW, 3, generator=torch.Generator(
        ).manual_seed(51)) * 255
    with torch.inference_mode():
        ref = cpu32(image.normalize(imgs), features=True)
        x8 = image.normalize(imgs.to(dev))
        f32 = models["float32"](x8, features=True)
        f16 = models["bfloat16"](x8, features=True)
    if f32.shape != (8, width) or not torch.isfinite(f32).all() \
            or not torch.isfinite(f16).all():
        raise AssertionError(f"ResNet-50 features {tuple(f32.shape)}")
    rec = {"features_f32_card_vs_cpu_rel": rel_err(f32, ref),
           "features_bf16_vs_f32_card_rel": rel_err(f16, f32),
           "max_abs_feature": float(ref.abs().max())}
    if rec["features_f32_card_vs_cpu_rel"] > F32_REL_TOL:
        raise AssertionError(f"ResNet-50 card vs CPU: {rec}")
    if not BF16_REL_FLOOR < rec["features_bf16_vs_f32_card_rel"] \
            <= BF16_REL_TOL:
        raise AssertionError(f"ResNet-50 bfloat16 vs float32: {rec}")
    flops = conv_flops(models["float32"], DNN_HW)
    x = torch.rand(DNN_BATCH, DNN_HW, DNN_HW, 3, device=dev,
                   generator=torch.Generator(dev).manual_seed(52)) * 255
    for name, m in models.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        with torch.inference_mode():
            ms = time_ms(lambda: m(image.normalize(x), features=True),
                         DNN_REPS[name])
        ips = DNN_BATCH / ms * 1e3
        rec[name] = {"ms_per_batch": ms, "batch": DNN_BATCH,
                     "images_per_s": ips,
                     "tflops": flops * ips / 1e12,
                     "peak_share": flops * ips / DNN_PEAK_FLOPS[name],
                     "peak_bytes": torch.cuda.max_memory_allocated(),
                     "base_bytes": base}
    rec["gflop_per_image"] = flops / 1e9
    rec["bfloat16"]["profile"] = backbone_profile(models["bfloat16"], x)
    return models, rec


def backbone_profile(model, x, calls: int = 3):
    """Where a backbone call's device time goes: ``torch.profiler`` over
    ``calls`` warm calls; the device time per call, the busy share of the
    window's wall and the top kernels by device time."""
    from torch.profiler import ProfilerActivity, profile
    from mmlspark_tpu_torch.ops import image
    with torch.inference_mode():
        model(image.normalize(x), features=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                model(image.normalize(x), features=True)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels.sort(key=lambda e: -e.self_device_time_total)
    total = sum(e.self_device_time_total for e in kernels) / 1e3
    return {"device_ms_per_call": total / calls,
            "busy_share": total / 1e3 / wall,
            "top": [{"name": e.key[:90], "calls": e.count // calls,
                     "ms_per_call": e.self_device_time_total / 1e3 / calls}
                    for e in kernels[:10]]}


def dnn_featurizer(dev, model_bf16):
    """The BASELINE config's shape end to end: 10,000 seeded 32 x 32 x 3
    uint8 images (CIFAR-10's test-set size and shape) through
    ``ImageFeaturizer`` with the bfloat16 ResNet-50 (224 x 224, batch
    256): resize and normalize on the card, 2048-d features.  Wall
    images/s of ``transform`` and its split (host stacking, host -> card,
    device, card -> host); the first 4 images' features equal the
    backbone's on the same resized input."""
    from mmlspark_tpu_torch.core import DataFrame
    from mmlspark_tpu_torch.dl import FlaxModelPayload, ImageFeaturizer
    from mmlspark_tpu_torch.ops import image
    rng = np.random.default_rng(53)
    X = rng.integers(0, 256, (FEATURIZER_IMAGES, 32, 32, 3), dtype=np.uint8)
    feat = ImageFeaturizer(input_col="image", output_col="features",
                           height=DNN_HW, width=DNN_HW, batch_size=DNN_BATCH)
    feat.set_model(payload=FlaxModelPayload(module=model_bf16))
    warm = DataFrame.from_dict({"image": X[:DNN_BATCH]})
    feat.transform(warm).collect()
    runner = feat._build_runner().runner()
    if runner.device.type != "cuda" or any(
            p.device.type != "cuda" for p in runner.module.parameters()):
        raise AssertionError("the featurizer does not run on the card")
    before = dict(runner.phase_s)
    df = DataFrame.from_dict({"image": X})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = feat.transform(df).collect()["features"]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = np.stack(list(out[:4]))
    split = {k: runner.phase_s[k] - before[k] for k in before}
    with torch.inference_mode():
        first = torch.from_numpy(X[:DNN_BATCH].astype(np.float32)).to(dev)
        direct = model_bf16(image.normalize(image.resize(first, DNN_HW,
                                                         DNN_HW)),
                            features=True)[:4]
    err = rel_err(got, direct)
    rec = {"images": len(out), "wall_s": wall,
           "images_per_s": len(out) / wall, "split_s": split,
           "features_vs_backbone_rel": err,
           "bucket_calls": dict(runner.bucket_calls)}
    if len(out) != FEATURIZER_IMAGES or out[0].shape != (model_bf16.head.in_features,) or \
            not np.isfinite(got).all():
        raise AssertionError(f"featurizer output {len(out)} x "
                             f"{out[0].shape}")
    if err > 1e-3:
        raise AssertionError(f"featurizer vs backbone: {err}")
    return rec


def dnn_onnx(dev, repo: str):
    """The committed ONNX DigitsMLP through the port's repo: logits on 256
    seeded inputs card = CPU (its pinned accuracy needs sklearn's digits,
    which the tier-1 tests hold)."""
    from mmlspark_tpu_torch.dl import ModelDownloader
    x = np.random.default_rng(54).uniform(0, 1, (256, 64)).astype(np.float32)
    card, cpu = (ModelDownloader(local_cache=repo).download_by_name(
        "DigitsMLP", device=d).apply(x) for d in (None, "cpu"))
    if card.device.type != "cuda" or card.shape != (256, 10):
        raise AssertionError(f"DigitsMLP on {card.device}, {card.shape}")
    err = rel_err(card, cpu)
    if err > F32_REL_TOL:
        raise AssertionError(f"DigitsMLP card vs CPU: {err}")
    return {"card_vs_cpu_rel": err}


def dnn_phase(dev):
    repo = os.path.join(ROOT, "artifacts", "model_repo")
    t0 = time.perf_counter()
    ckpt = dnn_checkpoint(dev, repo)
    t_ckpt = time.perf_counter() - t0
    models, backbone = dnn_backbone(dev)
    del models["float32"]
    t_backbone = time.perf_counter() - t0 - t_ckpt
    feat = dnn_featurizer(dev, models["bfloat16"])
    onnx = dnn_onnx(dev, repo)
    DETAIL["dnn"] = {"shapes_resnet20": ckpt, "resnet50": backbone,
                     "featurizer": feat, "digits_mlp": onnx,
                     "seconds": {"checkpoint": t_ckpt,
                                 "backbone": t_backbone,
                                 "total": time.perf_counter() - t0}}
    b16, b32 = backbone["bfloat16"], backbone["float32"]
    sp = feat["split_s"]
    log(f"[dnn] ShapesResNet20 accuracy {ckpt['accuracy']:.4f} (pinned "
        f"{ckpt['pinned']}), card vs CPU {ckpt['card_vs_cpu_rel']:.2e}; "
        f"ResNet-50 features card vs CPU {backbone['features_f32_card_vs_cpu_rel']:.2e}"
        f" (f32), bf16 vs f32 {backbone['features_bf16_vs_f32_card_rel']:.2e}; "
        f"backbone at batch 256, {backbone['gflop_per_image']:.3f} GFLOP/image: "
        f"f32 {b32['images_per_s']:.1f} img/s ({100 * b32['peak_share']:.1f}% "
        f"of 67 TFLOP/s, peak {b32['peak_bytes'] / 1e9:.2f} GB), bf16 "
        f"{b16['images_per_s']:.1f} img/s ({100 * b16['peak_share']:.1f}% of "
        f"989 TFLOP/s, peak {b16['peak_bytes'] / 1e9:.2f} GB); featurizer "
        f"10,000 x 32x32 -> 224, bf16: {feat['images_per_s']:.1f} img/s "
        f"(wall {feat['wall_s']:.3f} s: stack {sp['stack']:.3f}, h2d "
        f"{sp['h2d']:.3f}, device {sp['device']:.3f}, d2h {sp['d2h']:.3f}), "
        f"vs backbone {feat['features_vs_backbone_rel']:.1e}; DigitsMLP "
        f"card vs CPU {onnx['card_vs_cpu_rel']:.1e}")


# --------------------------------------------------------------------- seq
#: bench.py's decode LM (``phase_runner``, ``bench.py:449-452``)
SEQ_LM = dict(vocab_size=512, num_classes=512, embed_dim=256, num_heads=4,
              num_layers=4, mlp_dim=512, max_len=4096, causal=True,
              pool="none")
#: the reference's committed decode tolerance (tests/test_paged_decode.py)
DECODE_ATOL = 1e-4
SEQ_PAGE_SIZES = (64, 16)
ENCODER_BATCH, ENCODER_LEN = 8, 4096
BILSTM_POINTS = ((16_384, 24), (1_024, 512))   # (sequences, tokens)
BILSTM_BATCH = 256


def _column(rows):
    col = np.empty(len(rows), dtype=object)
    for i, r in enumerate(rows):
        col[i] = r
    return col


def timed_decode(runner, prompts, **kw):
    """One decode on the card: CUDA events around the call (the device
    timeline, host gaps included) and the host clock; tokens/s counts the
    real (unfrozen) tokens; peak memory above what was held before."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    res = runner.decode(prompts, **kw)
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ev_s = start.elapsed_time(end) / 1e3
    ex = res.extras
    rec = {"tokens_per_s_events": ex["real_tokens"] / ev_s,
           "tokens_per_s_wall": ex["real_tokens"] / wall,
           "events_s": ev_s, "wall_s": wall, "steps": res.steps,
           "real_tokens": ex["real_tokens"],
           "cache_bytes_per_seq": ex["cache_bytes_per_seq"],
           "peak_bytes": torch.cuda.max_memory_allocated() - base,
           "dispatch_s": ex["dispatch_s"], "device_s": ex["device_s"]}
    if ex["kv_layout"] == "paged":
        rec.update(pages_peak=ex["pages_peak"],
                   pages_prefill=ex["pages_prefill"],
                   table_width=ex["table_width"])
    return res, rec


def decode_profile(runner, prompts, **kw):
    """Where one decode's time goes: ``torch.profiler`` over a warm call;
    the device time and its busy share of the call's wall, kernel launches
    per step and the top kernels by device time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        res = runner.decode(prompts, **kw)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    events = prof.key_averages()
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels.sort(key=lambda e: -e.self_device_time_total)
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    launches = sum(e.count for e in events if e.key == "cudaLaunchKernel")
    forwards = res.steps + 1
    return {"wall_ms": wall * 1e3, "device_ms": device_ms,
            "busy_share": device_ms / 1e3 / wall,
            "launches_per_forward": launches / forwards,
            "device_ms_per_step": device_ms / forwards,
            "wall_ms_per_step": wall * 1e3 / forwards,
            "top": [{"name": e.key[:80], "calls": e.count,
                     "ms": e.self_device_time_total / 1e3}
                    for e in kernels[:8]]}


def decode_card_vs_cpu(card, cpu, what: str):
    """Tokens equal, except from a step where the CPU's top-two logits lie
    within DECODE_ATOL (a near-tie, reported); logits within DECODE_ATOL
    up to and including each row's first divergent step."""
    near_ties, max_err = [], 0.0
    for b in range(card.tokens.shape[0]):
        bad = np.nonzero(card.tokens[b] != cpu.tokens[b])[0]
        stop = card.tokens.shape[1] if len(bad) == 0 else int(bad[0]) + 1
        err = float(np.abs(card.logits[b, :stop]
                           - cpu.logits[b, :stop]).max())
        max_err = max(max_err, err)
        if err > DECODE_ATOL:
            raise AssertionError(f"{what}: row {b} logits card vs CPU {err}")
        if len(bad):
            t = int(bad[0])
            top2 = np.sort(cpu.logits[b, t])[-2:]
            gap = float(top2[1] - top2[0])
            if gap > DECODE_ATOL:
                raise AssertionError(f"{what}: row {b} step {t} tokens "
                                     f"differ, CPU top-two gap {gap}")
            near_ties.append({"row": b, "step": t, "gap": gap})
    return {"max_abs_logit_err": max_err, "near_ties": near_ties}


def seq_decode_point(dev, lm, name, prompts, lengths, new_tokens,
                     eos_id=None):
    """One decode point in both layouts: dense and paged at each page size
    give the same greedy tokens, bit for bit; their collected logits agree
    within DECODE_ATOL; the card's agree with the CPU's; every paged page is
    back in its pool at the end."""
    from mmlspark_tpu_torch.models import ModelRunner
    runner = ModelRunner(module=lm, name=f"seq.{name}",
                         batch_size=len(prompts))
    if runner.device.type != "cuda":
        raise AssertionError("the decode runner is not on the card")
    kw = dict(lengths=lengths, max_new_tokens=new_tokens, eos_id=eos_id)
    layouts = {"dense": {}}
    layouts.update({f"paged{ps}": {"kv_layout": "paged", "page_size": ps}
                    for ps in SEQ_PAGE_SIZES})
    rec = {"batch": len(prompts), "prompt_lens": [int(lengths.min()),
                                                  int(lengths.max())],
           "new_tokens": new_tokens, "eos_id": eos_id}
    greedy = {}
    for lay, lkw in layouts.items():
        runner.decode(prompts, **kw, **lkw)                     # warm
        greedy[lay], rec[lay] = timed_decode(runner, prompts, **kw, **lkw)
        if lay != "dense" and not np.array_equal(greedy[lay].tokens,
                                                 greedy["dense"].tokens):
            raise AssertionError(f"{name}: {lay} greedy tokens differ from "
                                 "dense")
        if lay != "dense" and greedy[lay].steps != greedy["dense"].steps:
            raise AssertionError(f"{name}: {lay} steps differ")
    logits = {lay: runner.decode(prompts, collect_logits=True, **kw, **lkw)
              for lay, lkw in layouts.items()}
    for lay, res in logits.items():
        if not np.array_equal(res.tokens, logits["dense"].tokens):
            raise AssertionError(f"{name}: {lay} collect_logits tokens")
        err = float(np.abs(res.logits - logits["dense"].logits).max())
        rec[lay]["logits_vs_dense"] = err
        if err > DECODE_ATOL:
            raise AssertionError(f"{name}: {lay} logits vs dense {err}")
    if not np.array_equal(logits["dense"].tokens, greedy["dense"].tokens):
        raise AssertionError(f"{name}: fused and host-argmax tokens differ")
    for lay in ("dense", f"paged{SEQ_PAGE_SIZES[-1]}"):
        rec[lay]["profile"] = decode_profile(runner, prompts, **kw,
                                             **layouts[lay])
    for ps in SEQ_PAGE_SIZES:
        pool = runner.page_pool(ps)
        if pool.pages_in_use():
            raise AssertionError(f"{name}: {pool.pages_in_use()} pages of "
                                 f"size {ps} still held")
    cpu = ModelRunner(module=lm, name=f"seq.{name}.cpu", device="cpu")
    t0 = time.perf_counter()
    ref = cpu.decode(prompts, collect_logits=True, **kw)
    rec["cpu_s"] = time.perf_counter() - t0
    rec["card_vs_cpu"] = decode_card_vs_cpu(logits["dense"], ref, name)
    rec["finished_rows"] = int((greedy["dense"].tokens == eos_id).any(1).sum()
                               ) if eos_id is not None else 0
    return rec


def seq_decode(dev):
    """(a) decode at bench.py's LM (seeded weights, float32): bench.py's
    arm (8 x 16 prompts, 32 new tokens) and a batch of 64 ragged 16-128
    token prompts, 128 new tokens, with ``eos_id`` the token the model
    emits most often there (so some rows finish and free their pages)."""
    from mmlspark_tpu_torch.models import TransformerEncoder
    lm = TransformerEncoder(**SEQ_LM,
                            generator=torch.Generator().manual_seed(60))
    rng = np.random.default_rng(61)
    out = {}
    prompts = rng.integers(0, 512, (8, 16)).astype(np.int32)
    out["bench"] = seq_decode_point(dev, lm, "bench", prompts,
                                    np.full(8, 16, np.int32), 32)
    lengths = rng.integers(16, 129, 64).astype(np.int32)
    prompts = rng.integers(0, 512, (64, int(lengths.max()))).astype(np.int32)
    from mmlspark_tpu_torch.models import ModelRunner
    probe = ModelRunner(module=lm, name="seq.probe").decode(
        prompts, lengths=lengths, max_new_tokens=128)
    eos = int(np.bincount(probe.tokens.ravel()).argmax())
    out["large"] = seq_decode_point(dev, lm, "large", prompts, lengths, 128,
                                    eos_id=eos)
    return out


def seq_encoder(dev):
    """(b) ``TransformerEncoder`` at its defaults (vocab 512) scoring 8 x
    4,096 tokens through ``JaxModel``, dense, blockwise and ring: the three
    agree, and the card agrees with the CPU on 2 sequences."""
    from mmlspark_tpu_torch.core import DataFrame
    from mmlspark_tpu_torch.dl import JaxModel
    from mmlspark_tpu_torch.models import TransformerEncoder
    cpu = TransformerEncoder(512, generator=torch.Generator().manual_seed(62))
    x = np.random.default_rng(63).integers(
        0, 512, (ENCODER_BATCH, ENCODER_LEN)).astype(np.int32)
    df = DataFrame.from_dict({"tokens": _column(x)})
    rec, outs = {}, {}
    for mode in ("dense", "blockwise", "ring"):
        model = TransformerEncoder.from_config({**cpu.config(),
                                                "attention_mode": mode})
        model.load_state_dict(cpu.state_dict())
        jm = JaxModel(input_col="tokens", output_col="logits",
                      batch_size=ENCODER_BATCH, input_dtype="int32")
        jm.set_model(module=model)
        jm.transform(df).collect()                              # warm
        if jm.runner().device.type != "cuda":
            raise AssertionError("the encoder is not on the card")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        out = jm.transform(df).collect()["logits"]
        wall = time.perf_counter() - t0
        outs[mode] = np.stack(list(out))
        rec[mode] = {"sequences_per_s": ENCODER_BATCH / wall, "wall_s": wall,
                     "peak_bytes": torch.cuda.max_memory_allocated() - base}
        del jm, model
    if outs["dense"].shape != (ENCODER_BATCH, 2) or \
            not np.isfinite(outs["dense"]).all():
        raise AssertionError(f"encoder output {outs['dense'].shape}")
    for mode in ("blockwise", "ring"):
        rec[mode]["vs_dense_rel"] = rel_err(outs[mode], outs["dense"])
        if rec[mode]["vs_dense_rel"] > F32_REL_TOL:
            raise AssertionError(f"encoder {mode} vs dense: {rec[mode]}")
    with torch.inference_mode():
        ref = cpu(torch.from_numpy(x[:2]))
    rec["card_vs_cpu_rel"] = rel_err(outs["dense"][:2], ref)
    rec["max_abs_logit"] = float(ref.abs().max())
    if rec["card_vs_cpu_rel"] > F32_REL_TOL:
        raise AssertionError(f"encoder card vs CPU: {rec['card_vs_cpu_rel']}")
    return rec


def seq_bilstm(dev):
    """(c) BASELINE config 5: ``BiLSTMTagger`` at its defaults with the
    example's vocabulary (200) and tags (3) through ``JaxModel`` at batch
    256: 16,384 sequences of the example's 24 tokens, then 1,024 of 512;
    tokens/s per length; the card's logits equal the CPU's on the first 256
    sequences of each."""
    from mmlspark_tpu_torch.core import DataFrame
    from mmlspark_tpu_torch.dl import JaxModel
    from mmlspark_tpu_torch.models import BiLSTMTagger
    cpu = BiLSTMTagger(200, 3, generator=torch.Generator().manual_seed(64))
    card = BiLSTMTagger.from_config(cpu.config())
    card.load_state_dict(cpu.state_dict())
    jm = JaxModel(input_col="tokens", output_col="tags",
                  batch_size=BILSTM_BATCH, input_dtype="int32")
    jm.set_model(module=card)
    rec = {}
    rng = np.random.default_rng(65)
    for n, L in BILSTM_POINTS:
        x = rng.integers(0, 200, (n, L)).astype(np.int32)
        df = DataFrame.from_dict({"tokens": _column(x)})
        jm.transform(DataFrame.from_dict(
            {"tokens": _column(x[:BILSTM_BATCH])})).collect()   # warm
        if jm.runner().device.type != "cuda":
            raise AssertionError("the tagger is not on the card")
        runner = jm.runner()
        before = dict(runner.phase_s)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = jm.transform(df).collect()["tags"]
        wall = time.perf_counter() - t0
        got = np.stack(list(out[:BILSTM_BATCH]))
        with torch.inference_mode():
            ref = cpu(torch.from_numpy(x[:BILSTM_BATCH]))
        err = rel_err(got, ref)
        rec[f"{n}x{L}"] = {
            "tokens_per_s": n * L / wall, "wall_s": wall,
            "split_s": {k: runner.phase_s[k] - before[k] for k in before},
            "card_vs_cpu_rel": err}
        if len(out) != n or out[0].shape != (L, 3) or \
                not np.isfinite(got).all():
            raise AssertionError(f"tagger output {len(out)} x {out[0].shape}")
        if err > F32_REL_TOL:
            raise AssertionError(f"tagger {n}x{L} card vs CPU: {err}")
    return rec


def seq_interchange(dev):
    """(d) ONNX export of a booster fitted on the card and of seeded
    ResNet-50 weights, each imported by the port's ``onnx_import`` on the
    card; a small torch CNN through ``torch_to_jax_model``."""
    from mmlspark_tpu_torch._device import float32_exact
    from mmlspark_tpu_torch.core import DataFrame
    from mmlspark_tpu_torch.dl import (export_gbdt, export_resnet,
                                       onnx_to_jax, torch_to_jax_model)
    from mmlspark_tpu_torch.lightgbm import GBDTParams, train
    rec = {}
    X, y = bench_data(50_000, seed=66)
    X = X[:, :20].copy()
    booster = train(X, y, GBDTParams(num_iterations=4, num_leaves=15,
                                     objective="binary")).booster
    fn, weights = onnx_to_jax(export_gbdt(booster))
    Xd = torch.from_numpy(X).to(dev)
    label, scores = fn(weights, Xd)
    raw = booster.raw_scores(X)
    if scores.device.type != "cuda":
        raise AssertionError("the imported booster ran off the card")
    rec["gbdt_max_abs_err"] = float(np.abs(scores[:, 1].cpu().numpy()
                                           - raw.ravel()).max())
    if rec["gbdt_max_abs_err"] > 1e-5:
        raise AssertionError(f"exported booster vs raw_scores: {rec}")
    model = seeded_resnet50(torch.Generator().manual_seed(67)).to(dev)
    t0 = time.perf_counter()
    data = export_resnet(model)
    rec["resnet50_export_s"] = time.perf_counter() - t0
    rec["resnet50_onnx_mb"] = len(data) / 1e6
    fn, weights = onnx_to_jax(data)
    weights = {k: torch.tensor(v, device=dev) for k, v in weights.items()}
    x = torch.rand(4, DNN_HW, DNN_HW, 3, device=dev,
                   generator=torch.Generator(dev).manual_seed(68))
    with torch.inference_mode():
        want = model(x)
        got = fn(weights, x.permute(0, 3, 1, 2).contiguous())
    rec["resnet50_rel"] = rel_err(got, want)
    if rec["resnet50_rel"] > F32_REL_TOL:
        raise AssertionError(f"exported ResNet-50 vs the port's: {rec}")
    net = torch.nn.Sequential(
        torch.nn.Conv2d(3, 16, 3, padding=1), torch.nn.BatchNorm2d(16),
        torch.nn.ReLU(), torch.nn.MaxPool2d(2),
        torch.nn.Conv2d(16, 32, 3, stride=2), torch.nn.ReLU(),
        torch.nn.AdaptiveAvgPool2d(1), torch.nn.Flatten(),
        torch.nn.Linear(32, 10)).eval()
    gen = torch.Generator().manual_seed(69)
    with torch.no_grad():
        bn = net[1]
        bn.running_mean.copy_(torch.randn(16, generator=gen) * 0.2)
        bn.running_var.copy_(torch.rand(16, generator=gen) + 0.5)
    imgs = np.random.default_rng(70).normal(size=(64, 32, 32, 3)).astype(
        np.float32)
    jm = torch_to_jax_model(net, input_col="image", output_col="logits",
                            batch_size=32)
    out = np.stack(list(jm.transform(DataFrame.from_dict(
        {"image": _column(imgs)})).collect()["logits"]))
    if jm.runner().device.type != "cuda":
        raise AssertionError("the imported CNN is not on the card")
    net = net.to(dev)
    with torch.inference_mode(), float32_exact():
        want = net(torch.from_numpy(imgs).to(dev).permute(0, 3, 1, 2))
    rec["torch_cnn_rel"] = rel_err(out, want)
    if rec["torch_cnn_rel"] > 1e-5:
        raise AssertionError(f"imported CNN vs the torch module: {rec}")
    return rec


def seq_phase(dev):
    t0 = time.perf_counter()
    dec = seq_decode(dev)
    t_dec = time.perf_counter() - t0
    enc = seq_encoder(dev)
    t_enc = time.perf_counter() - t0 - t_dec
    tag = seq_bilstm(dev)
    inter = seq_interchange(dev)
    DETAIL["seq"] = {"decode": dec, "encoder": enc, "bilstm": tag,
                     "interchange": inter,
                     "seconds": {"decode": t_dec, "encoder": t_enc,
                                 "total": time.perf_counter() - t0}}
    for point, r in dec.items():
        lays = " | ".join(
            f"{lay} {r[lay]['tokens_per_s_events']:.0f} tok/s (events; wall "
            f"{r[lay]['tokens_per_s_wall']:.0f}), {r[lay]['steps']} steps, "
            f"{r[lay]['cache_bytes_per_seq'] / 1e6:.3f} MB/seq"
            + (f", pages_peak {r[lay]['pages_peak']}" if "pages_peak"
               in r[lay] else "")
            + f", peak {r[lay]['peak_bytes'] / 1e6:.1f} MB"
            + (", profiled: {device_ms_per_step:.3f} device / "
               "{wall_ms_per_step:.3f} wall ms per forward, busy "
               "{busy_share:.2f}, {launches_per_forward:.0f} launches per "
               "forward".format(**r[lay]["profile"]) if "profile" in r[lay]
               else "")
            for lay in ("dense", *(f"paged{ps}" for ps in SEQ_PAGE_SIZES)))
        log(f"[seq] decode {point} (B {r['batch']}, prompts "
            f"{r['prompt_lens'][0]}-{r['prompt_lens'][1]}, "
            f"{r['new_tokens']} new, eos {r['eos_id']}, "
            f"{r['finished_rows']} rows hit eos): {lays}; dense = paged "
            f"tokens; logits card vs CPU "
            f"{r['card_vs_cpu']['max_abs_logit_err']:.1e}, near-ties "
            f"{r['card_vs_cpu']['near_ties']}")
    log(f"[seq] encoder {ENCODER_BATCH} x {ENCODER_LEN} (vocab 512, "
        "defaults): " + " | ".join(
        f"{m} {enc[m]['sequences_per_s']:.1f} seq/s, peak "
        f"{enc[m]['peak_bytes'] / 1e9:.2f} GB"
        + (f", vs dense {enc[m]['vs_dense_rel']:.1e}" if m != "dense"
           else "") for m in ("dense", "blockwise", "ring"))
        + f"; card vs CPU {enc['card_vs_cpu_rel']:.1e}")
    log("[seq] BiLSTM (config 5, batch 256): " + " | ".join(
        f"{k} {v['tokens_per_s']:.0f} tok/s (wall {v['wall_s']:.3f} s, card "
        f"vs CPU {v['card_vs_cpu_rel']:.1e})" for k, v in tag.items()))
    log(f"[seq] interchange: exported booster vs raw_scores "
        f"{inter['gbdt_max_abs_err']:.1e}; exported ResNet-50 "
        f"({inter['resnet50_onnx_mb']:.1f} MB) vs the port's "
        f"{inter['resnet50_rel']:.1e}; imported CNN vs torch "
        f"{inter['torch_cnn_rel']:.1e}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    smi = nvidia_smi()
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    log(f"[card] {smi} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {kind} x{torch.cuda.device_count()}")

    from mmlspark_tpu_torch.kernels import _build
    from mmlspark_tpu_torch.lightgbm import GBDTParams
    t0 = time.perf_counter()
    path = _build.build()
    _build.load_library()
    log(f"[build] {path} built and loaded in {time.perf_counter() - t0:.1f} s")
    with open(os.path.join(os.path.dirname(path), "nvcc.log")) as f:
        for line in f:
            if any(k in line for k in ("registers", "Compiling entry",
                                       "spill")):
                log("[build] " + line.strip())
    t0 = time.perf_counter()
    host_path = _build.build_host()
    _build.load_host_library()
    log(f"[build] {host_path} (g++) built and loaded in "
        f"{time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    stats = kernel_phase(dev)
    torch.cuda.synchronize()
    log(f"[kernels] phase done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    level_launches = slice_phase(dev)
    grower_check(dev)
    fit_phases(GBDTParams(num_iterations=8, max_depth=5,
                          objective="binary"), "slice")
    torch.cuda.synchronize()
    log(f"[slice] phase done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    leafwise_grower_check(dev)
    leaf_launches = leaf_slice_phase(dev)
    leaf_step_times(*fit_phases(GBDTParams(num_iterations=8, num_leaves=31,
                                           objective="binary"), "leaf"))
    modes_phase(dev)
    torch.cuda.synchronize()
    log(f"[leaf] phase done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    data_phase(dev)
    torch.cuda.synchronize()
    log(f"[data] phase done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    cat_grower_check(dev)
    cat_launches = cat_phase(dev)
    objectives_phase(dev)
    torch.cuda.synchronize()
    log(f"[cat] phase done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    multiclass_grower_check(dev)
    log(f"[multiclass] grower check done in {time.perf_counter() - t0:.1f} s")
    mc_launches = multiclass_phase(dev)
    torch.cuda.synchronize()
    log(f"[multiclass] phase done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    rank_launches = ranker_phase(dev)
    torch.cuda.synchronize()
    log(f"[ranker] phase done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    stream_launches = streamed_phase(dev)
    torch.cuda.synchronize()
    log(f"[streamed] phase done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    dnn_phase(dev)
    torch.cuda.synchronize()
    log(f"[dnn] phase done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    seq_phase(dev)
    torch.cuda.synchronize()
    log(f"[seq] phase done in {time.perf_counter() - t0:.1f} s")

    paths = {"level": level_launches, "leaf": leaf_launches,
             "cat_leaf": cat_launches["leaf"],
             "cat_level": cat_launches["level"],
             "multiclass_leaf": mc_launches["leaf"],
             "multiclass_level": mc_launches["level"],
             "ranker": rank_launches,
             "streamed_level": stream_launches["level"],
             "streamed_leaf": stream_launches["leaf"]}
    kernels = [{"name": name, "route": "cuda", "source": SOURCE,
                "replaces": REPLACES[name],
                "launches": sum(c[name] for c in paths.values()),
                "launches_by_path": {k: c[name] for k, c in paths.items()},
                **stats[name]} for name in ("hist_accumulate",
                                            "frontier_finish")]
    for k in kernels:
        for key, v in k.items():
            if isinstance(v, float) and not math.isfinite(v):
                raise AssertionError(f"{k['name']}.{key} is {v}")
    DETAIL.update(card=smi, kind=kind, kernels=kernels)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke_detail.json"),
              "w") as f:
        json.dump(DETAIL, f, indent=1, default=str)
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
