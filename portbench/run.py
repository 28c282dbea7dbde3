#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` on the card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Set-up (from the process's start: imports, the seeded inputs, the
cell's warm-up, which builds the kernels and captures the programs) is
``setup_s``; its phases and ``nvidia-smi``'s reading of the card are
printed once its clock has stopped.  The window then starts items (fits, transform calls) of the
cell's driver until ``--seconds`` have passed; the last one started
finishes.  With ``--trace 1`` the first items of the window run under
``torch.profiler`` and the line carries the cell's per-layer metrics, the
device's busy and traced seconds and a breakdown; else its end-to-end
metrics.  After the window the memory peak is read, the program's state
is dropped and the reference judges what the window produced: each
number compared is printed beside its limit, last on standard error and
under ``checks`` in the result.  The last line of standard output is the
result.  Without enough cards, or when ``jax``, ``jaxlib``, ``flax`` or
``mmlspark_tpu`` is loaded once the window has closed (looked for after
the window and again just before the result), the run prints no result
and exits non-zero.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

#: top-level module names that may not be loaded, compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "mmlspark_tpu")
#: every compiler cache at a fixed path inside the checkout
CACHES = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR":
          "torch_extensions", "CUDA_CACHE_PATH": "nv_compute"}


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def finite(x: float) -> float:
    """A reading for JSON: a non-finite one as the largest float."""
    return x if math.isfinite(x) else math.copysign(sys.float_info.max, x)


def _window(run, driver, k_traced: int):
    """Start items until the window's seconds have passed (at least
    one).  With ``k_traced`` the first ``k_traced`` items run under the
    profiler; a traced stretch whose device records fall short of the
    launches is traced again on the next items, up to three times."""
    import torch
    from portbench.harness import trace
    sessions = 0
    run.window_start = t0 = time.perf_counter()
    i = 0
    while i == 0 or time.perf_counter() - t0 < run.seconds:
        if k_traced and not run.traced and sessions < 3:
            sessions += 1
            recs = []
            with trace.Trace(run.device) as tr:
                for _ in range(k_traced):
                    with torch.profiler.record_function("portbench.item"):
                        recs.append(_item(run, driver, i))
                    i += 1
                t_items = time.perf_counter()
            run.notes.append(f"traced stretch {sessions}: the profiler "
                             f"stopped and was read in "
                             f"{time.perf_counter() - t_items:.1f} s")
            run.records.extend(recs)
            spans = tr.ranges("portbench.item")
            if len(spans) == len(recs) and tr.device and \
                    driver.trace_ok(run, tr, spans, recs):
                run.tracer = tr
                run.traced = [dict(r, span=sp) for r, sp in zip(recs, spans)]
            else:
                run.notes.append(
                    f"traced stretch {sessions}: {len(tr.device)} device "
                    f"records short of the launches; traced again")
            continue
        run.records.append(_item(run, driver, i))
        i += 1


def start(spec: dict, name: str, seed: int, seconds: float, trace: bool,
          device):
    """The run of cell ``name`` and its driver, nothing made yet."""
    from portbench.harness import bench
    cell = bench.cell(spec, name)
    run = bench.Run(root=ROOT, cell=cell,
                    config=bench.config(ROOT, spec, cell["config"]),
                    traffic=bench.traffic(cell["traffic"]), seed=seed,
                    seconds=seconds, trace=trace, device=device)
    return run, bench.module("drivers", run.traffic["driver"])


def measure(run, driver, t_start: float) -> float:
    """Set the run up, then run its window.  Returns set-up's seconds
    from ``t_start``: the driver's set-up, synchronised.  The card is
    read after that clock stops."""
    import torch
    from portbench.harness import counters, devinfo
    driver.setup(run)
    if run.device.type == "cuda":
        torch.cuda.synchronize(run.device)
    setup_s = time.perf_counter() - t_start
    run.mark("set-up done")
    print(f"portbench: set-up phases (s from the process's start) "
          f"{json.dumps({k: round(t - t_start, 3) for k, t in run.marks})}"
          f"; card after set-up {json.dumps(devinfo.smi())}", flush=True)
    before = counters.snapshot()
    _window(run, driver, int(run.traffic["trace_items"]) if run.trace
            else 0)
    if run.device.type == "cuda":
        torch.cuda.synchronize(run.device)
    run.counters["captures"] = counters.captures_between(
        before, counters.snapshot())
    return setup_s


def _refuse_if_forbidden(when: str) -> bool:
    found = forbidden_modules()
    if found:
        print(f"portbench: loaded {when}: {found}", file=sys.stderr)
    return bool(found)


def _item(run, driver, i):
    try:
        return driver.item(run, i)
    except Exception as e:  # noqa: BLE001 - a failed item is counted
        now = time.perf_counter()
        print(f"portbench: item {i} failed: {e!r}", file=sys.stderr)
        return {"t0": now, "t1": now, "error": repr(e)}


def main(argv=None, device=None) -> int:
    """Run the cell; ``device`` (tests only) skips the look for a card."""
    args = parse(argv)
    for var, sub in CACHES.items():
        os.environ[var] = os.path.join(ROOT, ".portbench_cache", sub)
    import torch
    from portbench.harness import bench, devinfo, trace

    spec = bench.benchmark(ROOT)
    cell = bench.cell(spec, args.workload)
    chips = int(cell["chips"])
    if device is None:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < chips:
            print(f"portbench: {args.workload} needs {chips} CUDA "
                  f"card(s); found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    device = torch.device(device)
    run, driver = start(spec, args.workload, args.seed, args.seconds,
                        bool(args.trace), device)
    run.mark("imports and the card")
    print(f"portbench: {args.workload} seed {args.seed} on "
          f"{devinfo.device_record(device, chips)['kind']}", flush=True)
    setup_s = measure(run, driver, T_START)
    dev_rec = devinfo.device_record(device, chips)
    took = sorted(r["t1"] - r["t0"] for r in run.records)
    print(f"portbench: {len(took)} items, seconds each min "
          f"{took[0]!r} median {took[len(took) // 2]!r} max {took[-1]!r}; "
          f"setup_s {setup_s!r}; card after the window "
          f"{json.dumps(devinfo.smi())}", flush=True)
    item_times = [[round(r[k] - run.window_start, 3)
                   for k in ("t0", "t1")] for r in run.records]
    print(f"portbench: items' start and end (s from the window's start) "
          f"{json.dumps(item_times)}", flush=True)
    if _refuse_if_forbidden("once the window closed"):
        return 4
    attempted = len(run.records)
    failed = sum(1 for r in run.records if "error" in r)
    if failed == attempted:
        print("portbench: every item of the window failed",
              file=sys.stderr)
        return 5

    result = {"correct": False, "attempted": attempted, "failed": failed}
    t_read = time.perf_counter()
    if run.trace:
        metrics = {}
        for m in bench.cell_metrics(spec, cell["name"], "per_layer"):
            v = bench.metric_reader(m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        if run.traced:
            spans = [t["span"] for t in run.traced]
            dev_rec["busy_s"] = trace.busy_us(run.tracer, spans) / 1e6
            dev_rec["window_s"] = sum(e - s for s, e in spans) / 1e6
            result["breakdown"] = {
                "device_ops": trace.top_device_ops(run.tracer, spans),
                "idle_gaps": trace.idle_gaps(run.tracer, spans)}
        else:
            print("portbench: the profiler gave no complete trace of the "
                  "window's first items: no device-trace metric is read",
                  file=sys.stderr)
    else:
        values = dict(driver.end_to_end(run), setup_s=setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in bench.cell_metrics(spec, cell["name"],
                                               "end_to_end")}
    run.notes.append(f"metrics read in {time.perf_counter() - t_read:.1f} s")
    for note in run.notes:
        print(f"portbench: {note}", file=sys.stderr)

    t_check = time.perf_counter()
    readings = driver.check(run)
    print(f"portbench: the reference judged in "
          f"{time.perf_counter() - t_check:.1f} s", file=sys.stderr)
    limits = bench.limits(cell["name"])
    for k in sorted(set(readings) - set(limits)):
        print(f"portbench: not compared: {k} {readings[k]!r}",
              file=sys.stderr)
    checks = {k: {"value": finite(float(readings[k])), "limit": limits[k]}
              for k in limits if k in readings}
    correct = failed == 0 and len(checks) == len(limits) and all(
        c["value"] <= c["limit"] for c in checks.values())
    result.update(correct=correct, metrics=metrics, device=dev_rec,
                  checks=checks)
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    # metric readers and the reference ran since the first look
    if _refuse_if_forbidden("after the window, by the readers or the "
                            "reference"):
        return 4
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
