"""A further configuration, traffic mix and per-layer metric are taken up
as new files and entries alone: no file of the benchmark changes."""
from __future__ import annotations

import json
import os

from conftest import make_tiny, run_in

READER = '''"""Fits started in the window: a metric added as a file."""


def read(run):
    return float(len(run.records))
'''


def test_new_files_and_entries_make_a_new_cell(tmp_path):
    root = make_tiny(str(tmp_path))
    pb = os.path.join(root, "portbench")
    before = {}
    for dirpath, _, files in os.walk(pb):
        for f in files:
            p = os.path.join(dirpath, f)
            with open(p, "rb") as fh:
                before[p] = fh.read()
    with open(os.path.join(pb, "configs", "higgs.json")) as f:
        cfg = json.load(f)
    cfg.update(name="higgs_narrow", num_data=12000, num_leaves=7)
    with open(os.path.join(pb, "configs", "higgs_narrow.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(pb, "traffic", "fit_sampled.json"), "w") as f:
        json.dump({"driver": "fit", "trace_items": 1, "raw_rows": 99}, f)
    with open(os.path.join(pb, "metrics", "fits_started.fit.py"), "w") as f:
        f.write(READER)
    with open(os.path.join(pb, "limits", "higgs_narrow.fit_sampled.json"),
              "w") as f:
        with open(os.path.join(pb, "limits", "higgs.fit.json")) as g:
            f.write(g.read())
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        spec = json.load(f)
    spec["configs"].append({"name": "higgs_narrow", "source": cfg["source"],
                            "file": "portbench/configs/higgs_narrow.json",
                            "reduced": ["num_iterations"], "why": "test"})
    spec["workloads"].append({"name": "higgs_narrow.fit_sampled",
                              "config": "higgs_narrow",
                              "traffic": "fit_sampled", "chips": 1,
                              "why": "test"})
    spec["end_to_end"][0]["workloads"].append("higgs_narrow.fit_sampled")
    spec["per_layer"].append({
        "name": "fits_started.fit", "unit": "count", "better": "higher",
        "source": "host_clock", "layer": "estimator and data plane",
        "moves": "fit_row_iters_per_s",
        "workloads": ["higgs_narrow.fit_sampled"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)

    rc, lines = run_in(root, "run", [
        "--workload", "higgs_narrow.fit_sampled", "--seed", "77",
        "--seconds", "1", "--trace", "1"])
    assert rc == 0
    res = json.loads(lines[-1])
    assert res["correct"] is True
    assert res["metrics"]["fits_started.fit"]["value"] >= 1
    for p, data in before.items():
        with open(p, "rb") as fh:
            assert fh.read() == data, p
