"""Every part a cell names is found by name, and ``BENCHMARK.json`` keeps
the shape the benchmark's contract gives it."""
from __future__ import annotations

import json
import os
import re

from conftest import REPO

from portbench.harness import bench

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def spec():
    return bench.benchmark(REPO)


def test_each_cell_finds_its_config_traffic_driver_dataset_and_limits():
    s = spec()
    for w in s["workloads"]:
        cfg = bench.config(REPO, s, w["config"])
        tr = bench.traffic(w["traffic"])
        assert callable(bench.module("drivers", tr["driver"]).item)
        assert callable(bench.module("datasets", cfg["dataset"]).make)
        lim = bench.limits(w["name"])
        assert lim and all(isinstance(v, (int, float)) for v in lim.values())


def test_each_metric_has_a_reader_and_each_cell_reports_enough():
    s = spec()
    for m in s["per_layer"]:
        assert callable(bench.metric_reader(m["name"]))
    for w in s["workloads"]:
        e2e = [m["name"] for m in bench.cell_metrics(s, w["name"],
                                                     "end_to_end")]
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = bench.cell_metrics(s, w["name"], "per_layer")
        assert layer
        for m in layer:
            assert m["moves"] in e2e


def test_benchmark_json_keeps_the_contract_shape():
    s = spec()
    assert set(s) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= s["run_seconds"] <= 51
    names = [c["name"] for c in s["configs"]]
    names += [w["name"] for w in s["workloads"]]
    names += [m["name"] for m in s["end_to_end"] + s["per_layer"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in s["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/")
        assert all(NAME.match(k) for k in c["reduced"])
    pairs = set()
    for w in s["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    for m in s["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in s["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["source"] in SOURCES
    for m in s["end_to_end"] + s["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert len(json.dumps(s)) < 64 * 1024


def test_configurations_state_source_cuts_assumptions_and_precision():
    s = spec()
    for c in s["configs"]:
        with open(os.path.join(REPO, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["source"] == c["source"]
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])
        assert cfg["assumed"] and cfg["precision"]
        for k in c["reduced"]:
            assert k in cfg["published"]
