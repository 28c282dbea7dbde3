"""A tiny run of each cell through ``run.py`` on the CPU prints, last, one
JSON line of the contract's shape, and the numbers compared beside their
limits."""
from __future__ import annotations

import json

import pytest

from conftest import REPO, run_in

from portbench.harness import bench

CELLS = [w["name"] for w in bench.benchmark(REPO)["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("traced", [0, 1])
def test_a_tiny_run_prints_the_contract_line(tiny_root, cell, traced):
    rc, lines = run_in(tiny_root, "run", [
        "--workload", cell, "--seed", str(2**31 + 11), "--seconds", "1",
        "--trace", str(traced)])
    assert rc == 0
    res = json.loads(lines[-1])
    assert list(res)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(res)
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 1
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    spec = bench.benchmark(tiny_root)
    if traced:
        layer = bench.cell_metrics(spec, cell, "per_layer")
        assert set(res["metrics"]) <= {m["name"] for m in layer}
        # the CPU's trace holds no device record: no share or idle time is
        # read from it, rather than a 0
        assert not {m["name"] for m in layer
                    if m["source"] == "device_trace"} & set(res["metrics"])
        assert "busy_s" not in res["device"]
        assert "breakdown" not in res
    else:
        want = {m["name"] for m in bench.cell_metrics(spec, cell,
                                                      "end_to_end")}
        assert set(res["metrics"]) == want
        assert all(v["value"] > 0 for v in res["metrics"].values())
    lim = bench.limits(cell)
    assert set(res["checks"]) == set(lim)
    for c in res["checks"].values():
        assert c["value"] <= c["limit"]
