"""On the card: a short run of each cell at the tiny size ends correct,
on the card, with a device trace when traced (skips without a card)."""
from __future__ import annotations

import json

import pytest

from conftest import REPO, run_in

from portbench.harness import bench

CELLS = [w["name"] for w in bench.benchmark(REPO)["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_tiny_traced_run_on_the_card(tiny_root, card, cell):
    rc, lines = run_in(tiny_root, "run", [
        "--workload", cell, "--seed", "2147483663", "--seconds", "2",
        "--trace", "1"], device=None)
    assert rc == 0
    res = json.loads(lines[-1])
    assert res["correct"] is True
    assert res["device"]["platform"] == "gpu"
    assert res["device"]["busy_s"] > 0
