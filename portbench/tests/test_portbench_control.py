"""The comparison that decides ``correct`` fails what it must.

The control (the reference one precision below the configuration's, in
the program's place) and, for the fit cells, the planted faults read
above a limit at a size a test run holds (``control.py``, as it runs on
the card at the cells' own sizes).  And a run whose timed path is broken
underneath (a state left unchanged, half the rows left out, an answer
altered where it is produced) ends with ``correct`` false."""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from conftest import run_in

from portbench.harness import bench

FIT_CELLS = ("higgs.fit", "mslr.fit")


@pytest.mark.parametrize("cell,candidates", [
    ("higgs.fit", "bfloat16,stale,half,altered"),
    ("mslr.fit", "bfloat16,stale,half,altered"),
    ("higgs.score", "bfloat16")])
def test_the_control_and_the_faults_fail_a_limit(tiny_root, cell,
                                                  candidates):
    rc, lines = run_in(tiny_root, "control", [
        "--workload", cell, "--seeds", "3,4,2147483659", "--candidates",
        candidates, "--seconds", "0.5"])
    assert rc == 0
    lim = bench.limits(cell)
    rows = [json.loads(x) for x in lines if x.startswith("{")]
    assert len(rows) == 3 * len(candidates.split(","))
    for r in rows:
        over = [k for k in lim if r["readings"][k] > lim[k]]
        assert over, r


def _fit_fault(monkeypatch, fault):
    from mmlspark_tpu_torch.lightgbm import core
    monkeypatch.setattr(core, "_JIT_CACHE", {})
    if fault == "stale":
        real = core._iteration

        def iteration(*a, **k):
            step = real(*a, **k)

            def stale(scores, *rest):
                keep = scores.clone()
                out = step(scores, *rest)
                scores.copy_(keep)
                return out
            return stale
        monkeypatch.setattr(core, "_iteration", iteration)
        return
    real_grower = core._make_grower

    def make_grower(*a, **k):
        grow = real_grower(*a, **k)

        def broken(binned, grad, hess, hist_mask, *rest, **kw):
            if fault == "half":
                rows = torch.arange(hist_mask.shape[0],
                                    device=hist_mask.device)
                hist_mask = hist_mask & (rows % 2 == 0)
            tree = grow(binned, grad, hess, hist_mask, *rest, **kw)
            if fault == "altered":
                lv = tree.leaf_value.clone()
                lv[0] += 0.05
                tree = tree._replace(leaf_value=lv)
            return tree
        return broken
    monkeypatch.setattr(core, "_make_grower", make_grower)


def _score_fault(monkeypatch, fault):
    from mmlspark_tpu_torch.models.gbdt import GBDTBooster
    real = GBDTBooster.raw_scores
    first = {}

    def raw_scores(self, X, *a, **k):
        out = real(self, X, *a, **k)
        if fault == "stale":
            return first.setdefault("out", out)
        if fault == "half":
            out = out.copy()
            out[out.shape[0] // 2:] = 0.0
        if fault == "altered":
            out = out.copy()
            out[0] += 1e-3
        return out
    monkeypatch.setattr(GBDTBooster, "raw_scores", raw_scores)


@pytest.mark.parametrize("cell", ["higgs.fit", "mslr.fit", "higgs.score"])
@pytest.mark.parametrize("fault", ["stale", "half", "altered"])
def test_a_broken_timed_path_reads_not_correct(tiny_root, monkeypatch,
                                               cell, fault):
    if cell in FIT_CELLS:
        _fit_fault(monkeypatch, fault)
    else:
        _score_fault(monkeypatch, fault)
    rc, lines = run_in(tiny_root, "run", [
        "--workload", cell, "--seed", "2147483661", "--seconds", "1",
        "--trace", "0"])
    assert rc == 0
    res = json.loads(lines[-1])
    assert res["correct"] is False, res["checks"]
    assert any(c["value"] > c["limit"] for c in res["checks"].values())
    assert np.isfinite([c["value"] for c in res["checks"].values()]).all()
