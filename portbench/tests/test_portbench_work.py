"""Each work count matches a count made by hand on a small tree."""
from __future__ import annotations

import numpy as np
import pytest

from portbench.work import (fit, frontier_finish, gbdt_walk,
                            hist_accumulate, peaks)


class Booster:
    """Two trees of three leaves: tree 0 splits the root (100 rows) into
    node 1 (60) and leaf 2 (40), node 1 into leaves 0 (45) and 1 (15);
    tree 1 splits the root into leaves 0 (70) and 1 (30) and stops."""
    num_trees = 2
    num_iterations = 2
    split_feature = np.array([[3, 1], [0, -1]])
    left_child = np.array([[1, ~0], [~0, -1]])
    right_child = np.array([[~2, ~1], [~1, -1]])
    internal_count = np.array([[100.0, 60.0], [100.0, 0.0]])
    leaf_count = np.array([[45.0, 15.0, 40.0], [70.0, 30.0, 0.0]])


def test_histogram_work_counts_the_root_and_each_smaller_child():
    rows, hists = hist_accumulate.rows_and_histograms(Booster, 100)
    # tree 0: 100 + min(60, 40) + min(45, 15); tree 1: 100 + min(70, 30)
    assert rows == 100 + 40 + 15 + 100 + 30
    assert hists == (1 + 2) + (1 + 1)
    nbytes, ops = hist_accumulate.work(Booster, 100, 4, 8)
    assert nbytes == rows * (4 + 2) + hists * 4 * 8 * 3 * 4
    assert ops == rows * 4 * 3


def test_split_search_scans_the_root_and_both_children_of_each_split():
    assert frontier_finish.cells(Booster, 4, 8) == (2 + 2 * 3) * 4 * 8


def test_whole_fit_sums_its_parts():
    F, B, n = 4, 8, 100
    want = (peaks.least_s(n * F * 5, 0)
            + peaks.least_s(n * 18 * 2, 0)
            + hist_accumulate.least_s(Booster, n, F, B)
            + frontier_finish.least_s(Booster, F, B))
    assert fit.least_s(Booster, n, F, B) == pytest.approx(want)
    # LambdaRank adds its pairs' operations
    pairs = fit.ranking_pairs(np.array([0, 1, 1, 2, 0, 0]),
                              np.array([0, 4, 6]))
    # query 0 (0, 1, 1, 2): 5 differing pairs; query 1 (0, 0): none
    assert pairs == 5
    assert fit.least_s(Booster, n, F, B, pairs) == pytest.approx(
        want + peaks.least_s(0, 5 * fit.PAIR_OPS * 2))


def test_walk_work_counts_inputs_tables_outputs_and_visits():
    nbytes, ops = gbdt_walk.work(rows=10, features=3, trees=2, nodes=4,
                                 leaves=5, visits=57)
    assert nbytes == 10 * 3 * 4 + 2 * (4 * 16 + 5 * 4) + 10 * 32
    assert ops == 57 * 2


def test_least_time_is_the_larger_bound():
    assert peaks.least_s(3.35e12, 0) == pytest.approx(1.0)
    assert peaks.least_s(0, 67e12) == pytest.approx(1.0)
    assert peaks.least_s(3.35e12, 2 * 67e12) == pytest.approx(2.0)
