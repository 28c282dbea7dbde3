"""Accuracy-benchmark regression harness.

An own copy of the JAX package's ``testing/benchmarks.py``, verbatim.

Reference: ``core/src/test/.../benchmarks/Benchmarks.scala:36`` — metric
values are appended to a CSV and compared against a checked-in baseline file
with per-metric precision (``compareBenchmark:70``); higherIsBetter rows only
fail when the new value is worse by more than the precision.

The reference's baseline datasets are fetched at build time from Azure
(BuildInfo.datasetDir) and are unavailable offline; this harness keeps the
exact file format and comparison semantics over deterministic synthetic
datasets (seeded), so regressions gate the same way.
"""
from __future__ import annotations

import csv
import dataclasses
import os
from typing import Dict, List


@dataclasses.dataclass
class Benchmark:
    name: str
    value: float
    precision: float
    higher_is_better: bool = True

    @staticmethod
    def from_row(row: Dict[str, str]) -> "Benchmark":
        return Benchmark(row["name"], float(row["value"]), float(row["precision"]),
                         row["higherIsBetter"].strip().lower() == "true")


class Benchmarks:
    """Collect benchmarks during a run, then compare to the baseline CSV."""

    def __init__(self, baseline_path: str):
        self.baseline_path = baseline_path
        self.new: List[Benchmark] = []

    def add(self, name: str, value: float, precision: float,
            higher_is_better: bool = True) -> None:
        self.new.append(Benchmark(name, value, precision, higher_is_better))

    def write_baseline(self, path: str = None) -> None:
        path = path or self.baseline_path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["name", "value", "precision", "higherIsBetter"])
            for b in self.new:
                w.writerow([b.name, b.value, b.precision,
                            str(b.higher_is_better).lower()])

    def load_baseline(self) -> Dict[str, Benchmark]:
        with open(self.baseline_path, newline="") as f:
            return {b.name: b for b in
                    (Benchmark.from_row(r) for r in csv.DictReader(f))}

    @staticmethod
    def compare(new: Benchmark, old: Benchmark) -> None:
        """Reference compareBenchmark:70 semantics."""
        if old.higher_is_better:
            assert new.value >= old.value - old.precision, \
                f"{new.name}: {new.value} below baseline {old.value} - {old.precision}"
        else:
            assert new.value <= old.value + old.precision, \
                f"{new.name}: {new.value} above baseline {old.value} + {old.precision}"

    def verify(self) -> None:
        old = self.load_baseline()
        new_names = {b.name for b in self.new}
        assert new_names == set(old), \
            f"benchmark set changed: +{new_names - set(old)} -{set(old) - new_names}"
        for b in self.new:
            self.compare(b, old[b.name])
