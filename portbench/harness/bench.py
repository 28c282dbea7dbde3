"""Finding a cell's parts by name, and the state of one run.

``BENCHMARK.json`` names each cell's configuration file and traffic mix;
the mix names its driver.  Everything else is a file named after the
thing it serves: ``traffic/<mix>.json``, ``drivers/<kind>.py``,
``datasets/<kind>.py``, ``metrics/<metric>.py``, ``limits/<cell>.json``.
A later cell, mix, driver or metric is new files and entries: no file
here changes.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import os
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"portbench: no workload named {name!r} in "
                     "BENCHMARK.json")


def config(root: str, bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return load_json(os.path.join(root, c["file"]))
    raise SystemExit(f"portbench: no configuration named {name!r}")


def traffic(name: str) -> dict:
    return load_json(os.path.join(HERE, "traffic", f"{name}.json"))


def limits(cell_name: str) -> Dict[str, float]:
    return load_json(os.path.join(HERE, "limits", f"{cell_name}.json"))


def module(kind: str, name: str):
    """``portbench.<kind>.<name>``: a driver, dataset or reference."""
    return importlib.import_module(f"portbench.{kind}.{name}")


def metric_reader(name: str):
    """``metrics/<name>.py``'s ``read``; a metric's name may hold dots."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench: dict, cell_name: str, section: str) -> List[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics this cell reports."""
    return [m for m in bench[section]
            if "workloads" not in m or cell_name in m["workloads"]]


@dataclass
class Run:
    """What one run made and measured; drivers and metric readers read
    and fill it."""
    root: str
    cell: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    state: Dict[str, Any] = field(default_factory=dict)
    #: one record per item of the window (a fit, a call)
    records: List[dict] = field(default_factory=list)
    #: the traced items' records and their spans on the trace's clock
    traced: List[dict] = field(default_factory=list)
    tracer: Optional[Any] = None
    counters: Dict[str, float] = field(default_factory=dict)
    window_start: float = 0.0
    notes: List[str] = field(default_factory=list)
    #: set-up's phases: (name, the clock when it ended)
    marks: List[Tuple[str, float]] = field(default_factory=list)

    def mark(self, name: str) -> None:
        self.marks.append((name, time.perf_counter()))
