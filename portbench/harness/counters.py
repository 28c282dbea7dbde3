"""The program's own counters that per-layer metrics read: its compiled
programs' captures (a signature's first call, booked as a compile in the
metrics registry, which outlives the program) and re-captures (read from
the programs still alive)."""
from __future__ import annotations

from typing import Dict


def snapshot() -> Dict[str, object]:
    from mmlspark_tpu_torch.observability import compute
    from mmlspark_tpu_torch.observability.metrics import get_registry
    fam = get_registry().counter("mmlspark_jit_compile_total",
                                 labels=("fn",))
    compiles = sum(child.value for _, child in fam._snapshot())
    return {"compiles": float(compiles),
            "recaptures": {id(p): p.recaptures
                           for p in list(compute._PROGRAMS)}}


def captures_between(before: Dict[str, object],
                     after: Dict[str, object]) -> float:
    """Captures and re-captures booked between two snapshots."""
    rec_before = before["recaptures"]
    recaptures = sum(n - rec_before.get(k, 0)
                     for k, n in after["recaptures"].items())
    return after["compiles"] - before["compiles"] + float(recaptures)
