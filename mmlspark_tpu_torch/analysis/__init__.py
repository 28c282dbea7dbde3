"""graft-lint for the port — repo-wide static analysis of
``mmlspark_tpu_torch`` for the invariants this codebase actually enforces in
review: tracer safety under torch tracing and CUDA-graph capture (TRC),
resilience coverage at remote boundaries (RES), lock discipline in the
telemetry layer (LCK), hot-path hygiene in serving (HOT), transfer
discipline (CMP), stage contracts mirroring the fuzzing harness (STG) and
concurrency/deadlock (CCY).

The twin of the JAX package's ``analysis/`` with the same module and public
names.  It parses source on the host and imports nothing it scans, so it
takes no ``device`` argument and launches no kernel.  It gates the port's
package against the port's own baseline,
``mmlspark_tpu_torch/analysis/baseline.toml``; the JAX package keeps its own
gate and ``analysis-baseline.toml``.

Usage::

    python -m mmlspark_tpu_torch.analysis            # gate: 0 = clean
    python -m mmlspark_tpu_torch graft-lint          # the same CLI
    python -m mmlspark_tpu_torch.analysis --format json
    python -m mmlspark_tpu_torch.analysis --update-baseline

See ``RULES.md`` beside this module for the rule catalog, with torch's
tracing roots and placement shapes.
"""
from .baseline import (BaselineEntry, load_baseline, save_baseline,
                       split_findings, update_baseline)
from .checkers import (CheckpointAtomicityChecker, HotPathChecker,
                       LockDisciplineChecker, ResilienceCoverageChecker,
                       TracerSafetyChecker, TransferDisciplineChecker,
                       UnboundedBlockingChecker, UndeadlinedRetryChecker)
from .cli import default_checkers, main, rule_catalog, run_analysis
from .concurrency import ConcurrencyChecker
from .engine import AnalysisEngine, Checker, Finding, iter_python_files
from .stagecheck import StageContractChecker

__all__ = [
    "AnalysisEngine", "BaselineEntry", "Checker", "CheckpointAtomicityChecker",
    "ConcurrencyChecker",
    "Finding", "HotPathChecker", "LockDisciplineChecker", "ResilienceCoverageChecker",
    "StageContractChecker", "TracerSafetyChecker",
    "TransferDisciplineChecker", "UnboundedBlockingChecker",
    "UndeadlinedRetryChecker",
    "default_checkers", "iter_python_files", "load_baseline", "main",
    "rule_catalog", "run_analysis", "save_baseline", "split_findings",
    "update_baseline",
]
