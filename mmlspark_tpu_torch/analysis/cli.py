"""graft-lint CLI for the port.

    python -m mmlspark_tpu_torch.analysis [paths...] [--format text|json]
                                          [--update-baseline]
                                          [--baseline FILE]
                                          [--rules TRC001,RES001,...]
                                          [--no-baseline] [--changed-only]

(also ``python -m mmlspark_tpu_torch graft-lint``).  Exit status: 0 when
every finding is baselined (or none), 1 when any unbaselined finding
exists, 2 on usage errors.  Default scan target is the
``mmlspark_tpu_torch`` package the module was imported from; default
baseline is ``mmlspark_tpu_torch/analysis/baseline.toml`` under the repo
root.  The JAX package keeps its own gate (``python -m
mmlspark_tpu.analysis``) and baseline (``analysis-baseline.toml``).

``--changed-only`` scopes REPORTING to files git sees as changed (staged,
unstaged, and untracked), while the analysis still parses the whole
package: the cross-module passes (STG inheritance, TRC call BFS, the CCY
lock graph) need every module in view to resolve — a staged-files-only
SCAN would false-positive — but a reviewer only wants findings their
diff can have introduced.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional, Sequence

from .baseline import (DEFAULT_BASELINE_NAME, load_baseline, split_findings,
                       update_baseline)
from .checkers import (CheckpointAtomicityChecker, HotPathChecker,
                       LockDisciplineChecker, ResilienceCoverageChecker,
                       TracerSafetyChecker, TransferDisciplineChecker,
                       UnboundedBlockingChecker, UndeadlinedRetryChecker)
from .concurrency import ConcurrencyChecker
from .engine import (PACKAGE, AnalysisEngine, Checker, Finding,
                     iter_python_files)
from .stagecheck import StageContractChecker

__all__ = ["default_checkers", "run_analysis", "main", "rule_catalog",
           "git_changed_files"]


def default_checkers(package: str = PACKAGE) -> List[Checker]:
    """Every shipped checker; those whose rules name module paths spell
    them under ``package``."""
    return [TracerSafetyChecker(), ResilienceCoverageChecker(package),
            UndeadlinedRetryChecker(package), CheckpointAtomicityChecker(),
            LockDisciplineChecker(), HotPathChecker(),
            TransferDisciplineChecker(package),
            StageContractChecker(package=package),
            UnboundedBlockingChecker(), ConcurrencyChecker(package)]


def rule_catalog() -> dict:
    """rule id -> description across all shipped checkers."""
    catalog = {}
    for checker in default_checkers():
        catalog.update(checker.rules)
    return catalog


def git_changed_files(root: str) -> Optional[List[str]]:
    """Repo-relative paths of changed ``.py`` files (staged + unstaged +
    untracked), or None when ``root`` is not a git work tree — the caller
    then falls back to an unscoped report rather than reporting nothing."""
    import subprocess
    try:
        out = subprocess.run(
            ["git", "-C", root, "status", "--porcelain", "-uall"],
            capture_output=True, text=True, timeout=30, check=True).stdout
    except Exception:  # noqa: BLE001 — not a repo / no git: fall back
        return None
    changed: List[str] = []
    for line in out.splitlines():
        if len(line) < 4:
            continue
        path = line[3:]
        if " -> " in path:           # rename: report the new side
            path = path.split(" -> ", 1)[1]
        path = path.strip().strip('"')
        if path.endswith(".py"):
            changed.append(path)
    return changed


def _package_root() -> str:
    """The directory CONTAINING the mmlspark_tpu_torch package (the repo
    root in a checkout) — findings are reported relative to it."""
    pkg_dir = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.dirname(pkg_dir)


def run_analysis(paths: Optional[Sequence[str]] = None,
                 root: Optional[str] = None,
                 checkers: Optional[Sequence[Checker]] = None,
                 rules: Optional[Sequence[str]] = None) -> List[Finding]:
    """Programmatic entry: scan ``paths`` (default: the installed
    mmlspark_tpu_torch package), return all findings before baselining."""
    root = root or _package_root()
    if paths is None:
        paths = [os.path.join(root, PACKAGE)]
    files: List[str] = []
    for p in paths:
        files.extend(iter_python_files(p))
    engine = AnalysisEngine(checkers or default_checkers(), root=root)
    findings = engine.run(files)
    if rules:
        # exact ids or family prefixes: "STG" matches STG001..STG003 (the
        # pre-commit hook restricts by family without hardcoding every id);
        # empty strings would prefix-match everything, so they are dropped
        wanted = tuple(r for r in rules if r)
        if wanted:
            findings = [f for f in findings if f.rule.startswith(wanted)]
    return findings


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="graft-lint",
        description="AST invariant checker for mmlspark_tpu_torch: tracer "
                    "safety under torch tracing and CUDA-graph capture "
                    "(TRC), resilience coverage (RES), lock discipline "
                    "(LCK), hot-path hygiene (HOT), transfer discipline "
                    "(CMP), stage contracts (STG), concurrency/deadlock "
                    "(CCY).")
    parser.add_argument("paths", nargs="*",
                        help="files/dirs to scan (default: the "
                             "mmlspark_tpu_torch package)")
    parser.add_argument("--format", choices=("text", "json"), default="text")
    parser.add_argument("--baseline", default=None,
                        help="baseline file (default: "
                             f"{DEFAULT_BASELINE_NAME} under the repo "
                             "root)")
    parser.add_argument("--no-baseline", action="store_true",
                        help="ignore the baseline: report every finding "
                             "and fail on any")
    parser.add_argument("--update-baseline", action="store_true",
                        help="rewrite the baseline from current findings "
                             "(existing justifications are preserved)")
    parser.add_argument("--rules", default=None,
                        help="comma-separated rule ids or family prefixes "
                             "to restrict to (e.g. STG001,STG002 or "
                             "TRC,RES,LCK,HOT)")
    parser.add_argument("--list-rules", action="store_true",
                        help="print the rule catalog and exit")
    parser.add_argument("--root", default=None,
                        help="repo root for relative paths (default: the "
                             "package's parent directory)")
    parser.add_argument("--changed-only", action="store_true",
                        help="report findings only in git-changed files "
                             "(staged+unstaged+untracked); the full "
                             "package is still parsed so cross-module "
                             "rules resolve correctly")
    args = parser.parse_args(argv)

    if args.list_rules:
        for rule, desc in sorted(rule_catalog().items()):
            print(f"{rule}  {desc}")
        return 0

    root = os.path.abspath(args.root) if args.root else _package_root()
    # drop empty segments: a stray trailing comma would otherwise become a
    # ""-prefix that matches EVERY rule, silently un-restricting the scan
    rules = [r.strip() for r in args.rules.split(",") if r.strip()] \
        if args.rules else None
    findings = run_analysis(args.paths or None, root=root, rules=rules)

    changed_scope: Optional[List[str]] = None
    if args.changed_only:
        if args.update_baseline:
            parser.error("--changed-only cannot combine with "
                         "--update-baseline (a scoped rewrite would drop "
                         "every entry outside the diff)")
        changed_scope = git_changed_files(root)
        if changed_scope is not None:
            in_scope = set(changed_scope)
            findings = [f for f in findings if f.file in in_scope]

    baseline_path = args.baseline or os.path.join(root, DEFAULT_BASELINE_NAME)
    if args.update_baseline:
        # a rule-restricted rewrite must not drop other families' entries:
        # findings were filtered, so out-of-scope entries would all look
        # "no longer firing" to the merge and be deleted with their
        # human-written justifications
        preserved = [e for e in load_baseline(baseline_path)
                     if not e.rule.startswith(tuple(rules))] if rules else []
        entries = update_baseline(baseline_path, findings, preserved)
        print(f"baseline written: {baseline_path} ({len(entries)} entries)")
        todo = sum(1 for e in entries if e.justification.startswith("TODO"))
        if todo:
            print(f"  {todo} entries need a justification before merge")
        return 0

    entries = [] if args.no_baseline else load_baseline(baseline_path)
    if rules:
        # a restricted scan must not report out-of-scope entries as stale
        entries = [e for e in entries if e.rule.startswith(tuple(rules))]
    if changed_scope is not None:
        # same guard for the diff scope: an entry for an unchanged file has
        # no matching finding left after the filter above and would be
        # reported stale on every pre-commit run
        in_scope = set(changed_scope)
        entries = [e for e in entries if e.file in in_scope]
    new, accepted, stale = split_findings(findings, entries)

    if args.format == "json":
        print(json.dumps({
            "findings": [vars(f) for f in new],
            "baselined": [vars(f) for f in accepted],
            "stale_baseline_entries": [
                {"rule": e.rule, "file": e.file, "symbol": e.symbol}
                for e in stale],
        }, indent=1))
    else:
        for f in new:
            print(f.render())
        if stale:
            print(f"-- {len(stale)} stale baseline entr"
                  f"{'y' if len(stale) == 1 else 'ies'} (fixed sites — "
                  "remove from the baseline):")
            for e in stale:
                print(f"   {e.rule} {e.file} [{e.symbol}]")
        print(f"graft-lint: {len(new)} finding"
              f"{'' if len(new) == 1 else 's'}, {len(accepted)} baselined, "
              f"{len(stale)} stale")
    return 1 if new else 0


if __name__ == "__main__":
    sys.exit(main())
