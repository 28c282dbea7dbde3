"""Baseline file — the port's curated list of accepted findings.

``mmlspark_tpu_torch/analysis/baseline.toml`` records every finding of the
port's package that the team has looked at and deliberately kept, each with
a one-line justification (the JAX package keeps its own,
``analysis-baseline.toml`` at the repo root, and its own gate).  The
CLI exits nonzero on any finding NOT in the baseline, so the gate ratchets:
new violations fail CI immediately, old accepted ones stay visible and
justified instead of silently pragma'd away.

Identity is ``(rule, file, symbol)`` (see ``Finding.key``) — line numbers
are recorded for the reader but do not participate in matching, so edits
elsewhere in a file never invalidate its baseline entries.

The file is a deliberately tiny TOML subset (``[[suppression]]`` tables of
string keys) read/written by this module directly: ``tomllib`` only reads,
the writer is needed anyway, and the repo vendors nothing.
"""
from __future__ import annotations

import os
from typing import Dict, Iterable, List, Sequence, Tuple

from .engine import Finding

__all__ = ["BaselineEntry", "load_baseline", "save_baseline",
           "split_findings", "update_baseline", "DEFAULT_BASELINE_NAME"]

#: the baseline's path relative to the repo root: inside the port's package,
#: so it never collides with the JAX package's ``analysis-baseline.toml``
DEFAULT_BASELINE_NAME = "mmlspark_tpu_torch/analysis/baseline.toml"

_HEADER = """\
# graft-lint baseline for mmlspark_tpu_torch — accepted findings, one
# justified entry each.
# Regenerate scaffolding with:
#   python -m mmlspark_tpu_torch.analysis --update-baseline
# Matching is (rule, file, symbol); `line` is informational only.
"""


class BaselineEntry:
    __slots__ = ("rule", "file", "symbol", "line", "justification", "count")

    def __init__(self, rule: str, file: str, symbol: str = "",
                 line: int = 0, justification: str = "", count: int = 1):
        self.rule = rule
        self.file = file
        self.symbol = symbol
        self.line = int(line)
        self.justification = justification
        #: how many findings this entry covers — the ratchet: a SECOND
        #: same-rule violation appearing inside an already-baselined
        #: function is a NEW finding, not silently accepted
        self.count = max(1, int(count))

    def key(self) -> Tuple[str, str, str]:
        return (self.rule, self.file, self.symbol)

    @classmethod
    def for_finding(cls, f: Finding, justification: str) -> "BaselineEntry":
        return cls(rule=f.rule, file=f.file, symbol=f.symbol, line=f.line,
                   justification=justification)


def _toml_escape(s: str) -> str:
    return s.replace("\\", "\\\\").replace('"', '\\"')


def _toml_unescape(s: str) -> str:
    return s.replace('\\"', '"').replace("\\\\", "\\")


def load_baseline(path: str) -> List[BaselineEntry]:
    """Parse the baseline's TOML subset; missing file = empty baseline."""
    if not os.path.exists(path):
        return []
    entries: List[BaselineEntry] = []
    current: Dict[str, str] = {}
    in_table = False
    with open(path, encoding="utf-8") as fh:
        for raw_line in fh:
            line = raw_line.strip()
            if not line or line.startswith("#"):
                continue
            if line == "[[suppression]]":
                if in_table:
                    entries.append(_entry_from(current))
                current, in_table = {}, True
                continue
            if "=" in line and in_table:
                key, _, value = line.partition("=")
                key, value = key.strip(), value.strip()
                if value.startswith('"') and value.endswith('"'):
                    current[key] = _toml_unescape(value[1:-1])
                else:
                    current[key] = value  # bare int (line = 42)
    if in_table:
        entries.append(_entry_from(current))
    return entries


def _entry_from(d: Dict[str, str]) -> BaselineEntry:
    def _int(key, default):
        try:
            return int(d.get(key, default))
        except ValueError:
            return default
    return BaselineEntry(rule=d.get("rule", ""), file=d.get("file", ""),
                         symbol=d.get("symbol", ""), line=_int("line", 0),
                         justification=d.get("justification", ""),
                         count=_int("count", 1))


def save_baseline(path: str, entries: Sequence[BaselineEntry]) -> None:
    chunks = [_HEADER]
    for e in sorted(entries, key=lambda e: e.key()):
        count = f"count = {e.count}\n" if e.count > 1 else ""
        chunks.append(
            "\n[[suppression]]\n"
            f'rule = "{_toml_escape(e.rule)}"\n'
            f'file = "{_toml_escape(e.file)}"\n'
            f'symbol = "{_toml_escape(e.symbol)}"\n'
            f"line = {e.line}\n" + count +
            f'justification = "{_toml_escape(e.justification)}"\n')
    with open(path, "w", encoding="utf-8") as fh:
        fh.write("".join(chunks))


def split_findings(findings: Iterable[Finding],
                   entries: Sequence[BaselineEntry]
                   ) -> Tuple[List[Finding], List[Finding], List[BaselineEntry]]:
    """-> (unbaselined, baselined, stale_entries).

    Each entry covers at most ``count`` findings (default 1): a second
    same-rule violation landing inside an already-baselined function is
    NEW, so the ratchet holds even within baselined symbols.  Stale
    entries (baselined sites that no longer fire) are surfaced so the
    baseline shrinks as violations get fixed — they warn, never fail."""
    remaining = {e.key(): e.count for e in entries}
    matched: set = set()
    new: List[Finding] = []
    accepted: List[Finding] = []
    for f in findings:
        if remaining.get(f.key(), 0) > 0:
            remaining[f.key()] -= 1
            matched.add(f.key())
            accepted.append(f)
        else:
            new.append(f)
    stale = [e for e in entries if e.key() not in matched]
    return new, accepted, stale


def update_baseline(path: str, findings: Iterable[Finding],
                    preserved: Sequence[BaselineEntry] = ()
                    ) -> List[BaselineEntry]:
    """Merge current findings into the baseline: existing justifications are
    preserved, new findings get a TODO placeholder (CI policy: a reviewer
    replaces it before merge), entries that no longer fire are dropped.

    ``preserved`` entries are written back verbatim regardless of the
    findings — a rule-restricted scan (``--rules STG --update-baseline``)
    passes its out-of-scope entries here, so restricting the scan can
    never silently delete another family's justified suppressions."""
    existing = {e.key(): e for e in load_baseline(path)}
    merged: Dict[Tuple[str, str, str], BaselineEntry] = {}
    for f in findings:
        prior = merged.get(f.key())
        if prior is not None:  # Nth same-key finding: widen the count
            prior.count += 1
            continue
        prior = existing.get(f.key())
        if prior is not None and prior.justification and \
                not prior.justification.startswith("TODO"):
            prior.line = f.line  # refresh the informational line
            prior.count = 1     # recounted from the live findings
            merged[f.key()] = prior
        else:
            merged[f.key()] = BaselineEntry.for_finding(
                f, "TODO: justify or fix")
    for e in preserved:
        merged.setdefault(e.key(), e)
    entries = list(merged.values())
    save_baseline(path, entries)
    return entries
