"""graft-lint for the port (``mmlspark_tpu_torch/analysis``) against the JAX
package's (``mmlspark_tpu/analysis``), on the CPU.

- The reference's framework-neutral fixture pairs (RES, LCK, HOT, RES004,
  CCY) and its STG fixtures: the port's checkers give the reference's
  findings exactly (rule, file, line, symbol, message; the reference tags
  some messages with its review history, which the port's drop).
- The port's checkers built with ``package="mmlspark_tpu"`` give the
  reference's own findings on the reference package for RES, LCK, HOT,
  STG and CCY.
- Torch TRC and CMP fixture pairs, written into ``tmp_path``: each marked
  line trips exactly its rule and nothing else trips.
- ``instrumented_jit`` (a CUDA graph per signature on the card) is a root:
  a host sync in a wrapped function is TRC004; ``instrumented_call``, the
  booking the ``parallel/`` steps use, is not, so
  ``parallel/collectives.py::_booked`` has no TRC finding.
- The tier-1 gate: the port's package scans clean against
  ``mmlspark_tpu_torch/analysis/baseline.toml``.
- Pragmas, the baseline workflow, ``--changed-only``, the CLI and the rule
  catalog, as twins of ``tests/test_static_analysis.py``.

Whole-package scans take seconds each, so the module shares them through
module-scoped fixtures.
"""
import collections
import json
import os
import re
import subprocess

import pytest

from mmlspark_tpu import analysis as ref
from mmlspark_tpu_torch import analysis as port
from mmlspark_tpu_torch.analysis import (AnalysisEngine, BaselineEntry,
                                         CheckpointAtomicityChecker,
                                         ConcurrencyChecker, Finding,
                                         HotPathChecker,
                                         ResilienceCoverageChecker,
                                         StageContractChecker,
                                         TracerSafetyChecker,
                                         TransferDisciplineChecker,
                                         default_checkers, load_baseline,
                                         main, rule_catalog, run_analysis,
                                         save_baseline, split_findings,
                                         update_baseline)
from mmlspark_tpu_torch.utils.concurrency import LockOrderRegistry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "analysis_fixtures")
PKG = os.path.join(REPO, "mmlspark_tpu_torch")
BASELINE = os.path.join(PKG, "analysis", "baseline.toml")

#: the rule families whose logic does not depend on the framework
NEUTRAL_FAMILIES = ["RES", "LCK", "HOT", "STG", "CCY"]


def _scan(checker, *relpaths, root=FIXTURES):
    engine = AnalysisEngine([checker], root=root)
    return engine.run([os.path.join(root, rp) for rp in relpaths])


def _untagged(message: str) -> str:
    """The message without the reference's review-history tag (an
    upper-case word and a number, as in "(XX 2: ...")."""
    return re.sub(r"\b[A-Z]{2,5} \d+: ", "", message)


def _rows(findings):
    return [(f.rule, f.file, f.line, f.symbol, _untagged(f.message),
             f.severity) for f in findings]


@pytest.fixture(scope="module")
def port_scan():
    """The port's default checkers over its own package, through
    ``run_analysis`` with its default paths and root."""
    checkers = default_checkers()
    findings = run_analysis(checkers=checkers)
    ccy = next(c for c in checkers if isinstance(c, ConcurrencyChecker))
    return findings, ccy


# ---------------------------------------------------------------------------
# parity with the reference on its framework-neutral fixtures
# ---------------------------------------------------------------------------

NEUTRAL_PAIRS = [
    ("ResilienceCoverageChecker", "cognitive/res_bad.py",
     "cognitive/res_ok.py", {"RES001"}),
    ("UndeadlinedRetryChecker", "cognitive/res_deadline_bad.py",
     "cognitive/res_deadline_ok.py", {"RES002"}),
    ("CheckpointAtomicityChecker", "parallel/checkpoint_bad.py",
     "parallel/checkpoint_ok.py", {"RES003"}),
    ("LockDisciplineChecker", "observability/lck_bad.py",
     "observability/lck_ok.py", {"LCK001", "LCK002", "LCK003"}),
    ("HotPathChecker", "serving/hot_bad.py", "serving/hot_ok.py",
     {"HOT001", "HOT002"}),
    ("UnboundedBlockingChecker", "serving/blk_bad.py", "serving/blk_ok.py",
     {"RES004"}),
    ("ConcurrencyChecker", "concurrency/ccy_cycle_bad.py",
     "concurrency/ccy_cycle_ok.py", {"CCY001"}),
    ("ConcurrencyChecker", "concurrency/ccy_shared_bad.py",
     "concurrency/ccy_shared_ok.py", {"CCY002"}),
    ("ConcurrencyChecker", "concurrency/ccy_cond_bad.py",
     "concurrency/ccy_cond_ok.py", {"CCY003"}),
    ("ConcurrencyChecker", "concurrency/ccy_leak_bad.py",
     "concurrency/ccy_leak_ok.py", {"CCY004"}),
]


@pytest.mark.parametrize("name,bad,ok,expected", NEUTRAL_PAIRS,
                         ids=[p[1].split("/")[-1][:-3] for p in NEUTRAL_PAIRS])
def test_neutral_fixture_pair_matches_the_reference(name, bad, ok, expected):
    for rel in (bad, ok):
        want = _scan(getattr(ref, name)(), rel)
        got = _scan(getattr(port, name)(), rel)
        assert _rows(got) == _rows(want), rel
    assert {f.rule for f in _scan(getattr(port, name)(), bad)} == expected
    assert _scan(getattr(port, name)(), ok) == []


def test_stage_contract_fixtures_match_the_reference():
    files = ("stgpkg/rogue/stg_bad.py", "stgpkg/registered/stg_ok.py")
    want = _scan(ref.StageContractChecker(subpackages=("registered",),
                                          package="stgpkg"), *files)
    got = _scan(StageContractChecker(subpackages=("registered",),
                                     package="stgpkg"), *files)
    assert _rows(got) == _rows(want)
    assert {f.rule for f in got} == {"STG001", "STG002", "STG003"}
    assert all("stg_bad.py" in f.file for f in got)


def test_ccy001_cycle_closes_through_call_edges():
    """The fixture's cycle exists only through the call graph: flush()
    holds _flush_lock and calls _update_stats(), which takes _stats_lock;
    book() takes them the other way round."""
    findings = _scan(ConcurrencyChecker(), "concurrency/ccy_cycle_bad.py")
    assert [f.rule for f in findings] == ["CCY001"]
    assert "Booker._flush_lock" in findings[0].message
    assert "Booker._stats_lock" in findings[0].message


def test_ccy_edges_match_the_reference_and_feed_the_port_registry():
    """lock_order_edges() speaks the runtime registry's "Owner._attr"
    naming: the port's ``LockOrderRegistry.validate(static_edges=...)``
    finds the fixture's cycle from the port checker's edges alone."""
    fixture = os.path.join(FIXTURES, "concurrency", "ccy_cycle_bad.py")
    edges = {}
    for mod in (ref, port):
        checker = mod.ConcurrencyChecker()
        mod.AnalysisEngine([checker], root=FIXTURES).run([fixture])
        edges[mod] = checker.lock_order_edges()
    assert edges[port] == edges[ref]
    assert ("Booker._stats_lock", "Booker._flush_lock") in edges[port]
    assert ("Booker._flush_lock", "Booker._stats_lock") in edges[port]
    reg = LockOrderRegistry(strict=False, book=False)
    found = reg.validate(static_edges=edges[port])
    assert [v.kind for v in found] == ["cycle"]


def test_ccy002_names_the_attribute_and_both_paths():
    findings = _scan(ConcurrencyChecker(), "concurrency/ccy_shared_bad.py")
    assert {f.rule for f in findings} == {"CCY002"}
    assert "_backlog" in " ".join(f.message for f in findings)


def test_res002_fires_once_per_unbudgeted_site():
    findings = _scan(port.UndeadlinedRetryChecker(),
                     "cognitive/res_deadline_bad.py")
    assert sorted(f.symbol for f in findings) == \
        ["deferred_callback.cb", "flaky_fetch", "flaky_init"]


# ---------------------------------------------------------------------------
# parity with the reference on the reference package
# ---------------------------------------------------------------------------

def test_neutral_rules_reproduce_the_reference_on_its_package():
    """Built with ``package="mmlspark_tpu"``, the port's checkers find on
    the JAX package exactly what the JAX package's own checkers find: the
    port's 2,000-odd lines of rule logic held against the reference's on
    its 150 real modules."""
    paths = [os.path.join(REPO, "mmlspark_tpu")]
    want = ref.run_analysis(paths=paths, root=REPO, rules=NEUTRAL_FAMILIES)
    got = run_analysis(paths=paths, root=REPO,
                       checkers=default_checkers(package="mmlspark_tpu"),
                       rules=NEUTRAL_FAMILIES)

    def key(f):
        return (f.rule, f.file, f.line, f.symbol)
    assert collections.Counter(map(key, got)) == \
        collections.Counter(map(key, want))
    assert sorted(_rows(got)) == sorted(_rows(want))
    assert {f.rule[:3] for f in want} >= {"RES", "STG", "CCY"}


def test_package_parameter_spells_the_allow_lists():
    """The reference's literal ``mmlspark_tpu/`` prefix made the port's own
    resilient clients look like rogue callers; the parameter fixes that
    and keeps the JAX package's spelling when asked for."""
    for rel in ("io/http.py", "serving/distributed.py", "testing/chaos.py"):
        assert not ResilienceCoverageChecker().interested(
            f"mmlspark_tpu_torch/{rel}")
        assert ResilienceCoverageChecker().interested(f"mmlspark_tpu/{rel}")
        assert not ResilienceCoverageChecker("mmlspark_tpu").interested(
            f"mmlspark_tpu/{rel}")
    assert not port.UndeadlinedRetryChecker().interested(
        "mmlspark_tpu_torch/utils/resilience.py")
    assert not TransferDisciplineChecker().interested(
        "mmlspark_tpu_torch/observability/compute.py")
    assert TransferDisciplineChecker().interested(
        "mmlspark_tpu/observability/compute.py")


@pytest.mark.parametrize("module", ["io/checkpoint.py",
                                    "observability/flightrecorder.py"])
def test_res003_scans_the_port_writers_clean(module, tmp_path):
    """RES003 scans io/checkpoint.py and the flight recorder: a raw writer
    in a twin trips, the port's real modules (atomic_write's one pragma'd
    open, every other open read-mode) scan clean."""
    assert CheckpointAtomicityChecker().interested(f"mmlspark_tpu_torch/"
                                                   f"{module}")
    twin = tmp_path / module
    twin.parent.mkdir(parents=True)
    twin.write_text("def dump(path, snap):\n"
                    "    with open(path, 'w') as f:\n"
                    "        f.write(repr(snap))\n")
    assert {f.rule for f in _scan(CheckpointAtomicityChecker(), module,
                                  root=str(tmp_path))} == {"RES003"}
    assert _scan(CheckpointAtomicityChecker(),
                 os.path.join("mmlspark_tpu_torch", module), root=REPO) == []


def test_rules_filter_accepts_family_prefixes():
    bad = os.path.join(FIXTURES, "serving", "hot_bad.py")
    findings = run_analysis([bad], root=FIXTURES, rules=["HOT"])
    assert findings and all(f.rule.startswith("HOT") for f in findings)
    assert run_analysis([bad], root=FIXTURES, rules=["STG"]) == []


# ---------------------------------------------------------------------------
# torch TRC and CMP fixture pairs
# ---------------------------------------------------------------------------
# Each bad module marks the lines that must trip with `# expect: RULE`;
# every ok module must scan clean.  Parsed by graft-lint only.

TRC_FIXTURES = {
    "compile": ("parallel/trc_compile", '''
import threading
import time

import numpy as np
import torch

_LOCK = threading.Lock()


def _noise(x):
    t = time.time()                         # expect: TRC001
    print("noise at", t)                    # expect: TRC002
    return x * np.random.rand()             # expect: TRC001


@torch.compile
def step(x):
    with _LOCK:                             # expect: TRC003
        return _noise(x) + float(x)         # expect: TRC004


@torch.compile(mode="reduce-overhead")
def synced(x):
    return x.sum().item()                   # expect: TRC004


def _body(x):
    return x.tolist()                       # expect: TRC004


compiled = torch.compile(_body)
''', '''
import time

import numpy as np
import torch


def host_setup(n):
    t0 = time.time()
    data = np.random.rand(n)
    print("staged", n, "rows in", time.time() - t0)
    return torch.from_numpy(data)


@torch.compile
def step(x):
    return x * torch.rand(x.shape) + 0.5


def evaluate(xs):
    out = step(xs)
    # .item() after the compiled call returns is host code
    return float(out.sum().item())
'''),
    "jit_fx": ("ops/trc_jit", '''
import time
import uuid

import torch


@torch.jit.script
def scripted(x):
    return x + time.perf_counter()          # expect: TRC001


def _traced(x):
    return x.cpu()                          # expect: TRC004


def _fx_fn(x):
    tag = uuid.uuid4()                      # expect: TRC001
    return x, tag


traced = torch.jit.trace(_traced, (torch.zeros(2),))
symbolic = torch.fx.symbolic_trace(_fx_fn)
''', '''
import time

import torch


@torch.jit.script
def scripted(x):
    return x + 1


def timed(x):
    t0 = time.perf_counter()
    out = scripted(x)
    return out.cpu(), time.perf_counter() - t0
'''),
    "cuda_graph": ("models/trc_graph", '''
import time

import numpy as np
import torch


def _fill(static_in):
    static_in.copy_(torch.from_numpy(np.random.rand(4)))   # expect: TRC001


def capture(static_in):
    t0 = time.time()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = static_in * time.monotonic()  # expect: TRC001
        _fill(static_in)
        n = int(static_in)                  # expect: TRC004

        def later():
            return time.time()
    print("captured in", time.time() - t0)
    return g, out, n, later


class Step:
    def warm(self, x):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            y = x.numpy()                   # expect: TRC004
        return graph, y
''', '''
import time

import torch


def capture(static_in, static_noise):
    t0 = time.time()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = static_in * static_noise
    print("captured in", time.time() - t0)
    return g, out


def replay(g, out):
    g.replay()
    return out.cpu()
'''),
    "graphed": ("lightgbm/trc_graphed", '''
import threading

import torch

_LOCK = threading.Lock()


def _a(x):
    return x.numpy()                        # expect: TRC004


def _b(x):
    with _LOCK:                             # expect: TRC003
        return x + 1


def _c(x):
    _LOCK.acquire()                         # expect: TRC003
    return x


graphed = torch.cuda.make_graphed_callables(
    (_a, _b), ((torch.zeros(2),), (torch.zeros(2),)))
single = torch.cuda.make_graphed_callables(_c, (torch.zeros(2),))
''', '''
import threading

import torch

_LOCK = threading.Lock()


def _a(x):
    return x * 2


def guarded(fn, x):
    with _LOCK:
        return fn(x)


graphed = torch.cuda.make_graphed_callables((_a,), ((torch.zeros(2),),))
'''),
    "vmap_grad": ("parallel/trc_vmap", '''
import time

import torch
from torch.func import grad, vmap


def _per_row(x):
    print("row")
    t = time.time()
    return x * t + x.item()                 # expect: TRC004


batched = vmap(_per_row)


@torch.vmap
def decide(x):
    return bool(x)                          # expect: TRC004


def _loss(w):
    return float(w)                         # expect: TRC004


dloss = grad(_loss)
''', '''
import time

import torch
from torch.func import grad, vmap


def _per_row(x):
    # host clocks and prints run per call under vmap: not TRC findings
    print("row at", time.time())
    return x * 2


batched = vmap(_per_row)
dloss = grad(lambda w: (w * w).sum())


def report(xs):
    return batched(xs).sum().item()
'''),
}

_EXPECT = re.compile(r"#\s*expect:\s*([A-Z]+\d+)")


def _write(tmp_path, rel: str, src: str) -> str:
    path = tmp_path / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(src.lstrip("\n"))
    return rel


def _expected(tmp_path, rel: str):
    lines = (tmp_path / rel).read_text().splitlines()
    return sorted((m.group(1), i) for i, line in enumerate(lines, start=1)
                  for m in [_EXPECT.search(line)] if m)


@pytest.mark.parametrize("family", sorted(TRC_FIXTURES))
def test_torch_trc_fixture_pair(family, tmp_path):
    stem, bad_src, ok_src = TRC_FIXTURES[family]
    bad = _write(tmp_path, f"{stem}_bad.py", bad_src)
    ok = _write(tmp_path, f"{stem}_ok.py", ok_src)
    found = _scan(TracerSafetyChecker(), bad, root=str(tmp_path))
    assert sorted((f.rule, f.line) for f in found) == \
        _expected(tmp_path, bad), [f.render() for f in found]
    clean = _scan(TracerSafetyChecker(), ok, root=str(tmp_path))
    assert clean == [], [f.render() for f in clean]


def test_torch_trc_fixtures_trip_every_rule_and_name_their_symbols(tmp_path):
    rels = [_write(tmp_path, f"{stem}_bad.py", src)
            for stem, src, _ in TRC_FIXTURES.values()]
    found = _scan(TracerSafetyChecker(), *rels, root=str(tmp_path))
    assert {f.rule for f in found} == {"TRC001", "TRC002", "TRC003",
                                       "TRC004"}
    symbols = {f.symbol for f in found}
    # _noise is reached only through step()'s call edge; _body, _traced,
    # _fx_fn, _a, _b, _c, _per_row and _loss are rooted by being passed to
    # a root; a capture block's sites carry their enclosing function
    assert {"_noise", "step", "synced", "_body", "scripted", "_traced",
            "_fx_fn", "_fill", "capture", "Step.warm", "_a", "_b", "_c",
            "_per_row", "decide", "_loss"} == symbols


XMOD_DEFS = '''
import time


def compiled_elsewhere(x):
    return x * time.time()                  # expect: TRC001


def called_from_traced(x):
    print("inside traced")                  # expect: TRC002
    return x + 1


def never_traced(x):
    return x * time.time()
'''

XMOD_USE = '''
import torch

from .xmod_defs import called_from_traced, compiled_elsewhere

apply_step = torch.compile(compiled_elsewhere)


@torch.compile
def local_root(x):
    return called_from_traced(x)
'''


def test_torch_trc_cross_module_reachability(tmp_path):
    """The defining module roots nothing; the using module compiles its
    functions through imports, directly and through a call edge.  The
    findings land in the defining module, for rooted functions only."""
    defs = _write(tmp_path, "models/xmod_defs.py", XMOD_DEFS)
    use = _write(tmp_path, "models/xmod_use.py", XMOD_USE)
    found = _scan(TracerSafetyChecker(), defs, use, root=str(tmp_path))
    assert sorted((f.rule, f.line) for f in found) == \
        _expected(tmp_path, defs)
    assert {f.symbol for f in found} == {"compiled_elsewhere",
                                         "called_from_traced"}
    assert all(f.file == "models/xmod_defs.py" for f in found)
    assert _scan(TracerSafetyChecker(), defs, root=str(tmp_path)) == []


CMP_BAD = '''
import torch


def ship(batch):
    return batch.cuda()                     # expect: CMP001


def stage(batch, dev):
    return batch.to(dev, non_blocking=True)     # expect: CMP001


def fill(dst, src):
    dst.copy_(src, non_blocking=True)       # expect: CMP001
'''

CMP_OK = '''
import torch

from mmlspark_tpu_torch.observability.compute import device_put


def ship(batch, dev):
    # the sanctioned route: bytes booked per site before the copy
    return device_put(batch, dev, site="parallel.fixture",
                      non_blocking=True)


def cast(x):
    return x.to(torch.float16)


def copy(dst, src):
    dst.copy_(src)


def other(backend, batch):
    return backend.device_put(batch, non_blocking=True)
'''


def test_torch_cmp_fixture_pair(tmp_path):
    bad = _write(tmp_path, "parallel/cmp_bad.py", CMP_BAD)
    ok = _write(tmp_path, "parallel/cmp_ok.py", CMP_OK)
    found = _scan(TransferDisciplineChecker(), bad, root=str(tmp_path))
    assert sorted((f.rule, f.line) for f in found) == \
        _expected(tmp_path, bad), [f.render() for f in found]
    assert _scan(TransferDisciplineChecker(), ok, root=str(tmp_path)) == []


def test_instrumented_jit_is_not_a_root_of_the_port(port_scan):
    """(The name dates from when the port's ``instrumented_jit`` ran
    eagerly; it captures CUDA graphs now and is a root, below.)  The
    ``parallel/`` steps book through ``instrumented_call``, which is never
    captured and is no root: neither the port's TRC nor the reference's
    (which roots ``instrumented_jit`` by name) flags the host clock, lock
    and ``int()`` of ``parallel/collectives.py::_booked``, and the port's
    package has no TRC finding with ``instrumented_jit`` a root."""
    findings, _ = port_scan
    assert [f for f in findings if f.rule.startswith("TRC")] == []
    parallel = os.path.join(PKG, "parallel")
    files = list(port.iter_python_files(parallel))
    assert ref.AnalysisEngine([ref.TracerSafetyChecker()],
                              root=REPO).run(files) == []
    assert AnalysisEngine([TracerSafetyChecker()], root=REPO).run(
        files) == []


IJ_BAD = '''
from mmlspark_tpu_torch.observability.compute import (InstrumentedJit,
                                                      instrumented_jit)


def _sync(x):
    return x.sum().item()                   # expect: TRC004


step = instrumented_jit(_sync, name="fixture.step")


@instrumented_jit(name="fixture.decorated")
def decorated(x):
    return x.tolist()                       # expect: TRC004


def _cls(x):
    return x.cpu()                          # expect: TRC004


wrapped = InstrumentedJit(_cls, name="fixture.cls")
'''

IJ_OK = '''
from mmlspark_tpu_torch.observability.compute import instrumented_call


def _sync(x):
    return x.sum().item()


step = instrumented_call(_sync, name="fixture.step")
'''


def test_instrumented_jit_is_a_trc_root(tmp_path):
    """A function wrapped by ``instrumented_jit`` (a call, a decorator, the
    class) is captured as a CUDA graph on the card, so a host sync in it
    is TRC004; the same function under ``instrumented_call`` is host
    code."""
    bad = _write(tmp_path, "models/ij_bad.py", IJ_BAD)
    ok = _write(tmp_path, "models/ij_ok.py", IJ_OK)
    found = _scan(TracerSafetyChecker(), bad, root=str(tmp_path))
    assert sorted((f.rule, f.line) for f in found) == \
        _expected(tmp_path, bad), [f.render() for f in found]
    assert {f.symbol for f in found} == {"_sync", "decorated", "_cls"}
    assert _scan(TracerSafetyChecker(), ok, root=str(tmp_path)) == []


def test_the_port_has_no_raw_placement(port_scan):
    findings, _ = port_scan
    assert [f.render() for f in findings if f.rule == "CMP001"] == []


# ---------------------------------------------------------------------------
# suppression: pragmas and the baseline file
# ---------------------------------------------------------------------------

def test_inline_pragma_suppresses_one_line(tmp_path):
    _write(tmp_path, "serving/pragma_case.py",
           "import uuid\n\n\n"
           "def hot(payload):\n"
           "    a = uuid.uuid4()  # graft-lint: disable=HOT001 — load-bearing\n"
           "    b = uuid.uuid4()\n"
           "    return a, b, payload\n")
    findings = _scan(HotPathChecker(), "serving/pragma_case.py",
                     root=str(tmp_path))
    assert [f.line for f in findings] == [6], [f.render() for f in findings]


def test_file_pragma_suppresses_whole_file(tmp_path):
    _write(tmp_path, "serving/filewide.py",
           "# graft-lint: disable-file=HOT001\n"
           "import uuid\n\n\n"
           "def hot():\n"
           "    return uuid.uuid4()\n")
    assert _scan(HotPathChecker(), "serving/filewide.py",
                 root=str(tmp_path)) == []


def test_the_ports_own_pragmas_keep_working(tmp_path):
    """``parallel/executor.py`` binds an ephemeral local port under a
    RES001 pragma: the real module scans clean, the same source without
    the pragma trips."""
    rel = os.path.join("mmlspark_tpu_torch", "parallel", "executor.py")
    assert _scan(ResilienceCoverageChecker(), rel, root=REPO) == []
    with open(os.path.join(REPO, rel)) as f:
        src = f.read()
    assert "graft-lint: disable=RES001" in src
    stripped = re.sub(r"#\s*graft-lint: disable=RES001[^\n]*", "", src)
    _write(tmp_path, "parallel/executor.py", stripped)
    assert {f.rule for f in _scan(ResilienceCoverageChecker(),
                                  "parallel/executor.py",
                                  root=str(tmp_path))} == {"RES001"}


def test_baseline_round_trip_and_split(tmp_path):
    path = str(tmp_path / "base.toml")
    entries = [BaselineEntry("HOT001", "a/b.py", 'Cls.meth"x"', 7,
                             'quotes "and" backslash \\ survive'),
               BaselineEntry("RES001", "c.py", "fetch", 3, "local socket")]
    save_baseline(path, entries)
    loaded = load_baseline(path)
    assert {(e.rule, e.file, e.symbol, e.line, e.justification)
            for e in loaded} == \
        {(e.rule, e.file, e.symbol, e.line, e.justification)
         for e in entries}
    hit = Finding("HOT001", "a/b.py", 99, "msg", symbol='Cls.meth"x"')
    miss = Finding("HOT001", "a/b.py", 99, "msg", symbol="other")
    new, accepted, stale = split_findings([hit, miss], loaded)
    assert [f.symbol for f in new] == ["other"]
    assert [f.symbol for f in accepted] == ['Cls.meth"x"']
    assert [e.rule for e in stale] == ["RES001"]


def test_baseline_ratchets_within_a_symbol(tmp_path):
    path = str(tmp_path / "base.toml")
    save_baseline(path, [BaselineEntry("RES001", "m.py", "fetch", 3,
                                       "reviewed: local socket")])
    one = Finding("RES001", "m.py", 3, "msg", symbol="fetch")
    two = Finding("RES001", "m.py", 9, "msg", symbol="fetch")
    new, accepted, stale = split_findings([one, two], load_baseline(path))
    assert len(accepted) == 1 and len(new) == 1 and not stale
    save_baseline(path, [BaselineEntry("RES001", "m.py", "fetch", 3,
                                       "two reviewed sites", count=2)])
    new, accepted, _ = split_findings([one, two], load_baseline(path))
    assert len(accepted) == 2 and not new


def test_update_baseline_preserves_justifications(tmp_path):
    path = str(tmp_path / "base.toml")
    f1 = Finding("HOT001", "a.py", 5, "m", symbol="f")
    f2 = Finding("RES001", "b.py", 9, "m", symbol="g")
    update_baseline(path, [f1])
    entries = load_baseline(path)
    assert entries[0].justification.startswith("TODO")
    entries[0].justification = "deliberate: reviewed"
    save_baseline(path, entries)
    update_baseline(path, [f1, f2])
    by_rule = {e.rule: e for e in load_baseline(path)}
    assert by_rule["HOT001"].justification == "deliberate: reviewed"
    assert by_rule["RES001"].justification.startswith("TODO")
    update_baseline(path, [f2])
    assert [e.rule for e in load_baseline(path)] == ["RES001"]
    with open(path) as f:
        assert "python -m mmlspark_tpu_torch.analysis --update-baseline" \
            in f.read()


def test_rule_restricted_update_preserves_other_families(tmp_path):
    path = str(tmp_path / "base.toml")
    keep = BaselineEntry("HOT001", "a.py", "f", 5, "reviewed: load-bearing")
    save_baseline(path, [keep])
    stg = Finding("STG001", "b.py", 9, "m", symbol="Cls.p")
    entries = update_baseline(path, [stg], preserved=[keep])
    by_rule = {e.rule: e for e in entries}
    assert by_rule["HOT001"].justification == "reviewed: load-bearing"
    assert by_rule["STG001"].justification.startswith("TODO")
    assert main(["--rules", "HOT", "--update-baseline", "--baseline", path,
                 os.path.join(FIXTURES, "serving", "hot_bad.py")]) == 0
    rules_after = {e.rule for e in load_baseline(path)}
    assert "STG001" in rules_after, "out-of-scope entry was deleted"
    assert {"HOT001", "HOT002"} <= rules_after


def test_changed_only_scopes_reporting_not_the_scan(tmp_path, capsys):
    from mmlspark_tpu_torch.analysis.cli import git_changed_files
    assert git_changed_files(str(tmp_path)) is None
    bad = os.path.join(FIXTURES, "serving", "hot_bad.py")
    assert main(["--root", str(tmp_path), "--no-baseline",
                 "--changed-only", bad]) == 1
    capsys.readouterr()
    subprocess.run(["git", "init", "-q", str(tmp_path)], check=True)
    (tmp_path / "other.py").write_text("x = 1\n")
    subprocess.run(["git", "-C", str(tmp_path), "add", "other.py"],
                   check=True)
    assert git_changed_files(str(tmp_path)) == ["other.py"]
    assert main(["--root", str(tmp_path), "--no-baseline", bad]) == 1
    capsys.readouterr()
    assert main(["--root", str(tmp_path), "--no-baseline",
                 "--changed-only", bad]) == 0


# ---------------------------------------------------------------------------
# the tier-1 gate: the port's package scans clean against its own baseline
# ---------------------------------------------------------------------------

def test_port_package_scans_clean_against_its_baseline(port_scan):
    findings, _ = port_scan
    assert findings and all(f.file.startswith("mmlspark_tpu_torch/")
                            for f in findings)
    entries = load_baseline(BASELINE)
    new, accepted, stale = split_findings(findings, entries)
    assert not new, "unbaselined findings:\n" + \
        "\n".join(f.render() for f in new)
    assert not stale, "baseline entries for fixed sites — remove them: " + \
        str([(e.rule, e.file, e.symbol) for e in stale])
    for e in entries:
        assert e.justification and not e.justification.startswith("TODO"), \
            f"baseline entry {e.key()} lacks a real justification"
        assert e.file.startswith("mmlspark_tpu_torch/")
        assert not e.rule.startswith(("RES001", "TRC"))


def test_static_lock_order_composes_with_the_runtime_registry(port_scan):
    """The port package's CCY001 graph, in the registry's naming, is
    acyclic: ``validate(static_edges=...)`` books no cycle."""
    _, ccy = port_scan
    edges = ccy.lock_order_edges()
    assert all("." in a and "." in b for a, b in edges)
    reg = LockOrderRegistry(strict=False, book=False)
    assert reg.validate(static_edges=edges) == []


def test_cli_exit_codes_and_json(capsys):
    assert main(["--format", "json"]) == 0
    payload = json.loads(capsys.readouterr().out)
    assert payload["findings"] == []
    assert payload["stale_baseline_entries"] == []
    assert len(payload["baselined"]) == sum(
        e.count for e in load_baseline(BASELINE))
    bad = os.path.join(FIXTURES, "serving", "hot_bad.py")
    assert main([os.path.join(PKG, "serving"), bad]) == 1
    capsys.readouterr()
    assert main(["--list-rules"]) == 0
    capsys.readouterr()
    assert main([bad, "--format", "json"]) == 1
    payload = json.loads(capsys.readouterr().out)
    assert {f["rule"] for f in payload["findings"]} == {"HOT001", "HOT002"}
    assert payload["baselined"] == []
    with pytest.raises(SystemExit) as exc:
        main(["--format", "yaml"])
    assert exc.value.code == 2


def test_rule_catalog_documented_and_equal_to_the_reference():
    """Every rule id appears in the port's RULES.md, and the port ships the
    reference's rule ids."""
    with open(os.path.join(PKG, "analysis", "RULES.md")) as f:
        doc = f.read()
    catalog = rule_catalog()
    for rule in catalog:
        assert rule in doc, f"rule {rule} missing from RULES.md"
    assert sorted(catalog) == sorted(ref.rule_catalog())
    for root in ("torch.compile", "torch.jit.script", "torch.jit.trace",
                 "torch.cuda.make_graphed_callables",
                 "torch.fx.symbolic_trace", "torch.cuda.graph",
                 "torch.vmap", "torch.func.vmap", "torch.func.grad",
                 "instrumented_jit", "non_blocking"):
        assert root in doc, root


def test_public_names_match_the_reference():
    assert sorted(port.__all__) == sorted(ref.__all__)
