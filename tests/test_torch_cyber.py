"""CyberML in the port (``mmlspark_tpu_torch.cyber``) against the JAX
package on the same seeded frames, on the CPU: AccessAnomaly's sparse ALS
factors within 1e-5 x max|factor| in implicit mode and 5e-5 in explicit
mode (float32 on both sides: the per-row sums and the batched solves round
in another order) and its anomaly scores
within 1e-4 x max|score|, in implicit and explicit mode, across several
outer-product chunks; the complement sampler, the id indexer and the
scalers equal bit for bit (host code); an ``AccessAnomalyModel`` the JAX
package saved loads and scores in a child process with ``jax`` and the JAX
package blocked, its scores equal to the JAX package's."""
import numpy as np
import pytest
import torch

import mmlspark_tpu.core as jcore
import mmlspark_tpu.cyber as jcy
import mmlspark_tpu_torch.core as tcore
import mmlspark_tpu_torch.cyber as tcy
from mmlspark_tpu.cyber import anomaly as janom
from mmlspark_tpu_torch.cyber import anomaly as tanom
from tests.test_torch_isolation import run_blocked

#: x max |factor|: implicit mode measured 8.5e-7 on the CPU; explicit mode
#: 1.2e-5 (its rows' normal equations lack the gram term, so a row with
#: few entries is held only by ``reg`` and float32 rounding grows)
FACTOR_TOL = {"implicit": 1e-5, "implicit_counts": 1e-5, "explicit": 5e-5}
SCORE_TOL = 1e-4        # x max |score|


def _access(n_obs=12_000, n_users=2_000, n_res=2_000, tenants=("t0", "t1"),
            seed=0):
    """The JAX tests' 10k x 10k sparse case cut down: user block i mostly
    touches resource block i, with repeated pairs and access counts."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, n_users, n_obs)
    block = (u // (n_users // 4)) * (n_res // 4)
    same = rng.random(n_obs) < 0.9
    r = np.where(same, block + rng.integers(0, n_res // 4, n_obs),
                 rng.integers(0, n_res, n_obs))
    cols = {"tenant": np.asarray(tenants, dtype=object)[
                rng.integers(0, len(tenants), n_obs)],
            "user": np.asarray([f"u{i}" for i in u], dtype=object),
            "res": np.asarray([f"r{i}" for i in r], dtype=object),
            "cnt": rng.integers(1, 5, n_obs).astype(np.float64)}
    return cols


def _probe(cols, n=400, seed=1):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, len(cols["user"]), n)
    out = {k: v[idx].copy() for k, v in cols.items() if k != "cnt"}
    out["res"][: n // 4] = np.asarray(
        [f"r{i}" for i in rng.integers(0, 2_000, n // 4)], dtype=object)
    out["user"][-3:] = "nobody"                     # unseen: scores 3.0
    return out


def _close(a, b, tol):
    np.testing.assert_allclose(a, b, rtol=0,
                               atol=tol * float(np.abs(b).max()))


PARAMS = {"implicit": dict(rank=8, max_iter=4, seed=2),
          "implicit_counts": dict(rank=6, max_iter=3, seed=3,
                                  likelihood_col="cnt"),
          "explicit": dict(rank=6, max_iter=3, seed=4, implicit_cf=False,
                           complementset_factor=2)}


@pytest.mark.parametrize("name", sorted(PARAMS))
def test_access_anomaly_equals_jax(name, monkeypatch):
    # several chunks of outer products a half-sweep, on both sides
    monkeypatch.setattr(janom, "_CHUNK_NNZ", 2_500)
    monkeypatch.setattr(tanom, "_CHUNK_NNZ", 2_500)
    cols = _access()
    jm = jcy.AccessAnomaly().set_params(**PARAMS[name]).fit(
        jcore.DataFrame.from_dict(cols))
    tm = tcy.AccessAnomaly().set_params(device="cpu", **PARAMS[name]).fit(
        tcore.DataFrame.from_dict(cols))
    jf, tf = jm.get("factors"), tm.get("factors")
    assert sorted(jf) == sorted(tf)
    for t in jf:
        assert jf[t]["users"] == tf[t]["users"]
        assert jf[t]["ress"] == tf[t]["ress"]
        for key in ("U", "V"):
            assert tf[t][key].dtype == np.float32
            _close(tf[t][key], jf[t][key], FACTOR_TOL[name])
        for key in ("mean", "std"):
            assert abs(tf[t][key] - jf[t][key]) <= \
                SCORE_TOL * abs(jf[t][key])
    probe = _probe(cols)
    js = jm.transform(jcore.DataFrame.from_dict(probe)).collect()
    ts = tm.transform(tcore.DataFrame.from_dict(probe)).collect()
    _close(ts["anomaly_score"], js["anomaly_score"], SCORE_TOL)
    assert (ts["anomaly_score"][-3:] == 3.0).all()


def test_solve_side_equals_jax_one_half_sweep():
    rng = np.random.default_rng(5)
    n_rows, n_other, k, nnz = 300, 200, 5, 4_000
    other = rng.normal(size=(n_other, k)).astype(np.float32)
    rows = np.sort(rng.integers(0, n_rows, nnz)).astype(np.int32)
    cols = rng.integers(0, n_other, nnz).astype(np.int32)
    tgt = np.ones(nnz, np.float32)
    conf = (1 + 10 * rng.integers(1, 4, nnz)).astype(np.float32)
    for gram in (other.T @ other, None):
        want = janom._solve_side(other, rows, cols, tgt, conf, n_rows, 0.1,
                                 gram)
        got = tanom._solve_side(
            torch.from_numpy(other), torch.from_numpy(rows.astype(np.int64)),
            torch.from_numpy(cols.astype(np.int64)), torch.from_numpy(tgt),
            torch.from_numpy(conf), n_rows, 0.1,
            None if gram is None else torch.from_numpy(gram)).numpy()
        _close(got, want, FACTOR_TOL["implicit"])


def test_duplicate_pairs_aggregate_as_counts():
    rows = {"tenant": [], "user": [], "res": []}
    for _ in range(5):
        rows["tenant"].append("t"); rows["user"].append("u0")
        rows["res"].append("r0")
    for u, r in [("u0", "r1"), ("u1", "r0"), ("u1", "r1")]:
        rows["tenant"].append("t"); rows["user"].append(u)
        rows["res"].append(r)
    df = tcore.DataFrame.from_dict({k: np.array(v) for k, v in rows.items()})
    m1 = tcy.AccessAnomaly().set_params(rank=2, max_iter=3, seed=1,
                                        device="cpu").fit(df)
    agg = tcore.DataFrame.from_dict({
        "tenant": np.array(["t"] * 4), "user": np.array(["u0", "u0", "u1",
                                                         "u1"]),
        "res": np.array(["r0", "r1", "r0", "r1"]),
        "cnt": np.array([5.0, 1.0, 1.0, 1.0])})
    m2 = tcy.AccessAnomaly().set_params(rank=2, max_iter=3, seed=1,
                                        likelihood_col="cnt",
                                        device="cpu").fit(agg)
    f1, f2 = m1.get("factors")["t"], m2.get("factors")["t"]
    np.testing.assert_allclose(f1["U"], f2["U"], atol=1e-5)
    np.testing.assert_allclose(f1["V"], f2["V"], atol=1e-5)


def test_complement_indexer_and_scalers_equal_jax():
    cols = _access(n_obs=300, n_users=40, n_res=40)
    out = {}
    for name, core, cy in (("j", jcore, jcy), ("t", tcore, tcy)):
        df = core.DataFrame.from_dict({**cols, "score": cols["cnt"] * 1.5})
        comp = cy.ComplementAccessTransformer(complement_factor=1,
                                              seed=3).transform(df).collect()
        idx = cy.IdIndexer().set_params(input_col="user",
                                        output_col="uid").fit(df)
        sc = cy.StandardScalarScaler().set_params(
            input_col="score", output_col="z", coefficient_factor=2.0).fit(df)
        ls = cy.LinearScalarScaler().set_params(
            input_col="score", output_col="mm", min_required_value=-1.0).fit(df)
        scored = ls.transform(sc.transform(idx.transform(df))).collect()
        out[name] = (comp, scored)
    (jc, js), (tc, ts) = out["j"], out["t"]
    for k in ("tenant", "user", "res"):
        assert list(tc[k]) == list(jc[k])
    for k in ("uid", "z", "mm"):
        np.testing.assert_array_equal(ts[k], js[k])


def test_access_anomaly_needs_the_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    df = tcore.DataFrame.from_dict(_access(n_obs=200, n_users=20, n_res=20))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcy.AccessAnomaly().set_params(rank=2, max_iter=1).fit(df)
    m = tcy.AccessAnomaly().set_params(rank=2, max_iter=1,
                                       device="cpu").fit(df)
    assert len(m.transform(df).collect()["anomaly_score"]) == 200


_SCORE = r"""
import json
import numpy as np
from mmlspark_tpu_torch.core import DataFrame, load
m = load({path!r})
assert type(m).__module__ == "mmlspark_tpu_torch.cyber.anomaly", type(m)
with open({probe!r}) as f:
    probe = {{k: np.asarray(v, dtype=object) for k, v in json.load(f).items()}}
np.save({out!r}, m.transform(DataFrame.from_dict(probe)).collect()[
    "anomaly_score"])
assert not [k for k in sys.modules if blocked(k)]
"""


def test_jax_saved_model_loads_with_jax_blocked(tmp_path):
    import json
    cols = _access(n_obs=3_000, n_users=300, n_res=300)
    jm = jcy.AccessAnomaly().set_params(rank=4, max_iter=2).fit(
        jcore.DataFrame.from_dict(cols))
    path = str(tmp_path / "anomaly")
    jcore.save(jm, path)
    probe = _probe(cols, n=200)
    with open(tmp_path / "probe.json", "w") as f:
        json.dump({k: [str(x) for x in v] for k, v in probe.items()}, f)
    run_blocked(_SCORE.format(path=path, probe=str(tmp_path / "probe.json"),
                              out=str(tmp_path / "out.npy")))
    want = jm.transform(jcore.DataFrame.from_dict(probe)).collect()[
        "anomaly_score"]
    np.testing.assert_array_equal(np.load(tmp_path / "out.npy"), want)
    with pytest.raises(PermissionError, match="pickle"):
        tcore.load(path, safe=True)
