"""The plumbing stages in the port (``mmlspark_tpu_torch.stages.transforms``,
own copies on the host) against the JAX package on the same frames: every
output column equal, partition by partition where a stage moves rows
between partitions."""
import numpy as np
import pytest

import mmlspark_tpu.core as jcore
import mmlspark_tpu.stages as jstages
import mmlspark_tpu_torch.core as tcore
import mmlspark_tpu_torch.stages as tstages

PKGS = {"jax": (jcore, jstages), "port": (tcore, tstages)}


def _cols(n=24, seed=0):
    rng = np.random.default_rng(seed)
    arr = np.empty(n, dtype=object)
    for i in range(n):
        arr[i] = list(range(int(rng.integers(0, 4))))
    vec = np.empty(n, dtype=object)
    for i in range(n):
        vec[i] = rng.normal(size=3)
    x = rng.normal(size=n)
    x[::5] = np.nan
    return {"k": np.array(rng.choice(["a", "b", "c"], n), dtype=object),
            "label": rng.integers(0, 3, n).astype(float),
            "x": x, "arr": arr, "vec": vec,
            "text": np.array([f"Héllo Wörld {i} ﬁ" for i in range(n)],
                             dtype=object)}


def _same(a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        if a.dtype == object:
            assert a.shape == b.shape
            for x, y in zip(a, b):
                _same(x, y)
            return
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, float) and np.isnan(a):
        assert np.isnan(b)
    else:
        assert a == b, (a, b)


STAGES = {
    "lambda": lambda s, core: s.Lambda(
        lambda d: d.with_column("y", lambda p: p["label"] + 1)),
    "udf": lambda s, core: s.UDFTransformer(input_col="x", output_col="z",
                                            udf=lambda v: v * 10),
    "timer": lambda s, core: s.Timer(s.UDFTransformer(
        input_col="label", output_col="z", udf=lambda v: -v)),
    "cacher": lambda s, core: s.Cacher(),
    "drop": lambda s, core: s.DropColumns("x", "vec"),
    "select": lambda s, core: s.SelectColumns("k", "label"),
    "rename": lambda s, core: s.RenameColumn().set_params(
        input_col="k", output_col="key"),
    "repartition": lambda s, core: s.Repartition().set_params(n=5),
    "repartition_off": lambda s, core: s.Repartition().set_params(
        n=5, disable=True),
    "consolidate": lambda s, core: s.PartitionConsolidator(),
    "explode": lambda s, core: s.Explode().set_params(input_col="arr",
                                                      output_col="item"),
    "ensemble": lambda s, core: s.EnsembleByKey().set_params(
        keys=["k"], cols=["label", "vec"]),
    "ensemble_named": lambda s, core: s.EnsembleByKey().set_params(
        keys=["k", "label"], cols=["x"], col_names=["mx"]),
    "stratified": lambda s, core: s.StratifiedRepartition().set_params(
        label_col="label"),
    "text": lambda s, core: s.TextPreprocessor().set_params(
        input_col="text", output_col="t2", map={"wörld": "world", "1": "one"}),
    "unicode": lambda s, core: s.UnicodeNormalize().set_params(
        input_col="text", output_col="t2"),
    "unicode_nfc": lambda s, core: s.UnicodeNormalize().set_params(
        input_col="text", output_col="t2", form="NFC", lower=False),
    "summarize": lambda s, core: s.SummarizeData(),
}


@pytest.mark.parametrize("name", sorted(STAGES))
def test_transformer_equals_jax(name):
    cols = _cols()
    if name == "summarize":
        cols = {k: cols[k] for k in ("k", "label", "x")}
    outs = {}
    for pkg, (core, stages) in PKGS.items():
        df = core.DataFrame.from_dict(cols, 3)
        out = STAGES[name](stages, core).transform(df)
        outs[pkg] = out
    j, t = outs["jax"], outs["port"]
    assert j.num_partitions == t.num_partitions
    assert j.columns == t.columns
    for pj, pt in zip(j.partitions, t.partitions):
        for c in pj:
            _same(pj[c], pt[c])


def test_class_balancer_equals_jax():
    y = np.array([0, 0, 0, 1, 2, 2] * 4, dtype=float)
    outs = {}
    for pkg, (core, stages) in PKGS.items():
        df = core.DataFrame.from_dict({"label": y}, 2)
        m = stages.ClassBalancer().set_params(input_col="label",
                                              output_col="w").fit(df)
        outs[pkg] = (m.get("mapping"), m.transform(df).collect()["w"])
    assert outs["port"][0] == outs["jax"][0]
    np.testing.assert_array_equal(outs["port"][1], outs["jax"][1])
    assert outs["port"][0]["1.0"] == 3.0


def test_timer_fit_timed_and_lambda_schema():
    t = tstages.Timer(tstages.ClassBalancer().set_params(input_col="label"))
    df = tcore.DataFrame.from_dict({"label": np.array([0.0, 1.0, 1.0])})
    m = t.fit_timed(df)
    assert t.last_seconds is not None and m.get("mapping")["0.0"] == 2.0
    lam = tstages.Lambda(lambda d: d)
    lam.set("transform_schema_fn", lambda s: {**s, "z": "double"})
    assert lam.transform_schema({"a": "double"}) == {"a": "double",
                                                     "z": "double"}
