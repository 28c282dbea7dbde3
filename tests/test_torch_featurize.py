"""Featurization in the port (``mmlspark_tpu_torch.featurize``: the column
stages and the text stages, own copies on the host) against the JAX
package on the same seeded inputs: every output column bit for bit, NaN
positions, object columns and hashed slots included."""
import datetime

import numpy as np
import pytest

import mmlspark_tpu.core as jcore
import mmlspark_tpu.featurize as jfeat
import mmlspark_tpu_torch.core as tcore
import mmlspark_tpu_torch.featurize as tfeat

PKGS = {"jax": (jcore, jfeat), "port": (tcore, tfeat)}


def _frame(pkg, cols, num_partitions=1):
    return PKGS[pkg][0].DataFrame.from_dict(cols, num_partitions)


def _run(build, cols, num_partitions=1):
    """``build(core, featurize, df)`` on both packages -> the collected
    output of each."""
    return [build(*PKGS[pkg], _frame(pkg, cols, num_partitions)).collect()
            for pkg in ("jax", "port")]


def _same_cell(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same_cell(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same_cell(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return a.dtype == b.dtype and a.shape == b.shape and \
            np.array_equal(a, b, equal_nan=a.dtype.kind == "f")
    if isinstance(a, float) and isinstance(b, float):
        return a == b or (np.isnan(a) and np.isnan(b))
    return type(a) is type(b) and a == b


def _same_frames(j, t):
    assert list(j) == list(t)
    for c in j:
        a, b = j[c], t[c]
        assert a.dtype == b.dtype, (c, a.dtype, b.dtype)
        if a.dtype == object:
            assert all(_same_cell(x, y) for x, y in zip(a, b)), c
        else:
            np.testing.assert_array_equal(a, b, err_msg=c)


def _mixed(n=240, seed=0):
    """Numeric with NaN, ints, bools, low- and high-cardinality strings with
    None, a vector column and an all-NaN column."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=n)
    x[rng.random(n) < 0.1] = np.nan
    city = np.array(rng.choice(["ulm", "pau", "ely", "aix"], n), dtype=object)
    city[rng.random(n) < 0.05] = None
    ident = np.array([f"id{v}" for v in rng.integers(0, 150, n)], dtype=object)
    vec = np.empty(n, dtype=object)
    for i in range(n):
        vec[i] = rng.normal(size=3)
    return {"x": x, "k": rng.integers(0, 9, n), "b": rng.random(n) < 0.3,
            "city": city, "ident": ident, "vec": vec,
            "dead": np.full(n, np.nan)}


@pytest.mark.parametrize("one_hot", [True, False])
@pytest.mark.parametrize("impute", [True, False])
def test_featurize_equals_jax(one_hot, impute):
    cols = _mixed()
    models = {}

    def build(core, feat, df):
        m = feat.Featurize().set_params(
            input_cols=list(cols), output_col="f", num_features=32,
            one_hot_encode_categoricals=one_hot,
            impute_missing=impute).fit(df)
        models[core.__name__] = m
        return m.transform(df)

    j, t = _run(build, cols, num_partitions=3)
    _same_frames(j, t)
    mj, mt = models["mmlspark_tpu.core"], models["mmlspark_tpu_torch.core"]
    assert mj.get("plan") == mt.get("plan")
    assert mj.categorical_slots() == mt.categorical_slots()
    kinds = {s["kind"] for s in mt.get("plan")}
    assert "hash" in kinds and ("onehot" if one_hot else "index") in kinds


@pytest.mark.parametrize("mode", ["Mean", "Median", "Custom"])
def test_clean_missing_data_equals_jax(mode):
    rng = np.random.default_rng(1)
    x = rng.normal(size=50)
    x[::7] = np.nan
    cols = {"x": x, "y": np.where(rng.random(50) < 0.2, np.nan, 3.0)}

    def build(core, feat, df):
        return feat.CleanMissingData().set_params(
            input_cols=["x", "y"], output_cols=["x2", "y2"],
            cleaning_mode=mode, custom_value=-1.5).fit(df).transform(df)

    _same_frames(*_run(build, cols, num_partitions=2))


def test_value_indexer_index_to_value_count_selector_equal_jax():
    rng = np.random.default_rng(2)
    c = np.array(rng.choice(["b", "a", "c"], 40), dtype=object)
    c[3] = None
    vec = np.empty(40, dtype=object)
    for i in range(40):
        v = rng.normal(size=6)
        v[[1, 4]] = 0.0
        vec[i] = v
    cols = {"c": c, "v": vec}

    def build(core, feat, df):
        vi = feat.ValueIndexer().set_params(input_col="c",
                                            output_col="ci").fit(df)
        out = vi.transform(df)
        out = feat.IndexToValue().set_params(
            input_col="ci", output_col="c2",
            levels=vi.get("levels")).transform(out)
        cs = feat.CountSelector().set_params(input_col="v",
                                             output_col="v2").fit(out)
        assert cs.get("indices") == [0, 2, 3, 5]
        return cs.transform(out)

    _same_frames(*_run(build, cols))


@pytest.mark.parametrize("to", ["boolean", "byte", "short", "integer", "long",
                                "float", "double", "string",
                                "toCategorical", "clearCategorical"])
def test_data_conversion_equals_jax(to):
    cols = {"n": np.array(["7", "8", "9", "7"], dtype=object),
            "x": np.array([1.5, 0.0, 3.25, np.nan])
            if to not in ("byte", "short", "integer", "long")
            else np.array([1.0, 0.0, 3.0, 2.0])}

    def build(core, feat, df):
        return feat.DataConversion().set_params(
            cols=["n", "x"], convert_to=to).transform(df)

    _same_frames(*_run(build, cols))


def test_data_conversion_spark_cast_semantics_and_dates():
    cols = {"x": np.array(["1.5", "?", "3"], dtype=object),
            "d": np.array(["2024-01-02", "2023-12-31T10:00:00"], dtype=object)}

    def bad(core, feat, df):
        return feat.DataConversion().set_params(
            cols=["x"], convert_to="double").transform(df)

    j, t = _run(bad, {"x": cols["x"]})
    _same_frames(j, t)
    assert np.isnan(t["x"][1])
    for pkg in ("jax", "port"):
        with pytest.raises((ValueError, TypeError)):
            PKGS[pkg][1].DataConversion().set_params(
                cols=["x"], convert_to="integer").transform(
                    _frame(pkg, {"x": cols["x"]})).collect()

    def dates(core, feat, df):
        return feat.DataConversion().set_params(
            cols=["d"], convert_to="date").transform(df)

    j, t = _run(dates, {"d": cols["d"]})
    _same_frames(j, t)
    assert t["d"][1] == datetime.datetime(2023, 12, 31, 10)


def test_assemble_vector_column_equals_jax():
    rng = np.random.default_rng(3)
    vec = np.empty(5, dtype=object)
    for i in range(5):
        vec[i] = rng.normal(size=2)
    scal = np.array([1.0, None, 2.5, None, -1.0], dtype=object)
    a = jfeat.assemble_vector_column([vec, scal])
    b = tfeat.assemble_vector_column([vec, scal])
    assert all(_same_cell(x, y) for x, y in zip(a, b))


TEXTS = np.array(["The cat sat on the mat", "dogs chase CATS and the cat",
                  "the mat is flat", "", "a b c d e f g h",
                  "  spaced   out\ttext  ", "the the the cat"], dtype=object)


@pytest.mark.parametrize("params", [
    {},
    {"use_stop_words_remover": True, "num_features": 64},
    {"use_ngram": True, "n": 2, "binary": True, "num_features": 128},
    {"use_idf": False, "to_lower_case": False, "min_token_length": 2},
    {"min_doc_freq": 2, "num_features": 256},
    {"tokenizer_pattern": r"\w+", "tokenizer_gaps": False,
     "stop_words": ["cat"], "use_stop_words_remover": True},
    {"use_tokenizer": False, "num_features": 32},
], ids=lambda p: ",".join(sorted(p)) or "defaults")
def test_text_featurizer_equals_jax(params):
    def build(core, feat, df):
        m = feat.TextFeaturizer().set_params(input_col="text",
                                             output_col="f", **params).fit(df)
        return m.transform(df)

    _same_frames(*_run(build, {"text": TEXTS}, num_partitions=2))


def test_multi_ngram_and_page_splitter_equal_jax():
    toks = np.empty(3, dtype=object)
    toks[0], toks[1], toks[2] = ["a", "b", "c", "d"], ["x"], []
    long_text = np.array(["word " * 40, "no-spaces-" * 12, "short"],
                         dtype=object)

    def grams(core, feat, df):
        return feat.MultiNGram().set_params(
            input_col="t", output_col="g", lengths=[1, 2, 3]).transform(df)

    def pages(core, feat, df):
        return feat.PageSplitter().set_params(
            input_col="s", output_col="p", maximum_page_length=37,
            minimum_page_length=20).transform(df)

    _same_frames(*_run(grams, {"t": toks}))
    j, t = _run(pages, {"s": long_text})
    _same_frames(j, t)
    assert all("".join(p) == s for p, s in zip(t["p"], long_text))


def test_featurize_model_saved_by_jax_loads_in_the_port(tmp_path):
    cols = _mixed(60, seed=4)
    df_j, df_t = _frame("jax", cols), _frame("port", cols)
    m = jfeat.Featurize().set_params(input_cols=list(cols), output_col="f",
                                     num_features=16).fit(df_j)
    jcore.save(m, str(tmp_path / "feat"))
    back = tcore.load(str(tmp_path / "feat"))
    assert type(back).__module__ == "mmlspark_tpu_torch.featurize.featurize"
    _same_frames(m.transform(df_j).collect(), back.transform(df_t).collect())
