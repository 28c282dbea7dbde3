"""The explainers in the port (``mmlspark_tpu_torch.explainers``) against
the JAX package on the same seeded inputs, on the CPU: the ISTA lasso
within rtol 1e-5 / atol 1e-6 (float32 on both sides, the reductions in
another order), the weighted least squares bit for bit (the same host
float64 code), the SLIC superpixels bit for bit, each explainer kind's
masks and perturbed inputs bit for bit (the same ``default_rng`` draws),
its coefficients bit for bit for KernelSHAP and within the lasso's
tolerance for LIME, and its fit metric within 1e-5; a TabularSHAP over a
LightGBM model, saved by the JAX package, loads and explains in a child
process with ``jax`` and the JAX package blocked, its coefficients within
1e-6 of the JAX package's (the two boosters' float32 probabilities differ
in their last bits)."""
import numpy as np
import pytest
import torch

import mmlspark_tpu.core as jcore
import mmlspark_tpu.explainers as jex
import mmlspark_tpu_torch.core as tcore
import mmlspark_tpu_torch.explainers as tex
from mmlspark_tpu.explainers import regression as jreg
from mmlspark_tpu_torch.explainers import regression as treg
from tests.test_torch_isolation import run_blocked

LASSO_RTOL, LASSO_ATOL = 1e-5, 1e-6


def _problem(n=300, d=12, seed=0, shap_weights=False):
    rng = np.random.default_rng(seed)
    X = rng.integers(0, 2, (n, d)).astype(np.float64)
    beta = rng.normal(size=d) * (rng.random(d) < 0.5)
    y = X @ beta + 0.3 + 0.05 * rng.normal(size=n)
    w = rng.uniform(0.1, 1.0, n)
    if shap_weights:
        X[0], X[1] = 1.0, 0.0
        w[:2] = 1e6
    return X, y, w


@pytest.mark.parametrize("alpha,iters,intercept",
                         [(0.01, 200, True), (0.001, 200, True),
                          (0.05, 50, False), (0.0, 300, True)])
def test_lasso_equals_jax(alpha, iters, intercept):
    X, y, w = _problem(seed=int(alpha * 1000) + iters)
    jb, ji = jreg.lasso_regression(X, y, w, alpha=alpha, iters=iters,
                                   fit_intercept=intercept)
    tb, ti = treg.lasso_regression(X, y, w, alpha=alpha, iters=iters,
                                   fit_intercept=intercept, device="cpu")
    assert tb.dtype == np.float32
    np.testing.assert_allclose(tb, jb, rtol=LASSO_RTOL, atol=LASSO_ATOL)
    np.testing.assert_allclose(ti, ji, rtol=LASSO_RTOL, atol=LASSO_ATOL)


@pytest.mark.parametrize("shap_weights", [False, True])
def test_weighted_least_squares_bit_for_bit(shap_weights):
    X, y, w = _problem(seed=5, shap_weights=shap_weights)
    for intercept in (True, False):
        jb, ji = jreg.weighted_least_squares(X, y, w, intercept)
        tb, ti = treg.weighted_least_squares(X, y, w, intercept)
        np.testing.assert_array_equal(tb, jb)
        assert ti == ji


def test_superpixels_bit_for_bit():
    rng = np.random.default_rng(3)
    img = rng.uniform(0, 255, (40, 36, 3))
    img[:, 18:] += 60.0
    for cs, mod in ((8.0, 130.0), (12.0, 20.0)):
        np.testing.assert_array_equal(
            tex.slic_superpixels(img, cs, mod),
            jex.slic_superpixels(img, cs, mod))
    for pkg, core in ((tex, tcore), (jex, jcore)):
        col = np.empty(1, dtype=object)
        col[0] = img
        out = pkg.SuperpixelTransformer().set_params(
            input_col="img", output_col="sp").transform(
                core.DataFrame.from_dict({"img": col})).collect()["sp"][0]
        np.testing.assert_array_equal(out, jex.slic_superpixels(img))


# --------------------------------------------------------------------------
# transparent models, one per package
# --------------------------------------------------------------------------

def _linear_model(core, weights, col="features"):
    """probability = sigmoid(w . x), as a transformer of ``core``."""

    class Lin(core.Transformer):
        def _transform(self, df):
            def per_part(p):
                X = np.stack([np.asarray(v, float) for v in p[col]])
                prob = 1 / (1 + np.exp(-(X @ weights)))
                out = np.empty(len(prob), dtype=object)
                for i in range(len(prob)):
                    out[i] = np.asarray([1 - prob[i], prob[i]])
                return {**p, "probability": out}
            return df.map_partitions(per_part)

    return Lin()


def _keyword_model(core):
    class Keyword(core.Transformer):
        def _transform(self, df):
            def per_part(p):
                out = np.asarray([float("good" in str(s)) + 0.3 * float(
                    "day" in str(s)) for s in p["text"]])
                return {**p, "prediction": out}
            return df.map_partitions(per_part)

    return Keyword()


def _bright_model(core):
    class Bright(core.Transformer):
        def _transform(self, df):
            def per_part(p):
                out = np.asarray([float(np.asarray(v)[..., 0].mean()) / 255.0
                                  for v in p["image"]])
                return {**p, "prediction": out}
            return df.map_partitions(per_part)

    return Bright()


W = np.asarray([2.0, -1.0, 0.0, 0.5, 1.5])
VEC = np.random.default_rng(11).normal(size=(3, len(W)))
BACKGROUND = np.random.default_rng(12).normal(size=(20, len(W)))


def _vector_case(pkg, core, kind):
    df = core.DataFrame.from_dict({"features": core.vector_column(list(VEC))})
    bg = core.DataFrame.from_dict({"features": core.vector_column(
        list(BACKGROUND))})
    cls = getattr(pkg.LocalExplainer, kind).vector
    exp = cls(model=_linear_model(core, W), input_col="features",
              output_col="w", target_classes=[1], num_samples=300,
              background_data=bg, regularization=0.001, seed=4)
    return exp, df


def _tabular_case(pkg, core, kind):
    cols = {f"c{j}": VEC[:, j] for j in range(len(W))}
    df = core.DataFrame.from_dict(cols)
    bg = core.DataFrame.from_dict({f"c{j}": BACKGROUND[:, j]
                                   for j in range(len(W))})
    cls = getattr(pkg.LocalExplainer, kind).tabular
    exp = cls(model=_linear_model(core, W), input_col="features",
              input_cols=list(cols), output_col="w", target_classes=[1],
              num_samples=400, background_data=bg, seed=5)
    return exp, df


def _text_case(pkg, core, kind):
    df = core.DataFrame.from_dict({"text": np.array(
        ["a good day", "not a good time at all", "day"], dtype=object)})
    cls = getattr(pkg.LocalExplainer, kind).text
    exp = cls(model=_keyword_model(core), input_col="text", output_col="w",
              target_col="prediction", num_samples=64, regularization=0.001,
              seed=6)
    return exp, df


def _image_case(pkg, core, kind):
    rng = np.random.default_rng(13)
    col = np.empty(2, dtype=object)
    for i in range(2):
        img = rng.uniform(0, 80, (24, 28, 3))
        img[:, 12 + 4 * i:] += 150.0
        col[i] = img
    df = core.DataFrame.from_dict({"image": col})
    cls = getattr(pkg.LocalExplainer, kind).image
    exp = cls(model=_bright_model(core), input_col="image", output_col="w",
              target_col="prediction", num_samples=48, cell_size=8.0,
              regularization=0.001, seed=7)
    return exp, df


CASES = {"vector": _vector_case, "tabular": _tabular_case,
         "text": _text_case, "image": _image_case}


@pytest.mark.parametrize("kind", ["LIME", "KernelSHAP"])
@pytest.mark.parametrize("modality", sorted(CASES))
def test_explainer_equals_jax(modality, kind):
    jexp, jdf = CASES[modality](jex, jcore, kind)
    texp, tdf = CASES[modality](tex, tcore, kind)
    texp.set_params(device="cpu")
    # the samplers draw the same masks and perturbed inputs
    inst = VEC[0] if modality == "tabular" else \
        jdf.collect()[jexp.get("input_col")][0]
    jm, ji = jexp._make_samples(inst, np.random.default_rng(1), 50)
    tm, ti = texp._make_samples(inst, np.random.default_rng(1), 50)
    np.testing.assert_array_equal(tm, jm)
    for a, b in zip(ti, ji):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    jo, to = jexp.transform(jdf).collect(), texp.transform(tdf).collect()
    for a, b in zip(to["w"], jo["w"]):
        if kind == "KernelSHAP":
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, rtol=LASSO_RTOL,
                                       atol=LASSO_ATOL)
    np.testing.assert_allclose(to["r2"], jo["r2"], rtol=1e-5, atol=1e-5)
    for extra in ("tokens", "superpixels"):
        if extra in jo:
            for a, b in zip(to[extra], jo[extra]):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_explainers_need_the_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for kind in ("LIME", "KernelSHAP"):
        exp, df = _vector_case(tex, tcore, kind)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            exp.transform(df).collect()
        exp.set_params(device="cpu")
        assert len(exp.transform(df).collect()["w"]) == len(VEC)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        treg.lasso_regression(*_problem(n=20, d=3))


def test_tabular_shap_over_a_port_lightgbm_model():
    """Each row's samples go through the port booster's walk in one
    transform; the coefficients plus the intercept give the row's own
    score (the all-on coalition's 1e6 weight)."""
    from mmlspark_tpu_torch.lightgbm import LightGBMClassifier
    rng = np.random.default_rng(21)
    X = rng.normal(size=(600, 4))
    y = (X[:, 0] + 0.5 * X[:, 1] > 0).astype(np.float64)
    cols = {f"x{j}": X[:, j] for j in range(4)}
    df = tcore.DataFrame.from_dict({"features": tcore.vector_column(
        list(X)), "label": y, **cols})
    model = LightGBMClassifier().set_params(num_iterations=5, device="cpu") \
        .fit(df)
    captured = []

    class Recording(tex.TabularSHAP):
        def _fit_surrogate(self, mask, scores, weights, device):
            out = super()._fit_surrogate(mask, scores, weights, device)
            captured.append((scores[0], out))
            return out

    exp = Recording(model=model, input_col="features", input_cols=list(cols),
                    output_col="shap", target_classes=[1], num_samples=200,
                    background_data=df, device="cpu")
    out = exp.transform(tcore.DataFrame.from_dict(
        {k: v[:3] for k, v in cols.items()})).collect()
    probs = model.transform(df).collect()["probability"][:3]
    for i, (full_score, (coefs, intercept)) in enumerate(captured):
        assert full_score == probs[i][1]
        assert abs(coefs.sum() + intercept - full_score) < 1e-3
        np.testing.assert_array_equal(out["shap"][i], coefs)


_EXPLAIN = r"""
import numpy as np
from mmlspark_tpu_torch.core import DataFrame, load
X = np.load({x!r})
exp = load({path!r}).set_params(device="cpu")
assert type(exp).__module__ == "mmlspark_tpu_torch.explainers.local", type(exp)
exp.get("model").set_params(device="cpu")
df = DataFrame.from_dict({{f"x{{j}}": X[:, j] for j in range(X.shape[1])}})
out = exp.transform(df).collect()
np.save({out!r}, np.stack(out["shap"]))
assert not [k for k in sys.modules if blocked(k)]
"""


def test_jax_saved_explainer_loads_with_jax_blocked(tmp_path):
    from mmlspark_tpu.lightgbm import LightGBMClassifier
    rng = np.random.default_rng(22)
    X = rng.normal(size=(500, 3))
    y = (X[:, 0] - X[:, 2] > 0).astype(np.float64)
    cols = {f"x{j}": X[:, j] for j in range(3)}
    df = jcore.DataFrame.from_dict({"features": jcore.vector_column(
        list(X)), "label": y, **cols})
    model = LightGBMClassifier().set_params(num_iterations=4).fit(df)
    exp = jex.TabularSHAP(model=model, input_col="features",
                          input_cols=list(cols), output_col="shap",
                          target_classes=[1], num_samples=120,
                          background_data=jcore.DataFrame.from_dict(
                              {k: v[:30] for k, v in cols.items()}))
    path = str(tmp_path / "shap")
    jcore.save(exp, path)
    np.save(tmp_path / "x.npy", X[:4])
    want = np.stack(exp.transform(jcore.DataFrame.from_dict(
        {k: v[:4] for k, v in cols.items()})).collect()["shap"])
    run_blocked(_EXPLAIN.format(x=str(tmp_path / "x.npy"), path=path,
                                out=str(tmp_path / "out.npy")))
    # the two walks' float32 probabilities differ in their last bits
    np.testing.assert_allclose(np.load(tmp_path / "out.npy"), want,
                               rtol=0, atol=1e-6)
