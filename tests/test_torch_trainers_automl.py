"""The auto-trainers and tuning in the port (``mmlspark_tpu_torch.train``'s
``TrainClassifier``/``TrainRegressor``, ``automl``) against the JAX
package on the same seeded frames, on the CPU with float histograms:
featurized vectors and the wired categorical slots equal; scores within
1e-5; ``TuneHyperparameters`` the same best params and metrics within
1e-6, and ``parallelism=2`` (two fits on two threads) equal to
``parallelism=1``; ``FindBestModel`` the same pick.  Whole fits are
compared, so the parity contract's slack applies: a split may part at an
f32 near-tie of two gains, which then moves a candidate's metric (at 300
rows and ``min_data_in_leaf=5`` one of the four grid candidates parted
so, its tree 0 choosing between two splits of gain 0.6062012); the search
runs on 1,500 rows with ``min_data_in_leaf=20``, where none parts."""
import numpy as np
import pytest

import mmlspark_tpu.automl as jautoml
import mmlspark_tpu.core as jcore
import mmlspark_tpu.lightgbm as jlgb
import mmlspark_tpu.train as jtrain
import mmlspark_tpu_torch.automl as tautoml
import mmlspark_tpu_torch.core as tcore
import mmlspark_tpu_torch.lightgbm as tlgb
import mmlspark_tpu_torch.train as ttrain

PKGS = {"jax": (jcore, jlgb, jtrain, jautoml),
        "port": (tcore, tlgb, ttrain, tautoml)}
TOL = 1e-5


def _learner(pkg, cls, **kw):
    est = getattr(PKGS[pkg][1], cls)()
    if pkg == "port":
        kw = {"device": "cpu", **kw}
    return est.set_params(**kw)


def _census(n=700, seed=0):
    """Numeric columns with NaN, string columns at a few cardinalities, a
    string label from a planted logistic model."""
    rng = np.random.default_rng(seed)
    age = rng.uniform(18, 80, n)
    hours = rng.normal(40, 10, n)
    hours[rng.random(n) < 0.05] = np.nan
    edu = np.array(rng.choice([f"e{i}" for i in range(7)], n), dtype=object)
    sex = np.array(rng.choice(["f", "m"], n), dtype=object)
    logit = 0.08 * (age - 45) + 0.9 * np.isin(edu, ["e1", "e4"]) \
        - 0.6 * (sex == "f")
    y = rng.random(n) < 1 / (1 + np.exp(-logit))
    label = np.array(np.where(y, ">50K", "<=50K"), dtype=object)
    return {"age": age, "hours": hours, "edu": edu, "sex": sex,
            "label": label}


@pytest.mark.parametrize("one_hot", [True, False])
def test_train_classifier_equals_jax(one_hot):
    cols = _census()
    out = {}
    for pkg in ("jax", "port"):
        core, _, train, _ = PKGS[pkg]
        df = core.DataFrame.from_dict(cols)
        tc = train.TrainClassifier(_learner(
            pkg, "LightGBMClassifier", num_iterations=15, num_leaves=7,
            min_data_in_leaf=5)).set_params(
                label_col="label", one_hot_encode_categoricals=one_hot)
        model = tc.fit(df)
        feat = model.get("featurizer")
        fcol = feat.transform(df).collect()[model.get("features_col")]
        scored = model.transform(df).collect()
        out[pkg] = (np.stack(fcol), feat.categorical_slots(),
                    model.get("inner_model").get("booster")
                    .categorical_features, scored)
    (fj, sj, cj, dj), (fp, sp, cp, dp) = out["jax"], out["port"]
    np.testing.assert_array_equal(fp, fj)
    assert sp == sj and list(cp) == list(cj)
    assert (list(cp) == [2, 3]) is (not one_hot)
    np.testing.assert_allclose(np.stack(dp["probability"]),
                               np.stack(dj["probability"]), rtol=TOL,
                               atol=TOL)
    np.testing.assert_array_equal(dp["predicted_label"],
                                  dj["predicted_label"])
    assert "TrainClassifier_features" not in dp


def test_train_regressor_equals_jax():
    rng = np.random.default_rng(1)
    n = 400
    x1 = rng.normal(size=n)
    cols = {"x1": x1, "cat": np.array(rng.choice(["a", "b", "c"], n),
                                      dtype=object),
            "label": 3 * x1 + (rng.random(n) < 0.5)}
    preds = {}
    for pkg in ("jax", "port"):
        core, _, train, _ = PKGS[pkg]
        tr = train.TrainRegressor(_learner(
            pkg, "LightGBMRegressor", num_iterations=20,
            min_data_in_leaf=5)).set_params(label_col="label")
        preds[pkg] = tr.fit(core.DataFrame.from_dict(cols)).transform(
            core.DataFrame.from_dict(cols)).collect()["prediction"]
    np.testing.assert_allclose(preds["port"], preds["jax"], rtol=TOL,
                               atol=TOL)


def _vectors(n=1500, seed=1):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 6))
    y = (X[:, 0] + 0.5 * X[:, 1] * X[:, 2] > 0).astype(float)
    return X, y


def _tune(pkg, parallelism, grid=True):
    core, _, _, automl = PKGS[pkg]
    X, y = _vectors()
    df = core.DataFrame.from_dict({"features": core.vector_column(list(X)),
                                   "label": y})
    spaces = automl.HyperparamBuilder() \
        .add_hyperparam("num_leaves", automl.DiscreteHyperParam([4, 15])) \
        .add_hyperparam("learning_rate",
                        automl.RangeHyperParam(0.1, 0.3)).build()
    space = automl.GridSpace(spaces, points_per_range=2) if grid \
        else automl.RandomSpace(spaces, seed=3)
    tuner = automl.TuneHyperparameters().set_params(
        parallelism=parallelism, number_of_runs=3,
        evaluation_metric="accuracy")
    tuner.set("models", _learner(pkg, "LightGBMClassifier",
                                 num_iterations=10, min_data_in_leaf=20))
    tuner.set("param_space", space)
    return tuner.fit(df), df


@pytest.mark.parametrize("grid", [True, False], ids=["grid", "random"])
def test_tune_hyperparameters_equals_jax_and_threads_change_nothing(grid):
    jbest, _ = _tune("jax", 1, grid)
    p1, df = _tune("port", 1, grid)
    p2, _ = _tune("port", 2, grid)
    assert p1.get("best_params") == jbest.get("best_params")
    np.testing.assert_allclose(p1.get("all_metrics"),
                               jbest.get("all_metrics"), atol=1e-6)
    assert abs(p1.get("best_metric") - jbest.get("best_metric")) <= 1e-6
    assert p2.get("all_metrics") == p1.get("all_metrics")
    assert p2.get("best_params") == p1.get("best_params")
    b1 = p1.get("best_model").get("booster")
    b2 = p2.get("best_model").get("booster")
    for name in ("split_feature", "threshold_bin", "leaf_value"):
        np.testing.assert_array_equal(getattr(b2, name), getattr(b1, name))
    np.testing.assert_array_equal(
        p2.transform(df).collect()["prediction"],
        p1.transform(df).collect()["prediction"])
    assert "metric=" in p1.get_best_model_info()


def test_find_best_model_equals_jax():
    X, y = _vectors(seed=2)
    picks = {}
    for pkg in ("jax", "port"):
        core, _, _, automl = PKGS[pkg]
        df = core.DataFrame.from_dict(
            {"features": core.vector_column(list(X)), "label": y})
        models = [_learner(pkg, "LightGBMClassifier", num_iterations=it,
                           min_data_in_leaf=5).fit(df) for it in (2, 20)]
        fb = automl.FindBestModel()
        fb.set("models", models)
        bm = fb.fit(df)
        picks[pkg] = (bm.get_evaluation_results(),
                      bm.get("best_model_metrics"),
                      bm.transform(df).collect()["prediction"])
        rmse = automl.FindBestModel().set_params(
            evaluation_metric="root_mean_squared_error")
        rmse.set("models", models)
        picks[pkg] += (rmse.fit(df).get("best_model_metrics"),)
    np.testing.assert_allclose(picks["port"][0], picks["jax"][0], atol=1e-6)
    assert abs(picks["port"][1] - picks["jax"][1]) <= 1e-6
    np.testing.assert_array_equal(picks["port"][2], picks["jax"][2])
    assert abs(picks["port"][3] - picks["jax"][3]) <= 1e-6


def test_default_hyperparams_and_spaces_equal_jax():
    for name in ("lightgbm_classifier", "vw_classifier"):
        j = getattr(jautoml.DefaultHyperparams, name)()
        t = getattr(tautoml.DefaultHyperparams, name)()
        assert [n for n, _ in j] == [n for n, _ in t]
        jg = list(jautoml.GridSpace(j, 3).param_maps())
        tg = list(tautoml.GridSpace(t, 3).param_maps())
        assert jg == tg
        jr, tr = jautoml.RandomSpace(j, 7).param_maps(), \
            tautoml.RandomSpace(t, 7).param_maps()
        assert [next(jr) for _ in range(5)] == [next(tr) for _ in range(5)]
