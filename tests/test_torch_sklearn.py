"""The scikit-learn estimators (``sklearn.py``) and plotting
(``plotting.py``) of the port against the JAX package's, on the CPU
(``device="cpu"`` through ``**kwargs``), both packages on their device
growers (``device_growth="on"``) except the custom objective, which takes
the host learner in both:

* ``tests/test_api.py``'s estimator cases re-pointed at the port;
* ``get_params`` equal to the JAX estimators' for the same arguments;
* the classifier (binary and three classes, ``class_weight``), regressor
  and ranker: the same trees as the JAX estimators' ("the same trees" of
  ``tests/test_torch_engine_api.py``; lambdarank's leaf values within
  1e-4, the JAX package's float32 pair sums), the same predictions;
* plotting on a model text both packages load: ``create_tree_digraph``'s
  source equal to the JAX package's, ``plot_importance``'s bars and
  ``plot_metric``'s curves equal;
* ``lightgbm_tpu_torch.sklearn`` and ``.plotting`` import with
  scikit-learn, matplotlib and graphviz hidden (the card machine has
  none of them).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu.plotting as jplot
import lightgbm_tpu_torch as tlgb
import lightgbm_tpu_torch.plotting as tplot

from test_torch_engine_api import _assert_same_trees

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JKW = {"device_growth": "on", "verbose": -1}
TKW = {**JKW, "device": "cpu"}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """This module's torch CPU ops on one thread (several test workers
    share the machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def bin_data():
    rng = np.random.default_rng(0)
    n = 3000
    x = rng.standard_normal((n, 8)).astype(np.float64)
    w = rng.standard_normal(8)
    p = 1 / (1 + np.exp(-(x @ w + np.abs(x[:, 0]))))
    y = (p > rng.random(n)).astype(np.float64)
    return x[:2400], y[:2400], x[2400:], y[2400:]


@pytest.fixture(scope="module")
def reg_data():
    rng = np.random.default_rng(1)
    n = 2000
    x = rng.standard_normal((n, 6)).astype(np.float64)
    y = x[:, 0] * 2 + np.sin(x[:, 1] * 3) + 0.1 * rng.standard_normal(n)
    return x[:1500], y[:1500], x[1500:], y[1500:]


@pytest.fixture(scope="module")
def rank_data():
    rng = np.random.default_rng(3)
    n, q = 1200, 60
    x = rng.standard_normal((n, 5))
    rel = np.clip((x[:, 0] + 0.3 * rng.standard_normal(n)) * 2, 0,
                  4).astype(int)
    return x, rel, np.full(q, n // q)


# ----------------------------------------------------------------------
# tests/test_api.py's estimator cases, re-pointed at the port

def test_sklearn_classifier(bin_data):
    x, y, xt, yt = bin_data
    clf = tlgb.LGBMClassifier(n_estimators=25, num_leaves=31,
                              learning_rate=0.1, device="cpu")
    clf.fit(x, y)
    proba = clf.predict_proba(xt)
    assert proba.shape == (len(yt), 2)
    assert np.allclose(proba.sum(axis=1), 1.0, atol=1e-6)
    acc = (clf.predict(xt) == yt).mean()
    assert acc > 0.75
    imp = clf.feature_importances_
    assert imp.shape == (x.shape[1],) and imp.sum() > 0


def test_sklearn_regressor_custom_objective(reg_data):
    x, y, xt, yt = reg_data

    def l2_obj(y_true, y_pred):
        return y_pred - y_true, np.ones_like(y_true)

    reg = tlgb.LGBMRegressor(n_estimators=30, num_leaves=15,
                             learning_rate=0.1, objective=l2_obj,
                             device="cpu")
    reg.fit(x, y)
    mse = float(np.mean((reg.predict(xt) - yt) ** 2))
    reg2 = tlgb.LGBMRegressor(n_estimators=30, num_leaves=15,
                              learning_rate=0.1, device="cpu")
    reg2.fit(x, y)
    mse2 = float(np.mean((reg2.predict(xt) - yt) ** 2))
    assert mse == pytest.approx(mse2, rel=0.2)


def test_sklearn_ranker(rank_data):
    x, rel, group = rank_data
    rk = tlgb.LGBMRanker(n_estimators=20, num_leaves=15, learning_rate=0.1,
                         device="cpu")
    rk.fit(x, rel, group=group)
    from scipy.stats import spearmanr
    assert spearmanr(rk.predict(x), rel).statistic > 0.5
    with pytest.raises(ValueError, match="group"):
        rk.fit(x, rel)


def test_sklearn_clone_and_get_params():
    from sklearn.base import clone
    clf = tlgb.LGBMClassifier(n_estimators=5, num_leaves=7, device="cpu")
    c2 = clone(clf)
    assert c2.get_params()["num_leaves"] == 7
    assert c2.get_params()["device"] == "cpu"


# ----------------------------------------------------------------------
# against the JAX estimators

@pytest.mark.parametrize("cls", ["LGBMModel", "LGBMRegressor",
                                 "LGBMClassifier", "LGBMRanker"])
def test_get_params_equal_jax(cls):
    kw = dict(num_leaves=7, learning_rate=0.05, subsample=0.8,
              subsample_freq=2, reg_lambda=1.5, random_state=4,
              class_weight="balanced", min_child_samples=5)
    j = getattr(jlgb, cls)(**kw, **JKW)
    t = getattr(tlgb, cls)(**kw, **TKW)
    tp = t.get_params()
    assert tp.pop("device") == "cpu"
    assert tp == j.get_params()
    j.set_params(num_leaves=9, max_bin=31)
    t.set_params(num_leaves=9, max_bin=31)
    assert {k: v for k, v in t.get_params().items() if k != "device"} \
        == j.get_params()
    j._n_classes = t._n_classes = 2
    tl = t._get_lgb_params()
    assert tl.pop("device") == "cpu"
    assert tl == j._get_lgb_params()


@pytest.mark.parametrize("case", ["binary", "balanced", "multiclass"])
def test_classifier_trees_equal_jax(bin_data, case):
    x, y, xt, _ = bin_data
    kw = dict(n_estimators=4, num_leaves=15, learning_rate=0.2)
    if case == "balanced":
        kw["class_weight"] = "balanced"
    if case == "multiclass":
        # noisy tertiles: no pure leaf, where the packages may part on a
        # split whose gain is float32 noise (ROADMAP §3)
        z = x[:, 1] + x[:, 2] + np.random.default_rng(5).standard_normal(
            len(x))
        y = np.array([-1, 3, 7])[np.digitize(z, np.quantile(z, [0.3,
                                                                0.7]))]
    else:
        y = np.where(y > 0, "yes", "no")
    j = jlgb.LGBMClassifier(**kw, **JKW).fit(x, y)
    t = tlgb.LGBMClassifier(**kw, **TKW).fit(x, y)
    assert list(t.classes_) == list(j.classes_)
    _assert_same_trees(j.booster_, t.booster_, x)
    np.testing.assert_allclose(t.predict_proba(xt), j.predict_proba(xt),
                               atol=1e-5)
    assert (t.predict(xt) == j.predict(xt)).all()


def test_regressor_with_eval_set_equal_jax(reg_data):
    x, y, xt, yt = reg_data
    kw = dict(n_estimators=30, num_leaves=15, learning_rate=0.3)
    fit = dict(eval_set=[(xt, yt)], eval_metric="l1",
               early_stopping_rounds=3, verbose=False)
    j = jlgb.LGBMRegressor(**kw, **JKW).fit(x, y, **fit)
    t = tlgb.LGBMRegressor(**kw, **TKW).fit(x, y, **fit)
    assert t.best_iteration_ == j.best_iteration_
    np.testing.assert_allclose(t.evals_result_["valid_0"]["l1"],
                               j.evals_result_["valid_0"]["l1"], atol=1e-5)
    _assert_same_trees(j.booster_, t.booster_, x)
    np.testing.assert_allclose(t.predict(xt), j.predict(xt), atol=1e-5)


def test_ranker_trees_equal_jax(rank_data):
    x, rel, group = rank_data
    kw = dict(n_estimators=4, num_leaves=15, learning_rate=0.1)
    j = jlgb.LGBMRanker(**kw, **JKW).fit(x, rel, group=group)
    t = tlgb.LGBMRanker(**kw, **TKW).fit(x, rel, group=group)
    _assert_same_trees(j.booster_, t.booster_, x, rtol=1e-4)


# ----------------------------------------------------------------------
# plotting

@pytest.fixture(scope="module")
def model_text(bin_data):
    x, y, _, _ = bin_data
    b = jlgb.train({"objective": "binary", "num_leaves": 7, **JKW},
                   jlgb.Dataset(x, y, feature_name=[f"f{i}"
                                                    for i in range(8)]),
                   3, verbose_eval=False)
    return b.model_to_string()


@pytest.mark.parametrize("info", [None, ["leaf_count", "split_gain",
                                          "internal_count"]])
def test_tree_digraph_equals_jax(model_text, info):
    jb = jlgb.Booster(model_str=model_text)
    tb = tlgb.Booster(model_str=model_text, params={"device": "cpu"})
    for i in range(3):
        js = jplot.create_tree_digraph(jb, tree_index=i, show_info=info)
        ts = tplot.create_tree_digraph(tb, tree_index=i, show_info=info)
        assert ts.source == js.source
    with pytest.raises(IndexError):
        tplot.create_tree_digraph(tb, tree_index=3)


def test_plot_importance_and_metric_equal_jax(model_text, bin_data):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    jb = jlgb.Booster(model_str=model_text)
    tb = tlgb.Booster(model_str=model_text, params={"device": "cpu"})
    for kind in ("split", "gain"):
        ja = jplot.plot_importance(jb, importance_type=kind)
        ta = tplot.plot_importance(tb, importance_type=kind)
        bars = lambda ax: [p.get_width() for p in ax.patches]
        assert bars(ta) == bars(ja) and len(bars(ta)) > 0
        assert [t.get_text() for t in ta.get_yticklabels()] == \
            [t.get_text() for t in ja.get_yticklabels()]
    x, y, xt, yt = bin_data
    kw = dict(n_estimators=3, num_leaves=7)
    fit = dict(eval_set=[(xt, yt)], eval_metric="binary_logloss",
               verbose=False)
    j = jlgb.LGBMClassifier(**kw, **JKW).fit(x, y, **fit)
    t = tlgb.LGBMClassifier(**kw, **TKW).fit(x, y, **fit)
    ja, ta = jplot.plot_metric(j), tplot.plot_metric(t)
    np.testing.assert_allclose(ta.lines[0].get_ydata(),
                               ja.lines[0].get_ydata(), atol=1e-6)
    assert tplot.plot_metric(t.evals_result_).get_ylabel() == "metric"
    with pytest.raises(TypeError):
        tplot.plot_importance(object())
    plt.close("all")


def test_modules_import_without_sklearn_or_matplotlib():
    code = (
        "import sys\n"
        "for m in ('sklearn', 'matplotlib', 'graphviz'):\n"
        "    sys.modules[m] = None\n"
        "import lightgbm_tpu_torch as lt\n"
        "import lightgbm_tpu_torch.sklearn, lightgbm_tpu_torch.plotting\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'lightgbm_tpu'))\n"
        "assert not bad, bad\n"
        "assert lt.LGBMClassifier(device='cpu').get_params()['device']\n"
        "try:\n"
        "    lt.plot_importance(None)\n"
        "except ImportError:\n"
        "    print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.strip() == "ok"
