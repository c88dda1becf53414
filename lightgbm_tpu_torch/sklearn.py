"""scikit-learn estimators (counterpart of ``lightgbm_tpu/sklearn.py``,
after the reference's ``python-package/lightgbm/sklearn.py:128-833``):
``LGBMModel``, ``LGBMRegressor``, ``LGBMClassifier`` (label encoding,
``class_weight``, ``predict_proba``) and ``LGBMRanker``, with the wrappers
of sklearn-style objectives and metrics.  Like the JAX package's they do
not subclass scikit-learn's ``BaseEstimator`` (``get_params`` /
``set_params`` are their own, so ``sklearn.base.clone`` works), and this
module imports nothing of scikit-learn.  Parameters the constructor does
not name go through ``**kwargs`` into the training params: ``device="cpu"``
trains and predicts on the CPU, the default is the card."""

from __future__ import annotations

from inspect import signature
from typing import Optional

import numpy as np

from .basic import Booster, Dataset
from .engine import train
from .utils.log import LightGBMError

__all__ = ["LGBMModel", "LGBMRegressor", "LGBMClassifier", "LGBMRanker"]


def _objective_function_wrapper(func):
    """Wrap a sklearn-style objective fobj(y_true, y_pred[, group]) into the
    engine's fobj(preds, dataset) (reference sklearn.py:31-86)."""

    def inner(preds, dataset):
        labels = dataset.get_label()
        argc = len(signature(func).parameters)
        if argc == 2:
            grad, hess = func(labels, preds)
        elif argc == 3:
            grad, hess = func(labels, preds, dataset.get_group())
        else:
            raise TypeError(
                "Self-defined objective should have 2 or 3 arguments")
        return grad, hess
    return inner


def _eval_function_wrapper(func):
    """Wrap feval(y_true, y_pred[, weight[, group]]) ->
    (name, value, is_higher_better) (reference sklearn.py:88-127)."""

    def inner(preds, dataset):
        labels = dataset.get_label()
        argc = len(signature(func).parameters)
        if argc == 2:
            return func(labels, preds)
        if argc == 3:
            return func(labels, preds, dataset.get_weight())
        if argc == 4:
            return func(labels, preds, dataset.get_weight(),
                        dataset.get_group())
        raise TypeError(
            "Self-defined eval function should have 2, 3 or 4 arguments")
    return inner


class LGBMModel:
    """The base estimator (reference sklearn.py:128-622): ``fit`` trains
    through ``engine.train`` on a ``Dataset`` that keeps its raw rows,
    ``predict`` uses the best iteration when early stopping set one."""

    def __init__(self, boosting_type="gbdt", num_leaves=31, max_depth=-1,
                 learning_rate=0.1, n_estimators=100,
                 subsample_for_bin=200000, objective=None, class_weight=None,
                 min_split_gain=0.0, min_child_weight=1e-3,
                 min_child_samples=20, subsample=1.0, subsample_freq=0,
                 colsample_bytree=1.0, reg_alpha=0.0, reg_lambda=0.0,
                 random_state=None, n_jobs=-1, silent=True,
                 importance_type="split", **kwargs):
        self.boosting_type = boosting_type
        self.objective = objective
        self.num_leaves = num_leaves
        self.max_depth = max_depth
        self.learning_rate = learning_rate
        self.n_estimators = n_estimators
        self.subsample_for_bin = subsample_for_bin
        self.class_weight = class_weight
        self.min_split_gain = min_split_gain
        self.min_child_weight = min_child_weight
        self.min_child_samples = min_child_samples
        self.subsample = subsample
        self.subsample_freq = subsample_freq
        self.colsample_bytree = colsample_bytree
        self.reg_alpha = reg_alpha
        self.reg_lambda = reg_lambda
        self.random_state = random_state
        self.n_jobs = n_jobs
        self.silent = silent
        self.importance_type = importance_type
        self._other_params = dict(kwargs)
        self._Booster: Optional[Booster] = None
        self._evals_result = None
        self._best_score = None
        self._best_iteration = None
        self._classes = None
        self._n_classes = None
        self._n_features = None
        self._objective = objective
        self.set_params(**kwargs)

    # -- sklearn plumbing ----------------------------------------------
    def get_params(self, deep=True):
        params = {
            "boosting_type": self.boosting_type,
            "num_leaves": self.num_leaves,
            "max_depth": self.max_depth,
            "learning_rate": self.learning_rate,
            "n_estimators": self.n_estimators,
            "subsample_for_bin": self.subsample_for_bin,
            "objective": self.objective,
            "class_weight": self.class_weight,
            "min_split_gain": self.min_split_gain,
            "min_child_weight": self.min_child_weight,
            "min_child_samples": self.min_child_samples,
            "subsample": self.subsample,
            "subsample_freq": self.subsample_freq,
            "colsample_bytree": self.colsample_bytree,
            "reg_alpha": self.reg_alpha,
            "reg_lambda": self.reg_lambda,
            "random_state": self.random_state,
            "n_jobs": self.n_jobs,
            "silent": self.silent,
            "importance_type": self.importance_type,
        }
        params.update(self._other_params)
        return params

    def set_params(self, **params):
        for key, value in params.items():
            setattr(self, key, value)
            if hasattr(self, f"_{key}"):
                setattr(self, f"_{key}", value)
            self._other_params[key] = value
        for key in list(self._other_params):
            if hasattr(type(self), key) or key in signature(
                    type(self).__init__).parameters:
                self._other_params.pop(key)
        return self

    # ------------------------------------------------------------------
    def _get_lgb_params(self):
        """The training params of the estimator's settings (the
        reference's names mapped to the core ones); sets ``_fobj`` from a
        callable objective."""
        params = self.get_params()
        params.pop("silent", None)
        params.pop("importance_type", None)
        params.pop("n_estimators", None)
        params.pop("class_weight", None)
        params["boosting"] = params.pop("boosting_type", "gbdt")
        params["bagging_fraction"] = params.pop("subsample", 1.0)
        params["bagging_freq"] = params.pop("subsample_freq", 0)
        params["feature_fraction"] = params.pop("colsample_bytree", 1.0)
        params["lambda_l1"] = params.pop("reg_alpha", 0.0)
        params["lambda_l2"] = params.pop("reg_lambda", 0.0)
        params["min_gain_to_split"] = params.pop("min_split_gain", 0.0)
        params["min_sum_hessian_in_leaf"] = params.pop("min_child_weight",
                                                       1e-3)
        params["min_data_in_leaf"] = params.pop("min_child_samples", 20)
        params["bin_construct_sample_cnt"] = params.pop("subsample_for_bin",
                                                        200000)
        rs = params.pop("random_state", None)
        if rs is not None:
            params["seed"] = (rs if isinstance(rs, int)
                              else rs.randint(2 ** 31 - 1))
        params.pop("n_jobs", None)
        if params.get("objective") is None:
            params["objective"] = self._default_objective()
        if callable(params.get("objective")):
            self._fobj = _objective_function_wrapper(params["objective"])
            params["objective"] = "none"
        else:
            self._fobj = None
        return {k: v for k, v in params.items() if v is not None}

    def _default_objective(self):
        return "regression"

    def fit(self, X, y, sample_weight=None, init_score=None, group=None,
            eval_set=None, eval_names=None, eval_sample_weight=None,
            eval_class_weight=None, eval_init_score=None, eval_group=None,
            eval_metric=None, early_stopping_rounds=None, verbose=True,
            feature_name="auto", categorical_feature="auto",
            callbacks=None):
        params = self._get_lgb_params()
        if self.class_weight is not None:
            sample_weight = _apply_class_weight(
                self.class_weight, np.asarray(y), sample_weight)
        if eval_metric is not None and not callable(eval_metric):
            params["metric"] = eval_metric
        feval = (_eval_function_wrapper(eval_metric)
                 if callable(eval_metric) else None)

        train_ds = Dataset(X, label=y, weight=sample_weight,
                           group=group, init_score=init_score,
                           params={}, feature_name=feature_name,
                           categorical_feature=categorical_feature,
                           free_raw_data=False)
        valid_sets = []
        valid_names = []
        if eval_set is not None:
            if isinstance(eval_set, tuple):
                eval_set = [eval_set]
            for i, (vx, vy) in enumerate(eval_set):
                if vx is X and vy is y:
                    valid_sets.append(train_ds)
                else:
                    w = (eval_sample_weight or {}).get(i) \
                        if isinstance(eval_sample_weight, dict) \
                        else (eval_sample_weight[i]
                              if eval_sample_weight else None)
                    g = eval_group[i] if eval_group else None
                    isc = eval_init_score[i] if eval_init_score else None
                    valid_sets.append(train_ds.create_valid(
                        vx, label=vy, weight=w, group=g, init_score=isc))
                valid_names.append((eval_names or {}).get(i)
                                   if isinstance(eval_names, dict)
                                   else (eval_names[i] if eval_names
                                         else f"valid_{i}"))
        evals_result = {}
        self._Booster = train(
            params, train_ds,
            num_boost_round=self.n_estimators,
            valid_sets=valid_sets or None,
            valid_names=valid_names or None,
            fobj=self._fobj, feval=feval,
            early_stopping_rounds=early_stopping_rounds,
            evals_result=evals_result, verbose_eval=verbose,
            callbacks=callbacks)
        self._evals_result = evals_result
        self._best_iteration = self._Booster.best_iteration
        self._best_score = self._Booster.best_score
        self._n_features = train_ds.num_feature()
        return self

    def predict(self, X, raw_score=False, num_iteration=-1, pred_leaf=False,
                pred_contrib=False, **kwargs):
        if self._Booster is None:
            raise LightGBMError("Estimator not fitted, call fit first")
        if num_iteration <= 0 and self._best_iteration is not None \
                and self._best_iteration > 0:
            num_iteration = self._best_iteration
        return self._Booster.predict(X, raw_score=raw_score,
                                     num_iteration=num_iteration,
                                     pred_leaf=pred_leaf,
                                     pred_contrib=pred_contrib)

    # -- attributes -----------------------------------------------------
    @property
    def booster_(self):
        if self._Booster is None:
            raise LightGBMError("No booster found, call fit first")
        return self._Booster

    @property
    def evals_result_(self):
        return self._evals_result

    @property
    def best_iteration_(self):
        return self._best_iteration

    @property
    def best_score_(self):
        return self._best_score

    @property
    def n_features_(self):
        return self._n_features

    @property
    def feature_importances_(self):
        if self._Booster is None:
            raise LightGBMError("No booster found, call fit first")
        return self._Booster.feature_importance(self.importance_type)

    @property
    def objective_(self):
        return self.objective or self._default_objective()


class LGBMRegressor(LGBMModel):
    """Regression (objective ``regression`` by default)."""

    def _default_objective(self):
        return "regression"

    def _more_tags(self):
        return {"estimator_type": "regressor"}


class LGBMClassifier(LGBMModel):
    """Classification: labels encoded to 0..n-1 (``classes_``), binary or
    multiclass by their count, ``predict_proba`` (N, n_classes)."""

    def _default_objective(self):
        return "binary" if (self._n_classes or 2) <= 2 else "multiclass"

    def fit(self, X, y, **kwargs):
        y = np.asarray(y)
        self._classes, y_enc = np.unique(y, return_inverse=True)
        self._n_classes = len(self._classes)
        if self._n_classes > 2:
            self._other_params["num_class"] = self._n_classes
            if self.objective is None:
                self.objective = "multiclass"
        # transform eval sets' labels too
        es = kwargs.get("eval_set")
        if es is not None:
            mapping = {c: i for i, c in enumerate(self._classes)}
            new_es = []
            for vx, vy in ([es] if isinstance(es, tuple) else es):
                new_es.append((vx, np.asarray(
                    [mapping[v] for v in np.asarray(vy)])))
            kwargs["eval_set"] = new_es
        return super().fit(X, y_enc, **kwargs)

    def predict(self, X, raw_score=False, num_iteration=-1, pred_leaf=False,
                pred_contrib=False, **kwargs):
        result = self.predict_proba(X, raw_score, num_iteration, pred_leaf,
                                    pred_contrib, **kwargs)
        if raw_score or pred_leaf or pred_contrib:
            return result
        return self._classes[np.argmax(result, axis=1)]

    def predict_proba(self, X, raw_score=False, num_iteration=-1,
                      pred_leaf=False, pred_contrib=False, **kwargs):
        res = super().predict(X, raw_score, num_iteration, pred_leaf,
                              pred_contrib, **kwargs)
        if raw_score or pred_leaf or pred_contrib:
            return res
        if res.ndim == 1:
            return np.column_stack([1.0 - res, res])
        return res

    @property
    def classes_(self):
        return self._classes

    @property
    def n_classes_(self):
        return self._n_classes

    def _more_tags(self):
        return {"estimator_type": "classifier"}


class LGBMRanker(LGBMModel):
    """Ranking (lambdarank); ``fit`` needs ``group`` (query sizes)."""

    def _default_objective(self):
        return "lambdarank"

    def fit(self, X, y, group=None, **kwargs):
        if group is None:
            raise ValueError("Should set group for ranking task")
        eval_set = kwargs.get("eval_set")
        if eval_set is not None and kwargs.get("eval_group") is None:
            raise ValueError("Eval_group cannot be None when eval_set "
                             "is not None")
        return super().fit(X, y, group=group, **kwargs)


def _apply_class_weight(class_weight, y, sample_weight):
    """Per-row weights of ``class_weight`` ("balanced" or a dict), times
    ``sample_weight``."""
    if class_weight == "balanced":
        classes, counts = np.unique(y, return_counts=True)
        weights = {c: len(y) / (len(classes) * cnt)
                   for c, cnt in zip(classes, counts)}
    else:
        weights = dict(class_weight)
    w = np.asarray([weights.get(v, 1.0) for v in y], np.float64)
    if sample_weight is not None:
        w = w * np.asarray(sample_weight, np.float64)
    return w
