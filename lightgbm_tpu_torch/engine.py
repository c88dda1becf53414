"""``train`` and ``cv``: the boosting entry points (counterpart of
``lightgbm_tpu/engine.py``) with validation sets, ``feval``, callbacks,
early stopping, learning-rate schedules and continued training from a
model (``init_model``), the fused driving of ``fused_chunk`` iterations a
dispatch between evaluation boundaries, and ``fobj`` on the host learner;
``cv``, k-fold cross validation over row subsets of one binned set."""

from __future__ import annotations

import collections
import os
from typing import List

import numpy as np

from . import callback as callback_mod
from . import obs
from .basic import PREDICT_CHUNK_ROWS, Booster, Dataset, _is_sparse, \
    _to_2d_float
from .config import normalize_params
from .utils.log import LightGBMError, log_warning


def steps_to_boundary(i: int, freq: int) -> int:
    """Iterations to run, starting at ``i``, to land on (and include) the
    next iteration j >= i with ``(j + 1) % freq == 0``: the chunk cap
    that keeps fused driving's evaluation cadence the per-iteration
    loop's (``lightgbm_tpu/engine.py:20``)."""
    return ((freq - ((i + 1) % freq)) % freq) + 1


def _dedupe_callbacks(callbacks) -> List:
    """The user's callbacks in their order, each once (first occurrence
    wins)."""
    out: List = []
    for cb in (callbacks or []):
        if cb not in out:
            out.append(cb)
    return out


def train(params, train_set: Dataset, num_boost_round: int = 100,
          valid_sets=None, valid_names=None, fobj=None, feval=None,
          init_model=None, feature_name="auto", categorical_feature="auto",
          early_stopping_rounds=None, evals_result=None,
          verbose_eval=True, learning_rates=None,
          keep_training_booster=False, callbacks=None) -> Booster:
    """Train a booster for ``num_boost_round`` iterations, until no leaf
    can be split, or until early stopping ends it.  Runs on
    ``params['device']`` (alias of ``device_type``, default ``cuda``;
    ``cpu`` takes the plain PyTorch path).

    ``valid_sets`` are evaluated every ``metric_freq`` iterations and on
    the last one (a set that is ``train_set`` is evaluated as the training
    set, under its valid name); ``feval(preds, dataset)`` adds
    ``(name, value, bigger_is_better)`` records; the results go to
    ``callbacks``, to ``evals_result`` and, with ``early_stopping_rounds``,
    to early stopping, which sets ``booster.best_iteration``.
    ``fobj(preds, train_set) -> (grad, hess)`` trains on custom gradients
    (objective ``none``), one iteration at a time.

    ``init_model`` (a model file or a ``Booster``) continues its model:
    its trees come first, its raw predictions of ``train_set``'s rows
    (kept with ``free_raw_data=False``) are the init score, and the
    callbacks see iterations from its count on.  ``learning_rates`` (a
    list, one rate an iteration, or a function of the iteration) resets
    the learning rate before each iteration; like any before-iteration
    callback it makes ``train`` drive one iteration at a time.
    ``feature_name`` / ``categorical_feature`` set the Dataset's before it
    is built.  Without ``keep_training_booster`` the booster lets go of
    ``train_set``."""
    params = normalize_params(params)
    if fobj is not None:
        # custom gradients: no objective, the host learner, no fusing
        # (lightgbm_tpu/engine.py:46-47, :134)
        params["objective"] = "none"
    num_boost_round = params.pop("num_iterations", num_boost_round)
    if num_boost_round <= 0:
        raise ValueError("num_boost_round should be greater than zero.")
    if not isinstance(train_set, Dataset):
        raise TypeError("Training only accepts Dataset object")
    if not (isinstance(feature_name, str) and feature_name == "auto"):
        train_set.set_feature_name(feature_name)
    if not (isinstance(categorical_feature, str)
            and categorical_feature == "auto"):
        train_set.set_categorical_feature(categorical_feature)
    init_iter = 0
    if init_model is not None:
        booster = _continue_from(init_model, params, train_set)
        init_iter = booster._gbdt.num_init_iteration
    else:
        booster = Booster(params=params, train_set=train_set)

    is_valid_contain_train = False
    train_data_name = "training"
    if valid_sets is not None:
        if isinstance(valid_sets, Dataset):
            valid_sets = [valid_sets]
        valid_names = valid_names or [f"valid_{i}"
                                      for i in range(len(valid_sets))]
        for i, vs in enumerate(valid_sets):
            if vs is train_set:
                is_valid_contain_train = True
                train_data_name = valid_names[i]
                continue
            if vs.reference is None:
                vs.reference = train_set
            booster.add_valid(vs, valid_names[i])

    cbs = _dedupe_callbacks(callbacks)
    if early_stopping_rounds is not None and early_stopping_rounds > 0:
        cbs.append(callback_mod.early_stopping(
            early_stopping_rounds, verbose=bool(verbose_eval)))
    if verbose_eval is True:
        cbs.append(callback_mod.print_evaluation())
    elif isinstance(verbose_eval, int) and verbose_eval is not False:
        cbs.append(callback_mod.print_evaluation(verbose_eval))
    if evals_result is not None:
        cbs.append(callback_mod.record_evaluation(evals_result))
    if learning_rates is not None:
        cbs.append(callback_mod.reset_parameter(learning_rate=learning_rates))
    if obs.enabled():
        # telemetry hooks: a CallbackEnv-compatible pair timing each
        # iteration and sampling device memory (fused driving keeps them)
        cbs.extend(obs.iteration_hooks())
    cbs_before = [cb for cb in cbs
                  if getattr(cb, "before_iteration", False)]
    cbs_after = [cb for cb in cbs
                 if not getattr(cb, "before_iteration", False)]
    # stable sorts: callbacks of equal order keep their insertion order
    cbs_before.sort(key=lambda cb: getattr(cb, "order", 0))
    cbs_after.sort(key=lambda cb: getattr(cb, "order", 0))

    metric_freq = int(params.get("metric_freq", 1) or 1)
    end_iter = init_iter + num_boost_round
    # fused driving (lightgbm_tpu/engine.py:113-185): when every callback
    # acts only on evaluation-carrying iterations, each stretch between
    # evaluation boundaries runs as chunks of fused_chunk trees
    # (GBDT.train_chunked).  A callback without that mark (a
    # before-iteration one such as reset_parameter among them) forces the
    # per-iteration loop: its CallbackEnv cadence is the contract.
    gbdt = booster._gbdt
    fused_cap = max(int(getattr(gbdt.config, "fused_chunk", 20)), 0)
    cbs_opaque = any(not (getattr(cb, "eval_cadence_only", False)
                          or getattr(cb, "obs_hook", False))
                     for cb in cbs_before + cbs_after)
    has_eval = (bool(gbdt.valid_sets) or is_valid_contain_train
                or feval is not None)
    # early stopping without evaluation data is a misconfiguration: stay
    # per-iteration so its error comes at the first iteration
    needs_eval_cb = any(getattr(cb, "requires_eval", False)
                        for cb in cbs_before + cbs_after)
    can_fuse = (fobj is None and fused_cap > 1 and not cbs_opaque
                and not (needs_eval_cb and not has_eval)
                and gbdt.fused_eligible())

    evaluation_result_list = []
    i = init_iter
    while i < end_iter:
        for cb in cbs_before:
            cb(callback_mod.CallbackEnv(
                model=booster, params=params, iteration=i,
                begin_iteration=init_iter, end_iteration=end_iter,
                evaluation_result_list=None))
        step = 1
        if can_fuse:
            step = end_iter - i
            if has_eval:
                # up to and including the next iteration whose results
                # feed the callbacks
                step = min(step, steps_to_boundary(i, metric_freq))
        if step > 1:
            before = gbdt.iter
            finished = gbdt.train_chunked(step, chunk=min(step, fused_cap))
            advanced = max(gbdt.iter - before, 1)
        else:
            finished = booster.update(fobj=fobj)
            advanced = 1
        i_done = i + advanced - 1
        evaluation_result_list = []
        if (i_done + 1) % metric_freq == 0 or i_done == end_iter - 1:
            if is_valid_contain_train:
                evaluation_result_list.extend(
                    (train_data_name, n, v, b)
                    for _, n, v, b in booster.eval_train(feval))
            evaluation_result_list.extend(booster.eval_valid(feval))
        try:
            for cb in cbs_after:
                cb(callback_mod.CallbackEnv(
                    model=booster, params=params, iteration=i_done,
                    begin_iteration=init_iter, end_iteration=end_iter,
                    evaluation_result_list=evaluation_result_list))
        except callback_mod.EarlyStopException as es:
            booster.best_iteration = es.best_iteration + 1
            evaluation_result_list = es.best_score
            break
        i += advanced
        if finished:
            break

    booster.best_score = collections.defaultdict(collections.OrderedDict)
    for rec in (evaluation_result_list or []):
        booster.best_score[rec[0]][rec[1]] = rec[2]
    if not keep_training_booster:
        booster._train_set = None
    try:
        obs.flush()   # write metrics/trace files when paths are configured
    except OSError as e:
        # telemetry is best-effort: a bad path must not lose the booster
        log_warning(f"failed to write telemetry output: {e}")
    return booster


def _continue_from(init_model, params, train_set: Dataset) -> Booster:
    """A booster that continues ``init_model`` on ``train_set``
    (``lightgbm_tpu/engine.py:200-229``; reference boosting.cpp:15-28):
    the loaded model's raw predictions of the training rows (through the
    forest kernel on the card from ``device_predict_min_rows`` rows) are
    the init score, stored class-major; its trees come first; ``iter``
    restarts at 0, as in the JAX package, so the bagging and
    feature_fraction draws follow its seeds."""
    if isinstance(init_model, (str, os.PathLike)):
        prev = Booster(model_file=str(init_model), params=params)
    elif isinstance(init_model, Booster):
        prev = Booster(model_str=init_model.model_to_string(), params=params)
    else:
        raise TypeError("init_model should be a Booster or a model file path")
    train_set.params = {**params, **train_set.params}
    train_set.construct()
    raw = train_set.raw
    if raw is None:
        raise LightGBMError(
            "continued training needs raw data: construct the Dataset with "
            "free_raw_data=False")
    g = prev._gbdt
    if _is_sparse(raw):
        n, step = raw.shape[0], PREDICT_CHUNK_ROWS
        init_score = np.concatenate(
            [g.predict_raw(_to_2d_float(raw[i:i + step], True),
                           batch_rows=n)
             for i in range(0, max(n, 1), step)], axis=1)
    else:
        init_score = g.predict_raw(raw)
    # (num_model, N) predictions; the metadata holds them class-major
    train_set._handle.metadata.set_init_score(init_score.reshape(-1))
    booster = Booster(params=params, train_set=train_set)
    booster._gbdt.models = list(g.models)
    booster._gbdt.num_init_iteration = g.num_iterations()
    booster._gbdt.iter = 0
    return booster


# ---------------------------------------------------------------------------
# cross validation (lightgbm_tpu/engine.py:232-372; reference
# engine.py:262-501)
# ---------------------------------------------------------------------------

def _make_n_folds(full_data: Dataset, folds, nfold, params, seed,
                  stratified, shuffle):
    """(train subset, test subset) pairs, as the JAX package makes them:
    the user's ``folds`` (an iterable of index pairs or a splitter with
    ``split``, given query ids for a ranking set), whole queries a fold
    for a ranking set, scikit-learn's ``StratifiedKFold``, or a seeded
    permutation cut into ``nfold`` chunks."""
    full_data.construct()
    num_data = full_data.num_data()
    if folds is not None:
        if not hasattr(folds, "__iter__") and not hasattr(folds, "split"):
            raise AttributeError(
                "folds should be a generator or iterator of (train_idx, "
                "test_idx) tuples or scikit-learn splitter object")
        if hasattr(folds, "split"):
            group = full_data.get_group()
            group_info = (np.repeat(np.arange(len(group)), group)
                          if group is not None else None)
            folds = folds.split(X=np.zeros(num_data),
                                y=full_data.get_label(), groups=group_info)
    else:
        group = full_data.get_group()
        if group is not None:
            # group-aware folds: whole queries
            ng = len(group)
            rng = np.random.RandomState(seed)
            order = rng.permutation(ng) if shuffle else np.arange(ng)
            boundaries = np.concatenate([[0], np.cumsum(group)])
            folds = []
            for f in np.array_split(order, nfold):
                test_idx = np.concatenate(
                    [np.arange(boundaries[q], boundaries[q + 1])
                     for q in f]) if len(f) else np.empty(0, np.int64)
                mask = np.ones(num_data, bool)
                mask[test_idx.astype(np.int64)] = False
                folds.append((np.nonzero(mask)[0], test_idx.astype(np.int64)))
        elif stratified:
            from sklearn.model_selection import StratifiedKFold
            skf = StratifiedKFold(n_splits=nfold, shuffle=shuffle,
                                  random_state=seed if shuffle else None)
            folds = list(skf.split(np.zeros(num_data),
                                   full_data.get_label()))
        else:
            rng = np.random.RandomState(seed)
            order = rng.permutation(num_data) if shuffle \
                else np.arange(num_data)
            folds = [(np.setdiff1d(order, chunk, assume_unique=False), chunk)
                     for chunk in np.array_split(order, nfold)]
    return [(full_data.subset(np.sort(train_idx)),
             full_data.subset(np.sort(test_idx)))
            for train_idx, test_idx in folds]


class _CVBooster:
    """The fold boosters, as a callback's ``env.model``."""

    def __init__(self, boosters):
        self.boosters = boosters

    def reset_parameter(self, new_params):
        for b in self.boosters:
            b.reset_parameter(new_params)


def cv(params, train_set: Dataset, num_boost_round=100, folds=None,
       nfold=5, stratified=True, shuffle=True, metrics=None, fobj=None,
       feval=None, init_model=None, feature_name="auto",
       categorical_feature="auto", early_stopping_rounds=None, fpreproc=None,
       verbose_eval=None, show_stdv=True, seed=0, callbacks=None) -> dict:
    """K-fold cross validation (``lightgbm_tpu/engine.py::cv``): a booster
    a fold over row subsets of ``train_set``'s codes (never re-binned),
    each fold's held-out rows its validation set, every booster updated
    once an iteration.  Returns ``{"<metric>-mean": [...], "<metric>-stdv":
    [...]}``, cut at the best iteration by early stopping on the means.
    ``stratified`` folds need scikit-learn (imported only then);
    ``fpreproc(train, test, params)`` may rewrite each fold.  ``init_model``,
    ``feature_name`` and ``categorical_feature`` are accepted and unused,
    as in the JAX package."""
    params = normalize_params(params)
    if fobj is not None:
        params["objective"] = "none"
    if metrics is not None:
        params["metric"] = metrics
    if train_set.get_label() is None and train_set.label is None:
        raise LightGBMError("labels should not be None in cv")
    if stratified and train_set.get_group() is not None:
        stratified = False
    if stratified:
        label = train_set.construct().get_label()
        # stratification needs classification-style labels
        if len(np.unique(label)) > max(2, int(params.get("num_class", 1))) \
                and params.get("objective", "regression").startswith(
                    ("regression", "huber", "fair", "poisson", "quantile",
                     "mape", "gamma", "tweedie")):
            stratified = False

    folds_data = _make_n_folds(train_set, folds, nfold, params, seed,
                               stratified, shuffle)
    boosters = []
    for train_sub, test_sub in folds_data:
        if fpreproc is not None:
            train_sub, test_sub, tparams = fpreproc(train_sub, test_sub,
                                                    params.copy())
        else:
            tparams = params
        bst = Booster(params=tparams, train_set=train_sub)
        bst.add_valid(test_sub, "valid")
        boosters.append(bst)

    results = collections.defaultdict(list)
    cbs = _dedupe_callbacks(callbacks)
    if early_stopping_rounds is not None and early_stopping_rounds > 0:
        cbs.append(callback_mod.early_stopping(early_stopping_rounds,
                                               verbose=False))
    if verbose_eval is True:
        cbs.append(callback_mod.print_evaluation(show_stdv=show_stdv))
    elif isinstance(verbose_eval, int) and verbose_eval not in (False, None):
        cbs.append(callback_mod.print_evaluation(verbose_eval, show_stdv))
    # stable sort: equal orders keep their insertion order
    cbs = sorted(cbs, key=lambda cb: getattr(cb, "order", 0))

    cvbooster = _CVBooster(boosters)
    for i in range(num_boost_round):
        for bst in boosters:
            bst.update(fobj=fobj)
        merged = collections.defaultdict(list)
        order = []
        bigger = {}
        for bst in boosters:
            for dname, mname, val, b in bst.eval_valid(feval):
                key = f"{dname} {mname}"
                if key not in merged:
                    order.append(key)
                merged[key].append(val)
                bigger[key] = b
        agg = [(k.split(" ", 1)[0], k.split(" ", 1)[1],
                float(np.mean(merged[k])), bigger[k],
                float(np.std(merged[k]))) for k in order]
        for _, name, mean, _, std in agg:
            results[f"{name}-mean"].append(mean)
            results[f"{name}-stdv"].append(std)
        try:
            for cb in cbs:
                cb(callback_mod.CallbackEnv(
                    model=cvbooster, params=params, iteration=i,
                    begin_iteration=0, end_iteration=num_boost_round,
                    evaluation_result_list=agg))
        except callback_mod.EarlyStopException as es:
            for k in results:
                results[k] = results[k][:es.best_iteration + 1]
            break
    return dict(results)
