"""``train``: the boosting driver (counterpart of ``lightgbm_tpu/engine.py``
with validation sets, ``feval``, callbacks and early stopping, and the
fused driving of ``fused_chunk`` iterations a dispatch between evaluation
boundaries; ``fobj``, ``init_model``, ``learning_rates`` and ``cv`` are not
ported yet and are refused by name)."""

from __future__ import annotations

import collections
from typing import List

from . import callback as callback_mod
from .basic import Booster, Dataset
from .config import normalize_params
from .utils.log import LightGBMError


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
          init_model=None, early_stopping_rounds=None, evals_result=None,
          verbose_eval=True, learning_rates=None, callbacks=None) -> Booster:
    """Train a booster for ``num_boost_round`` iterations, until no leaf
    can be split, or until early stopping ends it.  Runs on
    ``params['device']`` (alias of ``device_type``, default ``cuda``;
    ``cpu`` takes the plain PyTorch path).

    ``valid_sets`` are evaluated every ``metric_freq`` iterations and on
    the last one (a set that is ``train_set`` is evaluated as the training
    set, under its valid name); ``feval(preds, dataset)`` adds
    ``(name, value, bigger_is_better)`` records; the results go to
    ``callbacks``, to ``evals_result`` and, with ``early_stopping_rounds``,
    to early stopping, which sets ``booster.best_iteration``."""
    for name, value in (("fobj", fobj), ("init_model", init_model),
                        ("learning_rates", learning_rates)):
        if value is not None:
            raise LightGBMError(f"train({name}=...) is not ported to "
                                f"lightgbm_tpu_torch yet")
    params = normalize_params(params)
    num_boost_round = params.pop("num_iterations", num_boost_round)
    if num_boost_round <= 0:
        raise ValueError("num_boost_round should be greater than zero.")
    if not isinstance(train_set, Dataset):
        raise TypeError("Training only accepts Dataset object")
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
    cbs_before = [cb for cb in cbs
                  if getattr(cb, "before_iteration", False)]
    cbs_after = [cb for cb in cbs
                 if not getattr(cb, "before_iteration", False)]
    # stable sorts: callbacks of equal order keep their insertion order
    cbs_before.sort(key=lambda cb: getattr(cb, "order", 0))
    cbs_after.sort(key=lambda cb: getattr(cb, "order", 0))

    metric_freq = int(params.get("metric_freq", 1) or 1)
    # fused driving (lightgbm_tpu/engine.py:113-185): when every callback
    # acts only on evaluation-carrying iterations, each stretch between
    # evaluation boundaries runs as chunks of fused_chunk trees
    # (GBDT.train_chunked).  A callback without that mark forces the
    # per-iteration loop: its CallbackEnv cadence is the contract.
    gbdt = booster._gbdt
    fused_cap = max(int(getattr(gbdt.config, "fused_chunk", 20)), 0)
    cbs_opaque = any(not getattr(cb, "eval_cadence_only", False)
                     for cb in cbs_before + cbs_after)
    has_eval = (bool(gbdt.valid_sets) or is_valid_contain_train
                or feval is not None)
    # early stopping without evaluation data is a misconfiguration: stay
    # per-iteration so its error comes at the first iteration
    needs_eval_cb = any(getattr(cb, "requires_eval", False)
                        for cb in cbs_before + cbs_after)
    can_fuse = (fused_cap > 1 and not cbs_opaque
                and not (needs_eval_cb and not has_eval)
                and gbdt.fused_eligible())

    evaluation_result_list = []
    i = 0
    while i < num_boost_round:
        for cb in cbs_before:
            cb(callback_mod.CallbackEnv(
                model=booster, params=params, iteration=i,
                begin_iteration=0, end_iteration=num_boost_round,
                evaluation_result_list=None))
        step = 1
        if can_fuse:
            step = num_boost_round - i
            if has_eval:
                # up to and including the next iteration whose results
                # feed the callbacks
                step = min(step, steps_to_boundary(i, metric_freq))
        if step > 1:
            before = gbdt.iter
            finished = gbdt.train_chunked(step, chunk=min(step, fused_cap))
            advanced = max(gbdt.iter - before, 1)
        else:
            finished = booster.update()
            advanced = 1
        i_done = i + advanced - 1
        evaluation_result_list = []
        if (i_done + 1) % metric_freq == 0 or i_done == num_boost_round - 1:
            if is_valid_contain_train:
                evaluation_result_list.extend(
                    (train_data_name, n, v, b)
                    for _, n, v, b in booster.eval_train(feval))
            evaluation_result_list.extend(booster.eval_valid(feval))
        try:
            for cb in cbs_after:
                cb(callback_mod.CallbackEnv(
                    model=booster, params=params, iteration=i_done,
                    begin_iteration=0, end_iteration=num_boost_round,
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
    return booster


def cv(*args, **kwargs):
    raise LightGBMError("cv is not ported to lightgbm_tpu_torch yet")
