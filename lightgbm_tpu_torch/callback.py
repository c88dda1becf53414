"""Training callbacks (counterpart of ``lightgbm_tpu/callback.py``, after
the reference's ``python-package/lightgbm/callback.py``): evaluation
printing and recording, parameter schedules (``reset_parameter``) and
early stopping."""

from __future__ import annotations

import collections

from .utils.log import log_info, log_warning


class EarlyStopException(Exception):
    def __init__(self, best_iteration, best_score):
        super().__init__()
        self.best_iteration = best_iteration
        self.best_score = best_score


CallbackEnv = collections.namedtuple(
    "LightGBMCallbackEnv",
    ["model", "params", "iteration", "begin_iteration", "end_iteration",
     "evaluation_result_list"])


def _format_eval_result(value, show_stdv=True):
    if len(value) == 4:
        return f"{value[0]}'s {value[1]}: {value[2]:g}"
    if len(value) == 5:
        if show_stdv:
            return f"{value[0]}'s {value[1]}: {value[2]:g} + {value[4]:g}"
        return f"{value[0]}'s {value[1]}: {value[2]:g}"
    raise ValueError("Wrong metric value")


def print_evaluation(period=1, show_stdv=True):
    """Log the evaluation results every ``period`` iterations."""
    def _callback(env):
        if (period > 0 and env.evaluation_result_list
                and (env.iteration + 1) % period == 0):
            result = "\t".join(_format_eval_result(x, show_stdv)
                               for x in env.evaluation_result_list)
            log_info(f"[{env.iteration + 1}]\t{result}")
    _callback.order = 10
    # acts only on iterations that carry evaluation results, so the fused
    # driver may skip its empty-list invocations (engine.train)
    _callback.eval_cadence_only = True
    return _callback


def record_evaluation(eval_result):
    """Append every result to ``eval_result[data_name][metric_name]``."""
    if not isinstance(eval_result, dict):
        raise TypeError("eval_result should be a dictionary")
    eval_result.clear()

    def _callback(env):
        for data_name, eval_name, result, _ in env.evaluation_result_list:
            eval_result.setdefault(data_name, collections.OrderedDict())
            eval_result[data_name].setdefault(eval_name, []).append(result)
    _callback.order = 20
    _callback.eval_cadence_only = True
    return _callback


def reset_parameter(**kwargs):
    """Before each iteration, set every parameter of ``kwargs`` to its
    value for the iteration: a list holds one value an iteration
    (``num_boost_round`` of them), a function maps the iteration (from
    0 at the first of this ``train`` call) to the value
    (``Booster.reset_parameter``, which refuses on the device grower what
    its captured tree holds).  A before-iteration callback: ``train``
    drives iteration by iteration while it is present."""
    def _callback(env):
        new_parameters = {}
        for key, value in kwargs.items():
            if isinstance(value, list):
                if len(value) != env.end_iteration - env.begin_iteration:
                    raise ValueError(
                        f"Length of list {key!r} has to equal to "
                        f"'num_boost_round'.")
                new_param = value[env.iteration - env.begin_iteration]
            else:
                new_param = value(env.iteration - env.begin_iteration)
            new_parameters[key] = new_param
        if new_parameters:
            env.model.reset_parameter(new_parameters)
            env.params.update(new_parameters)
    _callback.before_iteration = True
    _callback.order = 10
    return _callback


def early_stopping(stopping_rounds, first_metric_only=False, verbose=True):
    """Stop when no validation metric improved for ``stopping_rounds``
    iterations (only the first metric with ``first_metric_only``); raises
    :class:`EarlyStopException` with the best iteration and its results,
    also at the last iteration."""
    best_score = []
    best_iter = []
    best_score_list = []
    cmp_op = []
    enabled = [True]

    def _init(env):
        enabled[0] = not any(
            env.params.get(alias, "") == "dart"
            for alias in ("boosting", "boosting_type", "boost"))
        if not enabled[0]:
            log_warning("Early stopping is not available in dart mode")
            return
        if not env.evaluation_result_list:
            raise ValueError(
                "For early stopping, at least one dataset and eval metric "
                "is required for evaluation")
        if verbose:
            log_info(f"Training until validation scores don't improve for "
                     f"{stopping_rounds} rounds.")
        for eval_ret in env.evaluation_result_list:
            best_iter.append(0)
            best_score_list.append(None)
            if eval_ret[3]:
                best_score.append(float("-inf"))
                cmp_op.append(lambda x, y: x > y)
            else:
                best_score.append(float("inf"))
                cmp_op.append(lambda x, y: x < y)

    def _callback(env):
        if not best_score:
            mf = max(int(env.params.get("metric_freq", 1) or 1), 1)
            if (not env.evaluation_result_list
                    and (env.iteration + 1) % mf != 0
                    and env.iteration != env.end_iteration - 1):
                # no evaluation on this iteration (off the metric_freq
                # cadence): initialize on the first one that has results.
                # An empty list on the cadence means no evaluation data at
                # all, and _init raises at once
                return
            _init(env)
        if not enabled[0]:
            return
        for i in range(len(env.evaluation_result_list)):
            score = env.evaluation_result_list[i][2]
            if best_score_list[i] is None or cmp_op[i](score, best_score[i]):
                best_score[i] = score
                best_iter[i] = env.iteration
                best_score_list[i] = env.evaluation_result_list
            elif env.iteration - best_iter[i] >= stopping_rounds:
                if verbose:
                    log_info("Early stopping, best iteration is:\n"
                             f"[{best_iter[i] + 1}]\t"
                             + "\t".join(_format_eval_result(x)
                                         for x in best_score_list[i]))
                raise EarlyStopException(best_iter[i], best_score_list[i])
            if env.iteration == env.end_iteration - 1:
                if verbose:
                    log_info("Did not meet early stopping. Best iteration "
                             "is:\n"
                             f"[{best_iter[i] + 1}]\t"
                             + "\t".join(_format_eval_result(x)
                                         for x in best_score_list[i]))
                raise EarlyStopException(best_iter[i], best_score_list[i])
            if first_metric_only:
                break
    _callback.order = 30
    _callback.eval_cadence_only = True
    # engine.train does not fuse when this callback has no evaluation data,
    # so _init's error still comes at the first iteration
    _callback.requires_eval = True
    return _callback
