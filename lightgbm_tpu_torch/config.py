"""Config: alias resolution, coercion, conflict checking.

Mirrors the behaviour of the reference's ``Config::Set`` pipeline
(``src/io/config.cpp:1-280``): resolve aliases via the generated table, coerce
types, resolve objective/boosting/tree-learner/metric enum aliases, then run
``check_param_conflict``-style fixups (e.g. force parallelism flags, default
metric from objective).  The schema lives in :mod:`lightgbm_tpu_torch.params`.
A copy of ``lightgbm_tpu/config.py`` except for the device names (``cuda``
and ``cpu``) and the warning for TPU-only knobs.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import torch

from .params import (
    BOOSTING_ALIASES,
    IGNORED_PARAMS,
    METRIC_ALIASES,
    OBJECTIVE_ALIASES,
    PARAM_ALIASES,
    PARAM_BY_NAME,
    TREE_LEARNER_ALIASES,
)
from .utils.log import LightGBMError, log_warning


def resolve_device(name: str) -> torch.device:
    """The device of ``name``.  ``cuda`` without a card raises: the port never
    carries on on the CPU unless the caller asks for ``cpu``."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise LightGBMError(
            "device_type=cuda but torch.cuda.is_available() is False; pass "
            "device='cpu' to run the plain PyTorch ops on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise LightGBMError(f"unsupported device {name!r}")
    return dev


_RANKING_OBJECTIVES = ("lambdarank",)
_MULTICLASS_OBJECTIVES = ("multiclass", "multiclassova")

# default metric per resolved objective (reference: objective name doubles as
# the default metric string; see config.cpp metric defaulting)
_DEFAULT_METRIC = {
    "regression": "l2",
    "regression_l1": "l1",
    "huber": "huber",
    "fair": "fair",
    "poisson": "poisson",
    "quantile": "quantile",
    "mape": "mape",
    "gamma": "gamma",
    "tweedie": "tweedie",
    "binary": "binary_logloss",
    "multiclass": "multi_logloss",
    "multiclassova": "multi_logloss",
    "cross_entropy": "cross_entropy",
    "cross_entropy_lambda": "cross_entropy_lambda",
    "lambdarank": "ndcg",
}


def _check_range(param, value):
    """Enforce the schema's declared constraint (reference CHECK failures).

    Constraint strings use a small grammar: "> 0", ">= 0.0",
    "0.0 < x <= 1.0", "0.0 <= x < 1.0".
    """
    spec = param.check
    if not spec or not isinstance(value, (int, float)) or isinstance(value, bool):
        return
    ops = {"<": float.__lt__, "<=": float.__le__,
           ">": float.__gt__, ">=": float.__ge__}
    v = float(value)
    parts = spec.split()
    ok = True
    if "x" in parts:
        # "LO <op> x <op> HI"
        lo, op1, _, op2, hi = parts
        ok = ops[op1](float(lo), v) and ops[op2](v, float(hi))
    else:
        op, bound = parts
        ok = ops[op](v, float(bound))
    if not ok:
        raise ValueError(
            f"parameter {param.name}={value} violates constraint {spec}")


def parse_config_str(content: str) -> Dict[str, str]:
    """``key=value`` lines of a CLI config file ('#' comments)."""
    out: Dict[str, str] = {}
    for line in content.splitlines():
        line = line.split("#", 1)[0].strip()
        if not line or "=" not in line:
            continue
        k, v = line.split("=", 1)
        out[k.strip()] = v.strip()
    return out


def resolve_alias(key: str) -> str:
    """Map a parameter alias to its canonical name (unknown keys pass through)."""
    k = key.strip().lower()
    return PARAM_ALIASES.get(k, k)


def normalize_params(params: Optional[Mapping[str, Any]]) -> Dict[str, Any]:
    """Alias-resolve + type-coerce a raw param mapping.

    Later duplicate aliases of the same canonical key warn and are ignored,
    matching the reference's first-alias-wins ``KV2Map`` behaviour.
    """
    out: Dict[str, Any] = {}
    if not params:
        return out
    for key, value in params.items():
        canon = resolve_alias(key)
        if canon in out and out[canon] != value:
            log_warning(f"{key} is set with {value}, will be ignored. "
                        f"Current value: {canon}={out[canon]}")
            continue
        param = PARAM_BY_NAME.get(canon)
        if param is not None and value is not None:
            try:
                value = param.coerce(value)
            except (TypeError, ValueError) as e:
                raise ValueError(f"bad value for parameter {canon}: {e}") from e
        out[canon] = value
    return out


class Config:
    """Flat config object with one attribute per schema parameter."""

    def __init__(self, params: Optional[Mapping[str, Any]] = None, **kwargs):
        for p in PARAM_BY_NAME.values():
            default = list(p.default) if isinstance(p.default, list) else p.default
            setattr(self, p.name, default)
        self.extra: Dict[str, Any] = {}   # unknown (pass-through) params
        merged = dict(params or {})
        merged.update(kwargs)
        self.raw_params = dict(merged)    # as passed, pre-normalization
        self.set(merged)

    # -- main entry -------------------------------------------------------
    def set(self, params: Mapping[str, Any]) -> "Config":
        norm = normalize_params(params)
        for key, value in norm.items():
            if key in PARAM_BY_NAME:
                _check_range(PARAM_BY_NAME[key], value)
                setattr(self, key, value)
                if key in IGNORED_PARAMS \
                        and value != PARAM_BY_NAME[key].default:
                    log_warning(f"{key} is a TPU-only knob of lightgbm_tpu; "
                                f"lightgbm_tpu_torch ignores it")
            else:
                self.extra[key] = value
        if "seed" in norm and norm["seed"]:
            # master seed deterministically derives the sub-seeds that were
            # not set explicitly (reference Config behaviour for `seed`)
            from .utils.random import derive_seeds
            derived = derive_seeds(int(norm["seed"]))
            for key, sub in (("data_random_seed", "data"),
                             ("feature_fraction_seed", "feature_fraction"),
                             ("bagging_seed", "bagging"),
                             ("drop_seed", "drop")):
                if key not in norm:
                    setattr(self, key, derived[sub] & 0x7FFFFFFF)
        self._resolve_enums()
        self._check_conflicts()
        return self

    # -- enum-style value aliases ----------------------------------------
    def _resolve_enums(self):
        obj = str(self.objective).strip().lower()
        if obj in OBJECTIVE_ALIASES:
            self.objective = OBJECTIVE_ALIASES[obj]
        else:
            raise ValueError(f"unknown objective: {self.objective}")

        boost = str(self.boosting).strip().lower()
        if boost in BOOSTING_ALIASES:
            self.boosting = BOOSTING_ALIASES[boost]
        else:
            raise ValueError(f"unknown boosting type: {self.boosting}")

        tl = str(self.tree_learner).strip().lower()
        if tl in TREE_LEARNER_ALIASES:
            self.tree_learner = TREE_LEARNER_ALIASES[tl]
        else:
            raise ValueError(f"unknown tree learner: {self.tree_learner}")

        metrics = []
        raw_metric = self.metric if isinstance(self.metric, list) else [self.metric]
        for m in raw_metric:
            m = str(m).strip().lower()
            if m not in METRIC_ALIASES:
                raise ValueError(f"unknown metric: {m}")
            m = METRIC_ALIASES[m]
            if m and m not in metrics:
                metrics.append(m)
        self.metric = metrics

        self.device_type = str(self.device_type).strip().lower()
        if self.device_type == "gpu":
            self.device_type = "cuda"
        if self.device_type not in ("cpu", "cuda"):
            raise ValueError(f"unknown device_type: {self.device_type} "
                             f"(lightgbm_tpu_torch runs on cuda or cpu)")

    # -- conflict fixups (reference: Config::CheckParamConflict) ----------
    def _check_conflicts(self):
        if not self.metric and self.objective != "none":
            default = _DEFAULT_METRIC.get(self.objective)
            if default:
                self.metric = [default]
        if "none" in self.metric:
            self.metric = []

        is_parallel = self.tree_learner != "serial"
        if is_parallel and self.num_machines <= 1:
            # single worker: parallel learners degrade to serial, like the
            # reference does when num_machines == 1
            pass
        if self.num_machines > 1:
            self.is_parallel = True
        else:
            self.is_parallel = is_parallel

        if self.objective in _MULTICLASS_OBJECTIVES:
            if self.num_class <= 1:
                raise ValueError("num_class must be > 1 for multiclass objectives")
        elif self.objective not in ("none",):
            if self.num_class != 1:
                raise ValueError(f"num_class must be 1 for objective {self.objective}")

        if self.objective in _RANKING_OBJECTIVES:
            if isinstance(self.eval_at, list):
                self.eval_at = sorted(int(v) for v in self.eval_at)

        # feature_fraction with feature-parallel: reference disables sampling
        if self.tree_learner == "feature" and self.feature_fraction < 1.0:
            log_warning("feature_fraction is ignored with feature-parallel "
                        "tree learner; setting to 1.0")
            self.feature_fraction = 1.0

        if self.boosting == "rf":
            if not (self.bagging_freq > 0 and self.bagging_fraction < 1.0
                    and self.bagging_fraction > 0.0):
                raise ValueError("random forest needs bagging "
                                 "(bagging_freq > 0, 0 < bagging_fraction < 1)")
        if self.boosting == "goss":
            if self.bagging_freq > 0 and self.bagging_fraction != 1.0:
                log_warning("goss ignores bagging_fraction/bagging_freq")
            self.bagging_freq = 0
            self.bagging_fraction = 1.0

        if self.max_depth > 0:
            # like the reference, cap num_leaves implied by depth
            self.num_leaves = min(self.num_leaves, 1 << self.max_depth)

        if self.is_unbalance and self.scale_pos_weight != 1.0:
            raise ValueError("cannot set both is_unbalance and scale_pos_weight")

        if self.tpu_double_precision:
            self.gpu_use_dp = True

        if self.grad_quant_bits not in (0, 8):
            raise ValueError(
                f"grad_quant_bits={self.grad_quant_bits} is not supported:"
                f" use 0 (off) or 8 (int8 quantized histograms)")
        if self.grad_quant_bits and self.gpu_use_dp:
            # dp asks for extra-precision accumulation; quantization asks
            # for less — precision wins, like the reference's gpu_use_dp
            # overriding its single-precision histogram default
            log_warning("grad_quant_bits is ignored with gpu_use_dp "
                        "(double-precision accumulation requested); "
                        "disabling quantized histograms")
            self.grad_quant_bits = 0

        wp = str(self.wave_plan).strip().lower()
        if wp not in ("auto", "fixed", "profiled"):
            raise ValueError(f"unknown wave_plan: {self.wave_plan}")
        self.wave_plan = wp

        fbf = str(self.find_best_fusion).strip().lower()
        if fbf not in ("auto", "fused", "two_pass"):
            raise ValueError(
                f"unknown find_best_fusion: {self.find_best_fusion}")
        self.find_best_fusion = fbf

        dp = str(self.device_predict).strip().lower()
        if dp not in ("auto", "force", "off"):
            raise ValueError(f"unknown device_predict: "
                             f"{self.device_predict}")
        self.device_predict = dp

    # -- misc -------------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        d = {p: getattr(self, p) for p in PARAM_BY_NAME}
        d.update(self.extra)
        return d

    def clone(self) -> "Config":
        c = Config.__new__(Config)
        for p in PARAM_BY_NAME.values():
            v = getattr(self, p.name)
            setattr(c, p.name, list(v) if isinstance(v, list) else v)
        c.extra = dict(self.extra)
        c.is_parallel = self.is_parallel
        return c

    def __repr__(self):
        changed = {}
        for p in PARAM_BY_NAME.values():
            v = getattr(self, p.name)
            if v != p.default and not (isinstance(p.default, list)
                                       and list(v) == list(p.default)):
                changed[p.name] = v
        return f"Config({changed})"

