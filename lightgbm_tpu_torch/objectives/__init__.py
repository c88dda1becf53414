"""Objective factory (``lightgbm_tpu/objectives/__init__.py``): every
single-model objective of the JAX package.  ``multiclass`` and
``multiclassova`` (K trees an iteration) are not ported yet and are refused
by name; ``regression_l1``, ``quantile`` and ``mape`` are ported, and
``GBDT.init_train`` refuses to train them (``is_renew_tree_output``)."""

from ..utils.log import LightGBMError
from .base import ObjectiveFunction
from .binary import BinaryLogloss
from .rank import LambdarankNDCG
from .regression import (Fair, Gamma, Huber, Mape, Poisson, Quantile,
                         RegressionL1, RegressionL2, Tweedie)
from .xentropy import CrossEntropy, CrossEntropyLambda

_REGISTRY = {
    "regression": RegressionL2,
    "regression_l1": RegressionL1,
    "huber": Huber,
    "fair": Fair,
    "poisson": Poisson,
    "quantile": Quantile,
    "mape": Mape,
    "gamma": Gamma,
    "tweedie": Tweedie,
    "binary": BinaryLogloss,
    "cross_entropy": CrossEntropy,
    "cross_entropy_lambda": CrossEntropyLambda,
    "lambdarank": LambdarankNDCG,
}
#: the JAX package's objectives that are not ported yet, and why
NOT_PORTED = {
    "multiclass": "K trees an iteration",
    "multiclassova": "K trees an iteration",
}


def create_objective(config) -> ObjectiveFunction:
    name = config.objective
    cls = _REGISTRY.get(name)
    if cls is None:
        why = f" ({NOT_PORTED[name]})" if name in NOT_PORTED else ""
        raise LightGBMError(f"objective {name!r} is not ported to "
                            f"lightgbm_tpu_torch yet{why} (have: "
                            f"{', '.join(sorted(_REGISTRY))})")
    return cls(config)
