"""Objective factory.  The port has binary logloss; the JAX package's other
objectives come in later slices and are refused by name here."""

from ..utils.log import LightGBMError
from .base import ObjectiveFunction
from .binary import BinaryLogloss

_REGISTRY = {"binary": BinaryLogloss}


def create_objective(config) -> ObjectiveFunction:
    name = config.objective
    cls = _REGISTRY.get(name)
    if cls is None:
        raise LightGBMError(f"objective {name!r} is not ported to "
                            f"lightgbm_tpu_torch yet (have: "
                            f"{', '.join(sorted(_REGISTRY))})")
    return cls(config)
