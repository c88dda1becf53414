"""``train``: the boosting driver (counterpart of
``lightgbm_tpu/engine.py``; no callbacks, valid sets or early stopping
yet)."""

from __future__ import annotations

from .basic import Booster, Dataset
from .config import normalize_params


def train(params, train_set: Dataset, num_boost_round: int = 100) -> Booster:
    """Train a booster for ``num_boost_round`` iterations, or until no leaf
    can be split.  Runs on ``params['device']`` (alias of ``device_type``,
    default ``cuda``; ``cpu`` takes the plain PyTorch path)."""
    params = normalize_params(params)
    num_boost_round = params.pop("num_iterations", num_boost_round)
    if num_boost_round <= 0:
        raise ValueError("num_boost_round should be greater than zero.")
    if not isinstance(train_set, Dataset):
        raise TypeError("Training only accepts Dataset object")
    booster = Booster(params=params, train_set=train_set)
    for _ in range(num_boost_round):
        if booster.update():
            break
    return booster
