"""Boosting modes; the factory mirrors ``Boosting::CreateBoosting``
(boosting.cpp:30-64) and ``lightgbm_tpu/boosting/__init__.py``."""

from .dart import DART
from .gbdt import GBDT, resolve_device
from .goss import GOSS
from .rf import RF

__all__ = ["DART", "GBDT", "GOSS", "RF", "create_boosting",
           "resolve_device"]


def create_boosting(config):
    """The booster of ``config.boosting``: gbdt, goss, dart or rf."""
    name = config.boosting
    if name == "gbdt":
        return GBDT(config)
    if name == "dart":
        return DART(config)
    if name == "goss":
        return GOSS(config)
    if name == "rf":
        return RF(config)
    raise ValueError(f"unknown boosting type: {name}")
