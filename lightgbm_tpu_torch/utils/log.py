"""Errors and log messages of the port.

Counterpart of ``lightgbm_tpu/utils/log.py``, on the standard ``logging``
module (logger ``lightgbm_tpu_torch``): a caller sets levels and handlers
there instead of through package state.
"""

from __future__ import annotations

import logging

logger = logging.getLogger("lightgbm_tpu_torch")


class LightGBMError(RuntimeError):
    """Error raised by the framework (reference: Log::Fatal throw)."""


def log_info(msg: str) -> None:
    logger.info(msg)


def log_warning(msg: str) -> None:
    logger.warning(msg)
