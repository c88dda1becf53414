"""Objective base class (reference ``include/LightGBM/objective_function.h``).

Counterpart of ``lightgbm_tpu/objectives/base.py``.  Scores are device
tensors of shape (num_model, N); ``get_gradients`` returns (grad, hess) as
float32 tensors on the scores' device.  Host-side statistics
(``boost_from_score``) stay numpy, as in the JAX package.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


class ObjectiveFunction:
    name = "none"

    def __init__(self, config):
        self.config = config

    @property
    def num_model_per_iteration(self) -> int:
        return 1

    def init(self, metadata, num_data: int, device: torch.device):
        self.num_data = num_data
        self.device = device
        self.label = np.asarray(metadata.label, np.float32) \
            if metadata.label is not None else np.zeros(num_data, np.float32)
        self.weights = (np.asarray(metadata.weights, np.float32)
                        if metadata.weights is not None else None)
        self.weights_d = (torch.as_tensor(self.weights, device=device)
                          if self.weights is not None else None)

    def get_gradients(self, scores) -> Tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError

    def device_grad(self):
        """``(fn, args)`` with ``fn(score, args) -> (grad, hess)`` a pure
        tensor function of the (N,) f32 score, which a captured CUDA graph
        can replay (``lightgbm_tpu/objectives/base.py:87``), or None: an
        objective without one is not eligible for fused training."""
        return None

    def boost_from_score(self, class_id: int) -> float:
        """Initial score (BoostFromScore)."""
        return 0.0

    def class_need_train(self, class_id: int) -> bool:
        return True

    def convert_output(self, raw: np.ndarray) -> np.ndarray:
        """Raw score -> user-facing prediction (ConvertOutput)."""
        return raw

    def to_string(self) -> str:
        return self.name
