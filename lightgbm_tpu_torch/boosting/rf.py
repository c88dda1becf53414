"""Random-forest mode (counterpart of ``lightgbm_tpu/boosting/rf.py``,
reference ``src/boosting/rf.hpp``)."""

from __future__ import annotations

import numpy as np
import torch

from ..utils.log import LightGBMError
from .gbdt import GBDT


class RF(GBDT):
    """Random forest: fixed targets (``-label``, or ``-1`` on the label's
    class for multiclass), unit hessians, no shrinkage, bagging
    mandatory, averaged output (rf.hpp:18-207).  The targets live on the
    training device; each tree grows on the bagging round's row mask."""

    def __init__(self, config):
        super().__init__(config)
        self.average_output = True

    def init_train(self, train_set):
        super().init_train(train_set)
        cfg = self.config
        if not (cfg.bagging_freq > 0 and 0.0 < cfg.bagging_fraction < 1.0):
            raise LightGBMError("RF mode requires bagging (bagging_freq > 0, "
                                "bagging_fraction in (0,1))")
        self.shrinkage_rate = 1.0
        label = torch.as_tensor(np.asarray(train_set.metadata.label,
                                           np.float32), device=self.device)
        n = self.num_data
        if self.num_model == 1:
            grad = -label[None, :]
        else:
            grad = torch.zeros((self.num_model, n), dtype=torch.float32,
                               device=self.device)
            grad[label.long(), torch.arange(n, device=self.device)] = -1.0
        self._rf_grad = grad
        self._rf_hess = torch.ones_like(grad)
        self.is_constant_hessian = False

    def boost_from_average(self, class_id: int) -> float:
        return 0.0

    def _device_gradients(self):
        return self._rf_grad, self._rf_hess, [0.0] * self.num_model

    def _check_custom_gradients(self, gradients, hessians) -> None:
        if gradients is not None or hessians is not None:
            raise LightGBMError("RF mode does not support custom objectives")

    def _averaged(self, score: torch.Tensor) -> np.ndarray:
        return score.double().cpu().numpy() / max(self.num_iterations(), 1)

    # The averaged score already is the output (a probability for binary
    # labels), so the metrics do not convert it through the objective
    # (rf.hpp's EvalOneMetric passes a null objective).
    def eval_train(self):
        if not self.train_metrics:
            return []
        score = self._averaged(self.train_score)
        return [("training", name, value, m.bigger_is_better)
                for m in self.train_metrics
                for name, value in m.eval(score, None)]

    def eval_valid(self):
        self._catch_up_valid_scores()
        out = []
        for v in self.valid_sets:
            score = self._averaged(v.score)
            out.extend((v.name, name, value, m.bigger_is_better)
                       for m in v.metrics
                       for name, value in m.eval(score, None))
        return out
