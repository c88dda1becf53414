"""Binary logloss objective (reference ``src/objective/binary_objective.hpp``).

Counterpart of ``lightgbm_tpu/objectives/binary.py``: the same f32 formula,
as torch ops on the scores' device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..utils.log import LightGBMError, log_info, log_warning
from .base import ObjectiveFunction

K_EPSILON = 1e-15


def logloss_grad(sigmoid: float, score, sign_label, label_weight, weights):
    """(grad, hess) of the sigmoid-scaled logistic loss, in float32."""
    response = (-sign_label * sigmoid
                / (1.0 + torch.exp(sign_label * sigmoid * score)))
    abs_r = response.abs()
    g = response * label_weight
    h = abs_r * (sigmoid - abs_r) * label_weight
    if weights is not None:
        g, h = g * weights, h * weights
    return g, h


class BinaryLogloss(ObjectiveFunction):
    """Labels {0,1} mapped to {-1,+1}; sigmoid-scaled logistic gradients with
    is_unbalance / scale_pos_weight label weighting
    (binary_objective.hpp:13-165)."""

    name = "binary"

    def __init__(self, config):
        super().__init__(config)
        self.sigmoid = float(config.sigmoid)
        self.is_unbalance = bool(config.is_unbalance)
        self.scale_pos_weight = float(config.scale_pos_weight)
        if self.sigmoid <= 0.0:
            raise LightGBMError("sigmoid param must be greater than zero")

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        is_pos = self.label > 0
        cnt_pos = int(is_pos.sum())
        cnt_neg = num_data - cnt_pos
        self.need_train = True
        if cnt_pos == 0 or cnt_neg == 0:
            log_warning("Contains only one class")
            self.need_train = False
        log_info(f"Number of positive: {cnt_pos}, number of negative: "
                 f"{cnt_neg}")
        w_pos, w_neg = 1.0, 1.0
        if self.is_unbalance and cnt_pos > 0 and cnt_neg > 0:
            if cnt_pos > cnt_neg:
                w_neg = cnt_pos / cnt_neg
            else:
                w_pos = cnt_neg / cnt_pos
        w_pos *= self.scale_pos_weight
        self.cnt_pos, self.cnt_neg = cnt_pos, cnt_neg
        f32 = dict(dtype=torch.float32, device=device)
        self.sign_label_d = torch.as_tensor(np.where(is_pos, 1.0, -1.0),
                                            **f32)
        self.label_weight_d = torch.as_tensor(np.where(is_pos, w_pos, w_neg),
                                              **f32)

    def get_gradients(self, scores):
        return logloss_grad(self.sigmoid, scores[0].float(),
                            self.sign_label_d, self.label_weight_d,
                            self.weights_d)

    def boost_from_score(self, class_id):
        is_pos = (self.label > 0).astype(np.float64)
        if self.weights is not None:
            suml = float((is_pos * self.weights).sum())
            sumw = float(self.weights.sum())
        else:
            suml = float(is_pos.sum())
            sumw = float(self.num_data)
        pavg = min(max(suml / max(sumw, K_EPSILON), K_EPSILON),
                   1.0 - K_EPSILON)
        init_score = math.log(pavg / (1.0 - pavg)) / self.sigmoid
        log_info(f"[binary:BoostFromScore]: pavg={pavg:.6f} -> "
                 f"initscore={init_score:.6f}")
        return init_score

    def class_need_train(self, class_id):
        return self.need_train

    def convert_output(self, raw):
        return 1.0 / (1.0 + np.exp(-self.sigmoid * raw))

    def to_string(self):
        return f"binary sigmoid:{self.sigmoid}"
