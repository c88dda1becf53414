"""Cross-entropy objectives (reference ``src/objective/xentropy_objective.hpp``).

Counterpart of ``lightgbm_tpu/objectives/xentropy.py``.
``cross_entropy``: labels are probabilities in [0, 1]; grad = sigmoid(s) - y.
``cross_entropy_lambda``: the log(1+exp(s)) intensity parameterization,
with the reference's closed forms when weighted.  Neither has a
``device_grad`` in the JAX package, so neither has one here: both train
on the per-iteration path.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..utils.log import LightGBMError, log_info
from .base import ObjectiveFunction

K_EPSILON = 1e-15


def _check_labels(label):
    if (label < 0).any() or (label > 1).any():
        raise LightGBMError("[cross-entropy]: labels must be in [0, 1]")


def xentropy_grad(score, label, weights):
    z = torch.sigmoid(score)
    g = z - label
    h = z * (1.0 - z)
    if weights is not None:
        g, h = g * weights, h * weights
    return g, h


def xentropy_lambda_grad(score, label, weights):
    if weights is None:
        return xentropy_grad(score, label, None)
    # weighted closed form (xentropy_objective.hpp:190-208)
    w, y = weights, label
    epf = torch.exp(score)
    hhat = torch.log1p(epf)
    z = 1.0 - torch.exp(-w * hhat)
    enf = 1.0 / epf
    g = (1.0 - y / torch.clamp(z, min=K_EPSILON)) * w / (1.0 + enf)
    c = 1.0 / torch.clamp(1.0 - z, min=K_EPSILON)
    d0 = 1.0 + epf
    a = w * epf / (d0 * d0)
    d = c - 1.0
    b = (c / torch.clamp(d * d, min=K_EPSILON)) * (1.0 + w * epf - c)
    h = a * (1.0 + y * b)
    return g, h


class CrossEntropy(ObjectiveFunction):
    name = "cross_entropy"
    _grad_fn = staticmethod(xentropy_grad)

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        _check_labels(self.label)
        self.label_d = torch.as_tensor(self.label, device=device)

    def get_gradients(self, scores):
        return self._grad_fn(scores[0].float(), self.label_d, self.weights_d)

    def boost_from_score(self, class_id):
        w = self.weights if self.weights is not None \
            else np.ones_like(self.label)
        pavg = float((self.label * w).sum() / max(w.sum(), K_EPSILON))
        pavg = min(max(pavg, K_EPSILON), 1.0 - K_EPSILON)
        init = math.log(pavg / (1.0 - pavg))
        log_info(f"[cross_entropy:BoostFromScore]: pavg={pavg:.6f} -> "
                 f"initscore={init:.6f}")
        return init

    def convert_output(self, raw):
        return 1.0 / (1.0 + np.exp(-raw))


class CrossEntropyLambda(CrossEntropy):
    name = "cross_entropy_lambda"
    _grad_fn = staticmethod(xentropy_lambda_grad)

    def boost_from_score(self, class_id):
        w = self.weights if self.weights is not None \
            else np.ones_like(self.label)
        havg = float((self.label * w).sum() / max(w.sum(), K_EPSILON))
        init = math.log(max(math.exp(havg) - 1.0, K_EPSILON))
        log_info(f"[cross_entropy_lambda:BoostFromScore]: havg={havg:.6f} "
                 f"-> initscore={init:.6f}")
        return init

    def convert_output(self, raw):
        return np.log1p(np.exp(raw))
