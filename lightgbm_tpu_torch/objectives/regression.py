"""Regression objectives (reference ``src/objective/regression_objective.hpp``).

Counterpart of ``lightgbm_tpu/objectives/regression.py``: each gradient is
a module-level function of float32 tensors on the scores' device, in the
JAX package's formula and operation order.  Only plain ``regression`` has
a ``device_grad`` (the fused path), as in the JAX package; the others take
the per-iteration path.  ``regression_l1``, ``quantile`` and ``mape`` renew
their leaf outputs after growth (``is_renew_tree_output``): their classes,
gradients, ``boost_from_score`` and ``renew_tree_output`` are here, and
``GBDT.init_train`` refuses to train them (the JAX package trains them on
its host learner, which the port does not have).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.log import LightGBMError, log_warning
from .base import ObjectiveFunction, percentile, weighted_percentile


def _sign(x):
    """-1, 0 or 1 (0 for NaN), as the JAX package's ``_sign``."""
    return torch.where(x > 0, 1.0, torch.where(x < 0, -1.0, 0.0))


def _unit(g, weights):
    """(g * w, w), or (g, 1) unweighted: the hessian of the L2 family."""
    if weights is None:
        return g, torch.ones_like(g)
    return g * weights, weights


def _weighted(g, h, weights):
    if weights is None:
        return g, h
    return g * weights, h * weights


def l2_grad(score, label, weights):
    return _unit(score - label, weights)


def _l2_device_grad(score, args):
    """The fused trees' gradients (``RegressionL2.device_grad``)."""
    return l2_grad(score, *args)


def l1_grad(score, label, weights):
    return _unit(_sign(score - label), weights)


def huber_grad(alpha: float, score, label, weights):
    diff = score - label
    return _unit(torch.where(diff.abs() <= alpha, diff, _sign(diff) * alpha),
                 weights)


def fair_grad(c: float, score, label, weights):
    x = score - label
    ax = x.abs()
    return _weighted(c * x / (ax + c), c * c / ((ax + c) ** 2), weights)


def poisson_grad(max_delta_step: float, score, label, weights):
    return _weighted(torch.exp(score) - label,
                     torch.exp(score + max_delta_step), weights)


def quantile_grad(alpha: float, score, label, weights):
    g = torch.where(score - label >= 0, 1.0 - alpha, -alpha)
    return _unit(g.to(torch.float32), weights)


def mape_grad(score, label, label_weight, weights):
    g = _sign(score - label) * label_weight
    return g, (torch.ones_like(score) if weights is None else weights)


def gamma_grad(score, label, weights):
    e = torch.exp(-score)
    return _weighted(1.0 - label * e, label * e, weights)


def tweedie_grad(rho: float, score, label, weights):
    e1 = torch.exp((1.0 - rho) * score)
    e2 = torch.exp((2.0 - rho) * score)
    return _weighted(-label * e1 + e2,
                     -label * (1.0 - rho) * e1 + (2.0 - rho) * e2, weights)


class RegressionL2(ObjectiveFunction):
    """L2 loss; grad = (score - label) [* w], hess = 1 [* w]
    (regression_objective.hpp:64-140)."""

    name = "regression"
    is_constant_hessian = True

    def __init__(self, config):
        super().__init__(config)
        self.sqrt = bool(getattr(config, "reg_sqrt", False))

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        if self.sqrt:
            self.label = (np.sign(self.label)
                          * np.sqrt(np.abs(self.label))).astype(np.float32)
        self.label_d = torch.as_tensor(self.label, device=device)
        self.is_constant_hessian = self.weights is None and \
            type(self) is RegressionL2
        self._gargs = (self.label_d, self.weights_d)

    def _grad(self, score):
        return l2_grad(score, self.label_d, self.weights_d)

    def get_gradients(self, scores):
        return self._grad(scores[0].float())

    def device_grad(self):
        """(lightgbm_tpu/objectives/regression.py:158-166): plain L2 only;
        the subclasses' formulas are not this one."""
        if type(self) is not RegressionL2:
            return None
        return _l2_device_grad, self._gargs

    def boost_from_score(self, class_id):
        if self.weights is None:
            return float(np.mean(self.label))
        return float(np.sum(self.label * self.weights)
                     / max(np.sum(self.weights), 1e-35))

    def convert_output(self, raw):
        if self.sqrt:
            return np.sign(raw) * raw * raw
        return raw

    def to_string(self):
        return self.name + (" sqrt" if self.sqrt else "")


class RegressionL1(RegressionL2):
    """L1: grad = sign(diff) [* w]; leaf outputs renewed to the weighted
    median of the residuals (regression_objective.hpp:175-258)."""

    name = "regression_l1"
    is_renew_tree_output = True
    alpha = 0.5

    def _grad(self, score):
        return l1_grad(score, self.label_d, self.weights_d)

    def boost_from_score(self, class_id):
        if self.weights is None:
            return percentile(self.label, self.alpha)
        return weighted_percentile(self.label, self.weights, self.alpha)

    def renew_tree_output(self, leaf_pred, residuals, weights):
        if weights is None:
            return percentile(residuals, self.alpha)
        return weighted_percentile(residuals, weights, self.alpha)


class Huber(RegressionL2):
    """Huber loss with transition alpha (regression_objective.hpp:261-320)."""

    name = "huber"

    def __init__(self, config):
        super().__init__(config)
        self.alpha = float(config.alpha)
        self.sqrt = False

    def _grad(self, score):
        return huber_grad(self.alpha, score, self.label_d, self.weights_d)


class Fair(RegressionL2):
    """Fair loss (regression_objective.hpp:323-369)."""

    name = "fair"
    is_constant_hessian = False

    def __init__(self, config):
        super().__init__(config)
        self.c = float(config.fair_c)

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        self.is_constant_hessian = False

    def _grad(self, score):
        return fair_grad(self.c, score, self.label_d, self.weights_d)


class Poisson(RegressionL2):
    """Poisson with log link: grad = exp(s) - y, hess = exp(s + mds)
    (regression_objective.hpp:371-450)."""

    name = "poisson"
    is_constant_hessian = False

    def __init__(self, config):
        super().__init__(config)
        self.max_delta_step = float(config.poisson_max_delta_step)
        self.sqrt = False

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        self.is_constant_hessian = False
        if (self.label < 0).any():
            raise LightGBMError(
                f"[{self.name}]: at least one target label is negative")
        if self.label.sum() == 0:
            raise LightGBMError(f"[{self.name}]: sum of labels is zero")

    def _grad(self, score):
        return poisson_grad(self.max_delta_step, score, self.label_d,
                            self.weights_d)

    def boost_from_score(self, class_id):
        return float(np.log(max(RegressionL2.boost_from_score(self, 0),
                                1e-35)))

    def convert_output(self, raw):
        return np.exp(raw)


class Quantile(RegressionL2):
    """Pinball loss at quantile alpha (regression_objective.hpp:452-549)."""

    name = "quantile"
    is_renew_tree_output = True

    def __init__(self, config):
        super().__init__(config)
        self.alpha = float(config.alpha)
        if not (0.0 < self.alpha < 1.0):
            raise LightGBMError("alpha should be in (0, 1) for quantile")

    def _grad(self, score):
        return quantile_grad(self.alpha, score, self.label_d, self.weights_d)

    def boost_from_score(self, class_id):
        if self.weights is None:
            return percentile(self.label, self.alpha)
        return weighted_percentile(self.label, self.weights, self.alpha)

    def renew_tree_output(self, leaf_pred, residuals, weights):
        if weights is None:
            return percentile(residuals, self.alpha)
        return weighted_percentile(residuals, weights, self.alpha)


class Mape(RegressionL1):
    """MAPE: sign(diff) / max(1, |y|) with the median renewal weighted by
    the label weight (regression_objective.hpp:551-650)."""

    name = "mape"

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        if (np.abs(self.label) < 1).any():
            log_warning("Met 'abs(label) < 1', will convert them to '1' in "
                        "MAPE objective and metric")
        lw = 1.0 / np.maximum(1.0, np.abs(self.label))
        if self.weights is not None:
            lw = lw * self.weights
        self.label_weight = lw.astype(np.float32)
        self.label_weight_d = torch.as_tensor(self.label_weight,
                                              device=device)

    def _grad(self, score):
        return mape_grad(score, self.label_d, self.label_weight_d,
                         self.weights_d)

    def boost_from_score(self, class_id):
        return weighted_percentile(self.label, self.label_weight, 0.5)

    def renew_tree_output(self, leaf_pred, residuals, weights):
        # ``weights`` are the label weights of the leaf's rows
        return weighted_percentile(residuals, weights, 0.5)


class Gamma(Poisson):
    """Gamma deviance with log link (regression_objective.hpp:652-687)."""

    name = "gamma"

    def init(self, metadata, num_data, device):
        RegressionL2.init(self, metadata, num_data, device)
        self.is_constant_hessian = False
        if (self.label <= 0).any():
            raise LightGBMError(f"[{self.name}]: labels must be positive")

    def _grad(self, score):
        return gamma_grad(score, self.label_d, self.weights_d)


class Tweedie(Poisson):
    """Tweedie with variance power rho (regression_objective.hpp:689-740)."""

    name = "tweedie"

    def __init__(self, config):
        super().__init__(config)
        self.rho = float(config.tweedie_variance_power)

    def _grad(self, score):
        return tweedie_grad(self.rho, score, self.label_d, self.weights_d)
