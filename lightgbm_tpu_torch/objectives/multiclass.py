"""Multiclass objectives (reference ``src/objective/multiclass_objective.hpp``).

Counterpart of ``lightgbm_tpu/objectives/multiclass.py``: K trees an
iteration, one per class.  Softmax takes ``grad = p - onehot`` and
``hess = 2 p (1 - p)`` over the (K, N) scores; one-vs-all wraps one
:class:`BinaryLogloss` per class on that class's 0/1 labels.  Neither has
a ``device_grad``: fused training is for one model an iteration, as in
the JAX package.
"""

from __future__ import annotations

import types

import numpy as np
import torch

from ..utils.log import LightGBMError
from .base import ObjectiveFunction
from .binary import BinaryLogloss


def softmax_grad(scores, label_int, weights):
    """(grad, hess) of the softmax cross-entropy over the class axis of
    the (K, N) f32 ``scores``, as (K, N) f32 tensors."""
    p = torch.softmax(scores, dim=0)
    classes = torch.arange(scores.shape[0], device=scores.device)
    g = p - (classes[:, None] == label_int[None, :]).to(p.dtype)
    h = 2.0 * p * (1.0 - p)
    if weights is not None:
        g, h = g * weights[None, :], h * weights[None, :]
    return g, h


class _Multiclass(ObjectiveFunction):
    """What both multiclass objectives share: K models an iteration, the
    label range check and the weighted class priors."""

    def __init__(self, config):
        super().__init__(config)
        self.num_class = int(config.num_class)

    @property
    def num_model_per_iteration(self):
        return self.num_class

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        li = self.label.astype(np.int32)
        if (li < 0).any() or (li >= self.num_class).any():
            raise LightGBMError(f"Label must be in [0, num_class) for "
                                f"{self.name} objective")
        self.label_int = li
        w = self.weights if self.weights is not None else np.ones(num_data)
        self.class_init_probs = [
            float((w * (li == k)).sum() / max(w.sum(), 1e-35))
            for k in range(self.num_class)]


class MulticlassSoftmax(_Multiclass):
    name = "multiclass"

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        self.label_int_d = torch.as_tensor(self.label_int, device=device)

    def get_gradients(self, scores):
        return softmax_grad(scores.float(), self.label_int_d, self.weights_d)

    def boost_from_score(self, class_id):
        # log of the class prior (multiclass_objective.hpp:137-139)
        return float(np.log(max(1e-15, self.class_init_probs[class_id])))

    def class_need_train(self, class_id):
        p = self.class_init_probs[class_id]
        return not (abs(p) <= 1e-15 or abs(p) >= 1.0 - 1e-15)

    def convert_output(self, raw):
        """raw (K, N) -> softmax probabilities."""
        e = np.exp(raw - raw.max(axis=0, keepdims=True))
        return e / e.sum(axis=0, keepdims=True)

    def to_string(self):
        return f"multiclass num_class:{self.num_class}"


class MulticlassOVA(_Multiclass):
    name = "multiclassova"

    def __init__(self, config):
        super().__init__(config)
        self.sigmoid = float(config.sigmoid)
        self._binaries = [BinaryLogloss(config)
                          for _ in range(self.num_class)]

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        for k, b in enumerate(self._binaries):
            view = types.SimpleNamespace(
                label=(self.label_int == k).astype(np.float32),
                weights=self.weights)
            b.init(view, num_data, device)

    def get_gradients(self, scores):
        gs, hs = zip(*(b.get_gradients(scores[k:k + 1])
                       for k, b in enumerate(self._binaries)))
        return torch.stack(gs), torch.stack(hs)

    def boost_from_score(self, class_id):
        return self._binaries[class_id].boost_from_score(0)

    def class_need_train(self, class_id):
        return self._binaries[class_id].class_need_train(0)

    def convert_output(self, raw):
        return 1.0 / (1.0 + np.exp(-self.sigmoid * raw))

    def to_string(self):
        return (f"multiclassova num_class:{self.num_class} "
                f"sigmoid:{self.sigmoid}")
