"""GOSS boosting (counterpart of ``lightgbm_tpu/boosting/goss.py``,
reference ``src/boosting/goss.hpp``)."""

from __future__ import annotations

import torch.nn.functional as F

from ..ops.bagging import goss_row_mask
from ..ops.histogram import bucket_size
from ..utils import random as trandom
from ..utils.log import LightGBMError
from .gbdt import GBDT


class GOSS(GBDT):
    """Gradient one-side sampling: keep the rows of the largest ``|g*h|``,
    sample the rest and up-weight the sample's gradients and hessians.  No
    sampling during the warm-up (``iter < 1/learning_rate``,
    goss.hpp:138).  The selection runs on the training device
    (``ops/bagging.goss_partition``'s draw) and reaches the device grower
    as its 0/1 row mask (nothing is read back to the host), the host
    learner as its index buffer."""

    def init_train(self, train_set):
        super().init_train(train_set)
        cfg = self.config
        if cfg.top_rate + cfg.other_rate > 1.0:
            raise LightGBMError("top_rate + other_rate <= 1.0 in GOSS")
        self.need_bagging = False      # GOSS replaces bagging
        self.is_constant_hessian = False
        self._goss_multiplier = None
        self._cur_grad = None

    def bagging(self, it: int) -> None:
        """The selection of iteration ``it`` from the stashed gradients:
        seed ``(bagging_seed + it) & 0x7FFFFFFF``, scores ``|g*h|`` summed
        over classes and padded with zeros to the host learner's pad
        ``bucket_size(num_data)`` (``lightgbm_tpu/tree/learner.py:
        185-204``)."""
        self.row_mask = None
        self.bag_buffer, self.bag_count = None, self.num_data
        self._goss_multiplier = None
        if it < int(1.0 / max(self.config.learning_rate, 1e-12)):
            return
        grad, hess = self._cur_grad
        seed = (int(self.config.bagging_seed) + it) & 0x7FFFFFFF
        if self._grower is None:
            # the host learner's selection: an index buffer
            # (lightgbm_tpu/boosting/goss.py:26-38)
            self.bag_buffer, self.bag_count, self._goss_multiplier = \
                self.learner.goss_state(seed, (grad * hess).abs().sum(0),
                                        self.config.top_rate,
                                        self.config.other_rate)
            return
        n_pad = bucket_size(max(self.num_data, 1))
        score = F.pad((grad * hess).abs().sum(0), (0, n_pad - self.num_data))
        self.row_mask, self._goss_multiplier = goss_row_mask(
            trandom.PRNGKey(seed), score, n_pad, self.num_data,
            self.config.top_rate, self.config.other_rate)

    def _adjust_gradients(self, grad, hess):
        # stashed for bagging(); the multiplier comes after the selection
        self._cur_grad = (grad, hess)
        return grad, hess

    def _post_bagging_adjust(self, grad, hess):
        self._cur_grad = None
        if self._goss_multiplier is None:
            return grad, hess
        m = self._goss_multiplier[None, :]
        return grad * m, hess * m
