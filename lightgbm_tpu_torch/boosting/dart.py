"""DART boosting (counterpart of ``lightgbm_tpu/boosting/dart.py``,
reference ``src/boosting/dart.hpp``)."""

from __future__ import annotations

import numpy as np

from ..ops.traverse import add_tree_score, device_tree
from .gbdt import GBDT


class DART(GBDT):
    """Dropout trees: each iteration drops a random subset of the earlier
    trees from the training score, trains on that residual, then rescales
    the dropped trees and the new one (dart.hpp:86-186).  The drop draw
    is the JAX package's numpy ``RandomState(drop_seed & 0x7FFFFFFF)``
    stream.  A dropped tree leaves and re-enters the training score by
    the binned traversal over the grower's (or the host learner's) own
    ``(G, N)`` codes (``ops/traverse.py``, ``groups_major``): no second
    copy of the training matrix.  ``traversals`` counts those traversals
    (training and validation)."""

    def init_train(self, train_set):
        super().init_train(train_set)
        self._drop_rng = np.random.RandomState(
            int(self.config.drop_seed) & 0x7FFFFFFF)
        self.tree_weight = []
        self.sum_weight = 0.0
        self.drop_index = []
        self.is_constant_hessian = False
        self.num_init_iteration = 0
        self.traversals = 0

    # -- score helpers -------------------------------------------------
    def _add_tree_everywhere(self, tree, k, train=True, valid=True):
        """Add ``tree``'s current leaf values to class ``k``'s training
        scores and/or every validation set's."""
        dt = device_tree(tree, self.train_set, self.config.num_leaves,
                         self.device)
        if train:
            self.train_score[k] = add_tree_score(
                self.train_score[k], self._train_codes_t(), dt, 1.0,
                groups_major=True)
            self.traversals += 1
        if valid:
            for v in self.valid_sets:
                v.score[k] = add_tree_score(v.score[k], v.binned, dt, 1.0)
                self.traversals += 1

    # ------------------------------------------------------------------
    def _dropping_trees(self) -> None:
        cfg = self.config
        self.drop_index = []
        is_skip = self._drop_rng.rand() < cfg.skip_drop
        if not is_skip and self.iter > 0:
            drop_rate = cfg.drop_rate
            if not cfg.uniform_drop:
                inv_avg = len(self.tree_weight) / max(self.sum_weight, 1e-35)
                if cfg.max_drop > 0:
                    drop_rate = min(drop_rate, cfg.max_drop * inv_avg
                                    / max(self.sum_weight, 1e-35))
                for i in range(self.iter):
                    if self._drop_rng.rand() < (drop_rate
                                                * self.tree_weight[i]
                                                * inv_avg):
                        self.drop_index.append(self.num_init_iteration + i)
                        if (cfg.max_drop > 0
                                and len(self.drop_index) >= cfg.max_drop):
                            break
            else:
                if cfg.max_drop > 0:
                    drop_rate = min(drop_rate, cfg.max_drop / self.iter)
                for i in range(self.iter):
                    if self._drop_rng.rand() < drop_rate:
                        self.drop_index.append(self.num_init_iteration + i)
                        if (cfg.max_drop > 0
                                and len(self.drop_index) >= cfg.max_drop):
                            break
        # dropped trees are rescaled in place, so the pending records are
        # replayed first, and the validation scores caught up now: the
        # normalization adds per-tree deltas to them, sound only once
        # every earlier tree reached them.  Iterations that drop nothing
        # read nothing back.
        if self.drop_index:
            if self.valid_sets:
                self._catch_up_valid_scores()
            else:
                self._flush_pending()
            if self._device_stop:
                # the flush trimmed a stalled iteration: training is over
                self.drop_index = []
                return
        self._negate_dropped_into_train()
        k_drop = len(self.drop_index)
        if not cfg.xgboost_dart_mode:
            self.shrinkage_rate = cfg.learning_rate / (1.0 + k_drop)
        else:
            self.shrinkage_rate = (cfg.learning_rate if k_drop == 0
                                   else cfg.learning_rate
                                   / (cfg.learning_rate + k_drop))

    def _negate_dropped_into_train(self) -> None:
        """Flip every dropped tree's sign in place and add it to the
        training score: once to drop (the tree leaves the score) and again
        to undo the drop when training stops before :meth:`_normalize`."""
        for i in self.drop_index:
            for k in range(self.num_model):
                tree = self.models[i * self.num_model + k]
                tree.apply_shrinkage(-1.0)
                self._add_tree_everywhere(tree, k, train=True, valid=False)
        if self.drop_index:
            self._packed_cache = None      # leaf values changed in place

    def _normalize(self) -> None:
        cfg = self.config
        k = float(len(self.drop_index))
        for i in self.drop_index:
            for cid in range(self.num_model):
                tree = self.models[i * self.num_model + cid]
                if not cfg.xgboost_dart_mode:
                    tree.apply_shrinkage(1.0 / (k + 1.0))
                    self._add_tree_everywhere(tree, cid, train=False,
                                              valid=True)
                    tree.apply_shrinkage(-k)
                    self._add_tree_everywhere(tree, cid, train=True,
                                              valid=False)
                else:
                    tree.apply_shrinkage(self.shrinkage_rate)
                    self._add_tree_everywhere(tree, cid, train=False,
                                              valid=True)
                    tree.apply_shrinkage(-k / cfg.learning_rate)
                    self._add_tree_everywhere(tree, cid, train=True,
                                              valid=False)
            if not cfg.uniform_drop:
                j = i - self.num_init_iteration
                if not cfg.xgboost_dart_mode:
                    self.sum_weight -= self.tree_weight[j] * (1.0 / (k + 1.0))
                    self.tree_weight[j] *= k / (k + 1.0)
                else:
                    self.sum_weight -= self.tree_weight[j] \
                        * (1.0 / (k + cfg.learning_rate))
                    self.tree_weight[j] *= k / (k + cfg.learning_rate)
        if self.drop_index:
            self._packed_cache = None

    # ------------------------------------------------------------------
    def train_one_iter(self, gradients=None, hessians=None) -> bool:
        self._check_custom_gradients(gradients, hessians)
        self._dropping_trees()
        if super().train_one_iter(gradients, hessians):
            # training stopped before _normalize could restore the dropped
            # trees: undo the drop, so the stored model agrees with the
            # training score and predict() (the reference returns with
            # the trees sign-flipped here, dart.hpp:52-58; the JAX package
            # undoes the drop as well)
            self._negate_dropped_into_train()
            self.drop_index = []
            return True
        self._normalize()
        if not self.config.uniform_drop:
            self.tree_weight.append(self.shrinkage_rate)
            self.sum_weight += self.shrinkage_rate
        return False
