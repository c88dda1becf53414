"""User-facing ``Dataset`` and ``Booster`` (counterpart of
``lightgbm_tpu/basic.py`` for dense matrices and scipy sparse ones, which
bin from CSR without densifying; no callbacks, valid sets or refit
yet)."""

from __future__ import annotations

from typing import Optional

import numpy as np

from .boosting.gbdt import GBDT
from .config import Config
from .data.dataset import BinnedDataset


def _is_sparse(data) -> bool:
    return hasattr(data, "tocsr") and hasattr(data, "nnz")


def _to_2d_float(data):
    """A dense float64 matrix of a prediction batch (sparse input is
    densified here; training data bins from CSR instead)."""
    if _is_sparse(data):
        data = data.toarray()
    arr = np.asarray(data)
    if arr.ndim == 1:
        arr = arr.reshape(1, -1)
    if arr.ndim != 2:
        raise ValueError("data must be 2-dimensional")
    return np.ascontiguousarray(arr, dtype=np.float64)


class Dataset:
    """Training data: a dense float matrix or a scipy sparse matrix and its
    labels, binned on the host at first use (``construct``)."""

    def __init__(self, data, label=None, weight=None, init_score=None,
                 feature_name=None, categorical_feature=(), params=None):
        self.data = data
        self.label = label
        self.weight = weight
        self.init_score = init_score
        self.feature_name = feature_name
        self.categorical_feature = categorical_feature
        self.params = dict(params or {})
        self._handle: Optional[BinnedDataset] = None

    def construct(self) -> "Dataset":
        if self._handle is not None:
            return self
        config = Config(self.params)
        if _is_sparse(self.data):
            csr = self.data.tocsr()
            self._handle = BinnedDataset.construct_from_csr(
                csr.indptr, csr.indices, csr.data, csr.shape[1], config,
                self.categorical_feature, feature_names=self.feature_name)
        else:
            self._handle = BinnedDataset.construct_from_matrix(
                _to_2d_float(self.data), config, self.categorical_feature,
                feature_names=self.feature_name)
        md = self._handle.metadata
        if self.label is not None:
            md.set_label(np.asarray(self.label))
        md.set_weights(self.weight)
        md.set_init_score(self.init_score)
        return self


class Booster:
    """A trained or loaded model.  Training runs on ``params['device']``
    (default ``cuda``); prediction walks the trees on the host."""

    def __init__(self, params=None, train_set: Optional[Dataset] = None,
                 model_str=None):
        self.params = dict(params or {})
        if train_set is not None:
            if not isinstance(train_set, Dataset):
                raise TypeError("Training data should be Dataset instance")
            train_set.params = {**self.params, **train_set.params}
            train_set.construct()
            self._gbdt = GBDT(Config(self.params))
            self._gbdt.init_train(train_set._handle)
        elif model_str is not None:
            self._gbdt = GBDT.load_model_from_string(model_str,
                                                     Config(self.params))
        else:
            raise TypeError("one of train_set or model_str is needed")

    @classmethod
    def from_gbdt(cls, gbdt: GBDT, params=None) -> "Booster":
        booster = cls.__new__(cls)
        booster.params = dict(params or {})
        booster._gbdt = gbdt
        return booster

    def update(self) -> bool:
        """One boosting iteration; True when training cannot continue."""
        return self._gbdt.train_one_iter()

    def num_trees(self) -> int:
        self._gbdt._flush_pending()
        return len(self._gbdt.models)

    def eval_train(self):
        return self._gbdt.eval_train()

    def predict(self, data, raw_score=False):
        return self._gbdt.predict(_to_2d_float(data), raw_score)

    def model_to_string(self) -> str:
        return self._gbdt.model_to_string()
