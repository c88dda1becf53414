"""User-facing ``Dataset`` and ``Booster`` (counterpart of
``lightgbm_tpu/basic.py`` for dense matrices and scipy sparse ones, which
bin from CSR and predict in row chunks without densifying; no callbacks,
valid sets, refit or pred_contrib yet)."""

from __future__ import annotations

from typing import Optional

import numpy as np

from .boosting.gbdt import GBDT
from .config import Config
from .data.dataset import BinnedDataset


def _is_sparse(data) -> bool:
    return hasattr(data, "tocsr") and hasattr(data, "nnz")


#: rows of a sparse prediction batch densified at a time
PREDICT_CHUNK_ROWS = 1 << 16


def _to_2d_float(data, keep_float32: bool = False):
    """A dense C-contiguous float64 matrix (sparse input is densified here;
    training data bins from CSR and prediction densifies it in row chunks
    instead).  With ``keep_float32`` (prediction) float32 stays float32:
    the packed-forest kernel widens it exactly on the card and the host
    walk compares it as float64."""
    if _is_sparse(data):
        data = data.toarray()
    arr = np.asarray(data)
    if arr.ndim == 1:
        arr = arr.reshape(1, -1)
    if arr.ndim != 2:
        raise ValueError("data must be 2-dimensional")
    dtype = np.float32 if keep_float32 and arr.dtype == np.float32 \
        else np.float64
    return np.ascontiguousarray(arr, dtype=dtype)


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
    """A trained or loaded model.  Training, and prediction of batches of
    ``device_predict_min_rows`` rows or more, run on ``params['device']``
    (default ``cuda``); smaller batches walk the trees on the host."""

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

    def predict(self, data, num_iteration=-1, raw_score=False,
                pred_leaf=False, start_iteration=0):
        """Predictions of iterations ``[start_iteration, start_iteration +
        num_iteration)`` (all from ``start_iteration`` when
        ``num_iteration <= 0``): converted or raw scores, or with
        ``pred_leaf`` each tree's leaf index.  A scipy sparse matrix is
        densified :data:`PREDICT_CHUNK_ROWS` rows at a time (the fork's
        harness predicts 20M-request windows from CSR); every chunk takes
        the route (kernel or host walk) of the whole batch's row count."""
        if isinstance(data, Dataset):
            raise TypeError("Cannot use Dataset instance for prediction, "
                            "please use raw data instead")
        kw = dict(num_iteration=num_iteration, raw_score=raw_score,
                  pred_leaf=pred_leaf, start_iteration=start_iteration)
        if _is_sparse(data):
            csr = data.tocsr()
            step = PREDICT_CHUNK_ROWS
            return np.concatenate(
                [self._gbdt.predict(_to_2d_float(csr[i:i + step], True),
                                    batch_rows=csr.shape[0], **kw)
                 for i in range(0, max(csr.shape[0], 1), step)], axis=0)
        return self._gbdt.predict(_to_2d_float(data, True), **kw)

    def model_to_string(self) -> str:
        return self._gbdt.model_to_string()
