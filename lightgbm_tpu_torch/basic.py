"""User-facing ``Dataset`` and ``Booster`` (counterpart of
``lightgbm_tpu/basic.py`` for dense matrices, scipy sparse ones, which
bin from CSR and predict in row chunks without densifying, and float32
tensors, binned on their device; validation sets bin against a training
set's mappers (``reference``); the model-output surface: sliced model
text, ``save_model``, ``Booster(model_file=)``, ``dump_model``,
``feature_importance``; no refit or pred_contrib yet)."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .boosting import create_boosting
from .boosting.gbdt import GBDT
from .config import Config
from .data.dataset import BinnedDataset
from .utils.log import LightGBMError


def _is_sparse(data) -> bool:
    return hasattr(data, "tocsr") and hasattr(data, "nnz")


#: rows of a sparse prediction batch densified at a time
PREDICT_CHUNK_ROWS = 1 << 16


def _resolve_categorical(categorical_feature, feature_names,
                         num_features: int) -> list:
    """Sorted column indices of ``categorical_feature``, given by index
    or by name (``lightgbm_tpu/basic.py::_resolve_categorical``)."""
    if categorical_feature in (None, "auto"):
        return []
    out = []
    for c in categorical_feature:
        if isinstance(c, str):
            if not feature_names or c not in feature_names:
                raise LightGBMError(f"unknown categorical feature name {c}")
            out.append(list(feature_names).index(c))
        else:
            if int(c) >= num_features:
                raise LightGBMError("categorical_feature index out of range")
            out.append(int(c))
    return sorted(set(out))


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
    """Training or validation data: a dense float matrix, a scipy sparse
    matrix or an (N, F) float32 tensor, and its labels, binned at first use
    (``construct``): a tensor on its own device
    (``BinnedDataset.construct_from_device_matrix``), the others on the
    host.  With ``reference`` (another ``Dataset``) it is binned with that
    set's mappers and inherits its params.  ``group``: the query sizes
    (or boundaries from 0) of a ranking set, in the JAX package's
    positional place (``lightgbm_tpu/basic.py:71``)."""

    def __init__(self, data, label=None, reference=None, weight=None,
                 group=None, init_score=None, feature_name=None,
                 categorical_feature=(), params=None):
        self.data = data
        self.label = label
        self.reference = reference
        self.weight = weight
        self.group = group
        self.init_score = init_score
        self.feature_name = feature_name
        self.categorical_feature = categorical_feature
        self.params = dict(params or {})
        self._handle: Optional[BinnedDataset] = None

    def construct(self) -> "Dataset":
        if self._handle is not None:
            return self
        params = dict(self.params)
        ref = None
        if self.reference is not None:
            ref = self.reference.construct()._handle
            params = {**self.reference.params, **params}
        config = Config(params)
        if isinstance(self.data, torch.Tensor):
            if len(self.categorical_feature):
                raise LightGBMError(
                    "a tensor Dataset supports numerical features only")
            self._handle = BinnedDataset.construct_from_device_matrix(
                self.data, config, feature_names=self.feature_name,
                reference=ref)
        elif _is_sparse(self.data):
            csr = self.data.tocsr()
            self._handle = BinnedDataset.construct_from_csr(
                csr.indptr, csr.indices, csr.data, csr.shape[1], config,
                _resolve_categorical(self.categorical_feature,
                                     self.feature_name, csr.shape[1]),
                feature_names=self.feature_name, reference=ref)
        else:
            data = _to_2d_float(self.data)
            self._handle = BinnedDataset.construct_from_matrix(
                data, config, _resolve_categorical(
                    self.categorical_feature, self.feature_name,
                    data.shape[1]),
                feature_names=self.feature_name, reference=ref)
        md = self._handle.metadata
        if self.label is not None:
            md.set_label(np.asarray(self.label))
        md.set_weights(self.weight)
        if self.group is not None:
            md.set_query(np.asarray(self.group))
        md.set_init_score(self.init_score)
        return self

    def create_valid(self, data, label=None, weight=None, group=None,
                     init_score=None, params=None) -> "Dataset":
        """A validation set binned with this set's mappers (its own
        labels, weights and queries)."""
        return Dataset(data, label=label, reference=self, weight=weight,
                       group=group, init_score=init_score, params=params,
                       feature_name=self.feature_name,
                       categorical_feature=self.categorical_feature)

    def set_group(self, group) -> "Dataset":
        self.group = group
        if self._handle is not None and group is not None:
            self._handle.metadata.set_query(np.asarray(group))
        return self

    def get_group(self):
        """The query sizes, or None."""
        if self._handle is not None:
            qb = self._handle.metadata.query_boundaries
            return None if qb is None else np.diff(qb)
        return self.group


class Booster:
    """A trained or loaded model.  Training, and prediction of batches of
    ``device_predict_min_rows`` rows or more, run on ``params['device']``
    (default ``cuda``); smaller batches walk the trees on the host.  The
    boosting mode is ``params['boosting']``: gbdt, goss, dart or rf."""

    def __init__(self, params=None, train_set: Optional[Dataset] = None,
                 model_file=None, model_str=None):
        self.params = dict(params or {})
        self.best_iteration = -1
        self.best_score: Dict[str, Dict[str, float]] = {}
        self._train_set: Optional[Dataset] = None
        if train_set is not None:
            if not isinstance(train_set, Dataset):
                raise TypeError("Training data should be Dataset instance")
            train_set.params = {**self.params, **train_set.params}
            train_set.construct()
            self._gbdt = create_boosting(Config(self.params))
            self._gbdt.init_train(train_set._handle)
            self._train_set = train_set
        elif model_file is not None:
            self._gbdt = GBDT.load_model_from_file(model_file,
                                                   Config(self.params))
        elif model_str is not None:
            self._gbdt = GBDT.load_model_from_string(model_str,
                                                     Config(self.params))
        else:
            raise TypeError("one of train_set, model_file or model_str is "
                            "needed")

    @classmethod
    def from_gbdt(cls, gbdt: GBDT, params=None) -> "Booster":
        booster = cls.__new__(cls)
        booster.params = dict(params or {})
        booster.best_iteration = -1
        booster.best_score = {}
        booster._train_set = None
        booster._gbdt = gbdt
        return booster

    def add_valid(self, data: Dataset, name: str) -> "Booster":
        """Evaluate ``data`` (binned against the training set) from the
        next iteration on."""
        data.construct()
        self._gbdt.add_valid(data._handle, name)
        return self

    def update(self) -> bool:
        """One boosting iteration; True when training cannot continue.
        Drives ``GBDT.train_chunked``: one iteration takes the
        per-iteration path, and the driver keeps the bagging state right
        when fused chunks (``update_chunked``, ``engine.train``) and single
        updates mix."""
        return self._gbdt.train_chunked(1)

    def update_chunked(self, n_iters: int, chunk: Optional[int] = None
                       ) -> bool:
        """Train ``n_iters`` iterations, fusing up to ``chunk`` whole
        iterations into one dispatch when the configuration allows
        (``GBDT.train_chunked``); True if training stopped early.
        ``chunk`` defaults to the ``fused_chunk`` param (``<= 1`` disables
        fusing).  No callbacks run here: ``engine.train`` keeps their
        cadence."""
        if chunk is None:
            chunk = max(int(getattr(self._gbdt.config, "fused_chunk", 20)),
                        0)
        return self._gbdt.train_chunked(n_iters, chunk=chunk)

    def current_iteration(self) -> int:
        self._gbdt._flush_pending()
        return self._gbdt.num_iterations()

    def num_trees(self) -> int:
        self._gbdt._flush_pending()
        return len(self._gbdt.models)

    def eval_train(self, feval=None):
        """``(data_name, metric, value, bigger_is_better)`` of the training
        set's metrics, then of ``feval(preds, train_set)``."""
        return self._eval(self._gbdt.eval_train(), feval, is_train=True)

    def eval_valid(self, feval=None):
        """The same records for every validation set."""
        return self._eval(self._gbdt.eval_valid(), feval, is_train=False)

    def _eval(self, records, feval, is_train):
        out = list(records)
        if feval is None:
            return out
        if is_train:
            if self._train_set is not None:
                pred = self._inner_eval_pred(self._gbdt.train_score)
                out.extend(_feval_records(
                    "training", feval(pred, self._train_set)))
            return out
        for v in self._gbdt.valid_sets:
            holder = Dataset.__new__(Dataset)
            holder._handle = v.dataset
            holder.label = v.dataset.metadata.label
            out.extend(_feval_records(
                v.name, feval(self._inner_eval_pred(v.score), holder)))
        return out

    def _inner_eval_pred(self, score):
        """Converted predictions of (num_model, N) scores, as ``feval``
        receives them: (N,), or (N * num_model,) row by row.  An averaged
        model (RF) gives its sums over the iterations, not converted
        (rf.hpp's EvalOneMetric passes a null objective)."""
        s = score.double().cpu().numpy()
        if self._gbdt.average_output:
            s = s / max(self._gbdt.num_iterations(), 1)
        elif self._gbdt.objective is not None:
            s = self._gbdt.objective.convert_output(s)
        return s[0] if s.shape[0] == 1 else s.T.reshape(-1)

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

    def model_to_string(self, num_iteration=-1, start_iteration=0) -> str:
        """The model text of iterations ``[start_iteration, start_iteration
        + num_iteration)`` (to the last when ``num_iteration <= 0``)."""
        return self._gbdt.model_to_string(start_iteration, num_iteration)

    def save_model(self, filename, num_iteration=-1,
                   start_iteration=0) -> "Booster":
        self._gbdt.save_model_to_file(filename, start_iteration,
                                      num_iteration)
        return self

    def dump_model(self, num_iteration=-1, start_iteration=0) -> dict:
        """The model as a dict (``lightgbm_tpu/basic.py::dump_model``: the
        header fields and every tree's ``Tree.to_json``)."""
        g = self._gbdt
        g._flush_pending()
        return {
            "name": "tree",
            "version": "v2",
            "num_class": max(g.num_model, 1),
            "num_tree_per_iteration": g.num_model,
            "label_index": 0,
            "max_feature_idx": g.max_feature_idx,
            "objective": (g.objective.to_string() if g.objective
                          else g.loaded_objective_str),
            "average_output": g.average_output,
            "feature_names": g.feature_names,
            "tree_info": [
                {"tree_index": i, **t.to_json()}
                for i, t in enumerate(g.models)],
        }

    def feature_importance(self, importance_type="split", iteration=-1):
        """(num_features,) float64 split counts ("split") or summed gains
        ("gain") over the first ``iteration`` iterations (all when
        ``<= 0``)."""
        return self._gbdt.feature_importance(importance_type, iteration)

    def feature_name(self):
        return list(self._gbdt.feature_names)


def _feval_records(dataset_name, res):
    if isinstance(res, list):
        return [(dataset_name, n, v, b) for n, v, b in res]
    n, v, b = res
    return [(dataset_name, n, v, b)]
