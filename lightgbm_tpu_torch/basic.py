"""User-facing ``Dataset`` and ``Booster`` (counterpart of
``lightgbm_tpu/basic.py`` for dense matrices, scipy sparse ones, which
bin from CSR and predict in row chunks without densifying, and float32
tensors, binned on their device; validation sets bin against a training
set's mappers (``reference``); the model-output surface: sliced model
text, ``save_model``, ``Booster(model_file=)``, ``dump_model``,
``feature_importance``; ``refit`` on new labels; TreeSHAP ``pred_contrib``;
the Dataset's row subsets, binary files, text files (``data/parser.py``)
and field getters and setters; ``rollback_one_iter``; the raw rows kept
for continued training (``free_raw_data=False``); ``reset_parameter``,
copies and pickling through the model text)."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .boosting import create_boosting
from .boosting.gbdt import GBDT
from .config import Config, normalize_params
from .data.dataset import BinnedDataset
from .ops.grow import reset_refusals
from .utils.log import LightGBMError


def _is_sparse(data) -> bool:
    return hasattr(data, "tocsr") and hasattr(data, "nnz")


def _host_array(v) -> np.ndarray:
    """A label, weight, query or init-score vector as a host array: a
    tensor, on the card or the host, is copied off its device."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


#: rows of a sparse prediction batch densified at a time
PREDICT_CHUNK_ROWS = 1 << 16


def _resolve_categorical(categorical_feature, feature_names,
                         num_features: int) -> list:
    """Sorted column indices of ``categorical_feature``, given by index
    or by name (``lightgbm_tpu/basic.py::_resolve_categorical``)."""
    if categorical_feature in (None, "auto"):
        return []
    if feature_names == "auto":
        feature_names = None
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
    positional place (``lightgbm_tpu/basic.py:71``).  ``label``,
    ``weight``, ``group`` and ``init_score`` may be tensors on any device
    (copied to the host's metadata).  ``data`` may also be
    a path: a binary dataset file (``save_binary``) or a text file
    (CSV, TSV or LibSVM, ``data/parser.py``).  With ``free_raw_data``
    False the rows stay as ``raw`` after binning (the dense float64
    matrix, the CSR matrix or the tensor), as continued training needs
    them (``engine.train(init_model=...)``); else ``data`` is dropped
    once the set is built."""

    def __init__(self, data, label=None, reference=None, weight=None,
                 group=None, init_score=None, feature_name="auto",
                 categorical_feature="auto", params=None,
                 free_raw_data=True):
        self.data = data
        self.label = label
        self.reference = reference
        self.weight = weight
        self.group = group
        self.init_score = init_score
        self.feature_name = None if isinstance(feature_name, str) \
            and feature_name == "auto" else feature_name
        self.categorical_feature = categorical_feature
        self.params = dict(params or {})
        self.free_raw_data = free_raw_data
        self.used_indices = None
        self.raw = None
        self._handle: Optional[BinnedDataset] = None

    def construct(self) -> "Dataset":
        if self._handle is not None:
            return self
        raw = self._construct()
        if not self.free_raw_data:
            self.raw = raw
        elif not isinstance(self.data, str):
            self.data = None
        return self

    def _construct(self):
        """Bin the set; returns the raw rows it was binned from (None for
        a subset or a binary file)."""
        params = dict(self.params)
        ref = None
        if self.reference is not None:
            ref = self.reference.construct()._handle
            params = {**self.reference.params, **params}
        config = Config(params)
        if self.used_indices is not None and ref is not None:
            # a subset slices the parent's codes; it never re-bins
            self._handle = ref.copy_subset(self.used_indices)
            self._set_fields()
            return None
        if isinstance(self.data, str):
            if BinnedDataset.is_binary_file(self.data):
                self._handle = BinnedDataset.load_binary(self.data)
                self._set_fields()
                return None
            from .data.parser import load_text_file
            raw, label, names = load_text_file(self.data, config)
            if self.label is None:
                self.label = label
            if self.feature_name is None:
                self.feature_name = names
            self._handle = BinnedDataset.construct_from_matrix(
                raw, config, _resolve_categorical(
                    self.categorical_feature, self.feature_name,
                    raw.shape[1]),
                feature_names=self.feature_name, reference=ref)
        elif isinstance(self.data, torch.Tensor):
            raw = self.data
            if _resolve_categorical(self.categorical_feature,
                                    self.feature_name, raw.shape[1]):
                raise LightGBMError(
                    "a tensor Dataset supports numerical features only")
            self._handle = BinnedDataset.construct_from_device_matrix(
                raw, config, feature_names=self.feature_name,
                reference=ref)
        elif _is_sparse(self.data):
            raw = self.data.tocsr()
            self._handle = BinnedDataset.construct_from_csr(
                raw.indptr, raw.indices, raw.data, raw.shape[1], config,
                _resolve_categorical(self.categorical_feature,
                                     self.feature_name, raw.shape[1]),
                feature_names=self.feature_name, reference=ref)
        else:
            raw = _to_2d_float(self.data)
            self._handle = BinnedDataset.construct_from_matrix(
                raw, config, _resolve_categorical(
                    self.categorical_feature, self.feature_name,
                    raw.shape[1]),
                feature_names=self.feature_name, reference=ref)
        self._set_fields()
        return raw

    def _set_fields(self) -> None:
        """The labels, weights, queries and init scores given to this
        Dataset, over the built set's own."""
        md = self._handle.metadata
        if self.label is not None:
            md.set_label(_host_array(self.label))
        if self.weight is not None:
            md.set_weights(_host_array(self.weight))
        if self.group is not None:
            md.set_query(_host_array(self.group))
        if self.init_score is not None:
            md.set_init_score(_host_array(self.init_score))

    def subset(self, used_indices, params=None) -> "Dataset":
        """The rows ``used_indices`` (sorted) of this set, binned with its
        mappers, with its labels, weights and init scores."""
        ds = Dataset(None, reference=self, params=params or self.params,
                     feature_name=self.feature_name,
                     categorical_feature=self.categorical_feature)
        ds.used_indices = sorted(int(i) for i in used_indices)
        return ds

    def save_binary(self, filename) -> "Dataset":
        """Write the built set in the binary format both packages read."""
        self.construct()._handle.save_binary(str(filename))
        return self

    def set_label(self, label) -> "Dataset":
        self.label = label
        if self._handle is not None and label is not None:
            self._handle.metadata.set_label(_host_array(label))
        return self

    def set_weight(self, weight) -> "Dataset":
        self.weight = weight
        if self._handle is not None and weight is not None:
            self._handle.metadata.set_weights(_host_array(weight))
        return self

    def set_init_score(self, init_score) -> "Dataset":
        self.init_score = init_score
        if self._handle is not None:
            self._handle.metadata.set_init_score(
                None if init_score is None else _host_array(init_score))
        return self

    def set_reference(self, reference) -> "Dataset":
        """Bin with ``reference``'s mappers (before the set is built)."""
        if self._handle is not None:
            raise LightGBMError("cannot set reference after constructed")
        self.reference = reference
        return self

    def set_categorical_feature(self, categorical_feature) -> "Dataset":
        """The categorical columns, by index or name (before the set is
        built, unless unchanged)."""
        if self._handle is not None and \
                categorical_feature != self.categorical_feature:
            raise LightGBMError(
                "cannot set categorical feature after constructed")
        self.categorical_feature = categorical_feature
        return self

    def get_feature_name(self) -> list:
        return list(self.construct()._handle.feature_names)

    def set_feature_name(self, feature_name) -> "Dataset":
        self.feature_name = feature_name
        if self._handle is not None and feature_name not in (None, "auto"):
            if len(feature_name) != self._handle.num_total_features:
                raise LightGBMError("length of feature names doesn't equal "
                                    "with num_feature")
            self._handle.feature_names = [str(f) for f in feature_name]
        return self

    def get_label(self):
        if self._handle is not None and \
                self._handle.metadata.label is not None:
            return np.asarray(self._handle.metadata.label)
        return None if self.label is None else _host_array(self.label)

    def get_weight(self):
        if self._handle is not None:
            w = self._handle.metadata.weights
            return None if w is None else np.asarray(w)
        return self.weight

    def get_init_score(self):
        if self._handle is not None:
            return self._handle.metadata.init_score
        return self.init_score

    def num_data(self) -> int:
        return self.construct()._handle.num_data

    def num_feature(self) -> int:
        return self.construct()._handle.num_total_features

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
            self._handle.metadata.set_query(_host_array(group))
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

    def update(self, train_set=None, fobj=None) -> bool:
        """One boosting iteration; True when training cannot continue.
        Drives ``GBDT.train_chunked``: one iteration takes the
        per-iteration path, and the driver keeps the bagging state right
        when fused chunks (``update_chunked``, ``engine.train``) and single
        updates mix.  With ``fobj(preds, train_set) -> (grad, hess)`` the
        iteration trains on the custom gradients, on the host learner
        (``lightgbm_tpu/basic.py:300-330``)."""
        if train_set is not None:
            raise LightGBMError("resetting training data mid-training is "
                                "not supported (nor in the JAX package)")
        if fobj is None:
            return self._gbdt.train_chunked(1)
        grad, hess = fobj(self._curr_pred_for_fobj(), self._train_set)
        return self._boost(grad, hess)

    def _curr_pred_for_fobj(self) -> np.ndarray:
        """The raw training scores for ``fobj``: (N,), or class-major
        rows flattened row by row for several models."""
        score = self._gbdt.train_score.double().cpu().numpy()
        if score.shape[0] == 1:
            return score[0]
        return score.T.reshape(-1)

    def _boost(self, grad, hess) -> bool:
        grad = np.asarray(grad, np.float32)
        hess = np.asarray(hess, np.float32)
        num_model = self._gbdt.num_model
        n = self._gbdt.num_data
        if grad.size != n * num_model or hess.size != n * num_model:
            raise LightGBMError(f"gradients size mismatch: {grad.size} != "
                                f"{n * num_model}")
        if num_model > 1:
            grad = grad.reshape(n, num_model).T
            hess = hess.reshape(n, num_model).T
        return self._gbdt.train_one_iter(grad, hess)

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

    def rollback_one_iter(self) -> "Booster":
        """Drop the last iteration's trees and take them out of the
        scores."""
        self._gbdt.rollback_one_iter()
        return self

    def num_model_per_iteration(self) -> int:
        return self._gbdt.num_model

    def set_train_data_name(self, name) -> "Booster":
        self._train_data_name = name
        return self

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
                pred_leaf=False, start_iteration=0, pred_contrib=False):
        """Predictions of iterations ``[start_iteration, start_iteration +
        num_iteration)`` (all from ``start_iteration`` when
        ``num_iteration <= 0``): converted or raw scores, or with
        ``pred_leaf`` each tree's leaf index.  A scipy sparse matrix is
        densified :data:`PREDICT_CHUNK_ROWS` rows at a time (the fork's
        harness predicts 20M-request windows from CSR); every chunk takes
        the route (kernel or host walk) of the whole batch's row count.
        ``pred_contrib``: the TreeSHAP contributions of the first
        ``num_iteration`` iterations, each row's last column the expected
        value, on the host in float64."""
        if isinstance(data, Dataset):
            raise TypeError("Cannot use Dataset instance for prediction, "
                            "please use raw data instead")
        if pred_contrib:
            return self._gbdt.predict(_to_2d_float(data),
                                      num_iteration=num_iteration,
                                      pred_contrib=True)
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

    def refit(self, data, label, decay_rate=0.9, **kwargs) -> "Booster":
        """A NEW Booster with this model's tree structure and leaf values
        refit against ``label`` on ``data`` with ``decay_rate`` (reference
        RefitTree, gbdt.cpp:265-288; ``GBDT.refit_leaves``).  This booster
        is left as it was: the copy is made through the model text.  The
        gradients run on ``params['device']`` (default ``cuda``)."""
        arr = _to_2d_float(data)
        new_booster = Booster(model_str=self.model_to_string(),
                              params=self.params)
        new_booster._gbdt.refit_leaves(arr, label, decay_rate=decay_rate)
        return new_booster

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

    def reset_parameter(self, params) -> "Booster":
        """Change parameters for the iterations to come
        (``lightgbm_tpu/basic.py::reset_parameter``).  The host learner
        takes every parameter it reads.  A booster on the device grower
        takes the learning rate and what only the host reads; any other
        change raises ``LightGBMError`` naming the parameters
        (``ops/grow.reset_refusals``): its captured tree holds their old
        values, which the JAX device grower would keep without a word."""
        new = {**self.params, **normalize_params(params)}
        cfg = Config(new)
        gb = self._gbdt
        if gb._grower is not None:
            refused = reset_refusals(gb.config, cfg)
            if refused:
                raise LightGBMError(
                    f"reset_parameter({', '.join(refused)}) on the device "
                    f"grower: its captured tree holds the old value; train "
                    f"a new booster, or use device_growth=off")
        self.params = new
        gb.config = cfg
        gb.shrinkage_rate = cfg.learning_rate
        if gb.learner is not None:
            from .ops.split import SplitHyper
            gb.learner.config = cfg
            gb.learner.hyper = SplitHyper.from_config(cfg)
        return self

    def __copy__(self) -> "Booster":
        return self.__deepcopy__(None)

    def __deepcopy__(self, memo) -> "Booster":
        """A new booster of this model's text and params (not trainable:
        it has no training set)."""
        return Booster(model_str=self.model_to_string(), params=self.params)

    def __getstate__(self) -> dict:
        return {"params": self.params, "model_str": self.model_to_string(),
                "best_iteration": self.best_iteration,
                "best_score": self.best_score}

    def __setstate__(self, state) -> None:
        """An unpickled booster loads the model text; it predicts on
        ``params['device']`` (default ``cuda``)."""
        self.params = state["params"]
        self.best_iteration = state["best_iteration"]
        self.best_score = state["best_score"]
        self._train_set = None
        self._gbdt = GBDT.load_model_from_string(state["model_str"],
                                                 Config(self.params))


def _feval_records(dataset_name, res):
    if isinstance(res, list):
        return [(dataset_name, n, v, b) for n, v, b in res]
    n, v, b = res
    return [(dataset_name, n, v, b)]
