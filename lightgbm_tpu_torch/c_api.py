"""``LGBM_*`` C-API compatibility layer of the port.

Counterpart of ``lightgbm_tpu/c_api.py``: the same 50 functions with the
same signatures, handle semantics, return codes and last-error text,
over this package's boosters and servers.  Training and serving run on
the parameter string's ``device`` (``device_type``), ``cuda`` by default.
The reference's compatibility contract is ``src/c_api.cpp`` /
``include/LightGBM/c_api.h:50-234,799-815``: opaque dataset/booster
handles, int return codes (0 ok, -1 failure + ``LGBM_GetLastError``),
caller-allocated output buffers.  The fork's cache-admission harness
consumes exactly this surface (``src/test.cpp:243-298``:
DatasetCreateFromCSR / DatasetSetField / BoosterCreate /
BoosterUpdateOneIter / BoosterPredictForCSR).

This module reproduces that surface Python-level so C-API-shaped client
code ports mechanically:

* handles are opaque ints managed by an internal registry — ``Free``
  really invalidates them, double-free raises through the error code;
* out-parameters are ``Ref`` cells (the ``ctypes.byref`` analog);
* array arguments are numpy arrays whose dtype must match the declared
  ``C_API_DTYPE_*`` constant, like the C layer's type switch;
* caller-allocated result buffers (``out_result``) are written in place.

Functions intentionally keep the reference's argument order, including
the ``parameters`` string argument, so a port is a transliteration.
"""
# torchlint: abi-header=../include/lightgbm_tpu/c_api.h
# (TL151 checks every declaration below against these defs' arities)

from __future__ import annotations

import functools
import json
import threading
from typing import Dict, Optional

import numpy as np

from .boosting import create_boosting
from .boosting.gbdt import GBDT
from .config import Config
from .data.dataset import BinnedDataset, Metadata
from .utils.log import LightGBMError

C_API_DTYPE_FLOAT32 = 0
C_API_DTYPE_FLOAT64 = 1
C_API_DTYPE_INT32 = 2
C_API_DTYPE_INT64 = 3

C_API_PREDICT_NORMAL = 0
C_API_PREDICT_RAW_SCORE = 1
C_API_PREDICT_LEAF_INDEX = 2
C_API_PREDICT_CONTRIB = 3

_DTYPE_MAP = {
    C_API_DTYPE_FLOAT32: np.float32,
    C_API_DTYPE_FLOAT64: np.float64,
    C_API_DTYPE_INT32: np.int32,
    C_API_DTYPE_INT64: np.int64,
}


class Ref:
    """Out-parameter cell — the ``ctypes.byref(x)`` analog."""

    __slots__ = ("value",)

    def __init__(self, value=None):
        self.value = value


_last_error = ""
# _last_error is process-global by C-API contract (LGBM_GetLastError);
# the embed path and user threads can fail concurrently, so the write is
# lock-guarded — a reader still sees whichever error landed last, but
# never a torn interpreter state
_ERROR_LOCK = threading.Lock()


def LGBM_GetLastError() -> str:
    return _last_error


def _api(fn):
    """C return-code convention: 0 ok, -1 failure + stored message."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        global _last_error
        try:
            fn(*args, **kwargs)
            return 0
        except Exception as e:   # noqa: BLE001 — the C API catches all
            with _ERROR_LOCK:
                _last_error = str(e)
            return -1
    return wrapper


# ---------------------------------------------------------------------------
# handle registry
# ---------------------------------------------------------------------------

class _DatasetEntry:
    __slots__ = ("binned", "config", "raw_params", "feature_names")

    def __init__(self, binned, config, raw_params):
        self.binned = binned
        self.config = config
        self.raw_params = raw_params
        self.feature_names = None


class _BoosterEntry:
    __slots__ = ("gbdt", "train", "valids", "custom_objective")

    def __init__(self, gbdt, train):
        self.gbdt = gbdt
        self.train = train
        self.valids = []
        self.custom_objective = False


class _ServeEntry:
    """A hot-swap PredictionServer behind an opaque handle
    (lightgbm_tpu extension — LGBM_Serve* functions)."""

    __slots__ = ("server",)

    def __init__(self, server):
        self.server = server


class _FleetEntry:
    """A multi-tenant FleetServer behind an opaque handle
    (lightgbm_tpu extension — LGBM_Fleet* functions)."""

    __slots__ = ("server",)

    def __init__(self, server):
        self.server = server


_handles: Dict[int, object] = {}
_next_handle = 1
# the serving setup is multi-threaded by design (PredictionServer micro-
# batch worker + harness threads), so handle allocation/free must not race
_HANDLES_LOCK = threading.Lock()


def _register(obj) -> int:
    global _next_handle
    with _HANDLES_LOCK:
        h = _next_handle
        _next_handle += 1
        _handles[h] = obj
    return h


def _unregister(handle) -> None:
    with _HANDLES_LOCK:
        del _handles[handle]


_HANDLE_KINDS = {_DatasetEntry: "Dataset", _BoosterEntry: "Booster",
                 _ServeEntry: "Serve", _FleetEntry: "Fleet"}


def _get(handle, cls):
    obj = _handles.get(handle)
    if not isinstance(obj, cls):
        kind = _HANDLE_KINDS.get(cls, "object")
        raise LightGBMError(f"invalid {kind} handle: {handle!r}")
    return obj


def _tokenize_params(parameters: Optional[str]) -> Dict[str, str]:
    """The C API's parameter format — space-separated key=value — as a
    raw dict.  The ONE tokenizer: `_parse_params` builds the Config
    from it, and explicit-key detection (LGBM_ServeCreate) reads its
    keys, so the two can never disagree."""
    kv: Dict[str, str] = {}
    if parameters:
        for tok in str(parameters).split():
            if "=" in tok:
                k, v = tok.split("=", 1)
                kv[k] = v
    return kv


def _parse_params(parameters: Optional[str]) -> Config:
    return Config(_tokenize_params(parameters))


def _check_array(arr, name, dtype_const, allowed):
    if dtype_const not in allowed:
        raise LightGBMError(f"unsupported dtype constant for {name}: "
                            f"{dtype_const}")
    want = _DTYPE_MAP[dtype_const]
    arr = np.asarray(arr)
    if arr.dtype != want:
        raise LightGBMError(
            f"{name} dtype {arr.dtype} does not match declared "
            f"C_API_DTYPE constant ({np.dtype(want)})")
    return arr


# ---------------------------------------------------------------------------
# Dataset functions (c_api.h:50-335)
# ---------------------------------------------------------------------------

@_api
def LGBM_DatasetCreateFromFile(filename, parameters, reference, out: Ref):
    cfg = _parse_params(parameters)
    ref = _get(reference, _DatasetEntry).binned if reference else None
    from .cli import _load_dataset
    binned = _load_dataset(str(filename), cfg, reference=ref)
    out.value = _register(_DatasetEntry(binned, cfg, parameters))


@_api
def LGBM_DatasetCreateFromMat(data, data_type, nrow, ncol, is_row_major,
                              parameters, reference, out: Ref):
    data = _check_array(data, "data", data_type,
                        (C_API_DTYPE_FLOAT32, C_API_DTYPE_FLOAT64))
    mat = np.asarray(data).reshape(
        (nrow, ncol) if is_row_major else (ncol, nrow))
    if not is_row_major:
        mat = mat.T
    cfg = _parse_params(parameters)
    ref = _get(reference, _DatasetEntry).binned if reference else None
    binned = BinnedDataset.construct_from_matrix(
        np.ascontiguousarray(mat, np.float64), cfg, reference=ref)
    out.value = _register(_DatasetEntry(binned, cfg, parameters))


@_api
def LGBM_DatasetCreateFromCSR(indptr, indptr_type, indices, data, data_type,
                              nindptr, nelem, num_col, parameters,
                              reference, out: Ref):
    indptr = _check_array(indptr, "indptr", indptr_type,
                          (C_API_DTYPE_INT32, C_API_DTYPE_INT64))
    data = _check_array(data, "data", data_type,
                        (C_API_DTYPE_FLOAT32, C_API_DTYPE_FLOAT64))
    indices = np.asarray(indices, np.int32)
    if len(indptr) != nindptr:
        raise LightGBMError("nindptr does not match indptr length")
    cfg = _parse_params(parameters)
    ref = _get(reference, _DatasetEntry).binned if reference else None
    binned = BinnedDataset.construct_from_csr(
        indptr[:nindptr], indices[:nelem],
        np.asarray(data[:nelem], np.float64), int(num_col), cfg,
        reference=ref)
    out.value = _register(_DatasetEntry(binned, cfg, parameters))


@_api
def LGBM_DatasetGetSubset(handle, used_row_indices, num_used_row_indices,
                          parameters, out: Ref):
    entry = _get(handle, _DatasetEntry)
    idx = np.asarray(used_row_indices, np.int32)[:num_used_row_indices]
    sub = entry.binned.copy_subset(idx)
    out.value = _register(_DatasetEntry(sub, entry.config, parameters))


@_api
def LGBM_DatasetSetFeatureNames(handle, feature_names, num_feature_names):
    entry = _get(handle, _DatasetEntry)
    names = [str(feature_names[i]) for i in range(num_feature_names)]
    entry.binned.feature_names = names
    entry.feature_names = names


@_api
def LGBM_DatasetGetFeatureNames(handle, out_strs: Ref, out_len: Ref):
    entry = _get(handle, _DatasetEntry)
    names = list(entry.binned.feature_names)
    out_strs.value = names
    out_len.value = len(names)


@_api
def LGBM_DatasetFree(handle):
    _get(handle, _DatasetEntry)
    _unregister(handle)


@_api
def LGBM_DatasetSaveBinary(handle, filename):
    _get(handle, _DatasetEntry).binned.save_binary(str(filename))


@_api
def LGBM_DatasetSetField(handle, field_name, field_data, num_element,
                         type_):
    entry = _get(handle, _DatasetEntry)
    md = entry.binned.metadata
    if md is None:
        md = entry.binned.metadata = Metadata(entry.binned.num_data)
    name = str(field_name)
    if name in ("label", "weight"):
        data = _check_array(field_data, name, type_,
                            (C_API_DTYPE_FLOAT32,))[:num_element]
        (md.set_label if name == "label" else md.set_weights)(
            np.asarray(data, np.float64))
    elif name in ("group", "query"):
        data = _check_array(field_data, name, type_,
                            (C_API_DTYPE_INT32,))[:num_element]
        md.set_query(np.asarray(data))
    elif name == "init_score":
        data = _check_array(field_data, name, type_,
                            (C_API_DTYPE_FLOAT64,))[:num_element]
        md.set_init_score(np.asarray(data, np.float64))
    else:
        raise LightGBMError(f"unknown field name: {name}")


@_api
def LGBM_DatasetGetField(handle, field_name, out_len: Ref, out_ptr: Ref,
                         out_type: Ref):
    md = _get(handle, _DatasetEntry).binned.metadata
    name = str(field_name)
    if md is None:
        raise LightGBMError("dataset has no metadata")
    if name == "label":
        arr, t = md.label, C_API_DTYPE_FLOAT32
        arr = None if arr is None else np.asarray(arr, np.float32)
    elif name == "weight":
        arr, t = md.weights, C_API_DTYPE_FLOAT32
        arr = None if arr is None else np.asarray(arr, np.float32)
    elif name in ("group", "query"):
        arr, t = md.query_boundaries, C_API_DTYPE_INT32
        arr = None if arr is None else np.asarray(arr, np.int32)
    elif name == "init_score":
        arr, t = md.init_score, C_API_DTYPE_FLOAT64
        arr = None if arr is None else np.asarray(arr, np.float64)
    else:
        raise LightGBMError(f"unknown field name: {name}")
    if arr is None:
        raise LightGBMError(f"field {name} is not set")
    out_ptr.value = arr
    out_len.value = len(arr)
    out_type.value = t


@_api
def LGBM_DatasetGetNumData(handle, out: Ref):
    out.value = int(_get(handle, _DatasetEntry).binned.num_data)


@_api
def LGBM_DatasetGetNumFeature(handle, out: Ref):
    out.value = int(_get(handle, _DatasetEntry).binned.num_total_features)


# ---------------------------------------------------------------------------
# Booster functions (c_api.h:341-797)
# ---------------------------------------------------------------------------

@_api
def LGBM_BoosterCreate(train_data, parameters, out: Ref):
    entry = _get(train_data, _DatasetEntry)
    cfg = _parse_params(parameters)
    gbdt = create_boosting(cfg)
    gbdt.init_train(entry.binned)
    out.value = _register(_BoosterEntry(gbdt, entry))


@_api
def LGBM_BoosterCreateFromModelfile(filename, out_num_iterations: Ref,
                                    out: Ref):
    gbdt = GBDT.load_model_from_file(str(filename))
    out_num_iterations.value = gbdt.num_iterations()
    out.value = _register(_BoosterEntry(gbdt, None))


@_api
def LGBM_BoosterLoadModelFromString(model_str, out_num_iterations: Ref,
                                    out: Ref):
    gbdt = GBDT.load_model_from_string(str(model_str))
    out_num_iterations.value = gbdt.num_iterations()
    out.value = _register(_BoosterEntry(gbdt, None))


@_api
def LGBM_BoosterFree(handle):
    """Free the booster; its device grower goes back to the grower cache,
    idle, for the next booster of equal shapes (``grower_cache``)."""
    _get(handle, _BoosterEntry).gbdt.release_grower()
    _unregister(handle)


@_api
def LGBM_BoosterAddValidData(handle, valid_data):
    b = _get(handle, _BoosterEntry)
    v = _get(valid_data, _DatasetEntry)
    b.gbdt.add_valid(v.binned, f"valid_{len(b.valids)}")
    b.valids.append(v)


@_api
def LGBM_BoosterGetNumClasses(handle, out_len: Ref):
    out_len.value = max(
        int(_get(handle, _BoosterEntry).gbdt.config.num_class), 1)


@_api
def LGBM_BoosterUpdateOneIter(handle, is_finished: Ref):
    b = _get(handle, _BoosterEntry)
    # unified driver: a 1-iteration chunk takes the per-iteration device
    # path but keeps bagging state consistent with fused chunks
    is_finished.value = 1 if b.gbdt.train_chunked(1) else 0


@_api
def LGBM_BoosterUpdateChunked(handle, n_iters, chunk, is_finished: Ref):
    """lightgbm_tpu extension (not in the reference ABI): train
    ``n_iters`` boosting iterations in fused chunks of up to ``chunk``
    trees, each tree one launch of its captured graph
    (``GBDT.train_chunked``).  The windowed retrain harness replaces its
    UpdateOneIter loop with ONE call per window."""
    b = _get(handle, _BoosterEntry)
    is_finished.value = 1 if b.gbdt.train_chunked(int(n_iters),
                                                  chunk=int(chunk)) else 0


@_api
def LGBM_BoosterUpdateOneIterCustom(handle, grad, hess, is_finished: Ref):
    b = _get(handle, _BoosterEntry)
    grad = np.asarray(grad, np.float32)
    hess = np.asarray(hess, np.float32)
    is_finished.value = 1 if b.gbdt.train_one_iter(grad, hess) else 0


@_api
def LGBM_BoosterRollbackOneIter(handle):
    _get(handle, _BoosterEntry).gbdt.rollback_one_iter()


@_api
def LGBM_BoosterGetCurrentIteration(handle, out_iteration: Ref):
    out_iteration.value = _get(handle, _BoosterEntry).gbdt.num_iterations()


@_api
def LGBM_BoosterNumModelPerIteration(handle, out_tree_per_iteration: Ref):
    out_tree_per_iteration.value = _get(handle, _BoosterEntry).gbdt.num_model


@_api
def LGBM_BoosterNumberOfTotalModel(handle, out_models: Ref):
    out_models.value = len(_get(handle, _BoosterEntry).gbdt.models)


@_api
def LGBM_BoosterGetEvalCounts(handle, out_len: Ref):
    b = _get(handle, _BoosterEntry)
    out_len.value = len(b.gbdt.train_metrics)


@_api
def LGBM_BoosterGetEvalNames(handle, out_len: Ref, out_strs: Ref):
    b = _get(handle, _BoosterEntry)
    names = [m.name for m in b.gbdt.train_metrics]
    out_strs.value = names
    out_len.value = len(names)


@_api
def LGBM_BoosterGetEval(handle, data_idx, out_len: Ref, out_results):
    """data_idx 0 = training data, >=1 = validation sets (c_api.cpp)."""
    b = _get(handle, _BoosterEntry)
    if data_idx == 0:
        res = b.gbdt.eval_train()
    else:
        allv = b.gbdt.eval_valid()
        name = f"valid_{data_idx - 1}"
        res = [r for r in allv if r[0] == name]
    vals = [v for (_, _, v, _) in res]
    out_results[:len(vals)] = vals
    out_len.value = len(vals)


def _num_preds(gbdt, nrow, predict_type, num_iteration):
    total_iter = gbdt.num_iterations()
    it = total_iter if num_iteration <= 0 else min(num_iteration,
                                                   total_iter)
    if predict_type == C_API_PREDICT_LEAF_INDEX:
        return nrow * gbdt.num_model * it
    if predict_type == C_API_PREDICT_CONTRIB:
        return nrow * gbdt.num_model * (gbdt.max_feature_idx + 2)
    return nrow * gbdt.num_model


@_api
def LGBM_BoosterCalcNumPredict(handle, num_row, predict_type,
                               num_iteration, out_len: Ref):
    b = _get(handle, _BoosterEntry)
    out_len.value = _num_preds(b.gbdt, num_row, predict_type,
                               num_iteration)


def _predict_dense(gbdt, mat, predict_type, num_iteration, out_len: Ref,
                   out_result):
    if predict_type == C_API_PREDICT_LEAF_INDEX:
        res = gbdt.predict(mat, num_iteration=num_iteration,
                           pred_leaf=True)
    elif predict_type == C_API_PREDICT_CONTRIB:
        res = gbdt.predict(mat, num_iteration=num_iteration,
                           pred_contrib=True)
    elif predict_type == C_API_PREDICT_RAW_SCORE:
        res = gbdt.predict(mat, num_iteration=num_iteration,
                           raw_score=True)
    else:
        res = gbdt.predict(mat, num_iteration=num_iteration)
    flat = np.asarray(res, np.float64).reshape(-1)
    out_result[:len(flat)] = flat
    out_len.value = len(flat)


@_api
def LGBM_BoosterPredictForMat(handle, data, data_type, nrow, ncol,
                              is_row_major, predict_type, num_iteration,
                              parameter, out_len: Ref, out_result):
    b = _get(handle, _BoosterEntry)
    data = _check_array(data, "data", data_type,
                        (C_API_DTYPE_FLOAT32, C_API_DTYPE_FLOAT64))
    mat = np.asarray(data).reshape(
        (nrow, ncol) if is_row_major else (ncol, nrow))
    if not is_row_major:
        mat = mat.T
    _predict_dense(b.gbdt, np.asarray(mat, np.float64), predict_type,
                   num_iteration, out_len, out_result)


def _densify_csr(indptr, indptr_type, indices, data, data_type, nindptr,
                 num_col) -> np.ndarray:
    indptr = _check_array(indptr, "indptr", indptr_type,
                          (C_API_DTYPE_INT32, C_API_DTYPE_INT64))
    data = _check_array(data, "data", data_type,
                        (C_API_DTYPE_FLOAT32, C_API_DTYPE_FLOAT64))
    indices = np.asarray(indices, np.int32)
    nrow = int(nindptr) - 1
    mat = np.zeros((nrow, int(num_col)), np.float64)
    counts = np.diff(np.asarray(indptr[:nrow + 1], np.int64))
    rows = np.repeat(np.arange(nrow, dtype=np.int64), counts)
    nnz = len(rows)
    mat[rows, indices[:nnz]] = np.asarray(data[:nnz], np.float64)
    return mat


@_api
def LGBM_BoosterPredictForCSR(handle, indptr, indptr_type, indices, data,
                              data_type, nindptr, nelem, num_col,
                              predict_type, num_iteration, parameter,
                              out_len: Ref, out_result):
    b = _get(handle, _BoosterEntry)
    mat = _densify_csr(indptr, indptr_type, indices, data, data_type,
                       nindptr, num_col)
    _predict_dense(b.gbdt, mat, predict_type, num_iteration, out_len,
                   out_result)


@_api
def LGBM_BoosterSaveModel(handle, start_iteration, num_iteration,
                          filename):
    _get(handle, _BoosterEntry).gbdt.save_model_to_file(
        str(filename), start_iteration, num_iteration)


@_api
def LGBM_BoosterSaveModelToString(handle, start_iteration, num_iteration,
                                  buffer_len, out_len: Ref, out_str: Ref):
    s = _get(handle, _BoosterEntry).gbdt.model_to_string(
        start_iteration, num_iteration)
    out_str.value = s
    out_len.value = len(s) + 1


@_api
def LGBM_BoosterDumpModel(handle, start_iteration, num_iteration,
                          buffer_len, out_len: Ref, out_str: Ref):
    b = _get(handle, _BoosterEntry)
    b.gbdt._flush_pending()
    dump = {
        "name": "tree",
        "version": "v2",
        "num_class": max(int(b.gbdt.config.num_class), 1),
        "num_tree_per_iteration": b.gbdt.num_model,
        "label_index": 0,
        "max_feature_idx": b.gbdt.max_feature_idx,
        "feature_names": list(b.gbdt.feature_names),
        "tree_info": [t.to_json() for t in b.gbdt.models],
    }
    s = json.dumps(dump)
    out_str.value = s
    out_len.value = len(s) + 1


@_api
def LGBM_BoosterFeatureImportance(handle, num_iteration, importance_type,
                                  out_results):
    b = _get(handle, _BoosterEntry)
    imp = b.gbdt.feature_importance(
        "split" if importance_type == 0 else "gain", num_iteration)
    out_results[:len(imp)] = imp


# ---------------------------------------------------------------------------
# Prediction-server functions (lightgbm_tpu extension, not in the
# reference ABI): a hot-swap packed-ensemble predictor behind an opaque
# handle, so the windowed harness scores every request against the
# CURRENT model and atomically replaces it after each retrain
# (docs/Serving.md).
# ---------------------------------------------------------------------------


@_api
def LGBM_ServeCreate(booster_handle, parameters, out: Ref):
    """Create a PredictionServer seeded from a booster, on ``device``.
    Recognized parameters: ``num_iteration_predict`` (served tree slice),
    ``device_predict_min_rows`` (the warm-up ladder) and the pass-through
    extras ``serve_max_batch`` / ``serve_max_wait_ms`` (micro-batching
    queue configuration)."""
    b = _get(booster_handle, _BoosterEntry)
    cfg = _parse_params(parameters)
    from .config import resolve_alias
    from .serve import PredictionServer
    # only an EXPLICIT device_predict_min_rows overrides the server's
    # adopt-from-booster default (the schema default would mask it)
    explicit = {resolve_alias(k) for k in _tokenize_params(parameters)}
    min_rows = (int(cfg.device_predict_min_rows)
                if "device_predict_min_rows" in explicit else None)
    server = PredictionServer(
        b.gbdt, device=cfg.device_type,
        num_iteration=int(getattr(cfg, "num_iteration_predict", -1)),
        max_batch=int(cfg.extra.get("serve_max_batch", 8192)),
        max_wait_ms=float(cfg.extra.get("serve_max_wait_ms", 2.0)),
        device_predict_min_rows=min_rows)
    out.value = _register(_ServeEntry(server))


@_api
def LGBM_ServeSwap(serve_handle, booster_handle):
    """Atomically point the server at ``booster_handle``'s current
    model (the retrain-window hand-off)."""
    s = _get(serve_handle, _ServeEntry)
    b = _get(booster_handle, _BoosterEntry)
    s.server.swap(b.gbdt)


@_api
def LGBM_ServeCalcNumPredict(serve_handle, num_row, out_len: Ref):
    s = _get(serve_handle, _ServeEntry)
    out_len.value = int(num_row) * s.server.packed.num_model


@_api
def LGBM_ServePredictForCSR(serve_handle, indptr, indptr_type, indices,
                            data, data_type, nindptr, nelem, num_col,
                            predict_type, out_len: Ref, out_result):
    """Score CSR rows against the server's CURRENT model in one kernel
    launch.  Supports NORMAL and RAW_SCORE predict types."""
    s = _get(serve_handle, _ServeEntry)
    if predict_type not in (C_API_PREDICT_NORMAL,
                            C_API_PREDICT_RAW_SCORE):
        raise LightGBMError("LGBM_ServePredictForCSR supports NORMAL "
                            "and RAW_SCORE predict types only")
    mat = _densify_csr(indptr, indptr_type, indices, data, data_type,
                       nindptr, num_col)
    res = s.server.predict(
        mat, raw_score=(predict_type == C_API_PREDICT_RAW_SCORE))
    flat = np.asarray(res, np.float64).reshape(-1)
    out_result[:len(flat)] = flat
    out_len.value = len(flat)


@_api
def LGBM_ServeFree(serve_handle):
    _get(serve_handle, _ServeEntry).server.stop()
    _unregister(serve_handle)


# ---------------------------------------------------------------------------
# Model-fleet functions (lightgbm_tpu extension, not in the reference
# ABI): M tenants stacked into one packed array family behind an opaque
# handle — one forest-kernel launch serves any (tenant_ids, rows) batch,
# a tenant retrain hands off through an index copy.
# ---------------------------------------------------------------------------


@_api
def LGBM_FleetCreate(booster_handle, num_tenants, parameters, out: Ref):
    """Create a FleetServer with ``num_tenants`` tenants, all seeded
    from ``booster_handle``'s current model (specialize them afterwards
    with LGBM_FleetSwapTenant).  Recognized parameters:
    ``num_iteration_predict`` (served slice), ``serve_replicas``,
    ``fleet_value_dtype`` and the pass-through extras
    ``serve_max_batch`` / ``serve_max_wait_ms``."""
    b = _get(booster_handle, _BoosterEntry)
    cfg = _parse_params(parameters)
    from .serve import FleetServer
    m = int(num_tenants)
    if m < 1:
        raise LightGBMError(f"num_tenants must be >= 1, got {m}")
    server = FleetServer(
        [b.gbdt] * m, device=cfg.device_type,
        num_iteration=int(getattr(cfg, "num_iteration_predict", -1)),
        replicas=int(getattr(cfg, "serve_replicas", 1)),
        value_dtype=str(getattr(cfg, "fleet_value_dtype", "f32")),
        max_batch=int(cfg.extra.get("serve_max_batch", 8192)),
        max_wait_ms=float(cfg.extra.get("serve_max_wait_ms", 2.0)))
    out.value = _register(_FleetEntry(server))


@_api
def LGBM_FleetSwapTenant(fleet_handle, tenant_id, booster_handle):
    """Atomically point ONE tenant at ``booster_handle``'s current
    model (the per-tenant retrain-window hand-off); the other tenants
    keep serving throughout."""
    f = _get(fleet_handle, _FleetEntry)
    b = _get(booster_handle, _BoosterEntry)
    f.server.swap_tenant(int(tenant_id), b.gbdt)


@_api
def LGBM_FleetCalcNumPredict(fleet_handle, num_row, out_len: Ref):
    f = _get(fleet_handle, _FleetEntry)
    out_len.value = int(num_row) * f.server.fleet.num_model


@_api
def LGBM_FleetPredictForCSR(fleet_handle, tenant_ids, num_tenant_ids,
                            indptr, indptr_type, indices, data,
                            data_type, nindptr, nelem, num_col,
                            predict_type, out_len: Ref, out_result):
    """Score CSR rows against the fleet in one kernel launch.
    ``tenant_ids`` is an int32 array routing each row to its tenant;
    ``num_tenant_ids == 1`` broadcasts one tenant to the whole batch.
    Supports NORMAL and RAW_SCORE predict types."""
    f = _get(fleet_handle, _FleetEntry)
    if predict_type not in (C_API_PREDICT_NORMAL,
                            C_API_PREDICT_RAW_SCORE):
        raise LightGBMError("LGBM_FleetPredictForCSR supports NORMAL "
                            "and RAW_SCORE predict types only")
    tids = np.asarray(tenant_ids, np.int32).reshape(-1)
    n_ids = int(num_tenant_ids)
    tids = tids[:n_ids] if n_ids > 1 else int(tids[0])
    mat = _densify_csr(indptr, indptr_type, indices, data, data_type,
                       nindptr, num_col)
    res = f.server.predict(
        tids, mat, raw_score=(predict_type == C_API_PREDICT_RAW_SCORE))
    flat = np.asarray(res, np.float64).reshape(-1)
    out_result[:len(flat)] = flat
    out_len.value = len(flat)


@_api
def LGBM_FleetFree(fleet_handle):
    _get(fleet_handle, _FleetEntry).server.stop()
    _unregister(fleet_handle)


# ---------------------------------------------------------------------------
# Warm-up functions (lightgbm_tpu extension, not in the reference ABI):
# build a deployment's kernel libraries into the build cache
# (compile_cache_dir / LGBM_TPU_COMPILE_CACHE) and capture its graphs
# into the grower cache, so the first real retrain window and the first
# large predict batch run warm.  The harness calls these once at start,
# before the request loop.
# ---------------------------------------------------------------------------


@_api
def LGBM_WarmupTrain(parameters, num_row, num_feature,
                     out_num_compiled: Ref):
    """Drive the real training path on a synthetic (num_row,
    num_feature) dataset long enough to build every kernel and capture
    every graph a run with ``parameters`` uses (one fused chunk and any
    per-iteration remainder); the grower stays idle in the grower cache.
    ``parameters`` should include ``compile_cache_dir`` (or export
    LGBM_TPU_COMPILE_CACHE) and the training params.  Returns the number
    of kernel libraries built fresh (0 = already built)."""
    from .warmup import warmup_train
    cfg = _parse_params(parameters)
    report = warmup_train(int(num_row), int(num_feature), config=cfg)
    out_num_compiled.value = int(report["cache_misses"])


@_api
def LGBM_WarmupServe(parameters, num_row, num_feature,
                     out_num_compiled: Ref):
    """Build the forest kernel and run it for the declared serving
    deployment (``num_iterations``/``num_leaves``/``num_class`` from
    ``parameters``) at ``num_row`` rows; ``num_row`` <= 0 runs the
    PredictionServer default buckets (128/1024/8192 + the
    ``device_predict_min_rows`` bucket).  Returns the number of kernel
    libraries built fresh."""
    from .warmup import warmup_serve
    cfg = _parse_params(parameters)
    rows = [int(num_row)] if int(num_row) > 0 else []
    report = warmup_serve(rows, int(num_feature), config=cfg)
    out_num_compiled.value = int(report["cache_misses"])


# ---------------------------------------------------------------------------
# Network functions (c_api.h:799-815)
# ---------------------------------------------------------------------------

_network_conf = {"num_machines": 1, "rank": 0}
_NETWORK_LOCK = threading.Lock()


@_api
def LGBM_NetworkInit(machines, local_listen_port, listen_time_out,
                     num_machines):
    """Records the topology request, as the JAX package does, so ported
    clients keep working.  ``num_machines > 1`` in the training parameters
    selects the parallel learners over this process's devices
    (``parallel/``); several processes train one model under
    ``data_sharding=multi_controller`` (``ops/shard.py``)."""
    with _NETWORK_LOCK:
        _network_conf["num_machines"] = int(num_machines)
        _network_conf["rank"] = 0


@_api
def LGBM_NetworkFree():
    with _NETWORK_LOCK:
        _network_conf["num_machines"] = 1
        _network_conf["rank"] = 0
