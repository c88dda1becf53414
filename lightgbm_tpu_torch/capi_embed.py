"""Flat adapters for the native ``liblgbm_tpu_torch`` shared library.

Counterpart of ``lightgbm_tpu/capi_embed.py``.  ``src/capi_cuda/
lgbm_capi.cpp`` embeds CPython and calls these functions to implement the
fork's C/C++ ABI (``include/lightgbm_tpu/c_api.h``): each adapter takes
memoryviews over the CALLER'S buffers plus plain ints/strings, forwards
to the ``c_api.py`` compatibility layer, and RAISES on failure — the C++
layer converts the exception into the C return-code convention (0 ok /
-1 + message via ``LGBM_GetLastError``).

Zero-copy discipline: input pointers arrive as read-only memoryviews
(``np.frombuffer`` wraps them without copying); prediction output is
written directly into the caller's pre-allocated buffer through a
writable memoryview.

Telemetry: importing this module initialises :mod:`lightgbm_tpu_torch.
obs`, which reads ``LGBM_TPU_METRICS`` / ``LGBM_TPU_TRACE`` — so the native
windowed harness gets per-window retrain spans, capture counts, grower
cache hits and memory peaks by exporting two env vars, no C++ change.
Each ``booster_create`` marks a retrain window boundary.  With telemetry
on, every call records the kernels' launch counts as gauges
(``hist_cuda.wave_hist.launches``, ``packed.forest_predict.launches``
and its routes), and the metrics file is written after every
``booster_update_chunked`` and ``*_free`` and by :func:`flush`, which the library calls at process exit (the embedded
interpreter is never finalized, so Python's own exit hooks never run).
"""
# torchlint: abi-header=../include/lightgbm_tpu/c_api.h
# torchlint: abi-impl=../src/capi_cuda/lgbm_capi.cpp
# (TL151 cross-checks header<->cpp parity, every call_adapter name and
# Py_BuildValue format against the adapters below, and each forwarded
# _call(C.LGBM_*, ...) against the header's arity and parameter order)

from __future__ import annotations

import numpy as np

from . import c_api as C
from . import compile_cache
from . import obs

# the kernel libraries' build directory: the native harness exports
# LGBM_TPU_COMPILE_CACHE=<dir> and a restarted harness finds them built
# (the LGBM_WarmupTrain/LGBM_WarmupServe ABI calls fill the same dir)
compile_cache.configure_from_env()


def _arr(mv, dtype_const):
    return np.frombuffer(mv, dtype=C._DTYPE_MAP[dtype_const])


def _record_launches() -> None:
    """The kernels' launch counts of this process, as gauges (reading the
    device counter waits for the card)."""
    from .ops import hist_cuda
    from .serve import packed
    obs.set_gauge("hist_cuda.wave_hist.launches",
                  hist_cuda.wave_hist.launches.read())
    obs.set_gauge("hist_cuda.wave_hist_rows.launches",
                  hist_cuda.wave_hist_rows.launches.read())
    obs.set_gauge("packed.forest_predict.launches",
                  packed.forest_predict.launches)
    for route, n in packed.forest_predict.routes.items():
        obs.set_gauge(f"packed.forest_predict.routes.{route}", n)


def _call(fn, *args):
    rc = fn(*args)
    if obs.enabled():
        _record_launches()
    if rc != 0:
        raise RuntimeError(C.LGBM_GetLastError())


def flush() -> None:
    """Write the telemetry files (the library calls this at exit)."""
    obs.flush()


def _free(fn, handle) -> None:
    _call(fn, handle)
    obs.flush()


def dataset_from_csr(indptr_mv, indptr_type, indices_mv, data_mv,
                     data_type, nindptr, nelem, num_col, params,
                     ref_handle):
    out = C.Ref()
    with obs.span("capi.dataset_from_csr", cat="capi",
                  rows=int(nindptr) - 1):
        _call(C.LGBM_DatasetCreateFromCSR,
              _arr(indptr_mv, indptr_type), indptr_type,
              _arr(indices_mv, C.C_API_DTYPE_INT32),
              _arr(data_mv, data_type), data_type,
              int(nindptr), int(nelem), int(num_col), params,
              ref_handle or None, out)
    return int(out.value)


def dataset_from_mat(data_mv, data_type, nrow, ncol, is_row_major,
                     params, ref_handle):
    out = C.Ref()
    _call(C.LGBM_DatasetCreateFromMat, _arr(data_mv, data_type),
          data_type, int(nrow), int(ncol), int(is_row_major), params,
          ref_handle or None, out)
    return int(out.value)


def dataset_set_field(handle, field_name, field_mv, num_element, type_):
    _call(C.LGBM_DatasetSetField, handle, field_name,
          _arr(field_mv, type_), int(num_element), type_)


def dataset_num_data(handle):
    out = C.Ref()
    _call(C.LGBM_DatasetGetNumData, handle, out)
    return int(out.value)


def dataset_free(handle):
    _free(C.LGBM_DatasetFree, handle)


def booster_create(train_handle, params):
    out = C.Ref()
    # each fresh booster is one retrain window in the LRB-style harness
    obs.inc("capi.retrain_windows")
    with obs.span("capi.booster_create", cat="capi"):
        _call(C.LGBM_BoosterCreate, train_handle, params, out)
    return int(out.value)


def booster_free(handle):
    _free(C.LGBM_BoosterFree, handle)


def booster_update_one_iter(handle):
    fin = C.Ref()
    with obs.span("capi.update_one_iter", cat="capi"):
        _call(C.LGBM_BoosterUpdateOneIter, handle, fin)
    return int(fin.value)


def booster_update_chunked(handle, n_iters, chunk):
    fin = C.Ref()
    with obs.span("capi.update_chunked", cat="capi",
                  n_iters=int(n_iters), chunk=int(chunk)):
        _call(C.LGBM_BoosterUpdateChunked, handle, int(n_iters),
              int(chunk), fin)
    obs.flush()
    return int(fin.value)


def booster_calc_num_predict(handle, num_row, predict_type,
                             num_iteration):
    out = C.Ref()
    _call(C.LGBM_BoosterCalcNumPredict, handle, int(num_row),
          predict_type, num_iteration, out)
    return int(out.value)


def booster_predict_for_csr(handle, indptr_mv, indptr_type, indices_mv,
                            data_mv, data_type, nindptr, nelem, num_col,
                            predict_type, num_iteration, params, out_mv):
    out_len = C.Ref()
    out_arr = np.frombuffer(out_mv, np.float64)
    with obs.span("capi.predict_for_csr", cat="capi",
                  rows=int(nindptr) - 1):
        _call(C.LGBM_BoosterPredictForCSR, handle,
              _arr(indptr_mv, indptr_type), indptr_type,
              _arr(indices_mv, C.C_API_DTYPE_INT32),
              _arr(data_mv, data_type), data_type,
              int(nindptr), int(nelem), int(num_col), predict_type,
              num_iteration, params, out_len, out_arr)
    return int(out_len.value)


def serve_create(booster_handle, params):
    out = C.Ref()
    with obs.span("capi.serve_create", cat="capi"):
        _call(C.LGBM_ServeCreate, booster_handle, params, out)
    return int(out.value)


def serve_swap(serve_handle, booster_handle):
    # one swap per retrain window: the server atomically adopts the
    # freshly trained booster's packed ensemble
    with obs.span("capi.serve_swap", cat="capi"):
        _call(C.LGBM_ServeSwap, serve_handle, booster_handle)


def serve_calc_num_predict(serve_handle, num_row):
    out = C.Ref()
    _call(C.LGBM_ServeCalcNumPredict, serve_handle, int(num_row), out)
    return int(out.value)


def serve_predict_for_csr(serve_handle, indptr_mv, indptr_type,
                          indices_mv, data_mv, data_type, nindptr,
                          nelem, num_col, predict_type, out_mv):
    out_len = C.Ref()
    out_arr = np.frombuffer(out_mv, np.float64)
    with obs.span("capi.serve_predict_for_csr", cat="capi",
                  rows=int(nindptr) - 1):
        _call(C.LGBM_ServePredictForCSR, serve_handle,
              _arr(indptr_mv, indptr_type), indptr_type,
              _arr(indices_mv, C.C_API_DTYPE_INT32),
              _arr(data_mv, data_type), data_type,
              int(nindptr), int(nelem), int(num_col), predict_type,
              out_len, out_arr)
    return int(out_len.value)


def serve_free(serve_handle):
    _free(C.LGBM_ServeFree, serve_handle)


def fleet_create(booster_handle, num_tenants, params):
    out = C.Ref()
    with obs.span("capi.fleet_create", cat="capi",
                  tenants=int(num_tenants)):
        _call(C.LGBM_FleetCreate, booster_handle, int(num_tenants),
              params, out)
    return int(out.value)


def fleet_swap_tenant(fleet_handle, tenant_id, booster_handle):
    # one per-tenant swap per retrain window: the fleet index-writes the
    # freshly trained booster while the other tenants keep serving
    with obs.span("capi.fleet_swap_tenant", cat="capi",
                  tenant=int(tenant_id)):
        _call(C.LGBM_FleetSwapTenant, fleet_handle, int(tenant_id),
              booster_handle)


def fleet_calc_num_predict(fleet_handle, num_row):
    out = C.Ref()
    _call(C.LGBM_FleetCalcNumPredict, fleet_handle, int(num_row), out)
    return int(out.value)


def fleet_predict_for_csr(fleet_handle, tenant_ids_mv, num_tenant_ids,
                          indptr_mv, indptr_type, indices_mv, data_mv,
                          data_type, nindptr, nelem, num_col,
                          predict_type, out_mv):
    out_len = C.Ref()
    out_arr = np.frombuffer(out_mv, np.float64)
    with obs.span("capi.fleet_predict_for_csr", cat="capi",
                  rows=int(nindptr) - 1):
        _call(C.LGBM_FleetPredictForCSR, fleet_handle,
              _arr(tenant_ids_mv, C.C_API_DTYPE_INT32),
              int(num_tenant_ids),
              _arr(indptr_mv, indptr_type), indptr_type,
              _arr(indices_mv, C.C_API_DTYPE_INT32),
              _arr(data_mv, data_type), data_type,
              int(nindptr), int(nelem), int(num_col), predict_type,
              out_len, out_arr)
    return int(out_len.value)


def fleet_free(fleet_handle):
    _free(C.LGBM_FleetFree, fleet_handle)


def warmup_train(params, num_row, num_feature):
    out = C.Ref()
    with obs.span("capi.warmup_train", cat="capi", rows=int(num_row)):
        _call(C.LGBM_WarmupTrain, params, int(num_row),
              int(num_feature), out)
    return int(out.value)


def warmup_serve(params, num_row, num_feature):
    out = C.Ref()
    with obs.span("capi.warmup_serve", cat="capi", rows=int(num_row)):
        _call(C.LGBM_WarmupServe, params, int(num_row),
              int(num_feature), out)
    return int(out.value)


def booster_save_model(handle, start_iteration, num_iteration, filename):
    _call(C.LGBM_BoosterSaveModel, handle, start_iteration,
          num_iteration, filename)


def booster_current_iteration(handle):
    out = C.Ref()
    _call(C.LGBM_BoosterGetCurrentIteration, handle, out)
    return int(out.value)
