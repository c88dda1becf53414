/*!
 * Native LGBM_* ABI for lightgbm_tpu_torch, the PyTorch/CUDA port: a thin
 * C++ layer that embeds CPython and forwards every call to
 * ``lightgbm_tpu_torch.capi_embed`` (the counterpart of
 * src/capi/lgbm_capi.cpp, against the same include/lightgbm_tpu/c_api.h).
 *
 * The port's runtime (binning, boosting, the CUDA kernels) lives in
 * Python; this library gives test.cpp-shaped C++ harnesses the fork's
 * link surface.  Caller buffers cross the boundary as memoryviews — no
 * copies on the C++ side; predictions are written straight into the
 * caller's array.  Training and serving run on the card unless the
 * parameter string says device=cpu.
 *
 * Environment: LGBM_TPU_PYROOT, the repo root when lightgbm_tpu_torch is
 * not importable from the default sys.path; LGBM_TPU_PYTHON, the Python
 * executable whose prefix (a virtual environment's too) the embedded
 * interpreter takes, by default the one the library was built with
 * (LGBM_PY_EXECUTABLE).
 *
 * The embedded interpreter is never finalized, so Python's exit hooks do
 * not run: a C atexit handler takes the GIL and calls capi_embed.flush()
 * to write the telemetry files.
 */
#include <Python.h>

#include <cstdint>
#include <cstdlib>
#include <mutex>   /* std::call_once */
#include <string>
#include <unordered_map>

#include "../../include/lightgbm_tpu/c_api.h"

namespace {

/* thread-local like the reference's error buffer: the returned pointer
 * stays valid for the calling thread regardless of other threads'
 * failures */
thread_local std::string g_last_error = "everything is fine";

void set_last_error(const std::string& msg) { g_last_error = msg; }

#ifndef LGBM_PY_EXECUTABLE
#define LGBM_PY_EXECUTABLE ""
#endif

/* Initialize the interpreter once, as the Python executable the library
 * was built with (or LGBM_TPU_PYTHON) would start, so its prefix and
 * site-packages are found; release the GIL so every API entry can use
 * PyGILState_Ensure regardless of calling thread. */
void ensure_python() {
  static std::once_flag once;
  std::call_once(once, [] {
    if (Py_IsInitialized()) return;
    PyConfig config;
    PyConfig_InitPythonConfig(&config);
    config.install_signal_handlers = 0;
    config.parse_argv = 0;
    const char* exe = std::getenv("LGBM_TPU_PYTHON");
    if (exe == nullptr || exe[0] == '\0') exe = LGBM_PY_EXECUTABLE;
    if (exe[0] != '\0') {
      PyConfig_SetBytesString(&config, &config.program_name, exe);
    }
    Py_InitializeFromConfig(&config);
    PyConfig_Clear(&config);
    PyEval_SaveThread();
  });
}

/* The exit hook: write the telemetry files (capi_embed.flush). */
void flush_at_exit() {
  if (!Py_IsInitialized()) return;
  PyGILState_STATE st = PyGILState_Ensure();
  PyObject* mod = PyImport_ImportModule("lightgbm_tpu_torch.capi_embed");
  if (mod != nullptr) {
    PyObject* res = PyObject_CallMethod(mod, "flush", nullptr);
    Py_XDECREF(res);
    Py_DECREF(mod);
  }
  PyErr_Clear();
  PyGILState_Release(st);
}

/* RAII GIL hold. */
struct Gil {
  PyGILState_STATE st;
  Gil() { st = PyGILState_Ensure(); }
  ~Gil() { PyGILState_Release(st); }
};

PyObject* adapter_module() {
  static PyObject* mod = nullptr;
  if (mod == nullptr) {
    PyRun_SimpleString(
        "import sys, os\n"
        "if not getattr(sys, 'argv', None):\n"
        "    sys.argv = ['liblgbm_tpu_torch']\n"
        "_p = os.environ.get('LGBM_TPU_PYROOT')\n"
        "if _p and _p not in sys.path:\n"
        "    sys.path.insert(0, _p)\n");
    mod = PyImport_ImportModule("lightgbm_tpu_torch.capi_embed");
    if (mod != nullptr) std::atexit(flush_at_exit);
  }
  return mod;
}

std::string py_error_string() {
  PyObject *type = nullptr, *value = nullptr, *trace = nullptr;
  PyErr_Fetch(&type, &value, &trace);
  PyErr_NormalizeException(&type, &value, &trace);
  std::string msg = "unknown python error";
  if (value != nullptr) {
    PyObject* s = PyObject_Str(value);
    if (s != nullptr) {
      const char* c = PyUnicode_AsUTF8(s);
      if (c != nullptr) msg = c;
      Py_DECREF(s);
    }
  }
  Py_XDECREF(type);
  Py_XDECREF(value);
  Py_XDECREF(trace);
  return msg;
}

/* Call adapter ``fn`` with an argument tuple (reference stolen).
 * Returns the result object or nullptr (error recorded). */
PyObject* call_adapter(const char* fn, PyObject* args) {
  PyObject* mod = adapter_module();
  if (mod == nullptr) {
    set_last_error("cannot import lightgbm_tpu_torch.capi_embed: "
                   + py_error_string());
    Py_XDECREF(args);
    return nullptr;
  }
  if (args == nullptr) {
    set_last_error("argument marshalling failed: " + py_error_string());
    return nullptr;
  }
  PyObject* f = PyObject_GetAttrString(mod, fn);
  if (f == nullptr) {
    set_last_error(std::string("missing adapter: ") + fn);
    Py_DECREF(args);
    return nullptr;
  }
  PyObject* res = PyObject_CallObject(f, args);
  Py_DECREF(f);
  Py_DECREF(args);
  if (res == nullptr) {
    set_last_error(std::string(fn) + ": " + py_error_string());
    return nullptr;
  }
  return res;
}

PyObject* mv_read(const void* ptr, Py_ssize_t nbytes) {
  return PyMemoryView_FromMemory(
      reinterpret_cast<char*>(const_cast<void*>(ptr)), nbytes,
      PyBUF_READ);
}

PyObject* mv_write(void* ptr, Py_ssize_t nbytes) {
  return PyMemoryView_FromMemory(reinterpret_cast<char*>(ptr), nbytes,
                                 PyBUF_WRITE);
}

Py_ssize_t dtype_size(int dtype) {
  switch (dtype) {
    case C_API_DTYPE_FLOAT32: return 4;
    case C_API_DTYPE_FLOAT64: return 8;
    case C_API_DTYPE_INT32:   return 4;
    case C_API_DTYPE_INT64:   return 8;
    default:                  return 0;
  }
}

/* map -> the c_api.py "k1=v1 k2=v2" parameter string */
std::string params_string(
    const std::unordered_map<std::string, std::string>& params) {
  std::string out;
  for (const auto& kv : params) {
    if (!out.empty()) out += " ";
    out += kv.first + "=" + kv.second;
  }
  return out;
}

int handle_result(PyObject* res, void** out) {
  if (res == nullptr) return -1;
  if (out != nullptr) {
    *out = reinterpret_cast<void*>(
        static_cast<intptr_t>(PyLong_AsLongLong(res)));
  }
  Py_DECREF(res);
  return 0;
}

int int_result(PyObject* res, int64_t* out) {
  if (res == nullptr) return -1;
  if (out != nullptr) *out = PyLong_AsLongLong(res);
  Py_DECREF(res);
  return 0;
}

int none_result(PyObject* res) {
  if (res == nullptr) return -1;
  Py_DECREF(res);
  return 0;
}

int64_t as_id(const void* handle) {
  return static_cast<int64_t>(reinterpret_cast<intptr_t>(handle));
}

}  // namespace

extern "C" const char* LGBM_GetLastError() {
  return g_last_error.c_str();
}

int LGBM_DatasetCreateFromCSR(
    const void* indptr, int indptr_type, const int32_t* indices,
    const void* data, int data_type, int64_t nindptr, int64_t nelem,
    int64_t num_col,
    std::unordered_map<std::string, std::string> parameters,
    const DatasetHandle reference, DatasetHandle* out) {
  ensure_python();
  Gil gil;
  PyObject* args = Py_BuildValue(
      "(NiNNiLLLsL)",
      mv_read(indptr, nindptr * dtype_size(indptr_type)), indptr_type,
      mv_read(indices, nelem * 4),
      mv_read(data, nelem * dtype_size(data_type)), data_type,
      static_cast<long long>(nindptr), static_cast<long long>(nelem),
      static_cast<long long>(num_col), params_string(parameters).c_str(),
      static_cast<long long>(as_id(reference)));
  return handle_result(call_adapter("dataset_from_csr", args), out);
}

extern "C" int LGBM_DatasetSetField(DatasetHandle handle,
                                    const char* field_name,
                                    const void* field_data,
                                    int num_element, int type) {
  ensure_python();
  Gil gil;
  PyObject* args = Py_BuildValue(
      "(LsNii)", static_cast<long long>(as_id(handle)), field_name,
      mv_read(field_data, num_element * dtype_size(type)), num_element,
      type);
  return none_result(call_adapter("dataset_set_field", args));
}

extern "C" int LGBM_DatasetGetNumData(DatasetHandle handle,
                                      int64_t* out) {
  ensure_python();
  Gil gil;
  PyObject* args = Py_BuildValue("(L)",
                                 static_cast<long long>(as_id(handle)));
  return int_result(call_adapter("dataset_num_data", args), out);
}

extern "C" int LGBM_DatasetFree(DatasetHandle handle) {
  ensure_python();
  Gil gil;
  PyObject* args = Py_BuildValue("(L)",
                                 static_cast<long long>(as_id(handle)));
  return none_result(call_adapter("dataset_free", args));
}

int LGBM_BoosterCreate(
    const DatasetHandle train_data,
    std::unordered_map<std::string, std::string> parameters,
    BoosterHandle* out) {
  ensure_python();
  Gil gil;
  PyObject* args = Py_BuildValue(
      "(Ls)", static_cast<long long>(as_id(train_data)),
      params_string(parameters).c_str());
  return handle_result(call_adapter("booster_create", args), out);
}

extern "C" int LGBM_BoosterFree(BoosterHandle handle) {
  ensure_python();
  Gil gil;
  PyObject* args = Py_BuildValue("(L)",
                                 static_cast<long long>(as_id(handle)));
  return none_result(call_adapter("booster_free", args));
}

extern "C" int LGBM_BoosterUpdateOneIter(BoosterHandle handle,
                                         int* is_finished) {
  ensure_python();
  Gil gil;
  PyObject* args = Py_BuildValue("(L)",
                                 static_cast<long long>(as_id(handle)));
  int64_t fin = 0;
  int rc = int_result(call_adapter("booster_update_one_iter", args),
                      &fin);
  if (rc == 0 && is_finished != nullptr) {
    *is_finished = static_cast<int>(fin);
  }
  return rc;
}

extern "C" int LGBM_BoosterUpdateChunked(BoosterHandle handle,
                                         int num_iters, int chunk,
                                         int* is_finished) {
  ensure_python();
  Gil gil;
  PyObject* args = Py_BuildValue(
      "(Lii)", static_cast<long long>(as_id(handle)), num_iters, chunk);
  int64_t fin = 0;
  int rc = int_result(call_adapter("booster_update_chunked", args), &fin);
  if (rc == 0 && is_finished != nullptr) {
    *is_finished = static_cast<int>(fin);
  }
  return rc;
}

extern "C" int LGBM_BoosterGetCurrentIteration(BoosterHandle handle,
                                               int64_t* out_iteration) {
  ensure_python();
  Gil gil;
  PyObject* args = Py_BuildValue("(L)",
                                 static_cast<long long>(as_id(handle)));
  return int_result(call_adapter("booster_current_iteration", args),
                    out_iteration);
}

extern "C" int LGBM_BoosterCalcNumPredict(BoosterHandle handle,
                                          int num_row, int predict_type,
                                          int num_iteration,
                                          int64_t* out_len) {
  ensure_python();
  Gil gil;
  PyObject* args = Py_BuildValue(
      "(Liii)", static_cast<long long>(as_id(handle)), num_row,
      predict_type, num_iteration);
  return int_result(call_adapter("booster_calc_num_predict", args),
                    out_len);
}

int LGBM_BoosterPredictForCSR(
    BoosterHandle handle, const void* indptr, int indptr_type,
    const int32_t* indices, const void* data, int data_type,
    int64_t nindptr, int64_t nelem, int64_t num_col, int predict_type,
    int num_iteration,
    std::unordered_map<std::string, std::string> parameter,
    int64_t* out_len, double* out_result) {
  ensure_python();
  Gil gil;
  /* the caller pre-allocated out_result to CalcNumPredict's length */
  int64_t out_cap = 0;
  {
    PyObject* cargs = Py_BuildValue(
        "(Liii)", static_cast<long long>(as_id(handle)),
        static_cast<int>(nindptr - 1), predict_type, num_iteration);
    if (int_result(call_adapter("booster_calc_num_predict", cargs),
                   &out_cap) != 0) {
      return -1;
    }
  }
  PyObject* args = Py_BuildValue(
      "(LNiNNiLLLiisN)", static_cast<long long>(as_id(handle)),
      mv_read(indptr, nindptr * dtype_size(indptr_type)), indptr_type,
      mv_read(indices, nelem * 4),
      mv_read(data, nelem * dtype_size(data_type)), data_type,
      static_cast<long long>(nindptr), static_cast<long long>(nelem),
      static_cast<long long>(num_col), predict_type, num_iteration,
      params_string(parameter).c_str(),
      mv_write(out_result, out_cap * 8));
  return int_result(call_adapter("booster_predict_for_csr", args),
                    out_len);
}

extern "C" int LGBM_BoosterSaveModel(BoosterHandle handle,
                                     int start_iteration,
                                     int num_iteration,
                                     const char* filename) {
  ensure_python();
  Gil gil;
  PyObject* args = Py_BuildValue(
      "(Liis)", static_cast<long long>(as_id(handle)), start_iteration,
      num_iteration, filename);
  return none_result(call_adapter("booster_save_model", args));
}

/* ------------------------------------------------------------------ */
/* Prediction server (lightgbm_tpu extension)                          */
/* ------------------------------------------------------------------ */

int LGBM_ServeCreate(
    const BoosterHandle booster,
    std::unordered_map<std::string, std::string> parameters,
    ServeHandle* out) {
  ensure_python();
  Gil gil;
  PyObject* args = Py_BuildValue(
      "(Ls)", static_cast<long long>(as_id(booster)),
      params_string(parameters).c_str());
  return handle_result(call_adapter("serve_create", args), out);
}

extern "C" int LGBM_ServeSwap(ServeHandle handle,
                              const BoosterHandle booster) {
  ensure_python();
  Gil gil;
  PyObject* args = Py_BuildValue(
      "(LL)", static_cast<long long>(as_id(handle)),
      static_cast<long long>(as_id(booster)));
  return none_result(call_adapter("serve_swap", args));
}

extern "C" int LGBM_ServeCalcNumPredict(ServeHandle handle, int num_row,
                                        int64_t* out_len) {
  ensure_python();
  Gil gil;
  PyObject* args = Py_BuildValue(
      "(Li)", static_cast<long long>(as_id(handle)), num_row);
  return int_result(call_adapter("serve_calc_num_predict", args),
                    out_len);
}

extern "C" int LGBM_ServePredictForCSR(
    ServeHandle handle, const void* indptr, int indptr_type,
    const int32_t* indices, const void* data, int data_type,
    int64_t nindptr, int64_t nelem, int64_t num_col, int predict_type,
    int64_t* out_len, double* out_result) {
  ensure_python();
  Gil gil;
  /* the caller pre-allocated out_result to ServeCalcNumPredict's len */
  int64_t out_cap = 0;
  {
    PyObject* cargs = Py_BuildValue(
        "(Li)", static_cast<long long>(as_id(handle)),
        static_cast<int>(nindptr - 1));
    if (int_result(call_adapter("serve_calc_num_predict", cargs),
                   &out_cap) != 0) {
      return -1;
    }
  }
  PyObject* args = Py_BuildValue(
      "(LNiNNiLLLiN)", static_cast<long long>(as_id(handle)),
      mv_read(indptr, nindptr * dtype_size(indptr_type)), indptr_type,
      mv_read(indices, nelem * 4),
      mv_read(data, nelem * dtype_size(data_type)), data_type,
      static_cast<long long>(nindptr), static_cast<long long>(nelem),
      static_cast<long long>(num_col), predict_type,
      mv_write(out_result, out_cap * 8));
  return int_result(call_adapter("serve_predict_for_csr", args),
                    out_len);
}

extern "C" int LGBM_ServeFree(ServeHandle handle) {
  ensure_python();
  Gil gil;
  PyObject* args = Py_BuildValue("(L)",
                                 static_cast<long long>(as_id(handle)));
  return none_result(call_adapter("serve_free", args));
}

/* ------------------------------------------------------------------ */
/* Model fleet (lightgbm_tpu extension)                                */
/* ------------------------------------------------------------------ */

int LGBM_FleetCreate(
    const BoosterHandle booster, int num_tenants,
    std::unordered_map<std::string, std::string> parameters,
    FleetHandle* out) {
  ensure_python();
  Gil gil;
  PyObject* args = Py_BuildValue(
      "(Lis)", static_cast<long long>(as_id(booster)), num_tenants,
      params_string(parameters).c_str());
  return handle_result(call_adapter("fleet_create", args), out);
}

extern "C" int LGBM_FleetSwapTenant(FleetHandle handle, int tenant_id,
                                    const BoosterHandle booster) {
  ensure_python();
  Gil gil;
  PyObject* args = Py_BuildValue(
      "(LiL)", static_cast<long long>(as_id(handle)), tenant_id,
      static_cast<long long>(as_id(booster)));
  return none_result(call_adapter("fleet_swap_tenant", args));
}

extern "C" int LGBM_FleetCalcNumPredict(FleetHandle handle, int num_row,
                                        int64_t* out_len) {
  ensure_python();
  Gil gil;
  PyObject* args = Py_BuildValue(
      "(Li)", static_cast<long long>(as_id(handle)), num_row);
  return int_result(call_adapter("fleet_calc_num_predict", args),
                    out_len);
}

extern "C" int LGBM_FleetPredictForCSR(
    FleetHandle handle, const int32_t* tenant_ids,
    int64_t num_tenant_ids, const void* indptr, int indptr_type,
    const int32_t* indices, const void* data, int data_type,
    int64_t nindptr, int64_t nelem, int64_t num_col, int predict_type,
    int64_t* out_len, double* out_result) {
  ensure_python();
  Gil gil;
  /* the caller pre-allocated out_result to FleetCalcNumPredict's len */
  int64_t out_cap = 0;
  {
    PyObject* cargs = Py_BuildValue(
        "(Li)", static_cast<long long>(as_id(handle)),
        static_cast<int>(nindptr - 1));
    if (int_result(call_adapter("fleet_calc_num_predict", cargs),
                   &out_cap) != 0) {
      return -1;
    }
  }
  PyObject* args = Py_BuildValue(
      "(LNLNiNNiLLLiN)", static_cast<long long>(as_id(handle)),
      mv_read(tenant_ids, num_tenant_ids * 4),
      static_cast<long long>(num_tenant_ids),
      mv_read(indptr, nindptr * dtype_size(indptr_type)), indptr_type,
      mv_read(indices, nelem * 4),
      mv_read(data, nelem * dtype_size(data_type)), data_type,
      static_cast<long long>(nindptr), static_cast<long long>(nelem),
      static_cast<long long>(num_col), predict_type,
      mv_write(out_result, out_cap * 8));
  return int_result(call_adapter("fleet_predict_for_csr", args),
                    out_len);
}

extern "C" int LGBM_FleetFree(FleetHandle handle) {
  ensure_python();
  Gil gil;
  PyObject* args = Py_BuildValue("(L)",
                                 static_cast<long long>(as_id(handle)));
  return none_result(call_adapter("fleet_free", args));
}

/* ------------------------------------------------------------------ */
/* Warm-up: kernel builds and graph captures (lightgbm_tpu extension)  */
/* ------------------------------------------------------------------ */

int LGBM_WarmupTrain(
    std::unordered_map<std::string, std::string> parameters,
    int64_t num_row, int32_t num_feature, int* out_num_compiled) {
  ensure_python();
  Gil gil;
  PyObject* args = Py_BuildValue(
      "(sLi)", params_string(parameters).c_str(),
      static_cast<long long>(num_row), static_cast<int>(num_feature));
  int64_t n = 0;
  int rc = int_result(call_adapter("warmup_train", args), &n);
  if (rc == 0 && out_num_compiled != nullptr) {
    *out_num_compiled = static_cast<int>(n);
  }
  return rc;
}

int LGBM_WarmupServe(
    std::unordered_map<std::string, std::string> parameters,
    int64_t num_row, int32_t num_feature, int* out_num_compiled) {
  ensure_python();
  Gil gil;
  PyObject* args = Py_BuildValue(
      "(sLi)", params_string(parameters).c_str(),
      static_cast<long long>(num_row), static_cast<int>(num_feature));
  int64_t n = 0;
  int rc = int_result(call_adapter("warmup_serve", args), &n);
  if (rc == 0 && out_num_compiled != nullptr) {
    *out_num_compiled = static_cast<int>(n);
  }
  return rc;
}
