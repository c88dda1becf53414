/* Miniature C implementation for the TL151 corpus fixture.
 *
 * Pairs with abi_parity.h / abi_parity.py.  Skew planted here:
 *   - LGBM_FixtureExtra is defined but never declared in the header;
 *   - LGBM_FixturePredict builds FIVE Py_BuildValue items for the
 *     four-parameter `fixture_predict` adapter.
 */
#include "abi_parity.h"

extern "C" int LGBM_FixtureCreate(const char* params, int n,
                                  void** out) {
  PyObject* args = Py_BuildValue("(si)", params, n);
  return call_adapter("fixture_create", args, out);
}

extern "C" int LGBM_FixtureFree(void* handle) {
  PyObject* args = Py_BuildValue("(L)", (long long)handle);
  return call_adapter("fixture_free", args, NULL);
}

extern "C" int LGBM_FixturePredict(void* handle, const double* data,
                                   int nrow, double* out) {
  PyObject* args = Py_BuildValue("(LNiiN)", (long long)handle,
                                 wrap(data), nrow, 0, wrap(out));
  return call_adapter("fixture_predict", args, NULL);
}

extern "C" int LGBM_FixtureMissing(void* handle) {
  PyObject* args = Py_BuildValue("(L)", (long long)handle);
  return call_adapter("fixture_missing", args, NULL);
}

extern "C" int LGBM_FixtureExtra(void* handle) {
  PyObject* args = Py_BuildValue("(L)", (long long)handle);
  return call_adapter("fixture_free", args, NULL);
}
