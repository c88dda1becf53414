"""The port's native ABI (``src/capi_cuda/``) built with g++ here and
driven on the CPU: ``liblgbm_tpu_torch.so`` against the unchanged
``include/lightgbm_tpu/c_api.h``, the unchanged ``src/capi/smoke_test.cpp``
linked to it (it trains on the card, so here it is only linked), and
``window_harness`` run on four small windows of the fork's 53 columns with
``device=cpu``: every window's model (its trees), predictions written into
the caller's buffers and served predictions equal to the Python-level
layer's (``lightgbm_tpu_torch.c_api``) on the same windows, and the
telemetry file showing windows 1-2 reusing window 0's grower.  Skips only
without g++ or ``Python.h``."""

import json
import os
import shutil
import subprocess
import sys
import sysconfig
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from lightgbm_tpu_torch import c_api as C

ROOT = Path(__file__).resolve().parents[1]
WINDOWS = 4
ROWS = 2500
EXTRA = ["device=cpu", "num_iterations=6", "num_leaves=15"]
PARAMS = ("boosting=gbdt objective=binary max_bin=255 num_iterations=6 "
          "learning_rate=0.1 num_leaves=15 tree_learner=serial "
          "feature_fraction=0.8 bagging_freq=5 bagging_fraction=0.8 "
          "min_data_in_leaf=50 min_sum_hessian_in_leaf=5.0 fused_chunk=25 "
          "verbosity=-1 device=cpu")

pytestmark = pytest.mark.skipif(
    shutil.which("g++") is None or not os.path.exists(
        os.path.join(sysconfig.get_config_var("INCLUDEPY") or "",
                     "Python.h")),
    reason="needs g++ and Python.h to build src/capi_cuda")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """This module's torch CPU ops on one thread (several test workers
    share the machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _window(k):
    """The fork's 53 columns (chip_smoke.window_shape's generator, small),
    zeros dropped."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    x, y = chip_smoke.window_shape(ROWS, 500 + k)
    return sp.csr_matrix(x), y


@pytest.fixture(scope="module")
def harness_run(tmp_path_factory):
    build = tmp_path_factory.mktemp("capi_build")
    out = subprocess.run(["make", "-C", str(ROOT / "src" / "capi_cuda"),
                          f"BUILD={build}", f"PY={sys.executable}"],
                         capture_output=True, text=True)
    assert out.returncode == 0, out.stdout + out.stderr
    for name in ("liblgbm_tpu_torch.so", "smoke_test", "window_harness"):
        assert (build / name).exists()
    data = tmp_path_factory.mktemp("windows")
    windows = [_window(k) for k in range(WINDOWS)]
    for k, (x, y) in enumerate(windows):
        x.indptr.astype(np.int64).tofile(data / f"w{k}_indptr.i64")
        x.indices.astype(np.int32).tofile(data / f"w{k}_indices.i32")
        x.data.astype(np.float32).tofile(data / f"w{k}_data.f32")
        y.astype(np.float32).tofile(data / f"w{k}_label.f32")
    env = dict(os.environ, LGBM_TPU_PYROOT=str(ROOT),
               LGBM_TPU_METRICS=str(data / "metrics.json"),
               OMP_NUM_THREADS="1")
    run = subprocess.run([str(build / "window_harness"), str(data),
                          str(WINDOWS)] + EXTRA, capture_output=True,
                         text=True, env=env, timeout=300)
    assert run.returncode == 0, run.stdout + run.stderr
    return data, windows, run.stdout


def _python_layer(windows):
    """The same loop through the Python-level layer: (model texts,
    booster predictions, served predictions) a training window."""
    ref = None
    texts, preds, served = [], [], []
    srv = C.Ref()
    for k in range(WINDOWS - 1):
        x, y = windows[k]
        ds = C.Ref()
        assert C.LGBM_DatasetCreateFromCSR(
            x.indptr.astype(np.int64), C.C_API_DTYPE_INT64,
            x.indices.astype(np.int32), x.data.astype(np.float32),
            C.C_API_DTYPE_FLOAT32, len(x.indptr), x.nnz, 53, PARAMS, ref,
            ds) == 0, C.LGBM_GetLastError()
        ref = ref or ds.value
        assert C.LGBM_DatasetSetField(ds.value, "label", y, len(y),
                                      C.C_API_DTYPE_FLOAT32) == 0
        bst = C.Ref()
        assert C.LGBM_BoosterCreate(ds.value, PARAMS, bst) == 0
        fin = C.Ref()
        assert C.LGBM_BoosterUpdateChunked(bst.value, 6, 25, fin) == 0
        if k == 0:
            assert C.LGBM_ServeCreate(bst.value, PARAMS, srv) == 0
        else:
            assert C.LGBM_ServeSwap(srv.value, bst.value) == 0
        s, n = C.Ref(), C.Ref()
        assert C.LGBM_BoosterSaveModelToString(bst.value, 0, -1, 0, n,
                                               s) == 0
        texts.append(s.value)
        xn, _ = windows[k + 1]
        args = (xn.indptr.astype(np.int64), C.C_API_DTYPE_INT64,
                xn.indices.astype(np.int32), xn.data.astype(np.float32),
                C.C_API_DTYPE_FLOAT32, len(xn.indptr), xn.nnz, 53,
                C.C_API_PREDICT_NORMAL)
        out, ln = np.zeros(xn.shape[0]), C.Ref()
        assert C.LGBM_BoosterPredictForCSR(bst.value, *args[:-1], 0, -1,
                                           "", ln, out) == 0
        preds.append(out)
        out2 = np.zeros(xn.shape[0])
        assert C.LGBM_ServePredictForCSR(srv.value, *args, ln, out2) == 0
        served.append(out2)
        assert C.LGBM_BoosterFree(bst.value) == 0
    C.LGBM_ServeFree(srv.value)
    return texts, preds, served


def test_window_harness_equals_the_python_layer(harness_run):
    data, windows, stdout = harness_run
    assert "window harness: PASS" in stdout
    lines = [json.loads(line.split(" ", 1)[1]) for line in
             stdout.splitlines() if line.startswith("WINDOW ")]
    assert [r["window"] for r in lines] == [0, 1, 2]
    assert all(r["iterations"] == 6 for r in lines)
    assert lines[-1]["fleet_max_err"] == 0.0
    texts, preds, served = _python_layer(windows)
    for k in range(WINDOWS - 1):
        native = (data / f"model_w{k}.txt").read_text()
        assert native == texts[k]
        np.testing.assert_array_equal(
            np.fromfile(data / f"pred_w{k}.f64"), preds[k])
        np.testing.assert_array_equal(
            np.fromfile(data / f"serve_w{k}.f64"), served[k])


def test_harness_telemetry_shows_the_grower_reused(harness_run):
    data, _, stdout = harness_run
    warm = json.loads(next(line for line in stdout.splitlines()
                           if line.startswith("WARMUP ")).split(" ", 1)[1])
    assert warm["train_built"] == 0 and warm["serve_built"] == 0
    hits = []
    for k in range(WINDOWS - 1):
        snap = json.loads((data / f"metrics_w{k}.json").read_text())
        hits.append(snap["counters"].get("grow.cache_hits", 0))
        assert snap["counters"]["capi.retrain_windows"] == k + 1
        assert "hist_cuda.wave_hist.launches" in snap["gauges"]
    assert hits == [0, 1, 2]
