"""The port's ``LGBM_*`` layer (``lightgbm_tpu_torch/c_api.py``) on the
CPU: ``tests/test_c_api.py``'s cases re-pointed at it (``device=cpu``),
every one of the JAX layer's 50 functions present with its parameters,
the fork harness's CSR windows trained through both layers (the JAX one
on its device grower, ``device_growth=on``) to the same trees, and the
four predict types against the JAX layer on the same model."""

import inspect

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from lightgbm_tpu import c_api as J
from lightgbm_tpu_torch import c_api as C

PARAMS = ("objective=binary num_leaves=15 min_data_in_leaf=5 verbosity=-1 "
          "device=cpu")
JAX_PARAMS = ("objective=binary num_leaves=15 min_data_in_leaf=5 "
              "verbosity=-1 device_growth=on")
#: a split gain at or below this fraction of its tree's largest gain is
#: f32 rounding noise (ROADMAP §3)
NOISE_REL = 1e-6
JAX_NAMES = sorted(n for n in dir(J) if n.startswith("LGBM_"))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """This module's torch CPU ops on one thread (several test workers
    share the machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _window(rng, n, nf=20, density=0.2):
    x = sp.random(n, nf, density=density, random_state=rng,
                  data_rvs=lambda k: rng.exponential(50.0, k)).tocsr()
    sig = np.asarray(x[:, :5].sum(axis=1)).ravel() / 100.0
    y = (sig + 0.3 * rng.standard_normal(n) > 0.35).astype(np.float32)
    return x, y


def _create_dataset(x, y, params=PARAMS, reference=None, api=C):
    ds = api.Ref()
    rc = api.LGBM_DatasetCreateFromCSR(
        x.indptr.astype(np.int32), api.C_API_DTYPE_INT32,
        x.indices.astype(np.int32), x.data.astype(np.float64),
        api.C_API_DTYPE_FLOAT64, len(x.indptr), x.nnz, x.shape[1],
        params, reference, ds)
    assert rc == 0, api.LGBM_GetLastError()
    rc = api.LGBM_DatasetSetField(ds.value, "label", y, len(y),
                                  api.C_API_DTYPE_FLOAT32)
    assert rc == 0, api.LGBM_GetLastError()
    return ds.value


def _predict_csr(api, bst, x, predict_type, num_iteration=-1):
    n = api.Ref()
    assert api.LGBM_BoosterCalcNumPredict(bst, x.shape[0], predict_type,
                                          num_iteration, n) == 0
    buf = np.zeros(n.value, np.float64)
    got = api.Ref()
    assert api.LGBM_BoosterPredictForCSR(
        bst, x.indptr.astype(np.int32), api.C_API_DTYPE_INT32,
        x.indices.astype(np.int32), x.data.astype(np.float64),
        api.C_API_DTYPE_FLOAT64, len(x.indptr), x.nnz, x.shape[1],
        predict_type, num_iteration, "", got, buf) == 0, \
        api.LGBM_GetLastError()
    assert got.value == n.value
    return buf


# ----------------------------------------------------------------------
# the tests/test_c_api.py cases, on the port

def test_fork_harness_window_loop():
    """Two windows of trainModel/evaluateModel via the C API surface."""
    rng = np.random.default_rng(0)
    windows = [_window(rng, 3000) for _ in range(3)]
    aucs = []
    for w in range(2):
        x, y = windows[w]
        ds = _create_dataset(x, y)
        bst = C.Ref()
        assert C.LGBM_BoosterCreate(ds, PARAMS, bst) == 0, \
            C.LGBM_GetLastError()
        fin = C.Ref()
        for _ in range(30):
            assert C.LGBM_BoosterUpdateOneIter(bst.value, fin) == 0
            if fin.value:
                break
        it = C.Ref()
        assert C.LGBM_BoosterGetCurrentIteration(bst.value, it) == 0
        assert it.value >= 1
        xn, yn = windows[w + 1]
        buf = _predict_csr(C, bst.value, xn, C.C_API_PREDICT_NORMAL)
        order = np.argsort(-buf)
        tp = np.cumsum(yn[order])
        fp = np.cumsum(1 - yn[order])
        aucs.append(float(np.trapezoid(tp, fp) / (tp[-1] * fp[-1])))
        assert C.LGBM_BoosterFree(bst.value) == 0
        assert C.LGBM_DatasetFree(ds) == 0
    assert min(aucs) > 0.6, aucs


def test_handle_semantics():
    rng = np.random.default_rng(1)
    x, y = _window(rng, 500)
    ds = _create_dataset(x, y)
    nd = C.Ref()
    assert C.LGBM_DatasetGetNumData(ds, nd) == 0 and nd.value == 500
    nf = C.Ref()
    assert C.LGBM_DatasetGetNumFeature(ds, nf) == 0 and nf.value == 20
    assert C.LGBM_DatasetFree(ds) == 0
    assert C.LGBM_DatasetFree(ds) == -1
    assert "invalid Dataset handle" in C.LGBM_GetLastError()
    bst = C.Ref()
    assert C.LGBM_BoosterCreate(ds, "objective=binary device=cpu",
                                bst) == -1


def test_dtype_mismatch_rejected():
    rng = np.random.default_rng(2)
    x, y = _window(rng, 400)
    ds = C.Ref()
    rc = C.LGBM_DatasetCreateFromCSR(
        x.indptr.astype(np.int64), C.C_API_DTYPE_INT32,
        x.indices.astype(np.int32), x.data.astype(np.float64),
        C.C_API_DTYPE_FLOAT64, len(x.indptr), x.nnz, x.shape[1],
        "device=cpu", None, ds)
    assert rc == -1
    assert "does not match declared" in C.LGBM_GetLastError()
    ds2 = _create_dataset(x, y)
    rc = C.LGBM_DatasetSetField(ds2, "label", y.astype(np.float64),
                                len(y), C.C_API_DTYPE_FLOAT32)
    assert rc == -1


def test_model_string_roundtrip_and_eval():
    rng = np.random.default_rng(3)
    x, y = _window(rng, 2000)
    params = PARAMS + " metric=binary_logloss"
    ds = _create_dataset(x, y, params=params)
    bst = C.Ref()
    assert C.LGBM_BoosterCreate(ds, params, bst) == 0
    fin = C.Ref()
    for _ in range(10):
        C.LGBM_BoosterUpdateOneIter(bst.value, fin)
    cnt = C.Ref()
    assert C.LGBM_BoosterGetEvalCounts(bst.value, cnt) == 0
    res = np.zeros(max(cnt.value, 1), np.float64)
    ln = C.Ref()
    assert C.LGBM_BoosterGetEval(bst.value, 0, ln, res) == 0
    assert ln.value == cnt.value and res[0] < 0.7
    slen = C.Ref()
    sstr = C.Ref()
    assert C.LGBM_BoosterSaveModelToString(bst.value, 0, -1, 0, slen,
                                           sstr) == 0
    nit = C.Ref()
    bst2 = C.Ref()
    assert C.LGBM_BoosterLoadModelFromString(sstr.value, nit, bst2) == 0
    dense = x.toarray().astype(np.float64)
    outs = []
    for h in (bst.value, bst2.value):
        out = np.zeros(x.shape[0], np.float64)
        got = C.Ref()
        assert C.LGBM_BoosterPredictForMat(
            h, dense, C.C_API_DTYPE_FLOAT64, x.shape[0], x.shape[1], 1,
            C.C_API_PREDICT_NORMAL, -1, "", got, out) == 0
        outs.append(out)
    np.testing.assert_allclose(outs[1], outs[0], atol=1e-6)
    imp = np.zeros(x.shape[1], np.float64)
    assert C.LGBM_BoosterFeatureImportance(bst.value, -1, 0, imp) == 0
    assert imp.sum() > 0


# ----------------------------------------------------------------------
# the surface against the JAX layer

def _jax_params_of(name):
    """The JAX layer's parameters: its functions are wrapped by a
    ``*args`` shim, the original is the wrapper's one closure cell."""
    fn = getattr(J, name)
    inner = fn.__closure__[0].cell_contents if fn.__closure__ else fn
    return list(inspect.signature(inner).parameters)


@pytest.mark.parametrize("name", JAX_NAMES)
def test_every_function_exists_with_the_jax_parameters(name):
    assert len(JAX_NAMES) == 50
    assert list(inspect.signature(getattr(C, name)).parameters) == \
        _jax_params_of(name)


def _trees(api, bst):
    s = api.Ref()
    n = api.Ref()
    assert api.LGBM_BoosterSaveModelToString(bst, 0, -1, 0, n, s) == 0
    from lightgbm_tpu_torch.boosting.gbdt import GBDT
    return GBDT.load_model_from_string(s.value).models


def _assert_same_trees_up_to_noise(jtrees, ttrees):
    """Equal structures and leaf counts, or equal up to the first node
    where one package splits at an f32-noise gain (ROADMAP §3)."""
    assert len(jtrees) == len(ttrees)
    for jt, tt in zip(jtrees, ttrees):
        n = min(jt.num_leaves, tt.num_leaves) - 1
        diff = [i for i in range(n)
                if (jt.split_feature[i], jt.threshold[i])
                != (tt.split_feature[i], tt.threshold[i])]
        if not diff and jt.num_leaves == tt.num_leaves:
            np.testing.assert_array_equal(tt.leaf_count[:n + 1],
                                          jt.leaf_count[:n + 1])
            scale = max(np.abs(jt.leaf_value[:n + 1]).max(), 1e-12)
            np.testing.assert_allclose(tt.leaf_value[:n + 1],
                                       jt.leaf_value[:n + 1], rtol=0,
                                       atol=1e-5 * scale)
            continue
        k = diff[0] if diff else n
        noise = NOISE_REL * max(jt.split_gain[:jt.num_leaves - 1].max(),
                                tt.split_gain[:tt.num_leaves - 1].max())
        assert min(jt.split_gain[min(k, jt.num_leaves - 2)],
                   tt.split_gain[min(k, tt.num_leaves - 2)]) <= noise
        break


def test_csr_windows_train_the_jax_layers_trees():
    """Three windows, each binned against window 0 (``reference``),
    trained in fused chunks through both layers: the same trees, up to a
    split on an f32-noise gain."""
    rng = np.random.default_rng(5)
    windows = [_window(rng, 3000) for _ in range(3)]
    refs = {}
    for w, (x, y) in enumerate(windows):
        for api, params in ((C, PARAMS), (J, JAX_PARAMS)):
            ds = _create_dataset(x, y, params, refs.get(api), api)
            refs.setdefault(api, ds)
            bst = api.Ref()
            assert api.LGBM_BoosterCreate(ds, params, bst) == 0, \
                api.LGBM_GetLastError()
            fin = api.Ref()
            assert api.LGBM_BoosterUpdateChunked(bst.value, 8, 4,
                                                 fin) == 0, \
                api.LGBM_GetLastError()
            if api is C:
                tbst = bst.value
            else:
                jbst = bst.value
        _assert_same_trees_up_to_noise(_trees(J, jbst), _trees(C, tbst))
        C.LGBM_BoosterFree(tbst)
        J.LGBM_BoosterFree(jbst)


@pytest.mark.parametrize("predict_type", [0, 1, 2, 3])
def test_predict_types_equal_jax(predict_type):
    """NORMAL, RAW_SCORE, LEAF_INDEX and CONTRIB of one model through both
    layers (the port's model loaded into the JAX layer), with
    ``num_iteration`` of all and of the first three iterations."""
    rng = np.random.default_rng(6)
    x, y = _window(rng, 2000)
    xq, _ = _window(rng, 300)
    ds = _create_dataset(x, y)
    bst = C.Ref()
    assert C.LGBM_BoosterCreate(ds, PARAMS, bst) == 0
    fin = C.Ref()
    assert C.LGBM_BoosterUpdateChunked(bst.value, 6, 3, fin) == 0
    s = C.Ref()
    n = C.Ref()
    assert C.LGBM_BoosterSaveModelToString(bst.value, 0, -1, 0, n, s) == 0
    jb = J.Ref()
    it = J.Ref()
    assert J.LGBM_BoosterLoadModelFromString(s.value, it, jb) == 0
    for num_iteration in (-1, 3):
        got = _predict_csr(C, bst.value, xq, predict_type, num_iteration)
        want = _predict_csr(J, jb.value, xq, predict_type, num_iteration)
        assert got.shape == want.shape
        if predict_type == C.C_API_PREDICT_LEAF_INDEX:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_dataset_fields_subset_and_binary_file(tmp_path):
    rng = np.random.default_rng(7)
    x, y = _window(rng, 800)
    ds = _create_dataset(x, y)
    w = np.linspace(0.5, 1.5, 800).astype(np.float32)
    assert C.LGBM_DatasetSetField(ds, "weight", w, 800,
                                  C.C_API_DTYPE_FLOAT32) == 0
    init = np.linspace(-1, 1, 800)
    assert C.LGBM_DatasetSetField(ds, "init_score", init, 800,
                                  C.C_API_DTYPE_FLOAT64) == 0
    for field, want in (("label", y), ("weight", w), ("init_score", init)):
        ln, ptr, typ = C.Ref(), C.Ref(), C.Ref()
        assert C.LGBM_DatasetGetField(ds, field, ln, ptr, typ) == 0
        np.testing.assert_array_equal(ptr.value, want)
        assert ln.value == 800
    names = [f"c{i}" for i in range(20)]
    assert C.LGBM_DatasetSetFeatureNames(ds, names, 20) == 0
    out, ln = C.Ref(), C.Ref()
    assert C.LGBM_DatasetGetFeatureNames(ds, out, ln) == 0
    assert out.value == names and ln.value == 20
    idx = np.arange(0, 800, 3, dtype=np.int32)
    sub = C.Ref()
    assert C.LGBM_DatasetGetSubset(ds, idx, len(idx), PARAMS, sub) == 0
    nd = C.Ref()
    assert C.LGBM_DatasetGetNumData(sub.value, nd) == 0
    assert nd.value == len(idx)
    path = str(tmp_path / "d.bin")
    assert C.LGBM_DatasetSaveBinary(ds, path) == 0
    loaded = C.Ref()
    assert C.LGBM_DatasetCreateFromFile(path, PARAMS, None, loaded) == 0
    np.testing.assert_array_equal(
        C._get(loaded.value, C._DatasetEntry).binned.binned,
        C._get(ds, C._DatasetEntry).binned.binned)
    jl = J.Ref()
    assert J.LGBM_DatasetCreateFromFile(path, "", None, jl) == 0
    np.testing.assert_array_equal(
        np.asarray(J._get(jl.value, J._DatasetEntry).binned.binned),
        C._get(ds, C._DatasetEntry).binned.binned)


def test_booster_surface_rollback_custom_and_network():
    rng = np.random.default_rng(8)
    x, y = _window(rng, 1000)
    ds = _create_dataset(x, y)
    bst = C.Ref()
    assert C.LGBM_BoosterCreate(ds, PARAMS, bst) == 0
    fin = C.Ref()
    for _ in range(3):
        assert C.LGBM_BoosterUpdateOneIter(bst.value, fin) == 0
    assert C.LGBM_BoosterRollbackOneIter(bst.value) == 0
    it, per, total, k = C.Ref(), C.Ref(), C.Ref(), C.Ref()
    assert C.LGBM_BoosterGetCurrentIteration(bst.value, it) == 0
    assert C.LGBM_BoosterNumModelPerIteration(bst.value, per) == 0
    assert C.LGBM_BoosterNumberOfTotalModel(bst.value, total) == 0
    assert C.LGBM_BoosterGetNumClasses(bst.value, k) == 0
    assert (it.value, per.value, total.value, k.value) == (2, 1, 2, 1)
    grad = np.full(1000, 0.1, np.float32)
    hess = np.ones(1000, np.float32)
    assert C.LGBM_BoosterUpdateOneIterCustom(bst.value, grad, hess,
                                             fin) == 0, \
        C.LGBM_GetLastError()
    assert C.LGBM_NetworkInit("127.0.0.1:12400", 12400, 1, 2) == 0
    assert C._network_conf["num_machines"] == 2
    assert C.LGBM_NetworkFree() == 0
    assert C._network_conf["num_machines"] == 1
    assert C.LGBM_BoosterFree(bst.value) == 0
    assert C.LGBM_BoosterFree(bst.value) == -1
    assert "invalid Booster handle" in C.LGBM_GetLastError()


def test_serve_and_fleet_handles():
    rng = np.random.default_rng(9)
    x, y = _window(rng, 1500)
    ds = _create_dataset(x, y)
    bst = C.Ref()
    assert C.LGBM_BoosterCreate(ds, PARAMS, bst) == 0
    fin = C.Ref()
    assert C.LGBM_BoosterUpdateChunked(bst.value, 5, 5, fin) == 0
    want = _predict_csr(C, bst.value, x, C.C_API_PREDICT_NORMAL)
    srv = C.Ref()
    assert C.LGBM_ServeCreate(bst.value, PARAMS, srv) == 0, \
        C.LGBM_GetLastError()
    args = (x.indptr.astype(np.int32), C.C_API_DTYPE_INT32,
            x.indices.astype(np.int32), x.data.astype(np.float64),
            C.C_API_DTYPE_FLOAT64, len(x.indptr), x.nnz, x.shape[1],
            C.C_API_PREDICT_NORMAL)
    out, ln = np.zeros(1500), C.Ref()
    assert C.LGBM_ServePredictForCSR(srv.value, *args, ln, out) == 0
    np.testing.assert_allclose(out, want, rtol=0, atol=1e-6)
    fl = C.Ref()
    assert C.LGBM_FleetCreate(bst.value, 2, PARAMS, fl) == 0
    assert C.LGBM_FleetSwapTenant(fl.value, 1, bst.value) == 0
    tids = (np.arange(1500) % 2).astype(np.int32)
    fout = np.zeros(1500)
    assert C.LGBM_FleetPredictForCSR(fl.value, tids, 1500, *args, ln,
                                     fout) == 0, C.LGBM_GetLastError()
    np.testing.assert_array_equal(fout, out)
    assert C.LGBM_FleetFree(fl.value) == 0
    assert C.LGBM_ServeFree(srv.value) == 0
    assert C.LGBM_ServeFree(srv.value) == -1
    assert "invalid Serve handle" in C.LGBM_GetLastError()
