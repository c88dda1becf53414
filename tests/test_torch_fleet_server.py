"""The port's ``FleetServer`` and ``TenantHandle`` (``serve/fleet.py``) on
the CPU: ``tests/test_fleet.py``'s cases re-pointed at the port (the
degrade-to-host ones in ``tests/test_torch_degrade.py``; here a fleet
with ``host_fallback=True``, the default, answers the injected dispatch
fault from the host walk, and a real device error raises with it and
without it).  Every tenant answers
byte-identically to its solo pack and server (missing modes, categorical
bitsets, a model loaded from text, mixed-tenant batches), a tenant swap
that fits is an index copy with no capture while the other tenants keep
answering, one that outgrows the pads re-stacks the fleet, bf16 values
keep the routing exact, multiclass and RF tenants answer as their
``Booster.predict``, the micro-batching queues a replica resolve to what
``predict`` returns, and the JAX package's FleetServer gives the same
answers on the same trees."""

import numpy as np
import pytest
import torch

from lightgbm_tpu.serve import FleetServer as JFleetServer
from lightgbm_tpu_torch import LightGBMError
from lightgbm_tpu_torch.boosting import create_boosting
from lightgbm_tpu_torch.boosting.gbdt import GBDT
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.data.dataset import BinnedDataset
from lightgbm_tpu_torch.obs import capture_track
from lightgbm_tpu_torch.serve import (FleetServer, PredictionServer,
                                      fleet_predict_leaves,
                                      fleet_predict_scores, pack_fleet,
                                      predict_leaves, predict_scores)
from lightgbm_tpu_torch.serve import fleet as fleet_mod


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """This module's torch CPU ops on one thread (several test workers
    share the machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _train(params, x, y, n_iters=5, categorical=()):
    cfg = Config({"verbosity": -1, "device": "cpu", "num_leaves": 15,
                  "min_data_in_leaf": 5, "max_depth": 6, **params})
    ds = BinnedDataset.construct_from_matrix(x, cfg, list(categorical))
    ds.metadata.set_label(y)
    bst = create_boosting(cfg)
    bst.init_train(ds)
    for _ in range(n_iters):
        if bst.train_one_iter():
            break
    bst._flush_pending()
    return bst


def _binary_booster(seed, nf=8, n_iters=5, nan_frac=0.05, **params):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((1500, nf)).astype(np.float32)
    if nan_frac:
        x[rng.random(x.shape) < nan_frac] = np.nan
    y = (np.nan_to_num(x[:, 0]) + np.abs(np.nan_to_num(x[:, 1]))
         > 0.4).astype(np.float32)
    return _train({"objective": "binary", **params}, x, y, n_iters)


def _query(seed, nf=8, n=400):
    rng = np.random.default_rng(seed)
    xq = rng.standard_normal((n, nf))
    xq[rng.random(xq.shape) < 0.1] = np.nan
    return xq


@pytest.fixture(scope="module")
def trio():
    boosters = [_binary_booster(s) for s in (1, 2, 3)]
    fl, packs = pack_fleet(boosters, device="cpu")
    return boosters, packs, fl


def _assert_tenant_identity(fl, packs, xq):
    for m, pe in enumerate(packs):
        np.testing.assert_array_equal(
            fleet_predict_leaves(fl, m, xq)[:, :pe.num_trees],
            predict_leaves(pe, xq))
        np.testing.assert_array_equal(
            fleet_predict_scores(fl, m, xq), predict_scores(pe, xq))


def _server(booster):
    return PredictionServer(booster, device="cpu")


def test_fleet_per_tenant_byte_identity(trio):
    _, packs, fl = trio
    _assert_tenant_identity(fl, packs, _query(0))


def test_fleet_missing_mode_tenant_mix():
    rng = np.random.default_rng(11)
    xz = rng.standard_normal((1500, 8)).astype(np.float32)
    xz[rng.random(xz.shape) < 0.3] = 0.0
    yz = (xz[:, 0] + xz[:, 1] > 0.3).astype(np.float32)
    zb = _train({"objective": "binary", "zero_as_missing": True}, xz, yz)
    fs = FleetServer([_binary_booster(1), zb], device="cpu")
    xq = _query(5)
    xq[rng.random(xq.shape) < 0.2] = 0.0
    xq[rng.random(xq.shape) < 0.05] = 1e-40
    for m, b in enumerate((_binary_booster(1), zb)):
        np.testing.assert_array_equal(fs.predict(m, xq),
                                      _server(b).predict(xq))


def test_fleet_categorical_tenants():
    def cat_booster(seed):
        rng = np.random.default_rng(seed)
        n = 2000
        cat = rng.integers(0, 12, n)
        x = np.column_stack([cat.astype(np.float32),
                             rng.standard_normal(n).astype(np.float32),
                             rng.standard_normal(n).astype(np.float32)])
        effect = rng.standard_normal(12) * 2.0
        y = (effect[cat] + x[:, 1]).astype(np.float32)
        return _train({"objective": "regression", "num_leaves": 31,
                       "min_data_in_leaf": 40, "min_gain_to_split": 1e-3},
                      x, y, n_iters=4, categorical=[0])

    boosters = [cat_booster(13), cat_booster(29)]
    assert all(any(t.num_cat > 0 for t in b.models) for b in boosters)
    fs = FleetServer(boosters, device="cpu")
    rng = np.random.default_rng(7)
    xq = np.column_stack([rng.integers(-3, 40, 600).astype(np.float64),
                          rng.standard_normal(600),
                          rng.standard_normal(600)])
    xq[rng.random(600) < 0.1, 0] = np.nan
    for m, b in enumerate(boosters):
        np.testing.assert_array_equal(fs.predict(m, xq),
                                      _server(b).predict(xq))


def test_fleet_file_loaded_tenant(trio):
    boosters, _, _ = trio
    loaded = GBDT.load_model_from_string(boosters[0].model_to_string())
    fs = FleetServer([loaded, boosters[1]], device="cpu")
    xq = _query(2)
    np.testing.assert_array_equal(fs.predict(0, xq),
                                  _server(boosters[0]).predict(xq))


def test_fleet_mixed_tenant_batch(trio):
    boosters, packs, fl = trio
    xq = _query(3)
    tids = np.random.default_rng(4).integers(0, 3, xq.shape[0]) \
        .astype(np.int32)
    mixed = fleet_predict_scores(fl, tids, xq)
    fs = FleetServer(boosters, device="cpu")
    out = fs.predict(tids, xq)
    for m, pe in enumerate(packs):
        rows = np.nonzero(tids == m)[0]
        np.testing.assert_array_equal(mixed[:, rows],
                                      predict_scores(pe, xq[rows]))
        np.testing.assert_array_equal(
            out[rows], _server(boosters[m]).predict(xq[rows]))


def test_fleet_swap_no_capture_while_others_serve(trio):
    """After warm-up, retraining one tenant swaps in as an index copy into
    the same fleet: no capture, no new fleet, the other tenants answer
    byte-identically throughout."""
    boosters, packs, _ = trio
    fs = FleetServer(boosters, device="cpu")
    xq = _query(6)
    assert fs.warmup([xq.shape[0]]) == [512]
    fs.predict(0, xq)
    fleet0 = fs.fleet
    captures = capture_track.COUNTS["captures"]
    before2 = predict_scores(packs[2], xq)
    for seed in (21, 22):
        nb = _binary_booster(seed)
        assert fs.swap_tenant(1, nb) is True
        np.testing.assert_array_equal(fs.predict(2, xq, True), before2[0])
        np.testing.assert_array_equal(fs.predict(1, xq),
                                      _server(nb).predict(xq))
    assert fs.fleet is fleet0
    assert capture_track.COUNTS["captures"] == captures


def test_fleet_swap_shape_growth(trio):
    boosters, _, _ = trio
    fs = FleetServer(boosters, device="cpu")
    big = _binary_booster(31, n_iters=9)   # 9 iterations > the 8-tree pad
    assert fs.swap_tenant(1, big) is False
    xq = _query(8)
    _, packs = pack_fleet([boosters[0], big, boosters[2]], device="cpu")
    _assert_tenant_identity(fs.fleet, packs, xq)


def test_fleet_bf16_values_quantize_routing_exact(trio):
    boosters, packs, _ = trio
    fs = FleetServer(boosters, value_dtype="bf16", device="cpu")
    xq = _query(12)
    for m, pe in enumerate(packs):
        np.testing.assert_array_equal(
            fleet_predict_leaves(fs.fleet, m, xq)[:, :pe.num_trees],
            predict_leaves(pe, xq))
        sq = fleet_predict_scores(fs.fleet, m, xq)
        ss = predict_scores(pe, xq)
        np.testing.assert_allclose(sq, ss, rtol=0.05, atol=0.05)
        assert not np.array_equal(sq, ss)
    assert fs.fleet.leaf_value.dtype == torch.bfloat16


def test_fleet_multiclass_and_rf_tenants():
    """Multiclass (num_model=3) and RF-averaged tenants stacked two a
    fleet answer as their own ``Booster.predict`` (host walk: float64 sums
    against the kernel's float32)."""
    rng = np.random.default_rng(40)

    def mc_booster(seed):
        r = np.random.default_rng(seed)
        x = r.standard_normal((1500, 6)).astype(np.float32)
        y = np.digitize(x[:, 0] + 0.5 * x[:, 1],
                        [-0.5, 0.5]).astype(np.float32)
        return _train({"objective": "multiclass", "num_class": 3}, x, y, 4)

    def rf_booster(seed):
        r = np.random.default_rng(seed)
        x = r.standard_normal((1500, 6)).astype(np.float32)
        y = (x[:, 0] + x[:, 1] > 0).astype(np.float32)
        return _train({"objective": "binary", "boosting": "rf",
                       "bagging_freq": 1, "bagging_fraction": 0.7},
                      x, y, 4)

    for make in (mc_booster, rf_booster):
        boosters = [make(41), make(42)]
        fs = FleetServer(boosters, device="cpu")
        xq = rng.standard_normal((300, 6))
        tids = rng.integers(0, 2, 300).astype(np.int32)
        got = fs.predict(tids, xq)
        want = np.empty_like(np.asarray(got))
        for m, b in enumerate(boosters):
            rows = np.nonzero(tids == m)[0]
            b.config.device_predict = "off"
            want[rows] = b.predict(xq[rows])
            np.testing.assert_array_equal(
                got[rows], _server(b).predict(xq[rows]))
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


def test_tenant_handle_surface(trio):
    boosters, _, _ = trio
    fs = FleetServer(boosters, device="cpu")
    h = fs.tenant(2)
    xq = _query(14)
    np.testing.assert_array_equal(h.predict(xq), fs.predict(2, xq))
    assert h._model is fs._snapshot().metas[2]
    nb = _binary_booster(51)
    assert h.swap(nb) is True
    np.testing.assert_array_equal(h.predict(xq), _server(nb).predict(xq))
    assert h.warmup([100]) == [128]
    h.stop()
    with pytest.raises(LightGBMError, match="out of range"):
        fs.tenant(3)


def test_fleet_submit_round_robin(trio):
    boosters, _, _ = trio
    fs = FleetServer(boosters, replicas=2, max_wait_ms=5.0, device="cpu")
    assert fs.num_replicas == 2
    rng = np.random.default_rng(15)
    queries = [(m, rng.standard_normal((n, 8)))
               for m, n in ((0, 17), (1, 64), (2, 33))]
    with fs:
        futs = [fs.submit(m, q) for m, q in queries]
        got = [f.result(timeout=30) for f in futs]
        bad = fs.submit(7, queries[0][1])
        with pytest.raises(LightGBMError, match="tenant_ids"):
            bad.result(timeout=30)
    for (m, q), g in zip(queries, got):
        np.testing.assert_array_equal(g, fs.predict(m, q))
    with pytest.raises(LightGBMError):
        fs.submit(0, queries[0][1])


def test_fleet_input_errors(trio):
    boosters, _, _ = trio
    fs = FleetServer(boosters, device="cpu")
    with pytest.raises(LightGBMError, match="tenant_ids"):
        fs.predict(np.array([0, 1]), np.zeros((3, 8)))
    with pytest.raises(LightGBMError, match=r"\[0, 3\)"):
        fs.predict(7, np.zeros((3, 8)))
    with pytest.raises(LightGBMError, match="features"):
        fs.predict(0, np.zeros((3, 2)))
    with pytest.raises(LightGBMError, match="at least one tenant"):
        FleetServer([], device="cpu")
    with pytest.raises(LightGBMError, match="value_dtype"):
        FleetServer(boosters, value_dtype="fp8", device="cpu")


def test_host_fallback_degrades_and_device_error_raises_without_it(
        trio, monkeypatch):
    """``host_fallback=True`` (the default, as in the JAX package) answers
    the injected dispatch fault from each tenant's host walk and counts
    it; a real device error raises to the caller, with the fallback on
    (where the JAX package would degrade) and without it."""
    from lightgbm_tpu_torch.robust import faults
    from lightgbm_tpu_torch.serve import engine
    boosters, _, _ = trio

    def device_error(*a, **k):
        raise RuntimeError("CUDA error: an illegal memory access")
    xq = _query(16)
    want = np.stack([fleet_mod.fleet_predict_scores(
        pack_fleet([b], device="cpu")[0], 0, xq)[0] for b in boosters])
    fs = FleetServer(boosters, device="cpu")
    assert fs.host_fallback
    before = engine.FALLBACK_COUNTS["fleet"]
    tid = np.arange(len(xq)) % 3
    faults.configure("serve.fleet.dispatch:n=1")
    try:
        got = fs.predict(tid, xq, raw_score=True)
    finally:
        faults.clear()
    np.testing.assert_allclose(got, want[tid, np.arange(len(xq))],
                               rtol=1e-5, atol=1e-6)
    assert engine.FALLBACK_COUNTS["fleet"] == before + 1
    monkeypatch.setattr(fleet_mod, "fleet_predict_scores", device_error)
    off = FleetServer(boosters, host_fallback=False, device="cpu")
    for server in (fs, off):
        with pytest.raises(RuntimeError, match="illegal memory access"):
            server.predict(0, xq)
    assert engine.FALLBACK_COUNTS["fleet"] == before + 1


def test_fleet_answers_as_the_jax_fleet_server():
    """The same trees (the port's models loaded into the JAX package)
    through both FleetServers: converted answers within the two packages'
    float32 summation orders."""
    boosters = [_binary_booster(s) for s in (61, 62)]
    from lightgbm_tpu.boosting.gbdt import GBDT as JGBDT
    jb = [JGBDT.load_model_from_string(b.model_to_string())
          for b in boosters]
    xq = _query(17)
    tids = (np.arange(xq.shape[0]) % 2).astype(np.int32)
    got = FleetServer(boosters, device="cpu").predict(tids, xq)
    want = JFleetServer(jb).predict(tids, xq)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
