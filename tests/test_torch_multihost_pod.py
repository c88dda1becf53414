"""The port's multi-controller pod in real processes over gloo
(``data_sharding=multi_controller``; tests/_torch_multihost_worker.py is
one host): the JAX package's contract of ``tests/test_multihost.py``, on
its data and BASE (2,500 x 8, ``grad_quant_bits=8``, 15 leaves,
``max_bin`` 63, ``two_round``).

* the 2- and 4-process legs' trees are byte-equal to the port's in-process
  single-controller model over the same 4 CPU shards, on every host; the
  mapper broadcast gives every host the baseline's layout digest;
* bf16 (``grad_quant_bits=0``) in 2 processes: byte-equal too (each
  shard's plain f32 partial gathered and summed in global shard order);
* bagging with feature_fraction: the same trees at 1 and 2 processes;
* kill one host before it acks the iteration-4 snapshot: iteration 2
  commits, 4 does not, host 0's error names host 1; a fresh pod refuses
  the uncommitted snapshot, resumes the committed one and ends on the
  straight run's bytes;
* a dead coordinator fails fast with the probe's error;
* the baseline's int8 tree is the JAX grower's
  (``test_torch_shard.py::test_int8_sharded_tree_equals_jax``'s bar).
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
import _torch_multihost_worker as mhw   # noqa: E402 — path set above

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """This module's torch CPU ops on one thread (several test workers
    share the machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run_pod(scenario, hosts, outdir, **kw):
    return mhw.run_pod(scenario, hosts, outdir, **kw)


def _leg_dir(pod_dir, name):
    sub = pod_dir / name
    sub.mkdir()
    os.link(mhw.data_path(str(pod_dir)), mhw.data_path(str(sub)))
    return sub


@pytest.fixture(scope="module")
def pod_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_multihost")
    mhw.write_csv(str(d))
    return d


def _baseline(pod_dir, extra):
    """The in-process single-controller model over 4 CPU shards, from
    ``load_text_two_round`` of the same file."""
    cfg, ds = mhw.load(mhw.params(0, 1, 0, extra),
                       mhw.data_path(str(pod_dir)))
    bst = mhw.train(cfg, ds, mesh=[CPU] * mhw.TOTAL_SHARDS)
    assert bst._grower.mesh == [CPU] * mhw.TOTAL_SHARDS
    from lightgbm_tpu_torch.pipeline.bins import reference_layout_digest
    return {"trees": mhw.trees_of(bst.model_to_string()),
            "layout_digest": reference_layout_digest(ds)}


@pytest.fixture(scope="module")
def baseline(pod_dir):
    return _baseline(pod_dir, {})


@pytest.mark.parametrize("hosts", [2, 4])
def test_pod_legs_equal_single_controller(pod_dir, baseline, hosts):
    reps = _run_pod("train", hosts, _leg_dir(pod_dir, f"train{hosts}"))
    for rep in reps:
        assert rep["trees"] == baseline["trees"], \
            f"host {rep['rank']} of {hosts} diverged from single_controller"
        assert rep["layout_digest"] == baseline["layout_digest"]
        assert rep["hosts_gauge"] == hosts
        # a host whose block is all padding bins no row
        real = rep["row_span"][0] < mhw.ROWS
        assert (rep["ingest_rows_per_s"] > 0) == real
        # one reduction a wave; the refit's leaf sums; one score gather a
        # tree
        assert rep["comm"]["gather_rows"]["calls"] == mhw.ITERS
        assert rep["comm"]["refit"]["calls"] == mhw.ITERS
        assert rep["comm"]["gather_shards"]["calls"] >= mhw.ITERS
        for what in ("rollback", "profile"):
            assert "not supported under data_sharding=multi_controller" \
                in rep[f"{what}_refused"]
    spans = [tuple(r["row_span"]) for r in reps]
    assert spans[0][0] == 0 and all(a[1] == b[0]
                                    for a, b in zip(spans, spans[1:]))
    assert len({s[1] - s[0] for s in spans}) == 1


def test_pod_bf16_equals_single_controller(pod_dir):
    want = _baseline(pod_dir, mhw.BF16)
    reps = _run_pod("bf16", 2, _leg_dir(pod_dir, "bf16"))
    assert reps[0]["trees"] == reps[1]["trees"] == want["trees"]
    assert "refit" not in reps[0]["comm"]


def test_pod_bagging_feature_fraction_host_invariant(pod_dir):
    one = _baseline(pod_dir, mhw.BAGFF)
    two = _run_pod("bagff", 2, _leg_dir(pod_dir, "bagff"))
    assert two[0]["trees"] == two[1]["trees"] == one["trees"], \
        "bagging/feature_fraction draws depend on the host count"


def test_pod_kill_one_host_resume_byte_identical(pod_dir, baseline):
    kill = _leg_dir(pod_dir, "kill")
    reps = _run_pod("killA", 2, kill,
                    expected_exits={1: mhw.KILLED_EXIT})
    r0 = reps[0]
    assert reps[1] is None
    assert r0["commit2"] is True, "iter-2 snapshot never committed"
    assert r0["commit4"] is False, \
        "iter-4 snapshot committed without the victim's ack"
    assert "no ack from host(s) [1]" in r0["ack_timeout_error"]
    reps = _run_pod("killB", 2, kill)
    for rep in reps:
        assert "no pod commit marker" in rep["uncommitted_refused"]
        assert rep["commit2"] is True and rep["commit4"] is False
        assert rep["trees"] == baseline["trees"], \
            "resume after host death diverged from the straight run"


def test_dead_coordinator_fails_fast(tmp_path):
    rep = _run_pod("deadcoord", 1, tmp_path, timeout=90)[0]
    assert "unreachable after 3 attempts" in rep["failfast_error"]
    assert rep["elapsed_s"] < 60.0


def test_baseline_int8_tree_equals_jax(pod_dir):
    """One quantized tree of the baseline's grower (4 shards of the pod
    data) against the JAX grower on the same codes and gradients:
    integer fields byte-equal, the rest within 1e-6."""
    import jax.numpy as jnp
    from lightgbm_tpu.config import Config as JConfig
    from lightgbm_tpu.data.dataset import BinnedDataset as JDataset
    from lightgbm_tpu.ops.grow import DeviceGrower as JGrower
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.data.dataset import BinnedDataset
    from lightgbm_tpu_torch.ops.grow import DeviceGrower
    data = np.loadtxt(mhw.data_path(str(pod_dir)), delimiter=",")
    x = data[:, 1:]
    p = {k: v for k, v in mhw.BASE.items()
         if k not in ("device", "two_round", "verbosity")}
    p.update(verbose=-1, hist_kernel="interpret", learning_rate=0.1)
    rng = np.random.default_rng(17)
    n = len(x)
    score = rng.standard_normal(n).astype(np.float32) * 0.1
    grad = rng.standard_normal(n).astype(np.float32)
    hess = rng.uniform(0.05, 0.3, n).astype(np.float32)
    jc = JConfig({**p, "device_growth": "on"})
    tc = Config({**p, "device": "cpu"})
    jg = JGrower(JDataset.construct_from_matrix(x, jc), jc)
    tg = DeviceGrower(BinnedDataset.construct_from_matrix(x, tc), tc, CPU,
                      mesh=[CPU] * mhw.TOTAL_SHARDS)
    out = jg.grow_one_iter(jnp.asarray(score), jnp.asarray(grad),
                           jnp.asarray(hess), jg.feature_mask_for(3),
                           tree_idx=3)
    res = tg.grow_one_iter(torch.from_numpy(score), torch.from_numpy(grad),
                           torch.from_numpy(hess),
                           feature_mask=tg.feature_mask_for(3), tree_idx=3)
    nl = int(out[4])
    assert int(res.num_leaves) == nl >= 3
    np.testing.assert_array_equal(res.rec_i.numpy()[:nl - 1],
                                  np.asarray(out[1])[:nl - 1])
    got, want = res.rec_f.numpy()[:nl - 1], np.asarray(out[2])[:nl - 1]
    exact = [1, 2, 3, 6]
    np.testing.assert_array_equal(got[:, exact], want[:, exact])
    assert (np.abs(got - want) <= 1e-6 * np.abs(want).max(axis=0)).all()
    np.testing.assert_allclose(res.score.numpy(), np.asarray(out[0]),
                               rtol=0, atol=1e-6)
