"""Training checkpoints in the port (``GBDT.train_chunked(snapshot_freq)``,
``save_checkpoint``, ``resume_from_checkpoint``; ``robust/checkpoint.py``).

A run stopped after a snapshot and resumed from it must give a model text
byte-equal to the uninterrupted run.  That needs every piece of state a
tree reads: the exact float32 scores (copied back into the score buffer
in place), the iteration that keys the bagging and feature_fraction
draws, the bagging mask of a round the resume lands inside, and under
``grad_quant_bits=8`` the quantization noise's key.  The cases: ``gbdt``
with bagging (a round of 3 iterations: the resume at iteration 10 lands
inside one) and ``feature_fraction``, and ``grad_quant_bits=8``; fused
chunks of 5 and the per-iteration path; a fused chunk longer than the
snapshot period (the dispatches are cut at the boundaries).  Also the
cases of ``tests/test_robust.py``'s snapshot section re-pointed at the
port, and the snapshot's model text read by the JAX package.
"""

import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
import parity_data as pd
from lightgbm_tpu_torch.boosting.gbdt import GBDT
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.data.dataset import BinnedDataset
from lightgbm_tpu_torch.robust import checkpoint, faults
from lightgbm_tpu_torch.utils.log import LightGBMError

BASE = {"objective": "binary", "num_leaves": 15, "max_bin": 63,
        "min_data_in_leaf": 5, "verbosity": -1, "metric": "none",
        "device": "cpu"}
CASES = {
    "bagging_ff": {"bagging_fraction": 0.8, "bagging_freq": 3,
                   "feature_fraction": 0.8},
    "int8": {"grad_quant_bits": 8, "bagging_fraction": 0.8,
             "bagging_freq": 3},
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """This module's torch CPU ops on one thread (several test workers
    share the machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    x = pd.make_features()[:1500]
    y = pd.make_labels(pd.make_features())[0][:1500]
    return x, y


def _gbdt(params, x, y):
    cfg = Config({**BASE, **params})
    ds = BinnedDataset.construct_from_matrix(np.asarray(x, np.float64), cfg)
    ds.metadata.set_label(y)
    g = GBDT(cfg)
    g.init_train(ds)
    return g


@pytest.mark.parametrize("chunk", [5, 1, 20])
@pytest.mark.parametrize("case", sorted(CASES))
def test_snapshot_resume_byte_identical(tmp_path, data, case, chunk):
    x, y = data
    params = CASES[case]
    ref = _gbdt(params, x, y)
    ref.train_chunked(20, chunk=chunk)
    want = ref.model_to_string()

    path = str(tmp_path / "m.txt")
    killed = _gbdt(params, x, y)
    killed.train_chunked(10, chunk=chunk, snapshot_freq=5,
                         snapshot_path=path)
    snap = checkpoint.latest_snapshot(path)
    assert snap == path + ".snapshot_iter_10"
    # the snapshots hold the trees of the first 5 and 10 iterations of the
    # run (a sliced text's importance block counts every tree)
    for it in (5, 10):
        text = open(f"{path}.snapshot_iter_{it}").read()
        assert text.split("end of trees")[0] \
            == ref.model_to_string(num_iteration=it).split("end of trees")[0]

    resumed = _gbdt(params, x, y)
    resumed.resume_from_checkpoint(snap)
    assert resumed.iter == 10
    resumed.train_chunked(10, chunk=chunk, snapshot_freq=5,
                          snapshot_path=path)
    assert resumed.model_to_string() == want
    np.testing.assert_array_equal(resumed.train_score.numpy(),
                                  ref.train_score.numpy())
    assert checkpoint.latest_snapshot(path) == path + ".snapshot_iter_20"


def test_snapshot_text_loads_in_the_jax_package(tmp_path, data):
    x, y = data
    g = _gbdt(CASES["bagging_ff"], x, y)
    path = str(tmp_path / "m.txt")
    g.train_chunked(5, chunk=5, snapshot_freq=5, snapshot_path=path)
    jb = jlgb.Booster(model_file=path + ".snapshot_iter_5")
    np.testing.assert_allclose(np.asarray(jb.predict(x, raw_score=True)),
                               g.predict(x, raw_score=True), rtol=0,
                               atol=1e-12)
    score, it, rng_state = checkpoint.load_train_state(
        path + ".snapshot_iter_5.state.npz")
    assert it == 5 and rng_state is None
    np.testing.assert_array_equal(score, g.train_score.numpy())


def test_latest_snapshot_requires_state_sidecar(tmp_path):
    base = str(tmp_path / "m.txt")
    for it in (2, 4):
        checkpoint.atomic_write_text(f"{base}.snapshot_iter_{it}", "x")
        checkpoint.save_train_state(
            f"{base}.snapshot_iter_{it}.state.npz",
            np.zeros((1, 4), np.float32), it)
    checkpoint.atomic_write_text(f"{base}.snapshot_iter_6", "x")
    assert checkpoint.latest_snapshot(base).endswith("snapshot_iter_4")
    assert checkpoint.latest_snapshot(str(tmp_path / "none.txt")) is None


def test_resume_rejects_mismatched_data(tmp_path, data):
    x, y = data
    bst = _gbdt(CASES["bagging_ff"], x, y)
    base = str(tmp_path / "m.txt")
    bst.train_chunked(2, chunk=2, snapshot_freq=2, snapshot_path=base)
    other = _gbdt(CASES["bagging_ff"], x[:500], y[:500])
    with pytest.raises(LightGBMError, match="SAME training data"):
        other.resume_from_checkpoint(checkpoint.latest_snapshot(base))


def test_interrupted_snapshot_write_keeps_the_previous_one(tmp_path, data):
    """An ``io.write`` fault between the temp write and the rename of the
    second snapshot's model text raises out of training and leaves the
    first snapshot whole: it still resumes."""
    x, y = data
    base = str(tmp_path / "m.txt")
    g = _gbdt(CASES["bagging_ff"], x, y)
    faults.configure("io.write:at=2")      # 0, 1: snapshot 2; 2: snapshot 4
    try:
        with pytest.raises(faults.InjectedFault):
            g.train_chunked(4, chunk=2, snapshot_freq=2,
                            snapshot_path=base)
    finally:
        faults.clear()
    assert checkpoint.latest_snapshot(base) == base + ".snapshot_iter_2"
    resumed = _gbdt(CASES["bagging_ff"], x, y)
    resumed.resume_from_checkpoint(base + ".snapshot_iter_2")
    assert resumed.iter == 2
