"""The port's in-process distributed plane (``parallel/network.py``, the
data-, feature- and voting-parallel learners, ``parallel/__init__.py``)
against the JAX package's on its 8-device CPU mesh (``tests/conftest.py``),
with 8 CPU workers in the port:

* every ``Network`` verb, ``argmax_allreduce``'s tie rule included, and
  the bytes each logs;
* one tree of each learner (voting with ``top_k`` covering every feature)
  equal to the JAX learner's and to the port's serial learner's;
* 10 boosted rounds through the boosting loop with a validation set: AUC
  within 1e-6 of the serial run, predictions within 1e-5
  (``tests/test_parallel.py::test_boosting_parallel_matches_serial``);
  bagging and GOSS on the row-sharded learners draw the serial learner's
  selection, so they match the serial run too;
* the comm volume of the data- and voting-parallel learners equal to the
  JAX learners';
* the factory's serial fallback and its ``multi_controller`` refusal.

"Equal trees": the same split features, children, leaf counts and leaf of
every row, leaf values within 1e-5 of the tree's largest (the port's CPU
plain version sums each worker's f32 histogram in worker order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import parity_data as pd
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.data.dataset import BinnedDataset as JDataset
from lightgbm_tpu.parallel import create_tree_learner as jcreate
from lightgbm_tpu.parallel.network import Network as JNetwork
from lightgbm_tpu.parallel.network import make_mesh as jmake_mesh
from lightgbm_tpu_torch.boosting import create_boosting
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.data.dataset import BinnedDataset, Metadata
from lightgbm_tpu_torch.parallel import create_tree_learner
from lightgbm_tpu_torch.parallel.network import Network, make_mesh
from lightgbm_tpu_torch.tree.learner import SerialTreeLearner
from lightgbm_tpu_torch.utils.log import LightGBMError

CPU = torch.device("cpu")
MESH = [CPU] * 8


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
    x = pd.make_features()
    y = pd.make_labels(x)[0]
    return x[:1800], y[:1800], x[1800:], y[1800:]


@pytest.fixture(scope="module")
def nets():
    return JNetwork(num_machines=8), Network(mesh=MESH)


# ---------------------------------------------------------------------------
# the verbs
def _jax_verb(jnet, fn, x, out_spec):
    f = jnet.run_sharded(fn, in_specs=P(jnet.axis), out_specs=out_spec)
    return np.asarray(jax.jit(f)(jnet.shard_rows(jnp.asarray(x))))


def test_network_verbs_equal_jax(nets):
    jnet, tnet = nets
    x = np.arange(8 * 32, dtype=np.float32).reshape(8 * 8, 4) ** 1.5
    xs = tnet.shard_rows(torch.from_numpy(x))
    assert [tuple(t.shape) for t in xs] == [(8, 4)] * 8
    jnet.reset_comm_log()
    tnet.reset_comm_log()
    cases = [
        ("allreduce", lambda a: jnet.allreduce(a), P(), tnet.allreduce),
        ("reduce_scatter", lambda a: jnet.reduce_scatter(a),
         P(jnet.axis), tnet.reduce_scatter),
        ("allreduce_max", lambda a: jnet.allreduce_max(a), P(),
         tnet.allreduce_max),
        ("allreduce_min", lambda a: jnet.allreduce_min(a), P(),
         tnet.allreduce_min),
    ]
    for name, jfn, spec, tfn in cases:
        want = _jax_verb(jnet, jfn, x, spec)
        got = tfn(xs)
        assert len(got) == 8
        if name == "reduce_scatter":
            got = torch.cat(got)
        else:
            assert all(torch.equal(g, got[0]) for g in got)
            got = got[0]
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                   err_msg=name)
    gathered = _jax_verb(jnet, lambda a: jnet.all_gather(a), x,
                         P(jnet.axis, None))
    got = tnet.all_gather(xs)
    np.testing.assert_array_equal(got[0].numpy(), gathered[:8])
    assert tnet.comm_log == jnet.comm_log
    np.testing.assert_allclose(tnet.global_sum(xs).numpy(),
                               x.reshape(8, 8, 4).sum(0))
    assert tnet.sync_up_by_min(3.5) == jnet.sync_up_by_min(3.5) == 3.5
    assert tnet.sync_up_by_mean(2) == 2 and tnet.sync_up_by_max(1) == 1
    assert [t.item() for t in tnet.replicate(torch.tensor(7))] == [7] * 8
    out = tnet.run_sharded(lambda a, s: a.sum() * s)(xs, 2.0)
    np.testing.assert_allclose(torch.stack(out).numpy(),
                               x.reshape(8, 32).sum(1) * 2, rtol=1e-6)


@pytest.mark.parametrize("keys", ["ties", "distinct"])
def test_argmax_allreduce_tie_rule_equals_jax(nets, keys):
    jnet, tnet = nets
    d = 8
    k = np.ones(d, np.float32) if keys == "ties" else \
        np.asarray([3, 9, 1, 9, 2, 9, 0, 4], np.float32)
    tie = np.arange(d)[::-1].astype(np.int32)
    pay = np.arange(d, dtype=np.float32) * 10

    def body(kk, t, p):
        out, _ = jnet.argmax_allreduce(kk[0], p[0], t[0])
        return out[None]
    f = jnet.run_sharded(body, in_specs=(P(jnet.axis),) * 3,
                         out_specs=P(jnet.axis))
    want = np.asarray(jax.jit(f)(jnp.asarray(k), jnp.asarray(tie),
                                 jnp.asarray(pay)))
    out, owner = tnet.argmax_allreduce(
        [torch.tensor(v) for v in k], [torch.tensor(v) for v in pay],
        [torch.tensor(v) for v in tie])
    np.testing.assert_array_equal(torch.stack(out).numpy(), want)
    assert sum(bool(o) for o in owner) == 1
    pair, _ = tnet.argmax_allreduce(
        [torch.tensor(v) for v in k],
        [(torch.tensor(v), torch.tensor(-v)) for v in pay],
        [torch.tensor(v) for v in tie])
    assert float(pair[3][1]) == -float(want[0])


def test_make_mesh_and_factory_refusals(data):
    x, y, _, _ = data
    assert make_mesh(3, ["cpu"] * 4) == [CPU] * 3
    with pytest.raises(LightGBMError, match="exceeds available devices"):
        make_mesh(4, [CPU])
    cfg = Config({"objective": "binary", "tree_learner": "data",
                  "num_machines": 1})
    ds = BinnedDataset.construct_from_matrix(x, cfg)
    assert type(create_tree_learner(cfg, ds, CPU)) is SerialTreeLearner
    bad = Config({"tree_learner": "data", "num_machines": 2,
                  "data_sharding": "multi_controller"})
    with pytest.raises(LightGBMError, match="cannot be combined with "
                                            "data_sharding=multi_controller"):
        create_tree_learner(bad, ds, CPU, mesh=MESH[:2])


# ---------------------------------------------------------------------------
# the learners
def _grads(y, seed=1):
    rng = np.random.default_rng(seed)
    p = 1.0 / (1.0 + np.exp(-rng.standard_normal(len(y)) * 0.5))
    return (p - y).astype(np.float32), (p * (1 - p)).astype(np.float32)


def _assert_same_tree(a, b, x):
    n = a.num_leaves
    assert b.num_leaves == n
    for name in ("split_feature", "left_child", "right_child"):
        np.testing.assert_array_equal(getattr(b, name)[:n - 1],
                                      getattr(a, name)[:n - 1], name)
    np.testing.assert_array_equal(b.leaf_count[:n], a.leaf_count[:n])
    np.testing.assert_array_equal(b.predict_leaf(x), a.predict_leaf(x))
    scale = float(np.abs(a.leaf_value[:n]).max())
    np.testing.assert_allclose(b.leaf_value[:n], a.leaf_value[:n],
                               rtol=1e-5, atol=1e-5 * scale)


LEARN = {"objective": "binary", "num_leaves": 31, "max_bin": 63,
         "verbose": -1, "top_k": 40}


@pytest.mark.parametrize("kind", ["data", "feature", "voting"])
def test_one_tree_equals_jax_and_serial(data, kind):
    x, y, _, _ = data
    g, h = _grads(y)
    params = {**LEARN, "tree_learner": kind, "num_machines": 8}
    jcfg = JConfig(params)
    jds = JDataset.construct_from_matrix(x, jcfg, ())
    jt = jcreate(jcfg, jds).train(jnp.asarray(g), jnp.asarray(h))
    cfg = Config(params)
    ds = BinnedDataset.construct_from_matrix(x, cfg)
    learner = create_tree_learner(cfg, ds, CPU, mesh=MESH)
    assert type(learner).__name__.lower().startswith(kind)
    tt = learner.train(torch.from_numpy(g), torch.from_numpy(h))
    st = SerialTreeLearner(Config(LEARN), ds, CPU).train(
        torch.from_numpy(g), torch.from_numpy(h))
    _assert_same_tree(st, tt, x)
    _assert_same_tree(jt, tt, x)
    if kind == "feature":
        assert tt.to_string() == st.to_string()


def _boosted(x, y, xv, yv, params, mesh, rounds=10):
    cfg = Config({"objective": "binary", "metric": "auc", "num_leaves": 15,
                  "learning_rate": 0.1, "top_k": 40, "verbose": -1,
                  "device": "cpu", "device_growth": "off", **params})
    ds = BinnedDataset.construct_from_matrix(x, cfg)
    ds.metadata.set_label(y)
    b = create_boosting(cfg)
    b.mesh = mesh
    b.init_train(ds)
    v = BinnedDataset.construct_from_matrix(xv, cfg, reference=ds)
    v.metadata = Metadata(len(yv))
    v.metadata.set_label(yv)
    b.add_valid(v, "valid_0")
    for _ in range(rounds):
        if b.train_one_iter():
            break
    return b


def _auc(b):
    return {n: v for _, n, v, _ in b.eval_valid()}["auc"]


@pytest.mark.parametrize("kind,extra", [
    ("data", {}), ("feature", {}), ("voting", {}),
    ("data", {"bagging_fraction": 0.7, "bagging_freq": 2}),
    ("voting", {"boosting": "goss", "top_rate": 0.3, "other_rate": 0.2}),
    ("data", {"boosting": "goss", "top_rate": 0.3, "other_rate": 0.2}),
], ids=["data", "feature", "voting", "data_bagging", "voting_goss",
        "data_goss"])
def test_boosting_parallel_matches_serial(data, kind, extra):
    x, y, xv, yv = data
    serial = _boosted(x, y, xv, yv, extra, None)
    par = _boosted(x, y, xv, yv, {**extra, "tree_learner": kind}, MESH)
    assert type(par.learner).__name__.lower().startswith(kind)
    assert abs(_auc(serial) - _auc(par)) < 1e-6
    np.testing.assert_allclose(par.predict(xv), serial.predict(xv),
                               atol=1e-5)


def test_voting_small_k_quality(data):
    x, y, xv, yv = data
    b = _boosted(x, y, xv, yv, {"tree_learner": "voting", "top_k": 2},
                 MESH, rounds=15)
    assert _auc(b) > 0.74


def test_comm_volume_equals_jax(data):
    """The data-parallel learner allreduces one (G, 256, 3) f32 histogram
    a split, the voting learner its totals and the 2k elected features'
    histograms only: the same payloads as the JAX learners'."""
    x, y, _, _ = data
    g, h = _grads(y, seed=4)

    def payloads(kind, extra):
        params = {"objective": "binary", "num_leaves": 15,
                  "tree_learner": kind, "num_machines": 8, "verbose": -1,
                  **extra}
        jcfg, cfg = JConfig(params), Config(params)
        jl = jcreate(jcfg, JDataset.construct_from_matrix(x, jcfg, ()),
                     mesh=jmake_mesh(8))
        jl.net.reset_comm_log()
        jl.train(jnp.asarray(g), jnp.asarray(h))
        ds = BinnedDataset.construct_from_matrix(x, cfg)
        tl = create_tree_learner(cfg, ds, CPU, mesh=MESH)
        assert tl.nb == 256
        tree = tl.train(torch.from_numpy(g), torch.from_numpy(h))
        assert tree.num_leaves > 1
        allred = lambda log: {b for v, b in log if v == "allreduce"}
        return allred(jl.net.comm_log), allred(tl.net.comm_log), ds

    jdata, tdata, ds = payloads("data", {})
    assert tdata == jdata == {ds.num_groups * 256 * 3 * 4}
    jvote, tvote, _ = payloads("voting", {"top_k": 2})
    assert tvote == jvote == {3 * 4, 2 * 2 * 256 * 3 * 4}
    assert max(tdata) > max(tvote)


def test_data_parallel_update_score_and_leaf_rows(data):
    x, y, _, _ = data
    g, h = _grads(y, seed=6)
    cfg = Config({**LEARN, "tree_learner": "data", "num_machines": 8})
    ds = BinnedDataset.construct_from_matrix(x, cfg)
    dp = create_tree_learner(cfg, ds, CPU, mesh=MESH)
    s = SerialTreeLearner(Config(LEARN), ds, CPU)
    t = dp.train(torch.from_numpy(g), torch.from_numpy(h))
    ts = s.train(torch.from_numpy(g), torch.from_numpy(h))
    _assert_same_tree(ts, t, x)
    zero = lambda: torch.zeros(ds.num_data)
    want = s.update_score(zero(), ts).numpy()
    np.testing.assert_allclose(dp.update_score(zero(), t).numpy(), want,
                               atol=1e-5 * np.abs(want).max())
    li_s, li_d = s.leaf_indices_host(), dp.leaf_indices_host()
    assert li_s.keys() == li_d.keys()
    for leaf in li_s:
        assert set(li_s[leaf].tolist()) == set(li_d[leaf].tolist())
