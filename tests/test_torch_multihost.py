"""The port's multi-controller pieces in one process, each held to its
JAX counterpart where it has one (``tests/test_multihost.py``'s unit
layer):

* ``multihost_params``: the same triple or the same error as
  ``lightgbm_tpu.ops.shard.multihost_params`` on the same config and env;
* ``process_row_span`` over a ``PodMesh`` against the JAX function over a
  mesh of the same process layout; ``shard_local_rows`` equal to the JAX
  function's where both pad to the power-of-two bucket (the port also
  buckets int8 rows and aligns no chunk below 32,768 rows a shard);
* ``broadcast_blob`` over localhost: a round trip, sequential rounds with
  a fast peer, a missing peer named by rank 0, a dead rank 0;
* ``reference_to_bytes`` -> ``broadcast_reference`` -> the layout digest,
  equal to the JAX package's for the same data;
* ``_round_two(row_span=)``: codes and labels equal to the JAX
  function's for a head span and a span past the rows;
* the pod ack/commit protocol case for case, ``pod_state_digest`` equal
  to the JAX function's;
* the parallel learners refused under ``multi_controller`` with the JAX
  package's text, by ``create_tree_learner`` and by ``GBDT``;
* a one-host pod over ``torch.distributed`` in this process: the bring-up
  is idempotent and sets ``shard.hosts``, ``torch_process_gather``
  exchanges mapper shards, and the pod trains single-controller's model.
"""

import os
import socket
import threading

import numpy as np
import pytest
import torch

from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.ops import shard
from lightgbm_tpu_torch.utils.log import LightGBMError

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """This module's torch CPU ops on one thread (several test workers
    share the machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


# ---------------------------------------------------------------------------
# bring-up parameters and the pod layout
PARAM_CASES = [
    ({}, {}),
    ({"coordinator_address": "h0:1234", "num_hosts": 4, "host_rank": 3},
     {}),
    ({"coordinator_address": "h0:1234"},
     {"LGBM_TPU_NUM_HOSTS": "2", "LGBM_TPU_HOST_RANK": "1"}),
    ({}, {"LGBM_TPU_COORDINATOR": "h9:7", "LGBM_TPU_NUM_HOSTS": "3",
          "LGBM_TPU_HOST_RANK": "0"}),
    ({"coordinator_address": "h0:1234"}, {}),
    ({"num_hosts": 2}, {}),
    ({"coordinator_address": "h0:1234", "num_hosts": 2, "host_rank": 2},
     {}),
    ({"coordinator_address": "h0", "num_hosts": 2, "host_rank": 0}, {}),
]


@pytest.mark.parametrize("params,env", PARAM_CASES)
def test_multihost_params_match_jax(monkeypatch, params, env):
    from lightgbm_tpu.config import Config as JConfig
    from lightgbm_tpu.ops.shard import multihost_params as jparams
    from lightgbm_tpu.utils.log import LightGBMError as JError
    for k in (shard.ENV_COORDINATOR, shard.ENV_NUM_HOSTS,
              shard.ENV_HOST_RANK):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)

    def run(fn, cfg, err):
        try:
            return ("ok", fn(cfg))
        except err as e:
            return ("error", str(e))

    got = run(shard.multihost_params, Config(params), LightGBMError)
    want = run(jparams, JConfig(params), JError)
    assert got == want


def test_multihost_params_errors():
    with pytest.raises(LightGBMError, match="ALL of"):
        shard.multihost_params(Config({"coordinator_address": "h0:1"}))
    with pytest.raises(LightGBMError, match="out of range"):
        shard.multihost_params(Config({"coordinator_address": "h0:1",
                                       "num_hosts": 2, "host_rank": 2}))
    with pytest.raises(LightGBMError, match="host:port"):
        shard.multihost_params(Config({"coordinator_address": "h0",
                                       "num_hosts": 2, "host_rank": 0}))


class _FakeDev:
    def __init__(self, pid, did):
        self.process_index = pid
        self.id = did


class _FakeMesh:
    def __init__(self, pids):
        arr = np.empty(len(pids), dtype=object)
        for i, p in enumerate(pids):
            arr[i] = _FakeDev(p, i)
        self.devices = arr


@pytest.mark.parametrize("counts", [(2, 2), (1, 1, 1, 1), (3, 1), (1, 2, 1)])
def test_process_row_span_matches_jax(counts):
    from lightgbm_tpu.ops.shard import process_row_span as jspan
    pids = [p for p, c in enumerate(counts) for _ in range(c)]
    spans = []
    for rank, c in enumerate(counts):
        pod = shard.PodMesh([CPU] * c, counts, rank)
        assert len(pod) == sum(counts) and pod.hosts == len(counts)
        got = shard.process_row_span(pod, 1000)
        assert got == jspan(_FakeMesh(pids), 1000, process_index=rank)
        assert got == shard.process_row_span(pod, 1000, process_index=rank)
        spans.append(got)
    # contiguous blocks covering the global padded rows in rank order
    assert spans[0][0] == 0 and spans[-1][1] == 1000 * sum(counts)
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    pod = shard.PodMesh([CPU] * counts[0], counts, 0)
    with pytest.raises(LightGBMError, match="owns no devices"):
        shard.process_row_span(pod, 1000, process_index=7)
    with pytest.raises(LightGBMError, match="does not match"):
        shard.PodMesh([CPU] * (counts[0] + 1), counts, 0)


@pytest.mark.parametrize("n,d", [(100_000, 4), (500_000, 4),
                                 (2_000_000, 4), (1_000_000, 2),
                                 (10_500_000, 8)])
def test_shard_local_rows_match_jax(n, d):
    from lightgbm_tpu.config import Config as JConfig
    from lightgbm_tpu.ops.shard import shard_local_rows as jrows
    got = shard.shard_local_rows(n, d, Config({}))
    assert got == jrows(n, d, JConfig({}))
    assert got * d >= n


def test_mesh_helpers():
    pod = shard.PodMesh([CPU, CPU], (2, 2), 1)
    assert shard.mesh_is_multihost(pod)
    assert not shard.mesh_is_multihost([CPU] * 4)
    assert not shard.mesh_is_multihost(shard.PodMesh([CPU] * 2, (2,), 0))
    assert pod.first == 2 and pod.key()[:3] == ("pod", 1, (2, 2))
    assert [t.tolist() for t in shard.host_replicated(pod, [1, 2])] == \
        [[1, 2]] * 2
    assert shard.pod_local_shards(Config({"device": "cpu",
                                          "shard_devices": 3})) == [CPU] * 3
    assert shard.pod_local_shards(Config({}), devices=["cpu"]) == [CPU]
    assert not shard.is_multihost()


# ---------------------------------------------------------------------------
# the socket plane
NET = {"network_timeout": 2, "network_retries": 5}


def _peers(addr, hosts, rank_set, cfg, rounds=1, got=None):
    got = {} if got is None else got
    from lightgbm_tpu_torch.parallel.network import broadcast_blob

    def peer(rank):
        for r in range(rounds):
            got[(rank, r)] = broadcast_blob(None, address=addr,
                                            num_hosts=hosts, rank=rank,
                                            config=cfg)
    threads = [threading.Thread(target=peer, args=(r,)) for r in rank_set]
    for t in threads:
        t.start()
    return threads, got


def test_broadcast_blob_roundtrip():
    from lightgbm_tpu_torch.parallel.network import broadcast_blob
    addr = f"127.0.0.1:{_free_port()}"
    cfg = Config(NET)
    payload = b"\x00mapper-reference\xff" * 1000
    threads, got = _peers(addr, 3, (1, 2), cfg)
    out0 = broadcast_blob(payload, address=addr, num_hosts=3, rank=0,
                          config=cfg)
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    assert out0 == payload
    assert got[(1, 0)] == payload and got[(2, 0)] == payload


def test_broadcast_blob_sequential_rounds():
    """A peer served early dials for the next round while rank 0 still
    serves this one: it is turned away and gets the next round's
    payload, never this one's again."""
    import time
    from lightgbm_tpu_torch.parallel.network import broadcast_blob
    addr = f"127.0.0.1:{_free_port()}"
    cfg = Config(NET)
    threads, got = _peers(addr, 3, (1,), cfg, rounds=3)
    late = {}

    def slow():
        time.sleep(0.6)
        for r in range(3):
            late[r] = broadcast_blob(None, address=addr, num_hosts=3,
                                     rank=2, config=cfg)
            time.sleep(0.3)
    t2 = threading.Thread(target=slow)
    t2.start()
    sent = [broadcast_blob(f"round{r}".encode(), address=addr, num_hosts=3,
                           rank=0, config=cfg) for r in range(3)]
    for t in threads + [t2]:
        t.join(timeout=30)
        assert not t.is_alive()
    assert [got[(1, r)] for r in range(3)] == sent
    assert [late[r] for r in range(3)] == sent


def test_broadcast_blob_fails_fast():
    from lightgbm_tpu_torch.parallel.network import broadcast_blob
    addr = f"127.0.0.1:{_free_port()}"
    cfg = Config({"network_timeout": 0.2, "network_retries": 2})
    with pytest.raises(LightGBMError, match=r"host\(s\) \[1\] never "
                                            r"connected"):
        broadcast_blob(b"x", address=addr, num_hosts=2, rank=0, config=cfg)
    with pytest.raises(LightGBMError, match="unreachable after 2 attempts"):
        broadcast_blob(None, address=addr, num_hosts=2, rank=1, config=cfg)
    with pytest.raises(LightGBMError, match="rank 0 must supply"):
        broadcast_blob(None, address=addr, num_hosts=1, rank=0, config=cfg)
    with pytest.raises(LightGBMError, match="bad broadcast address"):
        broadcast_blob(b"x", address="nohost", num_hosts=1, rank=0)


def test_pod_broadcast_address_and_policy():
    from lightgbm_tpu.parallel.network import (
        network_policy_from_config as jpolicy,
        pod_broadcast_address as jaddr)
    from lightgbm_tpu.config import Config as JConfig
    from lightgbm_tpu_torch.parallel import network as net
    assert net.pod_broadcast_address("h0:1234") == jaddr("h0:1234") \
        == "h0:1235"
    with pytest.raises(LightGBMError, match="bad coordinator address"):
        net.pod_broadcast_address("h0")
    for p in ({}, NET):
        assert net.network_policy_from_config(Config(p)) == \
            jpolicy(JConfig(p))


# ---------------------------------------------------------------------------
# the mapper reference and the streamed span
def _matrix(n=400, f=5, seed=3):
    return np.random.default_rng(seed).standard_normal((n, f))


def test_reference_broadcast_and_layout_digest_match_jax():
    from lightgbm_tpu.config import Config as JConfig
    from lightgbm_tpu.data.dataset import BinnedDataset as JDataset
    from lightgbm_tpu.pipeline.bins import (
        reference_from_bytes as jfrom_bytes,
        reference_layout_digest as jdigest)
    from lightgbm_tpu_torch.data.dataset import BinnedDataset
    from lightgbm_tpu_torch.pipeline.bins import (broadcast_reference,
                                                  reference_from_bytes,
                                                  reference_layout_digest,
                                                  reference_to_bytes)
    x = _matrix()
    ds = BinnedDataset.construct_from_matrix(x, Config({"max_bin": 31}))
    jds = JDataset.construct_from_matrix(x, JConfig({"max_bin": 31}))
    assert reference_layout_digest(ds) == jdigest(jds)
    blob = reference_to_bytes(ds, extra={"n_total": 400})
    # the blob is the JAX package's format
    jskel, jextra = jfrom_bytes(blob)
    assert jextra == {"n_total": 400} and jdigest(jskel) == jdigest(jds)
    with pytest.raises(LightGBMError, match="magic mismatch"):
        reference_from_bytes(b"garbage-not-a-reference")
    addr = f"127.0.0.1:{_free_port()}"
    cfg = Config(NET)
    got = {}

    def peer():
        got["out"] = broadcast_reference(None, address=addr, num_hosts=2,
                                         rank=1, config=cfg)
    t = threading.Thread(target=peer)
    t.start()
    ref0, extra0 = broadcast_reference(ds, address=addr, num_hosts=2,
                                       rank=0, config=cfg,
                                       extra={"n_total": 400})
    t.join(timeout=30)
    assert not t.is_alive()
    skel, extra = got["out"]
    assert ref0 is ds and extra0 == extra == {"n_total": 400}
    assert reference_layout_digest(skel) == jdigest(jds)
    assert [g.feature_indices for g in skel.groups] == \
        [g.feature_indices for g in ds.groups]
    with pytest.raises(LightGBMError, match="must supply the reference"):
        broadcast_reference(None, address=addr, num_hosts=1, rank=0)


@pytest.mark.parametrize("span", [(64, 160), (0, 64), (264, 328)])
def test_round_two_row_span_matches_jax(tmp_path, span):
    from lightgbm_tpu.config import Config as JConfig
    from lightgbm_tpu.data.dataset import BinnedDataset as JDataset
    from lightgbm_tpu.data import stream_loader as jsl
    from lightgbm_tpu_torch.data.dataset import BinnedDataset
    from lightgbm_tpu_torch.data import stream_loader as tsl
    csv = str(tmp_path / "mini.csv")
    rows = 200
    x = _matrix(rows, 4, seed=5)
    y = (x[:, 0] > 0).astype(float)
    with open(csv, "w") as fh:
        for i in range(rows):
            fh.write(",".join([repr(float(y[i]))]
                              + [repr(float(v)) for v in x[i]]) + "\n")
    lo, hi = span
    out = {}
    for name, sl, D, C in (("jax", jsl, JDataset, JConfig),
                           ("port", tsl, BinnedDataset, Config)):
        cfg = C({"two_round": True, "max_bin": 31})
        fmt = sl._Format(csv, cfg)
        sample, n_total, num_cols = sl._round_one(csv, fmt, cfg)
        full = D.construct_streaming_begin(sample, n_total, num_cols, cfg)
        full_label = sl._round_two(csv, fmt, full, num_cols, n_total)
        part = D.construct_streaming_begin(np.zeros((0, num_cols)),
                                           hi - lo, num_cols, cfg,
                                           reference=full)
        label = sl._round_two(csv, fmt, part, num_cols, n_total,
                              row_span=(lo, hi))
        np.testing.assert_array_equal(label, full_label)
        real = max(0, min(hi, n_total) - lo)
        np.testing.assert_array_equal(np.asarray(part.binned)[:real],
                                      np.asarray(full.binned)[lo:lo + real])
        assert not np.asarray(part.binned)[real:].any()
        out[name] = (np.asarray(part.binned), label)
    np.testing.assert_array_equal(out["port"][0], out["jax"][0])
    np.testing.assert_array_equal(out["port"][1], out["jax"][1])


# ---------------------------------------------------------------------------
# the pod commit protocol
def test_pod_ack_commit_protocol_matches_jax(tmp_path):
    from lightgbm_tpu.robust import checkpoint as jck
    from lightgbm_tpu_torch.robust import checkpoint as ck
    path = str(tmp_path / "snap.txt")
    score = np.arange(6, dtype=np.float32).reshape(1, 6)
    digest = ck.pod_state_digest("tree...", score, 3)
    assert digest == jck.pod_state_digest("tree...", score, 3)
    assert digest == ck.pod_state_digest("tree...", score.copy(), 3)
    assert digest != ck.pod_state_digest("tree...", score, 4)
    assert ck.pod_commit_path(path) == jck.pod_commit_path(path)
    # happy path: both hosts ack, host 0 commits, the peer sees it
    ck.write_pod_ack(path, 0, digest)
    ck.write_pod_ack(path, 1, digest)
    # the JAX package reads the port's acks
    jck.await_pod_acks(path, 2, digest, timeout_s=5.0)
    ck.await_pod_acks(path, 2, digest, timeout_s=5.0)
    ck.clear_pod_acks(path, 2)
    assert not any(os.path.exists(f"{path}.ack.h{r}") for r in (0, 1))
    ck.commit_pod(path, digest)
    assert ck.has_pod_commit(path) and jck.has_pod_commit(path)
    ck.await_pod_commit(path, digest, timeout_s=5.0)
    # a commit marker of an OLDER snapshot does not satisfy the wait
    with pytest.raises(LightGBMError, match="commit"):
        ck.await_pod_commit(path, "different-digest", timeout_s=0.3)
    # a missing ack: the timeout names the dead host
    os.remove(ck.pod_commit_path(path))
    assert not ck.has_pod_commit(path)
    ck.write_pod_ack(path, 0, digest)
    with pytest.raises(LightGBMError, match=r"no ack from host\(s\) "
                                            r"\[1\]"):
        ck.await_pod_acks(path, 2, digest, timeout_s=0.3)
    # a diverged ack is refused, never waited out
    ck.write_pod_ack(path, 1, "poisoned-digest")
    with pytest.raises(LightGBMError, match="diverged"):
        ck.await_pod_acks(path, 2, digest, timeout_s=5.0)


# ---------------------------------------------------------------------------
# the parallel learners under multi_controller
POD_LEARNER = {"tree_learner": "data", "num_machines": 2,
               "data_sharding": "multi_controller",
               "coordinator_address": "h0:1", "num_hosts": 2,
               "host_rank": 0, "objective": "binary", "device": "cpu",
               "verbose": -1}


def test_parallel_learner_refused_under_multi_controller():
    from lightgbm_tpu.config import Config as JConfig
    from lightgbm_tpu.parallel import create_tree_learner as jcreate
    from lightgbm_tpu.utils.log import LightGBMError as JError
    from lightgbm_tpu_torch.boosting import create_boosting
    from lightgbm_tpu_torch.data.dataset import BinnedDataset
    from lightgbm_tpu_torch.parallel import create_tree_learner
    text = "cannot be combined with data_sharding=multi_controller"
    with pytest.raises(JError, match=text) as want:
        jcreate(JConfig(POD_LEARNER), None)
    cfg = Config(POD_LEARNER)
    ds = BinnedDataset.construct_from_matrix(_matrix(), cfg)
    with pytest.raises(LightGBMError, match=text) as got:
        create_tree_learner(cfg, ds, CPU, mesh=[CPU] * 2)
    assert str(got.value) == str(want.value)
    ds.metadata.set_label((_matrix()[:, 0] > 0).astype(float))
    with pytest.raises(LightGBMError, match="requires the device grower"):
        create_boosting(cfg).init_train(ds)


# ---------------------------------------------------------------------------
# a one-host pod in this process
@pytest.fixture
def one_host_group():
    import torch.distributed as dist
    port = _free_port()
    cfg = Config({"data_sharding": "multi_controller",
                  "coordinator_address": f"127.0.0.1:{port}",
                  "num_hosts": 1, "host_rank": 0, "device": "cpu",
                  "shard_devices": 2, **NET})
    from lightgbm_tpu_torch import obs
    obs.configure(enabled=True)
    try:
        yield cfg
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        obs.configure(enabled=False)
        obs.reset()


def test_one_host_pod_trains_single_controller_model(one_host_group):
    from lightgbm_tpu_torch import obs
    from lightgbm_tpu_torch.boosting import create_boosting
    from lightgbm_tpu_torch.data.dataset import BinnedDataset
    from lightgbm_tpu_torch.data.distributed import (allgather_mappers,
                                                     find_bin_shard,
                                                     torch_process_gather)
    cfg = one_host_group
    assert shard.multihost_setup(cfg) == (0, 1)
    assert shard.multihost_setup(cfg) == (0, 1)       # idempotent
    assert obs.registry().snapshot()["gauges"]["shard.hosts"] == 1
    x = _matrix(600, 6, seed=9)
    pair = find_bin_shard(x, 0, 1, cfg)
    assert torch_process_gather(pair) == [pair]
    mappers = allgather_mappers(pair, gather_fn=lambda p:
                                torch_process_gather(p),
                                num_total_features=6)
    assert len(mappers) == 6
    mesh = shard.resolve_shard_mesh(cfg)
    assert isinstance(mesh, shard.PodMesh) and mesh.counts == (2,)
    y = (x[:, 0] + x[:, 1] > 0).astype(float)
    texts = []
    for extra in ({}, {"data_sharding": "single_controller"}):
        c = Config({**cfg.to_dict(), "objective": "binary",
                    "num_leaves": 7, "verbose": -1, **extra})
        ds = BinnedDataset.construct_from_matrix(x, c)
        ds.metadata.set_label(y)
        gb = create_boosting(c)
        gb.mesh = [CPU] * 2
        gb.init_train(ds)
        assert gb._grower.pod is None and gb._grower.mesh == [CPU] * 2
        gb.train_chunked(3, chunk=3)
        texts.append(gb.model_to_string().split("\nparameters:")[0])
    assert texts[0] == texts[1]
