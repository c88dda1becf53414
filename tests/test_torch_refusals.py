"""Options the port does not have yet are refused by name, never accepted
and ignored (ROADMAP §3, repaired fault 2).

What stays refused: a leaf budget past the histogram kernel's leaf table;
malformed input to the socket network and the mapper broadcast, by name.
The options the distributed planes lifted now do what the JAX package
does: the data-, feature- and voting-parallel learners with more machines
than devices raise as its ``make_mesh`` does; single-controller sharding
with one device trains unsharded and logs it;
``data_sharding=multi_controller`` with no coordinator raises its "no
coordinator configured" error and with a partial triple its "ALL of"
error, and ``num_hosts`` without it is ignored, as there; any nonzero
``grad_quant_bits`` reaching the grower trains int8 (both packages'
``Config`` still accept only 0 and 8).  A parallel ``tree_learner`` with
one machine degrades to serial, as the reference does.
"""

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as tlgb
import parity_data as pd
from lightgbm_tpu_torch.pipeline.bins import broadcast_reference
from lightgbm_tpu_torch.utils.log import LightGBMError

BASE = {"objective": "binary", "num_leaves": 15, "max_bin": 63,
        "verbose": -1, "device": "cpu"}

#: options refused before the distributed planes were ported
LIFTED = [
    ({"data_sharding": "multi_controller"},
     "data_sharding=multi_controller"),
    ({"num_hosts": 2}, "num_hosts=2"),
    ({"grad_quant_bits": 4}, "grad_quant_bits=4"),
    ({"tree_learner": "voting", "num_machines": 2, "top_k": 1},
     "tree_learner=voting"),
    ({"tree_learner": "feature", "num_machines": 2},
     "tree_learner=feature"),
    ({"tree_learner": "data", "num_machines": 8}, "tree_learner=data"),
    ({"data_sharding": "single_controller"},
     "data_sharding=single_controller"),
]


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
    return x, pd.make_labels(x)[0]


def _jax_error(fn):
    from lightgbm_tpu.utils.log import LightGBMError as JError
    with pytest.raises(JError) as ei:
        fn()
    return str(ei.value)


def _lifted_pod(data, extra):
    """multi_controller with no coordinator and a partial triple raise the
    JAX package's errors from engine.train; num_hosts alone is ignored, as
    there."""
    from lightgbm_tpu.config import Config as JConfig
    from lightgbm_tpu.ops.shard import (multihost_params as jparams,
                                        multihost_setup as jsetup)
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.ops.shard import multihost_params
    x, y = data
    pod = {**BASE, **extra, "data_sharding": "multi_controller"}
    if "num_hosts" in extra:
        want = _jax_error(lambda: jparams(JConfig(pod)))
        serial = tlgb.train(BASE, tlgb.Dataset(x, y), 4, verbose_eval=False)
        ignored = tlgb.train({**BASE, **extra}, tlgb.Dataset(x, y), 4,
                             verbose_eval=False)
        np.testing.assert_array_equal(ignored.predict(x, raw_score=True),
                                      serial.predict(x, raw_score=True))
        with pytest.raises(LightGBMError, match="ALL of"):
            multihost_params(Config(pod))
    else:
        want = _jax_error(lambda: jsetup(JConfig(pod)))
        assert "no coordinator configured" in want
    with pytest.raises(LightGBMError) as ei:
        tlgb.train(pod, tlgb.Dataset(x, y), 4, verbose_eval=False)
    assert str(ei.value) == want
    assert "not ported" not in want


def _lifted_quant(data):
    """A grower config with ``grad_quant_bits=4`` trains int8 as at 8
    (``lightgbm_tpu/ops/grow.py::_hist_layout``): the model text equals
    the port's own at 8, the tree the JAX grower's at 4."""
    import jax.numpy as jnp
    from lightgbm_tpu.config import Config as JConfig
    from lightgbm_tpu.data.dataset import BinnedDataset as JDataset
    from lightgbm_tpu.ops.grow import DeviceGrower as JGrower
    from lightgbm_tpu_torch.boosting import create_boosting
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.data.dataset import BinnedDataset
    from lightgbm_tpu_torch.ops.grow import DeviceGrower
    x, y = data
    texts = []
    for bits in (8, 4):
        cfg = Config({**BASE, "grad_quant_bits": 8})
        cfg.grad_quant_bits = bits        # both Configs accept only 0, 8
        ds = BinnedDataset.construct_from_matrix(x, cfg)
        ds.metadata.set_label(y)
        gb = create_boosting(cfg)
        gb.init_train(ds)
        assert gb._grower.quant_bits == bits
        gb.train_chunked(4, chunk=2)
        texts.append(gb.model_to_string().split("\nparameters:")[0])
    assert texts[0] == texts[1]
    p = {"objective": "binary", "max_bin": 63, "verbose": -1,
         "num_leaves": 15, "grad_quant_bits": 8, "learning_rate": 0.1}
    jc = JConfig({**p, "device_growth": "on", "hist_kernel": "interpret"})
    tc = Config({**p, "device": "cpu"})
    jc.grad_quant_bits = tc.grad_quant_bits = 4
    rng = np.random.default_rng(8)
    n = len(x)
    score = np.zeros(n, np.float32)
    grad = rng.standard_normal(n).astype(np.float32)
    hess = rng.uniform(0.05, 0.3, n).astype(np.float32)
    jg = JGrower(JDataset.construct_from_matrix(x, jc), jc)
    tg = DeviceGrower(BinnedDataset.construct_from_matrix(x, tc), tc,
                      torch.device("cpu"))
    out = jg.grow_one_iter(jnp.asarray(score), jnp.asarray(grad),
                           jnp.asarray(hess), jg.feature_mask_for(1),
                           tree_idx=1)
    res = tg.grow_one_iter(torch.from_numpy(score), torch.from_numpy(grad),
                           torch.from_numpy(hess), tree_idx=1)
    nl = int(out[4])
    assert int(res.num_leaves) == nl >= 3
    np.testing.assert_array_equal(res.rec_i.numpy()[:nl - 1],
                                  np.asarray(out[1])[:nl - 1])
    got, want = res.rec_f.numpy()[:nl - 1], np.asarray(out[2])[:nl - 1]
    np.testing.assert_array_equal(got[:, [1, 2, 3, 6]],
                                  want[:, [1, 2, 3, 6]])
    assert (np.abs(got - want) <= 1e-6 * np.abs(want).max(axis=0)).all()


@pytest.mark.parametrize("extra,name", LIFTED, ids=[n for _, n in LIFTED])
def test_lifted_options_do_what_the_jax_package_does(data, extra, name,
                                                     caplog):
    """More machines than this process's cards raise as the JAX
    ``make_mesh`` does (not as an unported option); single-controller
    sharding with no second device trains unsharded, logged; the pod's
    options raise the JAX package's bring-up errors; grad_quant_bits=4
    trains int8."""
    x, y = data
    params = {**BASE, **extra}
    if "data_sharding" in extra and extra["data_sharding"] != \
            "single_controller" or "num_hosts" in extra:
        _lifted_pod(data, extra)
        return
    if "grad_quant_bits" in extra:
        _lifted_quant(data)
        return
    if "num_machines" in extra:
        with pytest.raises(LightGBMError, match="exceeds available "
                                                "devices") as ei:
            tlgb.train(params, tlgb.Dataset(x, y), 4, verbose_eval=False)
        assert "not ported" not in str(ei.value)
        return
    serial = tlgb.train(BASE, tlgb.Dataset(x, y), 4, verbose_eval=False)
    with caplog.at_level("INFO"):
        sharded = tlgb.train(params, tlgb.Dataset(x, y), 4,
                             verbose_eval=False)
    assert "training unsharded" in caplog.text
    assert sharded._gbdt._grower.mesh is None
    np.testing.assert_array_equal(sharded.predict(x, raw_score=True),
                                  serial.predict(x, raw_score=True))


def test_socket_network_is_refused_by_name():
    """The socket plane is ported (tests/test_torch_multihost.py); what it
    refuses, it refuses by name: a malformed address, a rank 0 without
    its payload, a peer that never answers."""
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.parallel.network import (broadcast_blob,
                                                     wait_for_peer)
    with pytest.raises(LightGBMError, match="bad broadcast address"):
        broadcast_blob(b"", address="localhost", num_hosts=2, rank=0)
    with pytest.raises(LightGBMError, match="rank 0 must supply"):
        broadcast_blob(None, address="localhost:1", num_hosts=2, rank=0)
    with pytest.raises(LightGBMError, match="bad peer address"):
        wait_for_peer("localhost")
    with pytest.raises(LightGBMError, match="unreachable after 2 attempts"):
        wait_for_peer("127.0.0.1:1", config=Config(
            {"network_retries": 2, "network_timeout": 0.2}))


@pytest.mark.parametrize("learner", ["voting", "feature", "data"])
def test_parallel_learner_on_one_machine_trains_serially(data, learner):
    x, y = data
    serial = tlgb.train(BASE, tlgb.Dataset(x, y), 4, verbose_eval=False)
    one = tlgb.train({**BASE, "tree_learner": learner, "num_machines": 1},
                     tlgb.Dataset(x, y), 4, verbose_eval=False)
    # a feature-parallel learner drops feature_fraction (1.0 here anyway)
    np.testing.assert_array_equal(one.predict(x, raw_score=True),
                                  serial.predict(x, raw_score=True))


@pytest.mark.parametrize("device_growth", ["auto", "off"])
def test_leaf_budget_past_the_kernel_table_is_refused(data, device_growth):
    """More leaves than the histogram kernel's leaf table holds, on
    either learner."""
    x, y = data
    with pytest.raises(LightGBMError, match="num_leaves > 16384"):
        tlgb.train({**BASE, "num_leaves": 20_000,
                    "device_growth": device_growth}, tlgb.Dataset(x, y), 1,
                   verbose_eval=False)


def test_mapper_broadcast_is_refused_by_name():
    """The mapper broadcast is ported; host 0 without a reference is
    refused by name, and a one-host round returns host 0's reference."""
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.data.dataset import BinnedDataset
    with pytest.raises(LightGBMError, match="broadcast_reference"):
        broadcast_reference(None, address="localhost:1", num_hosts=2,
                            rank=0)
    ds = BinnedDataset.construct_from_matrix(pd.make_features()[:200],
                                             Config({"max_bin": 15}))
    ref, extra = broadcast_reference(ds, address="127.0.0.1:0",
                                     num_hosts=1, rank=0,
                                     extra={"n_total": 200})
    assert ref is ds and extra == {"n_total": 200}
