"""Options the port does not have yet are refused by name, never accepted
and ignored (ROADMAP §3, repaired fault 2).

What stays refused: ``data_sharding=multi_controller`` and
``num_hosts > 1`` (one process a host, the pod slice), from
``engine.train`` and from ``RetrainPipeline``, on the device grower and on
the host learner; the socket network's blob broadcast and the mapper
broadcast; a leaf budget past the histogram kernel's leaf table.  The
options the single-host distributed plane lifted (the data-, feature- and
voting-parallel learners, ``data_sharding=single_controller``) now do
what the JAX package does with the devices this process has: more
machines than devices raise as its ``make_mesh`` does, and
single-controller sharding with one device trains unsharded and logs it.
A parallel ``tree_learner`` with one machine degrades to serial, as the
reference does.
"""

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as tlgb
import parity_data as pd
from lightgbm_tpu_torch.pipeline import RetrainPipeline
from lightgbm_tpu_torch.pipeline.bins import broadcast_reference
from lightgbm_tpu_torch.utils.log import LightGBMError

BASE = {"objective": "binary", "num_leaves": 15, "max_bin": 63,
        "verbose": -1, "device": "cpu"}

REFUSED = [
    ({"data_sharding": "multi_controller"},
     "data_sharding=multi_controller"),
    ({"num_hosts": 2}, "num_hosts=2"),
]

#: options refused before the single-host distributed plane was ported
LIFTED = [
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


@pytest.mark.parametrize("extra,name", REFUSED,
                         ids=[n + ("_host" if e.get("device_growth") == "off"
                                   else "") for e, n in REFUSED])
def test_unported_options_are_refused_by_name(data, extra, name):
    x, y = data
    with pytest.raises(LightGBMError, match="not ported") as ei:
        tlgb.train({**BASE, **extra}, tlgb.Dataset(x, y), 4,
                   verbose_eval=False)
    assert name in str(ei.value)
    with pytest.raises(LightGBMError, match=name.split("=")[0]):
        RetrainPipeline({**BASE, **extra}, serve=False)


@pytest.mark.parametrize("extra,name", LIFTED, ids=[n for _, n in LIFTED])
def test_lifted_options_do_what_the_jax_package_does(data, extra, name,
                                                     caplog):
    """More machines than this process's cards raise as the JAX
    ``make_mesh`` does (not as an unported option); single-controller
    sharding with no second device trains unsharded, logged."""
    x, y = data
    params = {**BASE, **extra}
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
    from lightgbm_tpu_torch.parallel.network import broadcast_blob
    with pytest.raises(LightGBMError, match="not ported.*broadcast_blob"):
        broadcast_blob(b"", address="localhost:1", num_hosts=2, rank=0)


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
    with pytest.raises(LightGBMError, match="broadcast_reference"):
        broadcast_reference(None, address="localhost:1", num_hosts=2,
                            rank=0)
