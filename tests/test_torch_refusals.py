"""Options the port does not have yet are refused by name, never accepted
and ignored (ROADMAP §3, fault 1, repaired here).

The four distributed cases of the fault (the parity features, binary, 15
leaves, max_bin 63, 4 rounds on the CPU): before the repair the port
trained them serially with no error and no log, byte-equal to its serial
run, while the JAX package built its parallel learner.  They now raise
``LightGBMError`` naming the option, from ``engine.train`` and from
``RetrainPipeline``; so do the options that select data sharding and
multi-host training, on the device grower and on the host learner (the
telemetry exporter's and the cost attribution's options work since the
fleet soak slice: ``tests/test_torch_obs_stream.py``); so does a leaf
budget past the histogram kernel's leaf table.  A parallel
``tree_learner`` with one machine degrades to serial, as the reference
does.
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
    ({"tree_learner": "voting", "num_machines": 2, "top_k": 1},
     "tree_learner=voting"),
    ({"tree_learner": "feature", "num_machines": 2},
     "tree_learner=feature"),
    ({"tree_learner": "data", "num_machines": 8}, "tree_learner=data"),
    ({"data_sharding": "single_controller"},
     "data_sharding=single_controller"),
    ({"data_sharding": "multi_controller"},
     "data_sharding=multi_controller"),
    ({"num_hosts": 2}, "num_hosts=2"),
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
