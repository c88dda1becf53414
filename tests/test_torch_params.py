"""The port's parameter table is the JAX package's: names, aliases,
defaults, checks and sections; only the device differs.  ``device_growth``
routes: ``off`` trains on the host learner."""

import numpy as np
import pytest
import torch

from lightgbm_tpu import params as jp
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu_torch import params as tp
from lightgbm_tpu_torch.config import Config as TConfig


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """This module's torch CPU ops on one thread (several test workers
    share the machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_same_names_in_same_order():
    assert [p.name for p in tp.PARAM_SCHEMA] == \
        [p.name for p in jp.PARAM_SCHEMA]


@pytest.mark.parametrize("field", ["aliases", "default", "check", "section",
                                   "type"])
def test_same_fields(field):
    for p in jp.PARAM_SCHEMA:
        q = tp.PARAM_BY_NAME[p.name]
        if field == "default" and p.name == "device_type":
            assert (p.default, q.default) == ("tpu", "cuda")
            continue
        assert getattr(q, field) == getattr(p, field), p.name


def test_alias_tables_equal():
    assert tp.PARAM_ALIASES == jp.PARAM_ALIASES
    assert tp.OBJECTIVE_ALIASES == jp.OBJECTIVE_ALIASES
    assert tp.METRIC_ALIASES == jp.METRIC_ALIASES


def test_config_resolves_like_jax():
    raw = {"objective": "xentropy", "num_leaves": "63", "eta": 0.05,
           "min_child_samples": 7, "seed": 11, "max_depth": 5,
           "metric": "auc,binary"}
    a, b = JConfig(raw).to_dict(), TConfig(raw).to_dict()
    a.pop("device_type")
    assert b.pop("device_type") == "cuda"
    assert a == b


def test_device_names():
    assert TConfig({"device": "gpu"}).device_type == "cuda"
    assert TConfig({"device_type": "cpu"}).device_type == "cpu"
    with pytest.raises(ValueError, match="cuda or cpu"):
        TConfig({"device": "tpu"})


def test_tpu_only_knobs_accepted_and_announced(caplog):
    assert tp.IGNORED_PARAMS <= set(tp.PARAM_BY_NAME)
    with caplog.at_level("WARNING", logger="lightgbm_tpu_torch"):
        cfg = TConfig({"hist_kernel": "pallas", "device_growth": "off"})
    assert cfg.hist_kernel == "pallas"
    assert "hist_kernel is a TPU-only knob" in caplog.text
    # device_growth has a meaning in the port: off trains on the host
    # learner (test_device_growth_off_routes_to_the_host_learner)
    assert "device_growth" not in tp.IGNORED_PARAMS
    assert cfg.device_growth == "off"


@pytest.mark.parametrize("mode,host", [("off", True), ("auto", False),
                                       ("on", False)])
def test_device_growth_off_routes_to_the_host_learner(mode, host):
    import lightgbm_tpu_torch as tlgb
    rng = np.random.default_rng(4)
    x = rng.standard_normal((600, 4))
    y = (x[:, 0] > 0).astype(float)
    b = tlgb.train({"objective": "binary", "num_leaves": 7, "verbose": -1,
                    "device": "cpu", "device_growth": mode},
                   tlgb.Dataset(x, y), 2, verbose_eval=False)
    assert (b._gbdt.learner is not None) == host
    assert (b._gbdt._grower is None) == host
    assert b.num_trees() == 2
