"""Device-time attribution in the port (``lightgbm_tpu_torch/obs/
profile.py`` and ``DeviceGrower.profile_phases`` / the stage probes'
costs in ``ops/grow.py``) on the CPU:

* ``attribution_report`` equal to the JAX package's on the same inputs;
* ``cost_of`` against counts made by hand (kernel 1 at the train phase's
  2M x 28, K=3, W=128 shape is PERF.md's 24.2 us bytes bound at
  3.35 TB/s);
* ``device_trace`` yields False without a path and writes a Chrome trace
  with one;
* ``profile_phases``' keys, gauges and (under ``profile_attribution``)
  costs on a CPU grower; the stage probes' ``stage_cost``.
"""

import json

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as tlgb
from lightgbm_tpu.obs import profile as jprofile
from lightgbm_tpu_torch import obs
from lightgbm_tpu_torch.obs import profile
from lightgbm_tpu_torch.ops import grow, stage_plan


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """This module's torch CPU ops on one thread (several test workers
    share the machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean_obs():
    obs.configure(enabled=False, profile_attribution=False)
    obs.reset()
    yield
    obs.configure(enabled=False, profile_attribution=False)
    obs.reset()


REPORTS = [
    (10.0, {"wave_hist": 4.0, "find_best": 3.0, "split_apply": 1.0}, None),
    (5.0, {"a": 4.0, "b": 3.0}, {"a": {"flops": 2e6, "bytes_accessed": 1e6,
                                       "transcendentals": None}}),
    (0.0, {"a": 1.0}, None),
    (12.5, {"x": 0.0, "y": 2.5}, {"x": {"flops": 1.0}, "y": None}),
]


@pytest.mark.parametrize("measured,phases,costs", REPORTS)
def test_attribution_report_equals_the_jax_package(measured, phases, costs):
    assert profile.attribution_report(measured, phases, costs) \
        == jprofile.attribution_report(measured, phases, costs)


def test_cost_of_against_hand_counts():
    # kernel 1, 2M rows x 28 groups, NB 256, K=3 bf16, W=128, 1M rows in
    # the wave: codes and leaf ids of every row, the wave's stats, the
    # (G*NB, K, W) f32 histogram out; an add a (row, group, stat)
    n, g, m = 2_000_000, 28, 1_000_000
    c = profile.cost_of("wave_hist", rows=n, groups=g, bins=256, k=3, w=128,
                        rows_in_wave=m, stat_bytes=2)
    want = n * (g + 4) + m * 2 * 3 + g * 256 * 3 * 128 * 4
    assert c == {"flops": float(m * g * 3), "bytes_accessed": float(want),
                 "transcendentals": 0.0}
    assert c["bytes_accessed"] / 3.35e12 * 1e6 == pytest.approx(24.2,
                                                                abs=0.05)
    c = profile.cost_of("find_best", leaves=8, slots=100)
    assert c["bytes_accessed"] == 8 * (100 * 12 + 12 + 52)
    assert c["flops"] == 8 * 100 * profile.FIND_OPS_PER_SLOT == 16000
    c = profile.cost_of("split_apply", rows=1000, w=4)
    assert (c["bytes_accessed"], c["flops"]) == (9048.0, 4000.0)
    c = profile.cost_of("score_update", rows=1000, leaves=31)
    assert (c["bytes_accessed"], c["flops"]) == (12124.0, 2000.0)
    with pytest.raises(ValueError, match="no cost model"):
        profile.cost_of("nope", rows=1)


def test_device_trace(tmp_path):
    with profile.device_trace(None) as on:
        assert on is False
    path = tmp_path / "trace.json"
    with profile.device_trace(str(path)) as on:
        torch.ones(64).sum()
    if on:
        assert "traceEvents" in json.loads(path.read_text())


@pytest.fixture(scope="module")
def grower():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3000, 6))
    y = (x[:, 0] + x[:, 1] > 0).astype(float)
    b = tlgb.train({"objective": "binary", "num_leaves": 15, "verbose": -1,
                    "device": "cpu", "device_growth": "on"},
                   tlgb.Dataset(x, y), 2, verbose_eval=False)
    return b._gbdt._grower, rng


def test_profile_phases_keys_and_gauges(grower):
    g, rng = grower
    grad = rng.standard_normal(g.num_data).astype(np.float32)
    hess = np.abs(grad) + np.float32(0.1)
    obs.configure(enabled=True)
    out = g.profile_phases(grad, hess, reps=2)
    assert set(out) == {"wave_hist", "find_best", "split_apply",
                        "score_update", "dispatch_floor"}
    assert all(v >= 0.0 for v in out.values())
    for k, v in out.items():
        assert obs.registry().gauge(f"profile.{k}_ms") == v
    obs.configure(profile_attribution=True)
    out = g.profile_phases(grad, hess, reps=1)
    costs = out["costs"]
    assert set(costs) == set(profile.PHASES)
    assert costs["wave_hist"] == profile.cost_of(
        "wave_hist", rows=g.n_pad, groups=g.num_groups, bins=g.nb,
        k=g.hist_cols, w=g.wave_width, rows_in_wave=g.num_data,
        stat_bytes=2)
    assert obs.registry().gauge("profile.wave_hist_gbytes") == round(
        costs["wave_hist"]["bytes_accessed"] / 1e9, 4)
    rep = profile.attribution_report(
        10.0, {k: out[k] for k in profile.PHASES}, costs)
    assert set(rep["phases"]) == set(profile.PHASES)


def test_stage_probes_attach_costs(grower, monkeypatch):
    g, _ = grower
    monkeypatch.setattr(grow, "PROBE_REPS", 1)
    monkeypatch.setattr(g, "plan_source", "default")
    obs.configure(enabled=True, profile_attribution=True)
    try:
        out = g.profile_stage_plan()
    finally:
        stage_plan.forget_plan(g.signature)
    assert set(out["stage_cost"]) == set(out["stage_ms"])
    w = g.wave_width
    assert out["stage_cost"][w]["flops"] == g.num_data * g.num_groups \
        * g.hist_cols
    assert obs.registry().gauge(f"grow.stage.w{w}_gbytes") is not None
