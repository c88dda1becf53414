"""The port's fleet chaos soak (``lightgbm_tpu_torch/soak/``) against the
JAX package's (``lightgbm_tpu/soak/``), on the CPU:

* the same scenario compiles to the same timeline, fault spec and
  timeline digest, and gives the same window payloads byte for byte;
  scenarios round-trip through JSON and resolve from ``LGBM_TPU_SOAK``
  and the ``soak_*`` params alike;
* the port's copy of the cache-admission derivation
  (``soak/workload.py``) gives ``examples/cache_admission.py``'s outputs;
* ``build_verdict`` and ``strip_volatile`` on synthetic outcomes equal
  the JAX package's (apart from ``chip_pending``, true in both off the
  card);
* the default scenario end to end passes every gate (tenants trained on
  the CPU, the fleet degrading nothing, the killed tenant's final model
  equal to its unfaulted replay's); a same-seed replay gives the same
  stripped verdict; a persistent device death fails availability.
"""

import copy
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.soak import report as jreport
from lightgbm_tpu.soak import scenario as jscenario
from lightgbm_tpu_torch import obs
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.obs.state import STATE
from lightgbm_tpu_torch.robust import faults
from lightgbm_tpu_torch.soak import (SoakScenario, build_verdict,
                                     compile_timeline, fault_spec,
                                     run_and_report, strip_volatile,
                                     timeline_digest)
from lightgbm_tpu_torch.soak import report, scenario, workload

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "cache_admission_example", os.path.join(REPO, "examples",
                                            "cache_admission.py"))
example = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(example)
_vspec = importlib.util.spec_from_file_location(
    "validate_metrics", os.path.join(REPO, "scripts", "validate_metrics.py"))
validate_metrics = importlib.util.module_from_spec(_vspec)
_vspec.loader.exec_module(validate_metrics)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """This module's torch CPU ops on one thread (several test workers
    share the machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean_state():
    def clean():
        exp = STATE.exporter
        STATE.exporter = None
        if exp is not None:
            exp.stop(timeout_s=2.0)
        faults.clear()
        obs.configure(enabled=False)
        obs.reset()
        STATE.rolling = None
        STATE.last_slo = None
    clean()
    yield
    clean()


SCENARIOS = [
    {},
    {"tenants": 3, "windows": 4, "kills": 2, "seed": 11},
    {"device_deaths": 1, "device_death_persist": True, "kills": 0},
    {"device_deaths": 2, "device_death_burst": 3, "poison_batches": 3,
     "dead_peers": 2, "clock_skews": 2, "seed": 3},
    {"tenants": 2, "windows": 6, "cadence": [1, 2], "kills": 2},
]


@pytest.mark.parametrize("doc", SCENARIOS,
                         ids=[str(i) for i in range(len(SCENARIOS))])
def test_timeline_spec_and_digest_equal_the_jax_package(doc):
    sc = SoakScenario.from_json(dict(doc))
    jsc = jscenario.SoakScenario.from_json(dict(doc))
    assert sc.to_json() == jsc.to_json()
    assert [e.to_json() for e in compile_timeline(sc)] \
        == [e.to_json() for e in jscenario.compile_timeline(jsc)]
    assert fault_spec(sc) == jscenario.fault_spec(jsc)
    assert timeline_digest(sc) == jscenario.timeline_digest(jsc)
    assert scenario.kill_points(compile_timeline(sc)) \
        == jscenario.kill_points(jscenario.compile_timeline(jsc))
    assert scenario.poison_ticks(compile_timeline(sc)) \
        == jscenario.poison_ticks(jscenario.compile_timeline(jsc))
    assert SoakScenario.from_json(json.loads(json.dumps(sc.to_json()))) \
        == sc


@pytest.mark.parametrize("key", [(0, -1), (0, 0), (1, 2)])
def test_window_payload_bytes_equal_the_jax_package(key):
    doc = {"requests_per_window": 4096, "objects": 512, "sample_rows": 1024,
           "seed": 5}
    pw = SoakScenario.from_json(doc).window_payload(*key)
    jpw = jscenario.SoakScenario.from_json(doc).window_payload(*key)
    assert pw.label.tobytes() == jpw.label.tobytes()
    for a, b in zip(pw.csr, jpw.csr):
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
        else:
            assert a == b
    assert pw.meta == jpw.meta and pw.num_rows == 1024
    q = SoakScenario.from_json(doc).query_block(key[0])
    jq = jscenario.SoakScenario.from_json(doc).query_block(key[0])
    assert q.tobytes() == jq.tobytes() and q.shape == (256, 53)


def test_train_params_and_config_resolution(monkeypatch):
    sc = SoakScenario()
    assert sc.train_params() == jscenario.SoakScenario().train_params()
    params = {"soak_tenants": 3, "soak_windows": 5, "soak_seed": 9,
              "soak_kills": 2, "soak_slo": "availability>=0.99"}
    assert SoakScenario.from_config(Config(params)).to_json() \
        == jscenario.SoakScenario.from_config(JConfig(params)).to_json()
    monkeypatch.setenv("LGBM_TPU_SOAK", json.dumps({"tenants": 1,
                                                    "windows": 2}))
    a = SoakScenario.from_config(Config({}))
    assert a.tenants == 1 and a.to_json() \
        == jscenario.SoakScenario.from_config(JConfig({})).to_json()
    for bad in ({"windows": 1, "kills": 1}, {"sample_rows": 32},
                {"requests_per_window": 100}, {"cadence": [1]},
                {"nonsense": 1}):
        with pytest.raises(Exception):
            SoakScenario.from_json(dict(bad))


def test_cache_admission_copy_equals_the_example():
    ids, sizes, costs = workload.synth_trace(20_000, 2_000, seed=4)
    eids, esizes, ecosts = example.synth_trace(20_000, 2_000, seed=4)
    for a, b in ((ids, eids), (sizes, esizes), (costs, ecosts)):
        assert a.tobytes() == b.tobytes()
    cache = 1 << 22
    tc, ratio = workload.calculate_opt(ids, sizes, cache, len(ids))
    etc, eratio = example.calculate_opt(ids, sizes, cache, len(ids))
    assert tc.tobytes() == etc.tobytes() and ratio == eratio
    for sampling in (0, 1, 2):
        got = workload.derive_features(ids, sizes, costs, tc, cache, 5000,
                                       sampling, np.random.default_rng(1))
        want = example.derive_features(ids, sizes, costs, tc, cache, 5000,
                                       sampling, np.random.default_rng(1))
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    _, indptr, indices, data = got
    keep = np.random.default_rng(2).random(len(indptr) - 1) < 0.3
    for a, b in zip(workload.csr_row_subset(indptr, indices, data, keep),
                    example._csr_row_subset(indptr, indices, data, keep)):
        assert a.tobytes() == b.tobytes()
    assert scenario.REFERENCE_S_PER_1M_ROWS \
        == jscenario.REFERENCE_S_PER_1M_ROWS


@pytest.mark.parametrize("case", ["opt_labels", "random_labels",
                                  "sizes_per_request", "cache_fills"])
def test_cache_avail_walk_equals_the_example(case):
    """The vectorized cacheAvailBytes column equals the example's loop,
    bit for bit: random admissions, sizes that change between an
    object's requests (a leaving object gives back the size it entered
    with) and a cache that runs full (0 from then on)."""
    rng = np.random.default_rng(11)
    ids, sizes, costs = workload.synth_trace(30_000, 3_000, seed=5)
    cache = {"cache_fills": 1 << 20}.get(case, 1 << 30)
    if case == "sizes_per_request":
        sizes = (sizes * rng.uniform(0.5, 1.5, len(ids))).astype(np.int64)
    tc, _ = workload.calculate_opt(ids, sizes, cache, len(ids))
    if case in ("random_labels", "cache_fills"):
        tc = rng.random(len(ids)) < 0.6
    got = workload.derive_features(ids, sizes, costs, tc, cache, 0, 0, rng)
    want = example.derive_features(ids, sizes, costs, tc, cache, 0, 0, rng)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    avail = workload.cache_avail_bytes(ids, sizes, tc, cache)
    assert (avail == 0).any() == (case == "cache_fills")


def _synthetic_outcome(**over):
    sc = SoakScenario(tenants=2, windows=3)
    events = compile_timeline(sc)
    win = {"window": 0, "swap_same_shape": None, "train_s": 0.5,
           "rows_trained": 1024}
    later = dict(win, swap_same_shape=True)
    out = {
        "scenario": sc.to_json(), "fault_spec": fault_spec(sc, events),
        "timeline": [e.to_json() for e in events],
        "timeline_digest": timeline_digest(sc, events),
        "started_unix": 1.0, "evaluated_unix": 2.0, "elapsed_s": 3.0,
        "slo": {"spec": sc.slo, "ok": True, "window_s": 600,
                "objectives": [
                    {"name": "availability", "target": 0.999,
                     "observed": 1.0, "ok": True},
                    {"name": "p95_ms", "target": 250, "observed": 3.0,
                     "ok": True}],
                "counts": {"dark_fraction": 0.0}},
        "windows": {"0": [win, dict(later, window=1),
                          dict(later, window=2)],
                    "1": [win, dict(later, window=1),
                          dict(later, window=2)]},
        "kills": [{"tenant": 1, "window": 2, "payload_index": 2,
                   "checkpoint_window": 1, "resumed": True}],
        "byte_identity": [{"tenant": 1, "kills": [2], "resumed": True,
                           "byte_identical": True}],
        "tenant_errors": {},
        "load": {"submitted": 90, "answered": 89, "rejected": 1,
                 "poison_sent": 1, "dead_peer_timeouts": 1},
        "clock_faults_fired": 1,
        "counters": {"serve.fleet.input_errors": 1,
                     "serve.fleet.swap_shape_changes": 0},
        "export": {"dropped": 0, "write_errors": 0, "flushes": 9},
    }
    out.update(over)
    return out


VARIANTS = [
    {},
    {"tenant_errors": {"1": "boom"}},
    {"byte_identity": [{"tenant": 1, "kills": [2], "resumed": True,
                        "byte_identical": False}]},
    {"export": {"dropped": 2, "write_errors": 0}},
    {"clock_faults_fired": 0},
    {"counters": {"serve.fleet.input_errors": 0}},
    {"slo": {"ok": False, "objectives": [
        {"name": "availability", "target": 0.999, "observed": 0.5,
         "ok": False}], "counts": {"dark_fraction": 0.5}}},
    {"windows": {"0": [{"window": 0, "train_s": 1.0,
                        "rows_trained": 1024},
                       {"window": 1, "swap_same_shape": False,
                        "train_s": 1.0, "rows_trained": 1024}]}},
]


@pytest.mark.parametrize("over", VARIANTS,
                         ids=[str(i) for i in range(len(VARIANTS))])
def test_verdicts_equal_the_jax_package(over):
    outcome = _synthetic_outcome(**copy.deepcopy(over))
    v = build_verdict(copy.deepcopy(outcome))
    jv = jreport.build_verdict(copy.deepcopy(outcome))
    assert v["chip_pending"] and jv["chip_pending"]
    v["gates"]["throughput"].pop("reference")
    jv["gates"]["throughput"].pop("reference")
    assert v == jv
    assert strip_volatile(v) == jreport.strip_volatile(jv)
    # on the card the throughput gate is live
    card = build_verdict(dict(copy.deepcopy(outcome), device="cuda"))
    assert not card["chip_pending"]
    assert card["gates"]["throughput"]["ok"] \
        == (card["gates"]["throughput"]["train_s_per_1M_sampled_rows"]
            <= scenario.REFERENCE_S_PER_1M_ROWS * report.THROUGHPUT_SLACK)


def test_default_scenario_end_to_end(tmp_path):
    sc = SoakScenario(out=str(tmp_path / "verdict.json"))
    v = run_and_report(sc, workdir=str(tmp_path / "w"), device="cpu")
    assert v["ok"], {k: g for k, g in v["gates"].items() if not g["ok"]}
    assert v["chip_pending"] is True
    assert all(g["ok"] for g in v["gates"].values())
    assert v["counters"].get("serve.fleet.fallback_requests", 0) == 0
    ident = v["gates"]["resume_byte_identity"]["tenants"]
    assert ident and all(r["byte_identical"] for r in ident)
    assert json.load(open(tmp_path / "verdict.json"))["ok"] is True
    assert validate_metrics.validate_soak(v) == []
    lines = [json.loads(ln) for ln in open(tmp_path / "w" / "stream.jsonl")]
    assert lines and all(validate_metrics.validate_stream_line(d) == []
                         for d in lines)
    digest = obs.summary()["soak"]
    assert digest["kills"] == 1 and digest["resumes"] == 1


SMALL = {"tenants": 1, "windows": 2, "requests_per_window": 2048,
         "sample_rows": 512, "num_iterations": 4, "poison_batches": 0,
         "dead_peers": 0}


def test_same_seed_replay_gives_the_same_stripped_verdict(tmp_path):
    runs = []
    for i in range(2):
        sc = SoakScenario.from_json(dict(SMALL))
        runs.append(run_and_report(sc, workdir=str(tmp_path / f"r{i}"),
                                   device="cpu"))
    a, b = (json.dumps(strip_volatile(v), sort_keys=True) for v in runs)
    assert a == b
    assert runs[0]["ok"] and runs[0]["timeline_digest"] \
        == jscenario.timeline_digest(jscenario.SoakScenario.from_json(
            dict(SMALL)))


def test_persistent_device_death_fails_availability(tmp_path):
    sc = SoakScenario.from_json(dict(SMALL, kills=0, device_deaths=1,
                                     device_death_persist=True))
    v = run_and_report(sc, workdir=str(tmp_path), device="cpu")
    failing = sorted(k for k, g in v["gates"].items() if not g["ok"])
    assert not v["ok"] and failing == ["availability", "slo"]
    assert v["counters"]["serve.fleet.fallback_requests"] > 0
    assert v["gates"]["availability"]["dark_fraction"] > 0.0
