"""The servers' submit -> worker-flush trace edge, held against the JAX
package: under an active span, requests submitted to a
``PredictionServer`` and to a ``FleetServer`` each end in one
``serve.request`` / ``serve.fleet.request`` span event (the JAX
package's ``lightgbm_tpu/serve/engine.py::_run_batch`` and
``serve/fleet.py::_run_batch``) that runs from submit time to the
future's resolution and is parented under the submitter's span, in its
trace.  The exported events (the JSONL exporter of each package) agree
in names, counts, ``cat``, ``rows``, ``replica`` and parentage, and a
submit with no active span emits none.
"""

import json

import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu import obs as jobs
from lightgbm_tpu.obs.state import STATE as JSTATE
from lightgbm_tpu.serve import PredictionServer as JServer
from lightgbm_tpu.serve.fleet import FleetServer as JFleet
from lightgbm_tpu_torch import obs as tobs
from lightgbm_tpu_torch.obs.state import STATE as TSTATE
from lightgbm_tpu_torch.serve import FleetServer as TFleet
from lightgbm_tpu_torch.serve import PredictionServer as TServer

#: (obs module, its state, solo server, fleet server, Booster, kwargs)
PACKAGES = {
    "jax": (jobs, JSTATE, JServer, JFleet, jlgb.Booster, {}),
    "torch": (tobs, TSTATE, TServer, TFleet, tlgb.Booster,
              {"device": "cpu"}),
}
#: rows of each traced request (distinct, so events pair up by rows)
SIZES = (8, 16, 24)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """This module's torch CPU ops on one thread (several test workers
    share the machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def clean_obs():
    for o, _, *_rest in PACKAGES.values():
        o.configure(enabled=False)
        o.reset()
    yield
    for o, _, *_rest in PACKAGES.values():
        o.configure(enabled=False)
        o.reset()


@pytest.fixture(scope="module")
def model_texts():
    """Two small binary models trained by the JAX package (both packages
    load them from text)."""
    out = []
    for seed in (0, 1):
        rng = np.random.default_rng(seed)
        x = rng.standard_normal((400, 5))
        y = (x[:, 0] + x[:, 1] > 0).astype(np.float64)
        params = {"objective": "binary", "num_leaves": 7, "verbosity": -1,
                  "metric": "none", "min_data_in_leaf": 5}
        out.append(jlgb.train(params, jlgb.Dataset(x, label=y),
                              num_boost_round=3).model_to_string())
    return out


def _exported(state, tmp_path, tag):
    """The events the JSONL exporter writes."""
    path = tmp_path / f"{tag}.jsonl"
    state.trace.to_jsonl(str(path))
    return [json.loads(line) for line in path.read_text().splitlines()]


def _drive(pkg, texts, fleet, tmp_path):
    """Traced submits of SIZES rows under a caller span, then one submit
    outside any span; returns the exported events."""
    o, state, solo_cls, fleet_cls, booster_cls, kw = PACKAGES[pkg]
    o.configure(enabled=True, trace_context=True)
    boosters = [booster_cls(model_str=t) for t in texts]
    x = np.random.default_rng(7).standard_normal((64, 5))
    if fleet:
        srv = fleet_cls(boosters, replicas=2, max_wait_ms=1.0, **kw)
        submit = lambda rows: srv.submit(np.ones(rows, np.int32), x[:rows])
    else:
        srv = solo_cls(boosters[0], max_wait_ms=1.0, **kw)
        submit = lambda rows: srv.submit(x[:rows])
    srv.start()
    try:
        with o.span("caller.request", cat="serve"):
            for rows in SIZES:
                # one at a time: the replica of each is fixed
                submit(rows).result(timeout=60)
        submit(4).result(timeout=60)      # no active span: no event
    finally:
        srv.stop()
    return _exported(state, tmp_path, f"{pkg}_{fleet}")


def _request_view(events, name):
    """The request events' comparable fields, and their parentage checked
    against the caller span."""
    callers = [e for e in events if e["name"] == "caller.request"]
    assert len(callers) == 1
    caller = callers[0]["args"]
    reqs = [e for e in events if e["name"] == name]
    t0, t1 = callers[0]["t_unix"], callers[0]["t_unix"] + \
        callers[0]["dur_s"]
    for e in reqs:
        a = e["args"]
        assert a["parent_id"] == caller["span_id"]
        assert a["trace_id"] == caller["trace_id"]
        assert a["span_id"] and a["span_id"] != caller["span_id"]
        # from submit time (inside the caller's span) to the resolution
        assert e["kind"] == "span" and e["dur_s"] >= 0
        assert t0 - 1e-5 <= e["t_unix"] <= t1 + 1e-5
    return sorted((e["name"], e["cat"], e["args"]["rows"],
                   e["args"].get("replica")) for e in reqs)


@pytest.mark.parametrize("fleet", [False, True], ids=["solo", "fleet"])
def test_request_span_events_equal_the_jax_servers(model_texts, fleet,
                                                   tmp_path):
    name = "serve.fleet.request" if fleet else "serve.request"
    want = _request_view(_drive("jax", model_texts, fleet, tmp_path), name)
    jobs.configure(enabled=False)
    got = _request_view(_drive("torch", model_texts, fleet, tmp_path),
                        name)
    assert len(want) == len(SIZES), want
    assert got == want
    if fleet:
        assert sorted(r[3] for r in got) == [0, 0, 1]
    else:
        assert all(r[3] is None for r in got)


@pytest.mark.parametrize("fleet", [False, True], ids=["solo", "fleet"])
def test_no_span_no_request_event(model_texts, fleet, tmp_path):
    """Tracing on but no active span at submit: no request event (the
    captured context is None), in both packages."""
    name = "serve.fleet.request" if fleet else "serve.request"
    for pkg in ("jax", "torch"):
        o, state, solo_cls, fleet_cls, booster_cls, kw = PACKAGES[pkg]
        o.configure(enabled=True, trace_context=True)
        boosters = [booster_cls(model_str=t) for t in model_texts]
        x = np.zeros((8, 5))
        if fleet:
            srv = fleet_cls(boosters, replicas=2, **kw)
            srv.start()
            try:
                srv.submit(np.zeros(8, np.int32), x).result(timeout=60)
            finally:
                srv.stop()
        else:
            srv = solo_cls(boosters[0], **kw)
            srv.start()
            try:
                srv.submit(x).result(timeout=60)
            finally:
                srv.stop()
        events = _exported(state, tmp_path, f"none_{pkg}_{fleet}")
        assert not [e for e in events if e["name"] == name], pkg
        o.configure(enabled=False)
        o.reset()
