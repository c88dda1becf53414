"""Soak verdicts.

Counterpart of ``lightgbm_tpu/soak/report.py``.  Turns a driver outcome
into the gated verdict document:

* the scenario's SLO spec evaluated by ``obs/slo.py`` from the
  rolling windows — availability *through* retrains and kills (dark
  time accounted via the degraded-replica gauge integral), the p95
  bound, the burn rate;
* harness-level gates the SLO engine cannot see — every scheduled
  kill resumed and reconverged to a byte-identical model, every
  same-shape swap after window 0 was a zero-retrace index write,
  every scheduled chaos event actually fired, the exporter dropped
  nothing, and the throughput figure
  (``train_s_per_1M_sampled_rows``) against the fork's own 125.4 s per
  20M-row window (its result log).

A run that did not train on a CUDA device carries ``chip_pending=true``
and its throughput gate is informational (the number then checks the
plumbing, not the card).  On the card the gate is live: at most
``THROUGHPUT_SLACK`` x the fork's figure.

The verdict is written with a plain ``open().write``: it carries wall
timings by design, so it is no byte-reproducible artifact.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

from .scenario import REFERENCE_S_PER_1M_ROWS, SoakScenario

SCHEMA_NAME = "lightgbm-tpu-soak"
SCHEMA_VERSION = 1

# slack over the fork's figure for the throughput gate on the card; off
# the card the gate is informational (chip_pending)
THROUGHPUT_SLACK = 1.5


def _slo_json(slo) -> dict:
    if slo is None:
        return {}
    return slo if isinstance(slo, dict) else slo.to_json()


def _schedule(sc_doc: dict, m: int) -> List[int]:
    cadence = sc_doc.get("cadence") or []
    cad = int(cadence[m]) if cadence else 1
    return [w for w in range(int(sc_doc["windows"])) if w % cad == 0]


def build_verdict(outcome: dict, *,
                  throughput_slack: float = THROUGHPUT_SLACK) -> dict:
    """The gated verdict for one driver outcome (a pure function of the
    outcome, so tests can feed synthetic outcomes).  ``chip_pending``
    unless the outcome's ``device`` is a CUDA device."""
    sc = outcome["scenario"]
    chip_pending = not str(outcome.get("device", "")).startswith("cuda")
    slo = _slo_json(outcome.get("slo"))
    objectives = {o.get("name"): o for o in slo.get("objectives", [])}
    timeline = outcome.get("timeline", [])
    windows: Dict[str, List[dict]] = outcome.get("windows", {})
    load = outcome.get("load", {})
    counters = outcome.get("counters", {})
    export = outcome.get("export", {})
    gates: Dict[str, dict] = {}

    # -- SLO-engine gates ----------------------------------------------
    avail = objectives.get("availability", {})
    gates["availability"] = {
        "ok": bool(avail.get("ok", False)),
        "target": avail.get("target"),
        "observed": avail.get("observed"),
        "dark_fraction": (slo.get("counts") or {}).get("dark_fraction"),
    }
    gates["slo"] = {"ok": bool(slo.get("ok", False)),
                    "objectives": sorted(objectives)}

    # -- completion -----------------------------------------------------
    want = {str(m): len(_schedule(sc, m))
            for m in range(int(sc["tenants"]))}
    got = {m: len(v) for m, v in windows.items()}
    gates["completed"] = {
        "ok": (not outcome.get("tenant_errors")
               and all(got.get(m, 0) == n for m, n in want.items())),
        "windows_expected": want, "windows_trained": got,
        "tenant_errors": outcome.get("tenant_errors", {}),
    }

    # -- resume byte-identity per kill ---------------------------------
    kills = outcome.get("kills", [])
    ident = outcome.get("byte_identity", [])
    scheduled_kills = sum(1 for e in timeline if e["kind"] == "kill")
    gates["resume_byte_identity"] = {
        "ok": (len(kills) == scheduled_kills
               and all(r.get("resumed") for r in kills)
               and all(r.get("byte_identical") for r in ident)
               and len(ident) == len({r["tenant"] for r in kills})),
        "scheduled": scheduled_kills, "fired": len(kills),
        "tenants": ident,
    }

    # -- zero-retrace swaps after window 0 -----------------------------
    per_tenant = {}
    zr_ok = True
    for m, results in windows.items():
        later = [r for r in results if int(r.get("window", 0)) >= 1]
        retraced = [r["window"] for r in later
                    if r.get("swap_same_shape") is not True]
        per_tenant[m] = {"swaps": len(results),
                         "after_w0": len(later),
                         "retraced_windows": retraced}
        zr_ok = zr_ok and not retraced
    gates["zero_retrace_swaps"] = {
        "ok": zr_ok,
        "per_tenant": per_tenant,
        "fleet_shape_changes":
            counters.get("serve.fleet.swap_shape_changes", 0),
    }

    # -- scheduled chaos actually fired --------------------------------
    fired = {
        "kills": len(kills),
        "dead_peer_timeouts": load.get("dead_peer_timeouts", 0),
        "poison_sent": load.get("poison_sent", 0),
        "clock_faults": outcome.get("clock_faults_fired", 0),
        "device_faults": counters.get("fault.serve.fleet.dispatch", 0),
    }
    want_chaos = {
        "kills": scheduled_kills,
        "dead_peer_timeouts": next(
            (e["at"] for e in timeline if e["kind"] == "dead_peer"), 0),
        "clock_faults": sum(1 for e in timeline
                            if e["kind"] == "clock_skew"),
    }
    chaos_ok = all(fired[k] == v for k, v in want_chaos.items())
    if any(e["kind"] == "poison" for e in timeline):
        # poison batches fire only if the load loop reached their tick;
        # when any did, the fleet must have isolated them per-request
        chaos_ok = chaos_ok and (
            fired["poison_sent"] == 0
            or counters.get("serve.fleet.input_errors", 0) > 0)
    gates["chaos_fired"] = {"ok": chaos_ok, "fired": fired,
                            "scheduled": want_chaos}

    # -- telemetry integrity -------------------------------------------
    gates["export"] = {
        "ok": (export.get("dropped", 0) == 0
               and export.get("write_errors", 0) == 0),
        "stats": export,
    }

    # -- throughput vs the fork's committed reference ------------------
    train_s = rows = 0.0
    for results in windows.values():
        for r in results:
            train_s += float(r.get("train_s", 0.0))
            rows += float(r.get("rows_trained", 0))
    value = (train_s / (rows / 1e6)) if rows else None
    gates["throughput"] = {
        "ok": bool(chip_pending or (value is not None
                                    and value <= REFERENCE_S_PER_1M_ROWS
                                    * throughput_slack)),
        "train_s_per_1M_sampled_rows":
            None if value is None else round(value, 3),
        "reference_s_per_1M": round(REFERENCE_S_PER_1M_ROWS, 3),
        "reference": "125.4 s / 20M rows (the fork's result log)",
        "chip_pending": chip_pending,
    }

    verdict = {
        "schema": SCHEMA_NAME,
        "schema_version": SCHEMA_VERSION,
        "scenario": sc,
        "fault_spec": outcome.get("fault_spec", ""),
        "timeline": timeline,
        "timeline_digest": outcome.get("timeline_digest", ""),
        "slo": slo,
        "gates": gates,
        "ok": all(g["ok"] for g in gates.values()),
        "chip_pending": chip_pending,
        "kills": kills,
        "load": load,
        "counters": counters,
        "elapsed_s": outcome.get("elapsed_s"),
        "started_unix": outcome.get("started_unix"),
        "evaluated_unix": outcome.get("evaluated_unix"),
    }
    return verdict


def strip_volatile(verdict: dict) -> dict:
    """The replay-stable projection of a verdict: what two same-seed
    runs must agree on byte-for-byte (wall timings, observed latencies
    and counter magnitudes vary run to run; the timeline, the armed
    spec, which gates passed, and the kill/identity records must
    not)."""
    return {
        "schema": verdict.get("schema"),
        "schema_version": verdict.get("schema_version"),
        "scenario": verdict.get("scenario"),
        "fault_spec": verdict.get("fault_spec"),
        "timeline": verdict.get("timeline"),
        "timeline_digest": verdict.get("timeline_digest"),
        "gates": {name: bool(g.get("ok"))
                  for name, g in verdict.get("gates", {}).items()},
        "kills": sorted(
            ({"tenant": r.get("tenant"), "window": r.get("window"),
              "payload_index": r.get("payload_index"),
              "checkpoint_window": r.get("checkpoint_window"),
              "resumed": r.get("resumed")}
             for r in verdict.get("kills", [])),
            key=lambda r: (r["tenant"], r["window"])),
        "byte_identity": verdict.get("gates", {})
            .get("resume_byte_identity", {}).get("tenants"),
        "ok": verdict.get("ok"),
        "chip_pending": verdict.get("chip_pending"),
    }


def write_verdict(verdict: dict, path: str) -> str:
    """Plain (non-atomic-artifact) write — see module docstring."""
    with open(path, "w") as fh:
        fh.write(json.dumps(verdict, indent=2, sort_keys=True,
                            default=str))
        fh.write("\n")
    return path


def run_and_report(sc: SoakScenario, workdir: Optional[str] = None,
                   **kwargs) -> dict:
    """Drive the scenario, build its verdict, honor ``scenario.out``
    (``kwargs``: the driver's ``device``, ``prom_path``, ``http_port``)."""
    from .driver import SoakDriver
    outcome = SoakDriver(sc, workdir=workdir, **kwargs).run()
    verdict = build_verdict(outcome)
    if sc.out:
        write_verdict(verdict, sc.out)
    return verdict
