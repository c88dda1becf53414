"""Composed N-node CDN-fleet chaos soak, gated on the SLO engine.

Counterpart of ``lightgbm_tpu/soak``: the fork's pieces run *together*
on the card: an M-tenant ``FleetServer`` retrained per tenant through
``RetrainPipeline`` under a deterministic seed-keyed fault timeline, with
the verdict gated on ``obs/slo.py`` plus harness-level invariants (resume
byte identity, same-shape swaps, throughput against the fork's figure).
``python -m lightgbm_tpu_torch soak`` (or ``task=soak``) runs one.
"""

from .scenario import (FaultEvent, SoakScenario, compile_timeline,
                       fault_spec, timeline_digest)
from .driver import SoakDriver, run_scenario
from .report import (build_verdict, run_and_report, strip_volatile,
                     write_verdict)

__all__ = [
    "FaultEvent", "SoakScenario", "SoakDriver",
    "build_verdict", "compile_timeline", "fault_spec",
    "run_and_report", "run_scenario", "strip_volatile",
    "timeline_digest", "write_verdict",
]
