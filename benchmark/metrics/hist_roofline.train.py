"""Kernel 1's share of its roofline: the least time of its counted work
over the traced trees (``benchmark/cost.py``: every wave at the trees'
own leaf counts) over its device-clock time (the trees' ``hist_ns``)."""

from benchmark import cost
from benchmark.metrics import common, program


def read(facts):
    cl = program.clocks(facts)
    if cl is None:
        return None
    least = cost.least_seconds(*common.tree_phases(facts)["wave_hist"])
    return common.roofline_pct(least, sum(c.hist_ns for c in cl) * 1e-9)
