"""The share of the traced trees' device time spent in the waves outside
kernel 1 (the split scan, the splits' application, the grower's torch
index, compare and add kernels): the device clock's waves
(``waves_end`` - ``waves_start``) less ``hist_ns``, over the trees'
first-to-last stamp time."""

from benchmark.metrics import program


def read(facts):
    cl = program.clocks(facts)
    if cl is None:
        return None
    return program.share_pct(
        sum(c.waves_end - c.waves_start - c.hist_ns for c in cl),
        program.tree_ns(cl))
