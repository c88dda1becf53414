"""The traced window's trees' device time, from each tree's first
device-clock stamp to its last, summed, as a share of the window's
host-clock seconds (binning and training together)."""

from benchmark.metrics import program


def read(facts):
    return program.busy_pct(facts)
