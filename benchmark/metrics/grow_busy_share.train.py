"""The traced trees' device time, from each tree's first device-clock
stamp to its last, summed, as a share of the stretch's host-clock
seconds: how much of the window the card spends growing trees."""

from benchmark.metrics import program


def read(facts):
    return program.busy_pct(facts)
