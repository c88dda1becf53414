"""The whole iteration's share of the card's peak: the least time of
every phase's counted work over the traced trees (gradients, kernel 1
over every wave, the split scan, the split's application, the score
update) over the stretch's wall time."""

from benchmark.metrics import common


def read(facts):
    return common.roofline_pct(common.least_s(common.tree_phases(facts)),
                               facts["wall_s"])
