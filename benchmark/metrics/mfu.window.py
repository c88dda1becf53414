"""The whole window's share of the card's peak: the least time of the
traced window's counted work (its trees' phases and the codes: the
float32 rows read, a code a used column written) over its wall time."""

from benchmark.metrics import common


def read(facts):
    ph = common.tree_phases(facts)
    ph["binning"] = common.cost.binning(facts["rows"], facts["columns"],
                                        facts["groups"])
    return common.roofline_pct(common.least_s(ph), facts["wall_s"])
