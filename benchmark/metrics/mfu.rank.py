"""The whole ranking iteration's share of the card's peak: the least time
of every phase's counted work over the traced trees, as ``mfu.train``
reads it, with ``cost.py``'s row-wise gradients replaced by the
lambdarank gradient's pair work (``benchmark/cost_rank.py``), over the
stretch's wall time."""

from benchmark import cost_rank
from benchmark.metrics import common


def read(facts):
    phases = common.tree_phases(facts)
    grad = cost_rank.rank_gradients(facts["rows"], facts["query_sizes"],
                                    facts["pairs"])
    phases["gradients"] = tuple(len(facts["trees"]) * v for v in grad)
    return common.roofline_pct(common.least_s(phases), facts["wall_s"])
