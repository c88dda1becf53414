"""The lambdarank gradient's share of its roofline: the least time of its
counted work (``benchmark/cost_rank.py``: the label-ordered pairs and the
rows of the benchmark's own queries) over the traced trees, over its
device-clock time (the trees' ``grad_ns``).  None where the program's
clock has no gradient field."""

from benchmark import cost, cost_rank
from benchmark.metrics import common, program


def read(facts):
    cl = program.clocks(facts)
    if cl is None or any(getattr(c, "grad_ns", None) is None for c in cl):
        return None
    work = cost_rank.rank_gradients(facts["rows"], facts["query_sizes"],
                                    facts["pairs"])
    return common.roofline_pct(len(cl) * cost.least_seconds(*work),
                               sum(c.grad_ns for c in cl) * 1e-9)
