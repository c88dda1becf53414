"""The objective's gradient's share of the traced trees' device time: the
device clock's ``grad_ns`` (the fused tree's sample piece, stamped before
and after the gradient) over the trees' first-to-last stamp time.  None
where the program's clock has no gradient field."""

from benchmark.metrics import program


def read(facts):
    cl = program.clocks(facts)
    if cl is None or any(getattr(c, "grad_ns", None) is None for c in cl):
        return None
    return program.share_pct(sum(c.grad_ns for c in cl), program.tree_ns(cl))
