"""Kernel 1's share of the traced ranking trees' device time at 136
groups: the device clock's ``hist_ns`` (the grower's kernel-1 call,
stamped before and after it in every wave) over the trees'
first-to-last stamp time (``hist_share.train``'s arithmetic)."""

from benchmark.metrics import program


def read(facts):
    cl = program.clocks(facts)
    if cl is None:
        return None
    return program.share_pct(sum(c.hist_ns for c in cl),
                             program.tree_ns(cl))
