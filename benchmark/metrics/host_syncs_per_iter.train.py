"""The program's own count of host syncs (``GBDT.tree_stats``) over the
traced iterations."""


def read(facts):
    return facts["syncs"] / facts["iters"]
