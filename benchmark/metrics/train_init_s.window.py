"""Seconds of the program's ``train.init`` span (the booster's set-up:
the grower acquired and adopted, the codes uploaded, the objective)
inside the traced window."""

from benchmark.metrics import program


def read(facts):
    return program.span_s(facts, "train.init")
