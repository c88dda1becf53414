"""Seconds of the program's ``data.sample`` span (the bin-finding
sample's draw, gather and copy to the host) inside the traced window."""

from benchmark.metrics import program


def read(facts):
    return program.span_s(facts, "data.sample")
