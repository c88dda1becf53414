"""Seconds of the program's ``data.find_bins`` span (bin finding on the
host sample) inside the traced window."""

from benchmark.metrics import program


def read(facts):
    return program.span_s(facts, "data.find_bins")
