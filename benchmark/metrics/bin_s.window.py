"""Seconds of the benchmark's own span around the traced window's
``Dataset`` construction (bins found anew and the codes), to a
synchronize."""


def read(facts):
    b = facts.get("bin_s")
    return sum(b) / len(b) if b else None
