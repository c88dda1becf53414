"""Corpus: TL161 — fault-site registry coverage.

Self-contained miniature of the robust/faults.py contract: a
module-level ``KNOWN_SITES`` registry, arming calls that pass a site
string (positionally and by keyword), and thread workers that must be
reachable from at least one armed site.  Planted: one registry entry
no call ever arms (dead), one call arming a typo'd site (unknown),
and one worker no fault site can reach.
"""
import threading

KNOWN_SITES = ("fixture.alpha", "fixture.beta", "fixture.dead")  # PLANT: TL161


def check(site):
    del site            # the real one raises an injected fault


def with_retries(fn, site=""):
    del site
    return fn()


def armed_path():
    check("fixture.alpha")      # positional site resolves via check()


def typo_path():
    check("fixture.alfa")  # PLANT: TL161


def beta_path():
    return with_retries(lambda: None, site="fixture.beta")


def covered_worker():
    while armed_path() is None:
        return


def uncovered_worker():  # PLANT: TL161
    return


def spawn_all():
    threading.Thread(target=covered_worker).start()
    threading.Thread(target=uncovered_worker).start()
