"""TL006 fixture: module-level state mutated with and without a lock —
the pattern the port's process-wide counters follow (a module lock
around every bump)."""

import threading

_REGISTRY = {}
_EVENTS = []
_LOCK = threading.Lock()
_next_id = 0


def register(name, value):
    _REGISTRY[name] = value  # PLANT: TL006


def record(evt):
    _EVENTS.append(evt)  # PLANT: TL006


def bump():
    global _next_id
    _next_id += 1  # PLANT: TL006
    return _next_id


def register_safe(name, value):
    with _LOCK:
        _REGISTRY[name] = value


def record_safe(evt):
    with _LOCK:
        _EVENTS.append(evt)


def read_only(name):
    return _REGISTRY.get(name)
