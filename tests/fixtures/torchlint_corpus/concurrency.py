"""Corpus: TL141 — thread/queue concurrency-graph hazards.

Planted defects: a spawned thread that opens spans with no
SpanContext handoff, blocking queue ops / a bare acquire in dispatch
scopes, and a join executed under a lock the joined thread acquires.
The good twins (context handed off, timeouts everywhere, join after
release) must stay silent.  The nested workers carry
``disable=TL161`` because this fixture deliberately has no
fault-site registry wiring (fault_coverage.py owns that).
"""
import queue
import threading

import obs
import tracing


# -- (a) spans on a spawned thread --------------------------------------

def spawn_without_handoff():
    def worker():  # torchlint: disable=TL161
        with obs.span("corpus.window", cat="corpus"):
            pass

    t = threading.Thread(target=worker)  # PLANT: TL141
    t.start()
    return t


def spawn_with_set_current(captured):
    def worker():  # torchlint: disable=TL161
        tracing.set_current(captured)
        with obs.span("corpus.window", cat="corpus"):
            pass

    t = threading.Thread(target=worker)  # ok: context activated inside
    t.start()
    return t


def spawn_with_ctx_param(span_ctx):
    def worker(ctx):  # torchlint: disable=TL161
        with obs.span("corpus.window", cat="corpus"):
            pass

    t = threading.Thread(target=worker, args=(span_ctx,))  # ok: ctx arg
    t.start()
    return t


# -- (b) blocking calls in dispatch scopes ------------------------------

def dispatch_blocking():
    q = queue.Queue(maxsize=4)

    def worker():  # torchlint: disable=TL161
        while True:
            try:
                if q.get(timeout=0.5) is None:  # ok: timed
                    return
            except queue.Empty:
                continue

    t = threading.Thread(target=worker)
    t.start()
    q.put("work")  # PLANT: TL141
    return q.get()  # PLANT: TL141


def dispatch_nonblocking():
    q = queue.Queue()  # unbounded: puts never block

    def worker():  # torchlint: disable=TL161
        try:
            q.get(timeout=0.1)
        except queue.Empty:
            pass

    t = threading.Thread(target=worker)
    t.start()
    q.put("work")  # ok: unbounded put
    try:
        return q.get(timeout=1.0)  # ok: timed
    except queue.Empty:
        return None


def dispatch_bare_acquire():
    lock = threading.Lock()

    def worker():  # torchlint: disable=TL161
        with lock:  # ok: context manager
            pass

    t = threading.Thread(target=worker)
    t.start()
    lock.acquire()  # PLANT: TL141
    try:
        return t
    finally:
        lock.release()


# -- (c) join while holding the target's lock ---------------------------

class Flusher:
    def __init__(self):
        self._lock = threading.Lock()
        self._t = None

    def start(self):
        self._t = threading.Thread(target=self._flush_loop)
        self._t.start()

    def _flush_loop(self):  # torchlint: disable=TL161
        with self._lock:
            pass

    def stop_deadlocks(self):
        with self._lock:
            self._t.join()  # PLANT: TL141

    def stop_ok(self):
        with self._lock:
            t = self._t
        t.join()  # ok: lock released before the join
