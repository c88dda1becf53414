"""TL121 fixture: lock-order inversion and thread-shared state.

Planted: a two-lock order inversion (both acquisition sites are
findings) and an unguarded ``self.<attr>`` write inside a thread entry
point of a lock-owning class.  Exempt variants: consistently ordered
nested acquisition, a locked self-attr write, and a suppressed
occurrence.
"""

import threading

_A_LOCK = threading.Lock()
_B_LOCK = threading.Lock()


def a_then_b():
    with _A_LOCK:
        with _B_LOCK:       # PLANT: TL121
            pass


def b_then_a():
    with _B_LOCK:
        with _A_LOCK:       # PLANT: TL121
            pass


_C_LOCK = threading.Lock()
_D_LOCK = threading.Lock()


def c_then_d_only():
    # one global order, no inversion anywhere: exempt
    with _C_LOCK:
        with _D_LOCK:
            pass


def c_then_d_again():
    with _C_LOCK:
        with _D_LOCK:
            pass


class Worker:
    def __init__(self):
        self._lock = threading.Lock()
        self._results = None
        self._progress = 0
        self._thread = threading.Thread(target=self._run)

    def _run(self):  # torchlint: disable=TL161
        self._progress = 1          # PLANT: TL121
        with self._lock:
            self._results = []
        # torchlint: disable-next=TL121
        self._progress = 2

    def snapshot(self):
        with self._lock:
            return self._results, self._progress
