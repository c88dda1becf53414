"""TL002 fixture: CUDA-graph recapture hazards.

Every capture here records itself (``capture_track.record``) so the file
isolates TL002 from TL003.
"""

import torch

from lightgbm_tpu_torch.obs import capture_track


def predict_recapturing(model, x):
    g = torch.cuda.CUDAGraph()  # PLANT: TL002
    with torch.cuda.graph(g):
        y = model(x)
    g.replay()
    capture_track.record("predict", "()", 0.0, 0.0)
    return y


def graphed_per_call(fn, x):
    capture_track.record("graphed", "()", 0.0, 0.0)
    return torch.cuda.make_graphed_callables(fn, (x,))(x)  # PLANT: TL002


class Grower:
    def __init__(self, graphs):
        self.graphs = graphs
        self._composed = {}
        self._held = None
        self.quant = True

    def capture_kept(self, x):
        # held on the owner: captured once, replayed later
        if self._held is None:
            self._held = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self._held):
                self._piece(x)
            capture_track.record("kept", "()", 0.0, 0.0)
        self._held.replay()

    def build(self, key):
        # kept in a cache keyed by what shapes it
        if key not in self._composed:
            self._composed[key] = self.graphs.capture(self._piece_wave)
            capture_track.record("build", "()", 0.0, 0.0)
        return self._composed[key]

    def drop_piece(self):
        g = self.graphs.capture(self._piece)  # PLANT: TL002
        capture_track.record("drop", "()", 0.0, 0.0)
        g.replay()

    def _piece(self, x=None):
        if self.quant:              # host flag: the same every replay
            x = x * 2
        return x

    def _piece_wave(self):
        st = self.state
        if torch.any(st.best > 0):  # PLANT: TL002
            st.best.zero_()
        self._apply(st)

    def _apply(self, st):
        while int(st.ctl[0]) < 4:  # PLANT: TL002
            st.ctl[0:1].add_(1)


class GraphSet:
    """A capture primitive: the graph it captures is handed back."""

    def __init__(self):
        self.kept = []

    def capture(self, fn):
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            fn()
        self.kept.append(g)
        capture_track.record("set", "()", 0.0, 0.0)
        return g
