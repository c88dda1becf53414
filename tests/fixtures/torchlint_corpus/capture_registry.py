"""TL003 fixture: captures and kernel loads invisible to the capture
telemetry (``obs/capture_track.py``)."""

import ctypes

import torch

from lightgbm_tpu_torch.obs import capture_track


class Grower:
    def __init__(self, graphs):
        self.graphs = graphs
        self._pieces = None
        self._kept = {}

    def build_untracked(self):
        if self._pieces is None:
            self._pieces = self.graphs.capture(self._piece)  # PLANT: TL003
        return self._pieces

    def build_tracked(self, key):
        if key not in self._kept:
            self._kept[key] = self.graphs.capture(self._piece)
            capture_track.record("grow.tree", capture_track.signature_of(
                (key,)), 0.0, 0.0)
        return self._kept[key]

    def build_through_helper(self, key):
        # tracked through a same-file helper that records
        if key not in self._kept:
            self._kept[key] = self.graphs.capture(self._piece)
            self._note(key)
        return self._kept[key]

    def _note(self, key):
        capture_track.record("grow.helper", str(key), 0.0, 0.0)

    def _piece(self):
        return None


class Holder:
    def __init__(self):
        self.graph = None

    def capture_untracked(self, fn):
        self.graph = torch.cuda.CUDAGraph()  # PLANT: TL003
        with torch.cuda.graph(self.graph):
            fn()


def capture_primitive(fn, keep):
    # hands its graph back: the callers' capture calls are the sites
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        fn()
    keep.append(g)
    return g


def load_untracked(path):
    return ctypes.CDLL(path)  # PLANT: TL003


def load_tracked(name, path):
    lib = ctypes.CDLL(path)
    capture_track.record(f"build.{name}", path, 0.0, 0.0)
    return lib


def load_once_by_design(path):
    # a probe's one-off load, justified inline
    return ctypes.CDLL(path)  # torchlint: disable=TL003
