"""Persistent bin mappers across retrain windows, with drift detection.

Counterpart of ``lightgbm_tpu/pipeline/bins.py``.  The fork's harness
(``src/test.cpp``) re-runs find-bin from scratch for every sliding window
even though feature distributions drift slowly.  In the port a fresh set
of mappers also changes the grower's shapes (group count, slot pitch) and
with them its CUDA-graph captures, and the binned traversal of the
``refit``/``warm`` policies needs the previous window's mappers.

:class:`BinMapperCache` makes the first window's mappers the reference;
every later window's dataset is constructed AGAINST them
(``reference=``-style, ``Dataset::CreateValid`` semantics — no find-bin,
no re-bundling, identical group layout), and a cheap per-group drift
statistic decides when a re-find-bin is warranted:

    occ_w[g, s]  = P(slot s in group g)        for window w's binned rows
    tv_g         = 0.5 * sum_s | occ_w[g, s] - occ_ref[g, s] |
    drift        = mean_g  max(tv_g - noise_g, 0)

i.e. the MEAN per-group total-variation distance between this window's
bin-occupancy histogram and the occupancy recorded when the cached
mappers were found, each group's TV first reduced by its expected null
TV ``noise_g`` — what two same-distribution samples of these sizes would
measure from sampling noise alone (per-slot binomial std,
``E|N(0, s)| = s * sqrt(2/pi)``):

    noise_g = 0.5 * sqrt(2/pi) * sqrt(1/n_w + 1/n_ref)
                  * sum_s sqrt(occ_ref[g, s] * (1 - occ_ref[g, s]))

The mean (not the max) across groups makes the decision about global
mapper staleness: a single non-stationary feature (the cache-admission
trace's running ``cacheAvailBytes`` state) must not force a rebin that
would not help it.  When ``drift > threshold`` (and rebinding is enabled)
the window re-runs find-bin, becomes the new reference, and the rebind is
counted.  The statistic costs one ``np.bincount`` per group over the
(N, G) uint8 host matrix that window construction produces anyway.

The cache file and :func:`reference_to_bytes` blobs are the JAX package's
format (the same magic and pickled state), so either package reads the
other's.  :func:`broadcast_reference` sends host 0's layout to every host
of a pod over the socket plane (``parallel/network.broadcast_blob``), so
every host bins its rows against the same mappers.
"""

from __future__ import annotations

import pickle
from typing import Optional, Sequence, Tuple

import numpy as np

from .. import obs
from ..data.binning import BinMapper
from ..data.dataset import MAX_GROUP_BIN, BinnedDataset, FeatureGroupInfo
from ..utils.log import LightGBMError, log_info

CACHE_MAGIC = b"LIGHTGBM_TPU_BINCACHE_V1\n"


class BinMapperCache:
    """Owns the reference mappers of a windowed-retrain loop.

    ``dataset_for(...)`` is the single construction entry point: it
    builds the window's :class:`BinnedDataset` (dense or CSR) against
    the cached mappers, measures drift, optionally rebins, and reports
    what it did.  The cache is NOT thread-safe by itself — the pipeline
    calls it from its single prep thread.
    """

    def __init__(self, drift_threshold: float = 0.1,
                 rebin_on_drift: bool = True):
        self.drift_threshold = float(drift_threshold)
        self.rebin_on_drift = bool(rebin_on_drift)
        self.reference: Optional[BinnedDataset] = None
        self._ref_occ: Optional[np.ndarray] = None   # (G, 256) float64
        self._ref_n = 0          # rows behind _ref_occ (noise floor)
        self.windows = 0
        self.rebinds = 0
        self.last_drift: Optional[float] = None

    # -- construction ------------------------------------------------
    def dataset_for(self, config, *, dense: Optional[np.ndarray] = None,
                    csr: Optional[Tuple] = None,
                    categorical: Sequence[int] = (),
                    label=None) -> Tuple[BinnedDataset, dict]:
        """Build one window's dataset; returns ``(dataset, info)`` with
        ``info = {"rebinned": bool, "drift": float | None}``.  ``csr``
        is ``(indptr, indices, values, num_col)``; exactly one of
        ``dense``/``csr`` must be given."""
        if (dense is None) == (csr is None):
            raise LightGBMError(
                "dataset_for needs exactly one of dense= or csr=")
        self.windows += 1
        drift: Optional[float] = None
        if self.reference is None:
            # the initial find-bin is not a REBIND — `rebinds` counts
            # only drift-triggered re-runs (each of those recaptures)
            ds = self._construct(config, dense, csr, categorical, None)
            self._adopt(ds)
            rebinned = True
        else:
            ds = self._construct(config, dense, csr, categorical,
                                 self.reference)
            drift = self._drift(ds)
            self.last_drift = drift
            obs.set_gauge("pipeline.drift", drift)
            if self.rebin_on_drift and drift > self.drift_threshold:
                log_info(f"bin drift {drift:.4f} > "
                         f"{self.drift_threshold:.4f}: re-running "
                         f"find-bin (window {self.windows - 1})")
                ds = self._construct(config, dense, csr, categorical,
                                     None)
                self._adopt(ds)
                rebinned = True
                self.rebinds += 1
                obs.inc("pipeline.rebinds")
            else:
                rebinned = False
        if label is not None:
            ds.metadata.set_label(label)
        return ds, {"rebinned": rebinned, "drift": drift}

    @staticmethod
    def _construct(config, dense, csr, categorical, reference):
        if dense is not None:
            return BinnedDataset.construct_from_matrix(
                np.asarray(dense), config, categorical,
                reference=reference)
        indptr, indices, values, num_col = csr
        return BinnedDataset.construct_from_csr(
            indptr, indices, values, num_col, config, categorical,
            reference=reference)

    # -- drift statistic ---------------------------------------------
    @staticmethod
    def _occupancy(ds: BinnedDataset) -> np.ndarray:
        """(G, 256) normalized slot-occupancy of the binned matrix (a
        device-binned dataset's codes are read back once)."""
        binned = ds.binned
        if not isinstance(binned, np.ndarray):
            binned = binned.cpu().numpy()
        g_count = max(ds.num_groups, 1)
        occ = np.zeros((g_count, MAX_GROUP_BIN), np.float64)
        n = max(ds.num_data, 1)
        for g in range(ds.num_groups):
            occ[g] = np.bincount(binned[:, g],
                                 minlength=MAX_GROUP_BIN) / n
        return occ

    def _drift(self, ds: BinnedDataset) -> float:
        occ = self._occupancy(ds)
        tv = 0.5 * np.abs(occ - self._ref_occ).sum(axis=1)
        if not tv.size:
            return 0.0
        # expected null TV from sampling noise alone (module docstring)
        scale = np.sqrt(1.0 / max(ds.num_data, 1)
                        + 1.0 / max(self._ref_n, 1))
        noise = (0.5 * np.sqrt(2.0 / np.pi) * scale
                 * np.sqrt(self._ref_occ * (1.0 - self._ref_occ))
                 .sum(axis=1))
        return float(np.maximum(tv - noise, 0.0).mean())

    def _adopt(self, ds: BinnedDataset) -> None:
        self.reference = ds
        self._ref_occ = self._occupancy(ds)
        self._ref_n = int(ds.num_data)

    # -- persistence ---------------------------------------------------
    # A restarted pipeline re-loads its reference, so its first window
    # bins against the same mappers as the windows before the restart.
    def save(self, path: str) -> None:
        if self.reference is None:
            raise LightGBMError("BinMapperCache has no reference to save")
        state = _reference_state(self.reference)
        state.update(occ=self._ref_occ, occ_n=self._ref_n,
                     drift_threshold=self.drift_threshold)
        with open(path, "wb") as fh:
            fh.write(CACHE_MAGIC)
            pickle.dump(state, fh, protocol=4)
        log_info(f"Saved bin-mapper cache to {path}")

    @classmethod
    def load(cls, path: str, rebin_on_drift: bool = True
             ) -> "BinMapperCache":
        with open(path, "rb") as fh:
            if fh.read(len(CACHE_MAGIC)) != CACHE_MAGIC:
                raise LightGBMError(
                    f"{path} is not a lightgbm_tpu bin-mapper cache")
            state = pickle.load(fh)
        cache = cls(drift_threshold=float(state["drift_threshold"]),
                    rebin_on_drift=rebin_on_drift)
        cache.reference = _skeleton_from_state(state)
        cache._ref_occ = np.asarray(state["occ"], np.float64)
        cache._ref_n = int(state["occ_n"])
        return cache


# ---------------------------------------------------------------------------
# reference serialization and the pod's mapper broadcast
# ---------------------------------------------------------------------------
# A multi-controller pod host must bin its rows against EXACTLY the layout
# host 0's find-bin produced: a peer running its own find-bin over another
# sample would disagree on bin boundaries and on feature bundling, and the
# trees would part.  So the layout travels as a self-contained blob (the
# state dict the cache persists, minus the drift bookkeeping) over the
# network.py broadcast plane, and peers rebuild a data-free skeleton that
# construct_streaming_begin adopts ``reference=``-style.

def _reference_state(ref: BinnedDataset) -> dict:
    """The picklable mapper/group/constraint layout of a dataset (no
    row data) — the unit the on-disk cache and the blobs serialize."""
    return {
        "num_total_features": ref.num_total_features,
        "feature_names": ref.feature_names,
        "used_features": ref.used_features,
        "mappers": [m.to_state() if m else None
                    for m in ref.bin_mappers],
        "groups": [g.feature_indices for g in ref.groups],
        # adopted verbatim by reference-constructed datasets —
        # a restarted pipeline must keep training constrained
        "monotone": np.asarray(ref.monotone_constraints),
        "penalty": np.asarray(ref.feature_penalty),
    }


def _skeleton_from_state(state: dict) -> BinnedDataset:
    """A data-free skeleton dataset carrying the mappers/groups; only
    ever used as a ``reference=``, which reads exactly these."""
    ref = BinnedDataset()
    ref.num_total_features = int(state["num_total_features"])
    ref.feature_names = list(state["feature_names"])
    ref.used_features = list(state["used_features"])
    ref.bin_mappers = [BinMapper.from_state(s) if s else None
                       for s in state["mappers"]]
    ref.groups = [FeatureGroupInfo(g, [ref.bin_mappers[f] for f in g])
                  for g in state["groups"]]
    ref._build_feature_lookups(None)
    # restore what _build_feature_lookups(None) cannot know
    ref.monotone_constraints = np.asarray(state["monotone"], np.int32)
    ref.feature_penalty = np.asarray(state["penalty"], np.float64)
    return ref


def reference_to_bytes(ref: BinnedDataset,
                       extra: Optional[dict] = None) -> bytes:
    """Serialize a dataset's mapper/group layout (plus a small picklable
    ``extra`` dict) to a self-contained blob."""
    state = _reference_state(ref)
    state["extra"] = dict(extra or {})
    return CACHE_MAGIC + pickle.dumps(state, protocol=4)


def reference_from_bytes(blob: bytes
                         ) -> Tuple[BinnedDataset, dict]:
    """Rebuild ``(skeleton, extra)`` from :func:`reference_to_bytes`
    output."""
    if not blob.startswith(CACHE_MAGIC):
        raise LightGBMError(
            "blob is not a lightgbm_tpu mapper reference (magic "
            "mismatch)")
    state = pickle.loads(blob[len(CACHE_MAGIC):])
    return _skeleton_from_state(state), dict(state.get("extra") or {})


def reference_layout_digest(ref: BinnedDataset) -> str:
    """Digest of the mapper/group layout: equal for two references iff
    they bin rows identically into the same groups (equal across pod hosts
    iff they grow the same trees; the JAX package's digest, byte for
    byte)."""
    import hashlib
    state = _reference_state(ref)
    state.pop("penalty", None)
    h = hashlib.sha256()
    h.update(pickle.dumps(
        [state["num_total_features"], state["used_features"],
         state["groups"],
         [s if s is None else sorted(s.items())
          for s in state["mappers"]]], protocol=4))
    return h.hexdigest()


def broadcast_reference(reference: Optional[BinnedDataset], *,
                        address: str, num_hosts: int, rank: int,
                        config=None, extra: Optional[dict] = None
                        ) -> Tuple[BinnedDataset, dict]:
    """The pod ingest handshake: host 0 broadcasts its reference layout
    (and ``extra`` handshake facts), peers return the rebuilt skeleton
    and the facts.  Every host comes back with an equal layout digest."""
    from ..parallel.network import broadcast_blob
    payload = None
    if int(rank) == 0:
        if reference is None:
            raise LightGBMError(
                "broadcast_reference: host 0 must supply the reference")
        payload = reference_to_bytes(reference, extra)
    blob = broadcast_blob(payload, address=address,
                          num_hosts=num_hosts, rank=rank, config=config)
    if int(rank) == 0:
        return reference, dict(extra or {})
    return reference_from_bytes(blob)
