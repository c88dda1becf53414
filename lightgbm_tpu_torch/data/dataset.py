"""Binned dataset construction: sampling, bin finding, bundling, group
storage.

Counterpart of ``lightgbm_tpu/data/dataset.py`` for a dense float matrix
(``construct_from_matrix``), CSR triplets (``construct_from_csr``, which
bins without densifying) and a float32 tensor binned where it lies
(``construct_from_device_matrix``: bins found on a host sample, the codes
computed with torch ops on the tensor's device).  Each takes
``reference=``, a training set whose mappers and groups a validation set
adopts.  The binned matrix is a dense
``(num_data, num_groups)`` uint8 array: every feature group holds <= 256
total bins, so one byte per group cell suffices.  Slot 0 of every group
means "all features at their default bin"; feature ``f`` with bin
``b != default_bin(f)`` maps to ``offset(f) + b - (1 if default_bin(f) == 0
else 0)``.  The split scan reconstructs the skipped default bin from leaf
totals.  Bin codes, groups and offsets are the JAX package's byte for byte.  ``copy_subset`` slices rows of a
built set, and ``save_binary``/``load_binary`` keep a built set in the JAX
package's binary file (:data:`BINARY_MAGIC`, then a pickle of host numpy
arrays and mapper states), so either package loads the other's files.
"""

from __future__ import annotations

import pickle
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..config import Config, resolve_device
from ..utils.log import LightGBMError, log_info, log_warning
from ..utils.random import make_rng
from .binning import BIN_CATEGORICAL, BIN_NUMERICAL, BinMapper

MAX_GROUP_BIN = 256
#: the first bytes of a binary dataset file (``lightgbm_tpu/data/
#: dataset.py::BINARY_MAGIC``)
BINARY_MAGIC = b"LIGHTGBM_TPU_DATASET_V1\n"


class Metadata:
    """Labels, weights, query boundaries and init scores (reference
    ``Metadata``; ``lightgbm_tpu/data/dataset.py:36-103``)."""

    def __init__(self, num_data: int):
        self.num_data = num_data
        self.label: Optional[np.ndarray] = None
        self.weights: Optional[np.ndarray] = None
        self.query_boundaries: Optional[np.ndarray] = None
        self.query_weights: Optional[np.ndarray] = None
        self.init_score: Optional[np.ndarray] = None

    def set_label(self, label):
        label = np.ascontiguousarray(label, dtype=np.float32).reshape(-1)
        if len(label) != self.num_data:
            raise LightGBMError(
                f"label length {len(label)} != num_data {self.num_data}")
        self.label = label

    def set_weights(self, weights):
        if weights is None:
            self.weights = None
            return
        weights = np.ascontiguousarray(weights, dtype=np.float32).reshape(-1)
        if len(weights) != self.num_data:
            raise LightGBMError(
                f"weight length {len(weights)} != num_data {self.num_data}")
        self.weights = weights
        self._update_query_weights()

    def set_query(self, group):
        """``group``: per-query sizes, or boundaries when it is already
        cumulative from 0."""
        if group is None:
            self.query_boundaries = None
            self.query_weights = None
            return
        group = np.ascontiguousarray(group, dtype=np.int64).reshape(-1)
        if len(group) > 0 and group[0] == 0:
            boundaries = group
        else:
            boundaries = np.concatenate([[0], np.cumsum(group)])
        if boundaries[-1] != self.num_data:
            raise LightGBMError(
                f"sum of query counts {boundaries[-1]} != num_data "
                f"{self.num_data}")
        self.query_boundaries = boundaries.astype(np.int64)
        self._update_query_weights()

    def _update_query_weights(self):
        """Per-query weight: the mean of its rows' weights."""
        if self.weights is not None and self.query_boundaries is not None:
            qb = self.query_boundaries
            qw = np.zeros(len(qb) - 1, dtype=np.float32)
            for i in range(len(qw)):
                lo, hi = qb[i], qb[i + 1]
                qw[i] = self.weights[lo:hi].mean() if hi > lo else 0.0
            self.query_weights = qw

    def set_init_score(self, init_score):
        if init_score is None:
            self.init_score = None
            return
        self.init_score = np.ascontiguousarray(
            init_score, dtype=np.float64).reshape(-1)

    def num_queries(self) -> int:
        return 0 if self.query_boundaries is None \
            else len(self.query_boundaries) - 1


class FeatureGroupInfo:
    """Static description of one feature group (bundle)."""

    __slots__ = ("feature_indices", "bin_offsets", "num_total_bin")

    def __init__(self, feature_indices: List[int],
                 bin_mappers: List[BinMapper]):
        self.feature_indices = list(feature_indices)
        # slot 0 reserved for "all defaults" (reference feature_group.h:33-45)
        self.bin_offsets = [1]
        total = 1
        for m in bin_mappers:
            total += m.num_bin - (1 if m.default_bin == 0 else 0)
            self.bin_offsets.append(total)
        self.num_total_bin = total


class BinnedDataset:
    """Host-side binned dataset; the grower uploads its transpose."""

    def __init__(self):
        self.num_data: int = 0
        self.num_total_features: int = 0
        self.bin_mappers: List[Optional[BinMapper]] = []
        self.groups: List[FeatureGroupInfo] = []
        # (N, G) uint8: a numpy array, or a tensor where device_binned
        self.binned = None
        self.device_binned = False
        self.reference: Optional["BinnedDataset"] = None
        self.metadata: Optional[Metadata] = None
        self.feature_names: List[str] = []
        self.used_features: List[int] = []             # original idx, non-trivial
        # per-used-feature flattened lookups (device metadata)
        self.f_group = np.empty(0, np.int32)
        self.f_offset = np.empty(0, np.int32)
        self.f_num_bin = np.empty(0, np.int32)
        self.f_default_bin = np.empty(0, np.int32)
        self.f_missing_type = np.empty(0, np.int32)    # 0/1/2 none/zero/nan
        self.f_is_categorical = np.empty(0, np.int32)
        self.monotone_constraints = np.empty(0, np.int32)
        self.feature_penalty = np.empty(0, np.float64)

    @property
    def num_groups(self) -> int:
        return len(self.groups)

    @property
    def num_features(self) -> int:
        return len(self.used_features)

    def group_bin_boundaries(self) -> np.ndarray:
        """(G + 1,) int64 cumulative bin counts of the feature groups."""
        out = [0]
        for g in self.groups:
            out.append(out[-1] + g.num_total_bin)
        return np.asarray(out, dtype=np.int64)

    @classmethod
    def construct_from_matrix(
            cls, data: np.ndarray, config: Config,
            categorical: Sequence[int] = (),
            feature_names: Optional[Sequence[str]] = None,
            reference: Optional["BinnedDataset"] = None,
            predefined_mappers: Optional[List[Optional[BinMapper]]] = None,
    ) -> "BinnedDataset":
        """Build from a dense float matrix (rows, features).  With
        ``reference``, a validation set: its mappers and groups, no bin
        finding (reference ``Dataset::CreateValid``).
        ``predefined_mappers`` are mappers found elsewhere (the distributed
        find-bin, ``data/distributed.py``), taken where not None."""
        data = np.asarray(data)
        if data.ndim != 2:
            raise LightGBMError("data must be 2-dimensional")
        n, num_feat = data.shape
        ds = cls()
        ds.num_data = n
        ds.num_total_features = num_feat
        ds.metadata = Metadata(n)
        ds.feature_names = ([f"Column_{i}" for i in range(num_feat)]
                            if feature_names is None else list(feature_names))
        if reference is not None:
            ds._align_with_reference(data, reference)
            return ds
        ds._find_bins(data, config, set(int(c) for c in categorical),
                      predefined=predefined_mappers)
        ds._bundle_features(data, config)
        ds._build_group_matrix(data)
        ds._build_feature_lookups(config)
        return ds

    @classmethod
    def construct_from_csr(
            cls, indptr, indices, values, num_col: int, config: Config,
            categorical: Sequence[int] = (),
            feature_names: Optional[Sequence[str]] = None,
            reference: Optional["BinnedDataset"] = None,
    ) -> "BinnedDataset":
        """Build from CSR triplets without densifying: host memory stays
        proportional to nnz plus the (N, G) uint8 matrix (the analog of
        the reference's ``LGBM_DatasetCreateFromCSR``, which the fork's
        cache-admission harness calls every window).  ``reference`` as in
        :meth:`construct_from_matrix`."""
        indptr = np.asarray(indptr, np.int64)
        indices = np.asarray(indices, np.int64)
        values = np.asarray(values, np.float64)
        n = len(indptr) - 1
        num_col = int(num_col)
        ds = cls()
        ds.num_data = n
        ds.num_total_features = num_col
        ds.metadata = Metadata(n)
        ds.feature_names = ([f"Column_{i}" for i in range(num_col)]
                            if feature_names is None else list(feature_names))

        # column-major view of the nonzeros (one stable sort, O(nnz); on
        # 16-bit keys numpy's stable sort is a radix sort, ~7x faster than
        # on int64 at 55M nonzeros)
        row_ids = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
        key = indices.astype(np.int16) \
            if num_col <= np.iinfo(np.int16).max else indices
        order = np.argsort(key, kind="stable")
        col_sorted = indices[order]
        rows_by_col = row_ids[order]
        vals_by_col = values[order]
        col_bounds = np.searchsorted(col_sorted,
                                     np.arange(num_col + 1, dtype=np.int64))
        if reference is not None:
            ds._check_reference_width(num_col, reference)
            ds._align_with_reference_shared(reference)
            ds._build_group_matrix_csr(col_bounds, rows_by_col, vals_by_col)
            return ds

        # stage 1: sampled bin finding (recorded = nonzero or NaN values of
        # the sampled rows; zeros implicit, as in the dense path)
        sample_idx = ds._draw_sample(config)
        sample_cnt = len(sample_idx)
        in_sample = np.zeros(n, bool)
        in_sample[sample_idx] = True
        sample_pos = np.full(n, -1, np.int64)
        sample_pos[sample_idx] = np.arange(sample_cnt)
        filter_cnt = int(0.95 * config.min_data_in_leaf / max(n, 1)
                         * sample_cnt)
        cat = set(int(c) for c in categorical)
        ds.bin_mappers = []
        nz_masks: Dict[int, np.ndarray] = {}
        nz_counts: Dict[int, int] = {}
        for f in range(num_col):
            s, e = col_bounds[f], col_bounds[f + 1]
            rs, vs = rows_by_col[s:e], vals_by_col[s:e]
            keep = in_sample[rs]
            vs_s = vs[keep]
            rec_mask = (vs_s != 0.0) | np.isnan(vs_s)
            m = BinMapper()
            m.find_bin(vs_s[rec_mask], sample_cnt, config.max_bin,
                       config.min_data_in_bin, filter_cnt,
                       BIN_CATEGORICAL if f in cat else BIN_NUMERICAL,
                       config.use_missing, config.zero_as_missing)
            ds.bin_mappers.append(m)
            mask = np.zeros(sample_cnt, bool)
            mask[sample_pos[rs[keep][rec_mask]]] = True
            nz_masks[f] = mask
            nz_counts[f] = int(mask.sum())
        ds.used_features = [f for f in range(num_col)
                            if not ds.bin_mappers[f].is_trivial]
        if not ds.used_features:
            log_warning("There are no meaningful features, as all feature "
                        "values are constant.")

        # stage 2: bundling on the sampled masks
        if not ds.used_features:
            ds.groups = []
        elif not config.enable_bundle or len(ds.used_features) == 1:
            ds._set_groups([[f] for f in ds.used_features])
        else:
            ds._set_groups(ds._bundle_from_masks(config, nz_masks, nz_counts,
                                                 sample_cnt))
        ds._build_group_matrix_csr(col_bounds, rows_by_col, vals_by_col)
        ds._build_feature_lookups(config)
        return ds

    @classmethod
    def construct_from_device_matrix(
            cls, data, config: Config,
            feature_names: Optional[Sequence[str]] = None,
            reference: Optional["BinnedDataset"] = None,
            device="cuda",
    ) -> "BinnedDataset":
        """Build from an (N, F) float32 matrix, binned where it lies: a
        tensor keeps its device, a numpy array is uploaded to ``device``.
        Bins are found and features bundled on a host sample of
        ``bin_construct_sample_cnt`` rows (drawn as
        :meth:`construct_from_matrix` draws them, so the mappers and groups
        are a host build's); the codes are computed on the device and
        ``binned`` is an (N, G) uint8 tensor there (``device_binned``).

        Exactness: bin boundaries are float64; a float32 value ``v``
        satisfies ``v <= b64`` exactly when ``v <= round_down32(b64)``, so
        searching the float32 inputs among the boundaries rounded down to
        float32 gives the host's codes for float32 data byte for byte.

        Numerical features only; ``reference`` adopts a training set's
        mappers and groups and computes codes only."""
        if not isinstance(data, torch.Tensor):
            data = torch.from_numpy(np.ascontiguousarray(data)).to(
                resolve_device(str(device)))
        if data.ndim != 2:
            raise LightGBMError("data must be 2-dimensional")
        if data.dtype != torch.float32:
            raise LightGBMError(
                f"construct_from_device_matrix needs float32 data (got "
                f"{data.dtype}); use construct_from_matrix")
        n, num_feat = (int(s) for s in data.shape)
        ds = cls()
        ds.num_data = n
        ds.num_total_features = num_feat
        ds.metadata = Metadata(n)
        ds.feature_names = ([f"Column_{i}" for i in range(num_feat)]
                            if feature_names is None
                            else list(feature_names))
        if reference is not None:
            ds._check_reference_width(num_feat, reference)
            ds._align_with_reference_shared(reference)
        else:
            idx = ds._draw_sample(config)
            sample = data[torch.from_numpy(idx).to(data.device)].cpu() \
                .numpy().astype(np.float64)
            ds._find_bins(sample, config, set(), presampled=True)
            ds._bundle_features(sample, config)
            ds._build_feature_lookups(config)
        if any(m.bin_type == BIN_CATEGORICAL for m in ds.bin_mappers
               if m is not None):
            raise LightGBMError(
                "construct_from_device_matrix supports numerical "
                "features only; use construct_from_matrix")
        ds.binned = ds._bin_on_device(data)
        ds.device_binned = True
        return ds

    def _bin_on_device(self, data: torch.Tensor) -> torch.Tensor:
        """(N, F) float32 tensor -> (N, G) uint8 codes on its device, with
        torch ops: the used columns are gathered into an (F', N) matrix,
        every feature is searched in one batched
        ``searchsorted`` among its boundaries rounded down to float32
        (padded with +inf, which no search passes), and each group takes
        its features' non-default slots in feature order (the later
        feature wins a bundle conflict, as in ``_build_group_matrix``)."""
        dev = data.device
        n = int(data.shape[0])
        feats = [f for g in self.groups for f in g.feature_indices]
        if not feats:
            return torch.zeros((n, 0), dtype=torch.uint8, device=dev)
        # per used feature: its bounds rounded down to float32, and (column,
        # NaN's bin or -1 where NaN searches as 0, default bin, slot base)
        bounds, meta = [], []
        for g in self.groups:
            for sub, f in enumerate(g.feature_indices):
                m = self.bin_mappers[f]
                nan_bin = m.num_bin - 1 if m.missing_type == "nan" else -1
                n_search = m.num_bin - (1 if nan_bin >= 0 else 0)
                b64 = np.asarray(m.bin_upper_bound[:n_search - 1], np.float64)
                b32 = b64.astype(np.float32)
                over = b32.astype(np.float64) > b64
                b32[over] = np.nextafter(b32[over], np.float32(-np.inf))
                bounds.append(b32)
                meta.append((f, nan_bin, m.default_bin, g.bin_offsets[sub]
                             - (1 if m.default_bin == 0 else 0)))
        table = np.full((len(feats), max(1, max(map(len, bounds)))), np.inf,
                        np.float32)
        for i, b in enumerate(bounds):
            table[i, :len(b)] = b
        meta = torch.from_numpy(np.asarray(meta, np.int32).T.copy()).to(dev)
        nan_bin, default_bin, slot_base = (meta[i].view(-1, 1)
                                           for i in (1, 2, 3))
        # (F', N), each used feature a contiguous row, in one gather from
        # the transposed view (on the card as fast as a plain transpose and
        # faster than gathering rows first: scripts/ablate_binning_cuda.py)
        x = data.t().index_select(0, meta[0].long())
        nan = torch.isnan(x)
        b = torch.searchsorted(torch.from_numpy(table).to(dev),
                               x.masked_fill_(nan, 0.0), side="left",
                               out_int32=True)
        b = torch.where(nan & (nan_bin >= 0), nan_bin, b)
        # a default bin takes slot 0; any other slot is >= 1 (offsets
        # start at 1) and < 256 (a group holds at most 256 bins)
        slots = torch.where(b != default_bin, b + slot_base, 0) \
            .to(torch.uint8)
        codes = torch.empty((len(self.groups), n), dtype=torch.uint8,
                            device=dev)
        row = 0
        for gid, g in enumerate(self.groups):
            codes[gid] = slots[row]
            for sub in range(1, len(g.feature_indices)):
                codes[gid] = torch.where(slots[row + sub] != 0,
                                         slots[row + sub], codes[gid])
            row += len(g.feature_indices)
        return codes.t().contiguous()

    # -- stage 1: bin mappers ---------------------------------------------
    def _draw_sample(self, config: Config) -> np.ndarray:
        """Sorted indices of the ``bin_construct_sample_cnt`` rows bins are
        found on, from ``make_rng(data_random_seed)``."""
        n = self.num_data
        sample_cnt = min(n, int(config.bin_construct_sample_cnt))
        if sample_cnt < n:
            rng = make_rng(config.data_random_seed)
            return np.sort(rng.choice(n, size=sample_cnt, replace=False))
        return np.arange(n)

    def _find_bins(self, data: np.ndarray, config: Config,
                   categorical: set, presampled: bool = False,
                   predefined=None) -> None:
        """``presampled``: ``data`` is the sample already (device
        construction gathers it); the filter count still scales by the
        whole ``num_data``."""
        n = self.num_data
        sample_idx = (np.arange(len(data)) if presampled
                      else self._draw_sample(config))
        sample_cnt = len(sample_idx)
        self._sample_idx = sample_idx
        sampled = np.asarray(data[sample_idx], dtype=np.float64)

        # filter count mirrors dataset_loader.cpp:787 scaling to the sample
        filter_cnt = int(0.95 * config.min_data_in_leaf / max(n, 1)
                         * sample_cnt)
        self.bin_mappers = []
        for f in range(self.num_total_features):
            if predefined is not None and predefined[f] is not None:
                self.bin_mappers.append(predefined[f])
                continue
            col = sampled[:, f]
            bin_type = BIN_CATEGORICAL if f in categorical else BIN_NUMERICAL
            m = BinMapper()
            # recorded values contract: non-zero entries + NaNs, zeros are
            # implicit (the sparse sampling path of the loader)
            recorded = col[(col != 0.0) | np.isnan(col)]
            m.find_bin(recorded, sample_cnt, config.max_bin,
                       config.min_data_in_bin, filter_cnt, bin_type,
                       config.use_missing, config.zero_as_missing)
            self.bin_mappers.append(m)
        self.used_features = [f for f in range(self.num_total_features)
                              if not self.bin_mappers[f].is_trivial]
        if not self.used_features:
            log_warning("There are no meaningful features, as all feature "
                        "values are constant.")

    # -- stage 2: bundling -------------------------------------------------
    def _bundle_features(self, data: np.ndarray, config: Config) -> None:
        used = self.used_features
        if not used:
            self.groups = []
            return
        if not config.enable_bundle or len(used) == 1:
            feature_groups = [[f] for f in used]
        else:
            feature_groups = self._fast_feature_bundling(data, config)
        self._set_groups(feature_groups)

    # -- streaming (two-round) construction --------------------------------
    @classmethod
    def construct_streaming_begin(
            cls, sample: np.ndarray, n_total: int, num_cols: int, config,
            categorical: Sequence[int] = (),
            feature_names: Optional[Sequence[str]] = None,
            reference: Optional["BinnedDataset"] = None,
    ) -> "BinnedDataset":
        """Start a two-round construction (``data/stream_loader.py``):
        bins and bundles from ``sample`` (the round-one reservoir) scaled
        to ``n_total`` rows, and the ``(N, G)`` uint8 matrix allocated;
        chunks arrive through :meth:`construct_streaming_push` (reference
        ``dataset_loader.cpp:161-264``)."""
        ds = cls()
        ds.num_data = int(n_total)
        ds.num_total_features = int(num_cols)
        ds.metadata = Metadata(ds.num_data)
        ds.feature_names = ([f"Column_{i}" for i in range(num_cols)]
                            if feature_names is None
                            else list(feature_names))
        if reference is not None:
            ds._check_reference_width(num_cols, reference)
            ds._align_with_reference_shared(reference)
            ds.binned = np.zeros((ds.num_data, len(ds.groups)), np.uint8)
            return ds
        sample = np.asarray(sample, np.float64)
        sample_cnt = sample.shape[0]
        filter_cnt = int(0.95 * config.min_data_in_leaf
                         / max(n_total, 1) * sample_cnt)
        cat = set(int(c) for c in categorical)
        ds.bin_mappers = []
        nz_masks, nz_counts = {}, {}
        for f in range(num_cols):
            col = sample[:, f]
            mask = (col != 0.0) | np.isnan(col)
            m = BinMapper()
            m.find_bin(col[mask], sample_cnt, config.max_bin,
                       config.min_data_in_bin, filter_cnt,
                       BIN_CATEGORICAL if f in cat else BIN_NUMERICAL,
                       config.use_missing, config.zero_as_missing)
            ds.bin_mappers.append(m)
            nz_masks[f] = mask
            nz_counts[f] = int(mask.sum())
        ds.used_features = [f for f in range(num_cols)
                            if not ds.bin_mappers[f].is_trivial]
        if not ds.used_features:
            log_warning("There are no meaningful features, as all feature "
                        "values are constant.")
            ds.groups = []
        elif not config.enable_bundle or len(ds.used_features) == 1:
            ds._set_groups([[f] for f in ds.used_features])
        else:
            ds._set_groups(ds._bundle_from_masks(config, nz_masks,
                                                 nz_counts, sample_cnt))
        ds._build_feature_lookups(config)
        ds.binned = np.zeros((ds.num_data, len(ds.groups)), np.uint8)
        return ds

    def construct_streaming_push(self, chunk: np.ndarray,
                                 start_row: int) -> None:
        """Bin ``chunk``'s rows into ``binned[start_row:...]`` (the
        chunked ``Dataset::PushOneRow``, dataset.h:318-341)."""
        chunk = np.asarray(chunk, np.float64)
        end = start_row + chunk.shape[0]
        if end > self.num_data:
            raise LightGBMError("streaming push beyond declared num_data")
        out = self.binned[start_row:end]
        for gid, group in enumerate(self.groups):
            col_out = out[:, gid]
            for sub, f in enumerate(group.feature_indices):
                m = self.bin_mappers[f]
                bins = m.values_to_bins(chunk[:, f])
                slot = bins + group.bin_offsets[sub] \
                    - (1 if m.default_bin == 0 else 0)
                non_default = bins != m.default_bin
                col_out[non_default] = slot[non_default].astype(np.uint8)

    def construct_streaming_finish(self) -> None:
        """The end of the stream (nothing left to do: every row was
        binned as it was pushed)."""

    def _set_groups(self, feature_groups) -> None:
        self.groups = [FeatureGroupInfo(g, [self.bin_mappers[f] for f in g])
                       for g in feature_groups]
        for g in self.groups:
            if g.num_total_bin > MAX_GROUP_BIN:
                raise LightGBMError(
                    f"feature group exceeds {MAX_GROUP_BIN} bins; "
                    f"reduce max_bin (got {g.num_total_bin})")

    def _fast_feature_bundling(self, data: np.ndarray, config: Config):
        """Greedy conflict-bounded bundling (reference dataset.cpp:66-210)
        over the sampled rows' recorded (non-zero or NaN) masks."""
        sampled = np.asarray(data[self._sample_idx], dtype=np.float64)
        nz_masks, nz_counts = {}, {}
        for f in self.used_features:
            col = sampled[:, f]
            mask = (col != 0.0) | np.isnan(col)
            nz_masks[f] = mask
            nz_counts[f] = int(mask.sum())
        return self._bundle_from_masks(config, nz_masks, nz_counts,
                                       len(self._sample_idx))

    def _bundle_from_masks(self, config: Config, nz_masks, nz_counts,
                           total_sample: int):
        """Tries two orderings (original and by descending non-zero count),
        keeps whichever yields fewer groups, then breaks small sparse groups
        back apart.  Groups are capped at 256 total bins."""
        used = self.used_features
        max_error_cnt = int(total_sample * config.max_conflict_rate)
        filter_cnt = int(0.95 * config.min_data_in_leaf
                         / max(self.num_data, 1) * total_sample)

        def extra_bins(f):
            m = self.bin_mappers[f]
            return m.num_bin - (1 if m.default_bin == 0 else 0)

        def find_groups(order):
            groups: List[List[int]] = []
            marks: List[np.ndarray] = []
            conflict_cnt: List[int] = []
            non_zero_cnt: List[int] = []
            num_bin: List[int] = []
            for f in order:
                cur_nz = nz_counts[f]
                placed = False
                for gid in range(len(groups)):
                    if non_zero_cnt[gid] + cur_nz > total_sample + max_error_cnt:
                        continue
                    if num_bin[gid] + extra_bins(f) > MAX_GROUP_BIN:
                        continue
                    rest_max = max_error_cnt - conflict_cnt[gid]
                    cnt = int((marks[gid] & nz_masks[f]).sum())
                    if cnt <= rest_max:
                        rest_nz = int((cur_nz - cnt) * self.num_data
                                      / max(total_sample, 1))
                        if rest_nz < filter_cnt:
                            continue
                        groups[gid].append(f)
                        conflict_cnt[gid] += cnt
                        non_zero_cnt[gid] += cur_nz - cnt
                        marks[gid] |= nz_masks[f]
                        num_bin[gid] += extra_bins(f)
                        placed = True
                        break
                if not placed:
                    groups.append([f])
                    marks.append(nz_masks[f].copy())
                    conflict_cnt.append(0)
                    non_zero_cnt.append(cur_nz)
                    num_bin.append(1 + extra_bins(f))
            return groups

        g1 = find_groups(list(used))
        g2 = find_groups(sorted(used, key=lambda f: -nz_counts[f]))
        groups = g2 if len(g2) < len(g1) else g1

        # take small sparse groups apart (dataset.cpp:185-205)
        out: List[List[int]] = []
        for g in groups:
            if len(g) <= 1 or len(g) >= 5:
                out.append(g)
                continue
            cnt_nz = sum(int(self.num_data
                             * (1.0 - self.bin_mappers[f].sparse_rate))
                         for f in g)
            sparse_rate = 1.0 - cnt_nz / max(self.num_data, 1)
            if sparse_rate >= config.sparse_threshold \
                    and config.is_enable_sparse:
                out.extend([[f] for f in g])
            else:
                out.append(g)
        return out

    # -- stage 3: binned group matrix -------------------------------------
    def _build_group_matrix(self, data: np.ndarray) -> None:
        binned = np.zeros((self.num_data, len(self.groups)), dtype=np.uint8)
        for gid, group in enumerate(self.groups):
            col_out = binned[:, gid]
            for sub, f in enumerate(group.feature_indices):
                m = self.bin_mappers[f]
                bins = m.values_to_bins(np.asarray(data[:, f],
                                                   dtype=np.float64))
                slot = bins + group.bin_offsets[sub] \
                    - (1 if m.default_bin == 0 else 0)
                non_default = bins != m.default_bin
                # later features of a bundle overwrite on (rare) conflicts,
                # same as the reference's push order
                col_out[non_default] = slot[non_default].astype(np.uint8)
        self.binned = binned

    def _build_group_matrix_csr(self, col_bounds, rows_by_col,
                                vals_by_col) -> None:
        """(N, G) uint8 matrix straight from the column-sorted nonzeros:
        rows a feature does not record stay at the group's default slot
        0, as the dense path's non-default masking leaves them."""
        binned = np.zeros((self.num_data, len(self.groups)), dtype=np.uint8)
        for gid, group in enumerate(self.groups):
            col_out = binned[:, gid]
            for sub, f in enumerate(group.feature_indices):
                m = self.bin_mappers[f]
                s, e = col_bounds[f], col_bounds[f + 1]
                bins = m.values_to_bins(vals_by_col[s:e])
                slot = bins + group.bin_offsets[sub] \
                    - (1 if m.default_bin == 0 else 0)
                non_default = bins != m.default_bin
                col_out[rows_by_col[s:e][non_default]] = \
                    slot[non_default].astype(np.uint8)
        self.binned = binned

    # -- stage 4: per-feature lookups -------------------------------------
    def _build_feature_lookups(self, config: Optional[Config]) -> None:
        nf = len(self.used_features)
        self.f_group = np.zeros(nf, np.int32)
        self.f_offset = np.zeros(nf, np.int32)
        self.f_num_bin = np.zeros(nf, np.int32)
        self.f_default_bin = np.zeros(nf, np.int32)
        self.f_missing_type = np.zeros(nf, np.int32)
        self.f_is_categorical = np.zeros(nf, np.int32)
        pos = {f: i for i, f in enumerate(self.used_features)}
        for gid, group in enumerate(self.groups):
            for sub, f in enumerate(group.feature_indices):
                i = pos[f]
                m = self.bin_mappers[f]
                self.f_group[i] = gid
                self.f_offset[i] = group.bin_offsets[sub]
                self.f_num_bin[i] = m.num_bin
                self.f_default_bin[i] = m.default_bin
                self.f_missing_type[i] = {"none": 0, "zero": 1,
                                          "nan": 2}[m.missing_type]
                self.f_is_categorical[i] = int(m.bin_type == BIN_CATEGORICAL)
        mono = np.zeros(nf, np.int32)
        pen = np.ones(nf, np.float64)
        if config is not None:
            mc = list(config.monotone_constraints or [])
            fp = list(config.feature_contri or [])
            for i, f in enumerate(self.used_features):
                if f < len(mc):
                    mono[i] = int(mc[f])
                if f < len(fp):
                    pen[i] = float(fp[f])
        self.monotone_constraints = mono
        self.feature_penalty = pen

    # -- validation alignment ---------------------------------------------
    @staticmethod
    def _check_reference_width(num_feat: int, reference) -> None:
        if num_feat != reference.num_total_features:
            raise LightGBMError(
                f"validation data has {num_feat} features, train has "
                f"{reference.num_total_features}")

    def _align_with_reference_shared(self, reference) -> None:
        """Adopt the training set's mappers and grouping (CreateValid)."""
        self.reference = reference
        self.bin_mappers = reference.bin_mappers
        self.groups = reference.groups
        self.used_features = reference.used_features
        self.f_group = reference.f_group
        self.f_offset = reference.f_offset
        self.f_num_bin = reference.f_num_bin
        self.f_default_bin = reference.f_default_bin
        self.f_missing_type = reference.f_missing_type
        self.f_is_categorical = reference.f_is_categorical
        self.monotone_constraints = reference.monotone_constraints
        self.feature_penalty = reference.feature_penalty
        self.feature_names = reference.feature_names

    def _align_with_reference(self, data: np.ndarray,
                              reference: "BinnedDataset") -> None:
        self._check_reference_width(data.shape[1], reference)
        self._align_with_reference_shared(reference)
        self._build_group_matrix(data)

    def check_align(self, other: "BinnedDataset") -> bool:
        """Reference ``Dataset::CheckAlign`` (dataset.h:300-316)."""
        return (self.num_total_features == other.num_total_features
                and self.num_groups == other.num_groups
                and all(a.num_total_bin == b.num_total_bin
                        for a, b in zip(self.groups, other.groups)))

    # -- row subsets and the binary file ----------------------------------
    def host_binned(self) -> np.ndarray:
        """The (N, G) uint8 codes as a host numpy array."""
        b = self.binned
        if isinstance(b, torch.Tensor):
            return b.cpu().numpy()
        return np.asarray(b)

    def copy_subset(self, indices) -> "BinnedDataset":
        """A set of the rows ``indices`` with this set's mappers and groups
        (reference ``Dataset::CopySubset``; ``lightgbm_tpu/data/
        dataset.py::copy_subset``).  Codes stay where they lie."""
        indices = np.asarray(indices, np.int64)
        sub = BinnedDataset()
        sub.num_data = len(indices)
        sub.num_total_features = self.num_total_features
        for name in ("bin_mappers", "groups", "used_features", "f_group",
                     "f_offset", "f_num_bin", "f_default_bin",
                     "f_missing_type", "f_is_categorical",
                     "monotone_constraints", "feature_penalty",
                     "feature_names"):
            setattr(sub, name, getattr(self, name))
        if isinstance(self.binned, torch.Tensor):
            sub.binned = self.binned[torch.from_numpy(indices).to(
                self.binned.device)]
            sub.device_binned = True
        else:
            sub.binned = np.ascontiguousarray(self.binned[indices])
        md = Metadata(sub.num_data)
        old = self.metadata
        if old is not None:
            if old.label is not None:
                md.label = old.label[indices]
            if old.weights is not None:
                md.weights = old.weights[indices]
            if old.init_score is not None:
                ns = len(old.init_score) // max(old.num_data, 1)
                md.init_score = (old.init_score.reshape(ns, -1)[:, indices]
                                 .reshape(-1) if ns > 1
                                 else old.init_score[indices])
        sub.metadata = md
        return sub

    def save_binary(self, path: str) -> None:
        """Write the set to ``path`` in the JAX package's binary format
        (reference ``SaveBinaryFile``): host numpy arrays only, never
        tensors."""
        md = self.metadata
        state = {
            "num_data": self.num_data,
            "num_total_features": self.num_total_features,
            "feature_names": self.feature_names,
            "used_features": self.used_features,
            "mappers": [m.to_state() if m else None
                        for m in self.bin_mappers],
            "groups": [g.feature_indices for g in self.groups],
            "binned": self.host_binned(),
            "label": None if md is None else md.label,
            "weights": None if md is None else md.weights,
            "query_boundaries": None if md is None else md.query_boundaries,
            "init_score": None if md is None else md.init_score,
            "monotone": np.asarray(self.monotone_constraints),
            "penalty": np.asarray(self.feature_penalty),
        }
        with open(path, "wb") as fh:
            fh.write(BINARY_MAGIC)
            pickle.dump(state, fh, protocol=4)
        log_info(f"Saved binary dataset to {path}")

    @classmethod
    def is_binary_file(cls, path: str) -> bool:
        try:
            with open(path, "rb") as fh:
                return fh.read(len(BINARY_MAGIC)) == BINARY_MAGIC
        except OSError:
            return False

    @classmethod
    def load_binary(cls, path: str) -> "BinnedDataset":
        """Read a file :meth:`save_binary` (or the JAX package) wrote."""
        with open(path, "rb") as fh:
            if fh.read(len(BINARY_MAGIC)) != BINARY_MAGIC:
                raise LightGBMError(
                    f"{path} is not a lightgbm_tpu binary dataset")
            state = pickle.load(fh)
        ds = cls()
        ds.num_data = int(state["num_data"])
        ds.num_total_features = int(state["num_total_features"])
        ds.feature_names = list(state["feature_names"])
        ds.used_features = list(state["used_features"])
        ds.bin_mappers = [BinMapper.from_state(s) if s else None
                          for s in state["mappers"]]
        ds.groups = [FeatureGroupInfo(g, [ds.bin_mappers[f] for f in g])
                     for g in state["groups"]]
        ds.binned = np.asarray(state["binned"])
        md = ds.metadata = Metadata(ds.num_data)
        md.label = state["label"]
        md.weights = state["weights"]
        md.query_boundaries = state["query_boundaries"]
        md.init_score = state["init_score"]
        md._update_query_weights()
        ds._build_feature_lookups(None)
        ds.monotone_constraints = np.asarray(state["monotone"], np.int32)
        ds.feature_penalty = np.asarray(state["penalty"], np.float64)
        return ds
