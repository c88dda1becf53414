"""Multi-tenant model fleet: M packed ensembles stacked on a model axis.

Counterpart of the data plane of ``lightgbm_tpu/serve/fleet.py``
(``PackedFleet``, ``stack_packs``, ``pack_fleet``, ``_fleet_write``,
``fleet_predict_scores`` / ``fleet_predict_leaves``).  M same-family
boosters become one ``(M, T, N)`` tensor family, and one launch of the
packed-forest kernel (``serve/packed.forest_predict``) serves any batch of
``(tenant id, row)`` pairs: each row routes exactly as its tenant's solo
pack would, because both go through the same kernel.  A tenant swap is an
index copy into the model axis (:func:`write_tenant`).  The opt-in
``value_dtype="bf16"`` variant halves the leaf table; routing stays exact,
only the leaf values quantize.

``FleetServer`` and ``TenantHandle`` (replicas, per-replica circuit
breakers and the host fallback) are not ported yet.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.log import LightGBMError
from .engine import _as_gbdt
from .packed import (ARRAY_FIELDS, ForestRecords, ForestTables,
                     PackedEnsemble, forest_predict, forest_records,
                     pack_ensemble, query_tensor)

__all__ = ["PackedFleet", "stack_packs", "pack_fleet", "write_tenant",
           "fleet_predict_scores", "fleet_predict_leaves"]

#: accepted ``value_dtype`` spellings -> torch dtype of the leaf table
_VALUE_DTYPES = {"f32": torch.float32, "float32": torch.float32,
                 "bf16": torch.bfloat16, "bfloat16": torch.bfloat16}


def _value_dtype(name: str):
    try:
        return _VALUE_DTYPES[str(name).lower()]
    except KeyError:
        raise LightGBMError(
            f"unknown fleet value_dtype {name!r}; expected one of "
            f"{sorted(set(_VALUE_DTYPES))}") from None


@dataclasses.dataclass(frozen=True)
class PackedFleet:
    """M stacked :class:`~.packed.PackedEnsemble` tenants: every tensor is
    the solo layout with a leading model axis.  Tenants whose solo pads
    are smaller than the fleet's are padded up (padding trees are stumps
    with leaf value 0, padded nodes are unreachable), which leaves each
    tenant's results unchanged."""

    split_feature: torch.Tensor
    threshold_hi: torch.Tensor
    threshold_lo: torch.Tensor
    decision_type: torch.Tensor
    left_child: torch.Tensor
    right_child: torch.Tensor
    cat_start: torch.Tensor
    cat_len: torch.Tensor
    cat_words: torch.Tensor
    leaf_value: torch.Tensor
    is_stump: torch.Tensor
    num_tenants: int = 1
    num_model: int = 1
    max_depth: int = 0
    num_features: int = 1
    value_dtype: str = "f32"

    @property
    def device(self) -> torch.device:
        return self.split_feature.device

    @property
    def tree_pad(self) -> int:
        return int(self.split_feature.shape[1])

    @property
    def node_pad(self) -> int:
        return int(self.split_feature.shape[2])

    @property
    def word_pad(self) -> int:
        return int(self.cat_words.shape[1])

    def shape_signature(self) -> tuple:
        return (tuple(self.split_feature.shape),
                tuple(self.leaf_value.shape), tuple(self.cat_words.shape),
                self.num_model, self.max_depth, self.num_features,
                self.value_dtype)

    def fits(self, pe: PackedEnsemble) -> bool:
        """Can ``pe`` be written into this fleet without growing a pad?"""
        return (pe.split_feature.shape[0] <= self.tree_pad
                and pe.split_feature.shape[1] <= self.node_pad
                and pe.cat_words.shape[0] <= self.word_pad
                and pe.max_depth <= self.max_depth
                and pe.num_model == self.num_model
                and pe.num_features == self.num_features)

    def tables(self) -> ForestTables:
        return ForestTables(*(getattr(self, f) for f in ARRAY_FIELDS))

    @functools.cached_property
    def records(self) -> ForestRecords:
        """The kernel's node records of every tenant (built on first use,
        rewritten tenant by tenant by :func:`write_tenant`)."""
        return forest_records(self.tables())


def _bits(a: torch.Tensor) -> torch.Tensor:
    """uint32 tensors as their int32 bits (a view), others as they are."""
    return a.view(torch.int32) if a.dtype == torch.uint32 else a


def _padded_tenant_arrays(pe: PackedEnsemble, t_pad: int, n_pad: int,
                          w_pad: int, leaf_dtype) -> Tuple:
    """The solo pack's tensors padded up to the fleet pads, in
    ``ARRAY_FIELDS`` order, without the model axis; the words as their
    int32 bits."""
    dt = int(t_pad) - int(pe.split_feature.shape[0])
    dn = int(n_pad) - int(pe.split_feature.shape[1])
    dw = int(w_pad) - int(pe.cat_words.shape[0])
    if min(dt, dn, dw) < 0:
        raise LightGBMError("packed ensemble exceeds the fleet pads")
    pad = torch.nn.functional.pad

    def pad2(a, fill=0):
        return pad(a, (0, dn, 0, dt), value=fill)

    # uint32 and bool lack pad kernels on some backends: pad their bits
    words = pad(_bits(pe.cat_words), (0, dw))
    stump = pad(pe.is_stump.to(torch.uint8), (0, dt), value=1).bool()
    return (
        pad2(pe.split_feature), pad2(pe.threshold_hi),
        pad2(pe.threshold_lo), pad2(pe.decision_type),
        pad2(pe.left_child, -1), pad2(pe.right_child, -1),
        pad2(pe.cat_start), pad2(pe.cat_len), words,
        pad2(pe.leaf_value).to(leaf_dtype), stump,
    )


def stack_packs(packs: Sequence[PackedEnsemble],
                value_dtype: str = "f32") -> PackedFleet:
    """Stack solo packs (equal ``num_model`` and ``num_features``, one
    device) into one :class:`PackedFleet`, every tenant padded to the
    fleet-wide max of each pad."""
    if not packs:
        raise LightGBMError("stack_packs needs at least one tenant")
    k = packs[0].num_model
    nf = packs[0].num_features
    for i, pe in enumerate(packs):
        if pe.num_model != k or pe.num_features != nf:
            raise LightGBMError(
                f"tenant {i} has num_model={pe.num_model}/num_features="
                f"{pe.num_features}; the fleet requires ({k}, {nf}): "
                f"pack every tenant with the same num_features")
    t_pad = max(int(pe.split_feature.shape[0]) for pe in packs)
    n_pad = max(int(pe.split_feature.shape[1]) for pe in packs)
    w_pad = max(int(pe.cat_words.shape[0]) for pe in packs)
    depth = max(int(pe.max_depth) for pe in packs)
    dtype = _value_dtype(value_dtype)
    cols = [torch.stack(col) for col in zip(*[
        _padded_tenant_arrays(pe, t_pad, n_pad, w_pad, dtype)
        for pe in packs])]
    i = ARRAY_FIELDS.index("cat_words")
    cols[i] = cols[i].view(torch.uint32)
    return PackedFleet(*cols, num_tenants=len(packs), num_model=k,
                       max_depth=depth, num_features=nf,
                       value_dtype=str(value_dtype).lower())


def pack_fleet(boosters: Sequence, num_features: Optional[int] = None,
               start_iteration: int = 0, num_iteration: int = -1,
               value_dtype: str = "f32", device="cuda"
               ) -> Tuple[PackedFleet, List[PackedEnsemble]]:
    """Pack M boosters (``Booster``, ``GBDT`` or model-file path each) into
    a fleet on ``device``.  ``num_features`` defaults to the max over the
    tenants.  Returns the fleet and the per-tenant solo packs."""
    gbdts = [_as_gbdt(b) for b in boosters]
    for g in gbdts:
        g._flush_pending()
    nf = int(num_features) if num_features else \
        max(g.max_feature_idx + 1 for g in gbdts)
    # a fleet seeded from one booster passes it M times: pack it once
    packed_by_id = {}
    packs = []
    for g in gbdts:
        pe = packed_by_id.get(id(g))
        if pe is None:
            pe = pack_ensemble(g.models, g.num_model,
                               start_iteration=start_iteration,
                               num_iteration=num_iteration,
                               num_features=nf, device=device)
            packed_by_id[id(g)] = pe
        packs.append(pe)
    return stack_packs(packs, value_dtype), packs


def _fleet_write(fl: PackedFleet, row: PackedFleet, idx: int) -> PackedFleet:
    """Index-copy one tenant (``row``: a one-tenant fleet at ``fl``'s
    pads) into ``fl``'s model axis at ``idx``, in place; returns ``fl``.
    On the card the copies are ordered on the current stream with the
    launches around them.  Node records already built are rewritten for
    the tenant the same way."""
    for f in ARRAY_FIELDS:
        _bits(getattr(fl, f))[idx].copy_(_bits(getattr(row, f))[0])
    if "records" in fl.__dict__:
        for f in ("blob", "cat", "live"):
            getattr(fl.records, f)[idx].copy_(getattr(row.records, f)[0])
    return fl


def write_tenant(fl: PackedFleet, idx: int, pe: PackedEnsemble
                 ) -> PackedFleet:
    """Swap tenant ``idx`` of ``fl`` for the pack ``pe`` by an index copy
    (in place).  ``pe`` must fit the fleet's pads (:meth:`PackedFleet.fits`);
    a pack that does not is re-stacked with :func:`stack_packs`."""
    m = int(idx)
    if not 0 <= m < fl.num_tenants:
        raise LightGBMError(
            f"tenant_id {m} out of range [0, {fl.num_tenants})")
    if not fl.fits(pe):
        raise LightGBMError(
            f"tenant pack {pe.shape_signature()} does not fit the fleet's "
            f"pads {fl.shape_signature()}; re-stack with stack_packs")
    row = PackedFleet(
        *(a.to(fl.device)[None] for a in _padded_tenant_arrays(
            pe, fl.tree_pad, fl.node_pad, fl.word_pad,
            _value_dtype(fl.value_dtype))),
        num_tenants=1, num_model=fl.num_model, max_depth=fl.max_depth,
        num_features=fl.num_features, value_dtype=fl.value_dtype)
    return _fleet_write(fl, row, m)


def _tenant_tensor(fl: PackedFleet, tenant_ids, rows: int) -> torch.Tensor:
    """The (rows,) int32 tenant ids on the fleet's device (a scalar
    broadcasts), checked to lie in [0, M): the kernel reads the tables
    at them unchecked."""
    tid = np.asarray(tenant_ids, np.int32)
    if tid.ndim == 0:
        tid = np.full(rows, int(tid), np.int32)
    if tid.shape != (rows,):
        raise LightGBMError(
            f"tenant_ids shape {tid.shape} does not match {rows} rows")
    if rows and (tid.min() < 0 or tid.max() >= fl.num_tenants):
        raise LightGBMError(
            f"tenant_ids must be in [0, {fl.num_tenants}); got "
            f"[{tid.min()}, {tid.max()}]")
    return torch.from_numpy(tid).to(fl.device)


def fleet_predict_scores(fl: PackedFleet, tenant_ids, data) -> np.ndarray:
    """Raw scores (num_model, rows) float64 for a mixed-tenant batch: one
    kernel launch however many tenants the batch touches."""
    n = int(data.shape[0])
    if n == 0:
        return np.zeros((fl.num_model, 0), np.float64)
    tid = _tenant_tensor(fl, tenant_ids, n)
    x = query_tensor(data, fl.num_features, fl.device)
    out = forest_predict(fl.tables(), x, tid, num_model=fl.num_model,
                         max_depth=fl.max_depth, records=fl.records)
    return out.cpu().numpy().astype(np.float64)


def fleet_predict_leaves(fl: PackedFleet, tenant_ids, data) -> np.ndarray:
    """Leaf index (rows, tree_pad) int32 for a mixed-tenant batch; columns
    past a tenant's real tree count are padding."""
    n = int(data.shape[0])
    if n == 0:
        return np.zeros((0, fl.tree_pad), np.int32)
    tid = _tenant_tensor(fl, tenant_ids, n)
    x = query_tensor(data, fl.num_features, fl.device)
    return forest_predict(fl.tables(), x, tid, num_model=fl.num_model,
                          max_depth=fl.max_depth, leaves=True,
                          records=fl.records).cpu().numpy()
