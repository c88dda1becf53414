"""Packed-forest prediction and hot-swap serving on the card.

``packed``: flatten a tree slice into padded tensors and route any batch
through the whole ensemble in one launch of ``csrc/forest_predict.cu``.
``engine``: the thread-safe :class:`~.engine.PredictionServer` (atomic
``swap``, micro-batching, warm-up).  ``fleet``: M tenants stacked on a
model axis, served by the same kernel with per-row tenant ids, and the
:class:`~.fleet.FleetServer` over them.
"""

from .engine import PredictionServer, warmup_bucket_ladder
from .fleet import (FleetServer, PackedFleet, TenantHandle,
                    fleet_predict_leaves, fleet_predict_scores, pack_fleet,
                    stack_packs, write_tenant)
from .packed import (PackedEnsemble, forest_predict, pack_ensemble, pack_gbdt,
                     predict_leaves, predict_scores)

__all__ = ["PredictionServer", "FleetServer", "TenantHandle",
           "warmup_bucket_ladder", "PackedEnsemble", "forest_predict",
           "pack_ensemble", "pack_gbdt", "predict_leaves", "predict_scores",
           "PackedFleet", "pack_fleet", "stack_packs", "write_tenant",
           "fleet_predict_scores", "fleet_predict_leaves"]
