"""Leaf-wise tree growth on the device, in synchronized waves.

Counterpart of ``lightgbm_tpu/ops/grow.py`` (``GrowerPrograms._grow_impl``
and ``DeviceGrower``), unsharded or row-sharded over a mesh of devices
(``ops/shard.py``: kernel 1 once a shard a wave, the shards' fixed-point
sums reduced before one conversion; over a pod of processes, each holding
its block of the rows, the sums all-reduced across them), with bf16 stat
columns or, under ``grad_quant_bits`` (any nonzero value, as in the JAX
package), int8 quantized ones, with the per-tree bagging row
mask and feature_fraction mask, and with categorical splits.  The stat
columns take the JAX package's layouts (``_hist_layout``): K=3 ``[g, h,
1]``; from :data:`COUNT_SPLIT_ROWS` rows the striped K=4 (two count
columns, rows split at half the grower's rows) or, under int8, K=6 (g, h
and count each striped); under ``gpu_use_dp`` K=5 (hi/lo bf16 g and h)
or K=6 (and striped counts).  The wave width scales with 3/K.  The
formulation is the JAX package's:

* a per-row ``leaf_id`` vector stands in for a row permutation; a wave's
  splits rewrite it in place in one pass over the ``(G, N)`` binned matrix
  (``ops/routing.split_rows``: on the card one launch of a hand-written
  kernel);
* each *wave* builds, in one pass over all rows, the histograms of up to W
  pending leaves (the smaller child of each new split) with the
  hand-written kernel (``ops/hist_cuda.wave_hist``); the larger sibling is
  the parent minus the smaller one;
* every new leaf's best split comes from one batched scan
  (``ops/split.find_best_split``), and the wave applies up to W of
  the best-gain splits at once, within the ``num_leaves`` budget;
* wave widths follow a stage plan (``ops/stage_plan.py``): the legacy
  doubling plan, or one derived from kernel 1's times at each candidate
  width on the grower's own codes (:meth:`DeviceGrower.profile_stage_plan`,
  ``wave_plan=profiled``, or ``auto`` on first use at scale with a plan
  store), kept in the process and beside the compile cache;
* a categorical split sends a row left iff the bit of its decoded bin is
  set in the winner's bin set, kept per leaf as a (256,) membership row
  (``bestc``) and recorded as eight int32 words (``rec_c``).  Every
  categorical step is gated on ``has_cat`` (a dataset with a categorical
  feature), so other models run exactly the ops they ran before.

Under ``grad_quant_bits=8`` the histograms, leaf totals and the split
scan stay int32 in quantized units (``ops/split.find_best_split`` with
``scales``), so the parent-minus-sibling subtraction and every count are
exact; after
growth each leaf's value is refit from the full-precision gradients with
an exact base-128 digit sum and written back into the split record that
created the leaf.  Past :data:`INT32_SCAN_ROWS` rows (where an int32 sum
of |q| <= 127 could wrap) the quantized histograms are dequantized once
to f32 (the stripes cast to f32 before they are summed), the scan runs
in f32 and the refit sums hi/lo bf16 columns exactly in int64 fixed
point.

The JAX package runs the wave loop inside ``lax.while_loop``s, one per
stage, with no host sync.  Here a tree is cut into pieces that work in
place on tensors allocated once per grower (``_ensure_state``): a clock
piece (the tree's first device-clock stamp, ``ops/clock.py``), a sample
piece (fused trees: gradients, the bagging redraw, the feature mask), a
start piece (stat columns, a fresh root), one wave piece per stage width
and a finish piece (refit, score update, the records into a chunk slot).
The start and finish pieces, the sample piece's gradient and each wave's
kernel-1 call stamp the tree's device clock too, into the chunk slot's
row beside its records.
The leaf count, the done flag, the wave count and the chunk slot live in
device control words (``ctl``), so no piece reads anything back.  On the
card the pieces are captured once as CUDA graphs and composed into one
graph a tree, each stage's wave the body of a WHILE node that loops while
``not done and nl < limit`` (``ops/graphs.py``, ``csrc/graph_loop.cu``);
on the CPU the same pieces run in a Python loop that reads the control
words.  A wave that selects nothing is an exact no-op on the tree.

With ``grower_cache`` (on by default, as in the JAX package) a grower
outlives its booster: :func:`acquire_grower` hands a new booster an idle
grower of equal key (:func:`grower_key`: rows, groups, slot pitch,
features, categorical, the layout bounds, the config but its seeds and
learning rate, the gradient function's shapes, the device, the shard
mesh, the stage plan's digest), which
takes the booster's codes, feature metadata, gradient arguments and seeds
into its static buffers (:meth:`DeviceGrower.adopt`) and replays its
captured graphs without a new capture.

Every per-leaf tensor has one junk row (index L; records: index L-1) that
absorbs the scatters of empty lanes, so a scatter never writes a live leaf
twice.  CUDA ``index_put_`` writes duplicate indices in no fixed order;
only the junk row ever receives duplicates, and nothing reads it as a
result.
"""

from __future__ import annotations

import functools
import hashlib
import threading
import time
import types
import weakref
from collections import OrderedDict
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import obs
from ..obs import capture_track
from ..utils import random as trandom
from ..utils.log import LightGBMError, log_info
from . import clock
from .bagging import bag_mask
from .hist_cuda import (MAX_LEAF_BOUND, hist_scale_exponents, wave_hist,
                        wave_hist_sharded)
from .histogram import QUANT_MAX, bucket_size, quantize_gh_keys, slot_pitch
from .routing import feature_table, split_rows
from .split import (F_DEFAULT_LEFT, F_FEATURE, F_GAIN, F_LEFT_C, F_LEFT_G,
                    F_LEFT_H, F_LEFT_OUT, F_RIGHT_C, F_RIGHT_G, F_RIGHT_H,
                    F_IS_CAT, F_RIGHT_OUT, F_THRESHOLD, NEG_INF,
                    FeatureMeta, SplitHyper, find_best_split)
from . import stage_plan as stage_plan_mod
from .shard import PodMesh, canonical, process_row_span, shard_spec
from .stage_plan import legacy_stage_plan

REC_I_FIELDS = 5    # leaf, right, feature, threshold, default_left
REC_F_FIELDS = 9    # gain, lg, lh, lc, rg, rh, rc, left_out, right_out
REC_F_LEFT_OUT, REC_F_RIGHT_OUT = 7, 8
REC_C_WORDS = 8     # a categorical split's 256-bin set as int32 words
#: at or above this many grower rows the stat columns are striped: two
#: count columns (under int8 two g and two h columns too), each summing
#: fewer than 2^24 rows.  The device grower takes up to twice this many
#: real rows; past that the host learner trains.  Module-level so tests
#: can force the striped layouts on small data (as the JAX package's
#: tests set its own).
COUNT_SPLIT_ROWS = 1 << 24
#: the int32 scan of grad_quant_bits=8 is exact up to this many padded
#: rows (|sum q| <= 127 * rows); past it the histograms are dequantized to
#: f32 before the scan.  Module-level for the tests, like the JAX
#: package's.
INT32_SCAN_ROWS = ((1 << 31) - 1) // 127
#: key words of a tree in the key table: feature_fraction (2), int8 noise
#: g and h (2 + 2), bagging (2)
KEY_WORDS = 8


class GrowResult(NamedTuple):
    score: torch.Tensor       # (num_data,) f32 score after this tree
    rec_i: torch.Tensor       # (L-1, 5) int32 split records
    rec_f: torch.Tensor       # (L-1, 9) f32 split records
    rec_c: torch.Tensor       # (L-1, 8) int32 categorical bin sets
    num_leaves: torch.Tensor  # () int32, on the device
    root_value: torch.Tensor  # () f32 root leaf output
    waves: torch.Tensor       # () int32 waves run, on the device
    clock: torch.Tensor       # (6,) int64 device clock (ops/clock.py)


class FusedResult(NamedTuple):
    """Device views of a fused chunk's outputs, K trees."""
    score: torch.Tensor       # (num_data,) f32 score after the chunk
    rec_i: torch.Tensor       # (K, L-1, 5) int32
    rec_f: torch.Tensor       # (K, L-1, 9) f32
    rec_c: torch.Tensor       # (K, L-1, 8) int32
    nl: torch.Tensor          # (K,) int32 leaves
    waves: torch.Tensor       # (K,) int32 waves
    qscales: torch.Tensor     # (K, 2) f32 int8 scales (ones without)
    clock: torch.Tensor       # (K, 6) int64 device clocks (ops/clock.py)


def _wave_width(num_leaves: int, hist_cols: int) -> int:
    scale = 3.0 / hist_cols
    wmax = max(int(128 * scale), 4)
    return min(wmax, max(int(num_leaves) - 1, 1))


def _hist_layout(num_rows: int, config):
    """(quant_bits, striped, hist_cols) for the grower's row count and the
    config (``lightgbm_tpu/ops/grow.py::_hist_layout``): int8 K=3, or 6
    striped; gpu_use_dp K=5, or 6 with striped counts; bf16 K=3, or 4
    with striped counts."""
    dp = bool(getattr(config, "gpu_use_dp", False))
    quant_bits = int(getattr(config, "grad_quant_bits", 0) or 0)
    striped = int(num_rows) >= COUNT_SPLIT_ROWS
    if quant_bits:
        hist_cols = 6 if striped else 3
    elif dp:
        hist_cols = 6 if striped else 5
    else:
        hist_cols = 4 if striped else 3
    return quant_bits, striped, hist_cols


def grower_rows(num_data: int, config):
    """(layout rows, n_pad): the row count the JAX grower keys its layout
    on and the port's row pad.  Rows are padded to a power-of-two bucket
    (one set of buffer shapes, and of captured graphs, per bucket) unless
    ``train_row_bucketing`` is off or the bucket would reach twice
    :data:`COUNT_SPLIT_ROWS`, where exact rows are used, as the JAX grower
    does (``lightgbm_tpu/ops/grow.py:1494-1510``).  The JAX grower never
    buckets under int8 and the port does (element i of a draw does not
    depend on the draw's length), so its layout follows the real rows
    there."""
    n = int(num_data)
    quant = bool(int(getattr(config, "grad_quant_bits", 0) or 0))
    n_pad = n
    if config.train_row_bucketing:
        bucket = bucket_size(max(n, 1))
        if bucket >= 2 * COUNT_SPLIT_ROWS:
            log_info(f"train_row_bucketing: row bucket {bucket} would "
                     f"reach the striped-count bound "
                     f"({2 * COUNT_SPLIT_ROWS}); using exact rows ({n}): "
                     f"graphs are per row count at this scale")
        else:
            n_pad = bucket
    return (n if quant else n_pad), n_pad


def _combine_hist_cols(h, k: int):
    """The K accumulated stat columns (last axis) as [g, h, count]
    (``lightgbm_tpu/ops/grow.py::_combine_hist_cols``): K=4 sums the
    count stripes, K=5 the hi/lo pairs of g and h, K=6 every pair; f32 or
    int32 (exact below :data:`INT32_SCAN_ROWS`)."""
    if k == 4:
        return torch.stack([h[..., 0], h[..., 1], h[..., 2] + h[..., 3]],
                           dim=-1)
    if k == 5:
        return torch.stack([h[..., 0] + h[..., 1], h[..., 2] + h[..., 3],
                            h[..., 4]], dim=-1)
    if k == 6:
        return torch.stack([h[..., 0] + h[..., 1], h[..., 2] + h[..., 3],
                            h[..., 4] + h[..., 5]], dim=-1)
    return h


def _hi_lo_cols(grad, hess, one):
    """[g_hi, g_lo, h_hi, h_lo] bf16 columns masked by ``one`` (bf16): each
    lo column carries the bf16 rounding residual of its hi column
    (``lightgbm_tpu/ops/grow.py::_hi_lo_cols``)."""
    ghi, hhi = grad.to(torch.bfloat16), hess.to(torch.bfloat16)
    glo = (grad - ghi.float()).to(torch.bfloat16)
    hlo = (hess - hhi.float()).to(torch.bfloat16)
    return [ghi * one, glo * one, hhi * one, hlo * one]


def _grower_refusal(config, dataset):
    """What of the data and the config the device grower does not take,
    or None."""
    if np.asarray(dataset.monotone_constraints).any():
        return "monotone constraints"
    if getattr(config, "forcedsplits_filename", ""):
        return "forced splits"
    if int(dataset.num_data) >= 2 * COUNT_SPLIT_ROWS:
        return (f"{int(dataset.num_data)} rows >= 2 * COUNT_SPLIT_ROWS "
                f"({2 * COUNT_SPLIT_ROWS})")
    return None


def host_learner_reason(config, dataset, objective):
    """Why the device grower does not cover this training configuration,
    or None when it does (``lightgbm_tpu/ops/grow.py::
    device_growth_eligible``); the host learner (``tree/learner.py``)
    trains the rest."""
    if dataset.num_groups == 0 or dataset.num_features == 0:
        return "no usable features"
    if objective is None:
        return "custom objective (objective=none, fobj)"
    if objective.is_renew_tree_output:
        return f"objective={objective.name} renews its leaf outputs"
    return _grower_refusal(config, dataset)


def feature_fraction_mask(seed: int, tree_idx: int, nf: int, k: int,
                          device=None) -> torch.Tensor:
    """(nf,) bool mask of ``k`` features drawn without replacement: the
    ``k`` smallest of ``nf`` uniforms under ``fold_in(PRNGKey(seed),
    tree_idx)`` (``lightgbm_tpu/ops/grow.py::feature_fraction_mask``)."""
    key = trandom.fold_in(trandom.PRNGKey(seed), tree_idx)
    return feature_mask_from_key(key, nf, k, device)


def feature_mask_from_key(key, nf: int, k: int,
                          device=None) -> torch.Tensor:
    """:func:`feature_fraction_mask` under ``key`` (a host pair or a
    ``(2,)`` int64 tensor, as a captured graph reads it)."""
    u = trandom.uniform(key, (nf,), device=device)
    thr = torch.sort(u).values[k - 1]
    return u <= thr


#: the host learner's int32 row indices and the kernel's row lists hold
#: fewer rows than this
MAX_ROWS = 1 << 31


def check_slice_config(config, dataset) -> None:
    """Refuse, by name, the options whose code paths the port does not
    have yet, whichever learner would train them: more leaves than the
    histogram kernel's leaf table holds, and more rows than a row index
    holds."""
    todo = []
    if int(config.num_leaves) > MAX_LEAF_BOUND:
        todo.append(f"num_leaves > {MAX_LEAF_BOUND}")
    if int(dataset.num_data) >= MAX_ROWS:
        todo.append(f"{int(dataset.num_data)} rows (int32 row indices)")
    if todo:
        raise LightGBMError("not ported to lightgbm_tpu_torch yet: "
                            + ", ".join(todo))


#: idle growers kept for later boosters, at most this many (LRU; the JAX
#: package's ``_PROGRAM_CACHE_MAX``)
GROWER_CACHE_MAX = 8
# id(grower) -> [key, grower, weakref to its booster or None when idle]
_GROWER_CACHE: "OrderedDict[int, list]" = OrderedDict()
_GROWER_CACHE_LOCK = threading.Lock()
#: cache hits and misses of this process (always counted, under
#: :data:`_GROWER_CACHE_LOCK`; with telemetry on also ``grow.cache_hits`` /
#: ``grow.cache_misses``)
GROWER_CACHE_COUNTS = {"hits": 0, "misses": 0}
#: the seeds: a grower takes its booster's (:meth:`DeviceGrower.adopt`;
#: the binning's and DART's are the booster's)
SEED_PARAMS = frozenset({"seed", "bagging_seed", "feature_fraction_seed",
                         "data_random_seed", "drop_seed"})
#: parameters no capture reads: the seeds, the learning rate (a buffer
#: written every launch) and the caching and logging knobs
_NON_CAPTURE_PARAMS = SEED_PARAMS | {
    "learning_rate", "grower_cache", "compile_cache_dir", "verbosity",
    "num_iterations"}
#: the parameters ``Booster.reset_parameter`` may change on a booster that
#: trains on the device grower: what no capture reads but the seeds a
#: grower copied.  A change of any other parameter is refused by name
#: (:func:`reset_refusals`)
RESET_ON_DEVICE = _NON_CAPTURE_PARAMS - SEED_PARAMS


def reset_refusals(old, new) -> list:
    """The parameters whose values differ between configs ``old`` and
    ``new`` that a device grower holds: those of its key's config digest
    and the seeds it copied.  The captured tree keeps what it was built
    with, and the JAX device grower silently keeps the old value of every
    such parameter (ROADMAP §3), so the port refuses the reset instead;
    a grower's key then never goes stale."""
    a, b = old.to_dict(), new.to_dict()
    return sorted(k for k in b
                  if k not in RESET_ON_DEVICE and a.get(k) != b[k])


def _config_digest(config, exclude=_NON_CAPTURE_PARAMS) -> str:
    """sha1 of the config's sorted (name, repr(value)) items but
    ``exclude``."""
    items = sorted((k, repr(v)) for k, v in config.to_dict().items()
                   if k not in exclude)
    return hashlib.sha1(repr(items).encode()).hexdigest()


def _args_signature(a):
    """The shapes a captured gradient reads: tensors by shape and dtype,
    scalars by value, sequences element by element."""
    if isinstance(a, torch.Tensor):
        return ("tensor", tuple(a.shape), str(a.dtype))
    if isinstance(a, (tuple, list)):
        return tuple(_args_signature(x) for x in a)
    return repr(a)


def _copy_args(dst, src) -> None:
    """Copy the tensors of ``src`` into those of ``dst`` (equal
    signatures), in place."""
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
    elif isinstance(dst, (tuple, list)):
        for d, s in zip(dst, src):
            _copy_args(d, s)


#: stage-plan profiles, and plans adopted from the store, of this process
#: (always counted, under :data:`_PLAN_COUNTS_LOCK`; with telemetry on also
#: ``grow.plan_profiles`` / ``grow.plan_persisted_loads``)
PLAN_COUNTS = {"profiles": 0, "persisted_loads": 0}
_PLAN_COUNTS_LOCK = threading.Lock()
#: timed launches of kernel 1 at each width of a stage profile, after one
#: warm launch (:meth:`DeviceGrower.profile_stage_plan`)
PROBE_REPS = 5
#: what a stage plan's signature leaves out of the config: what no capture
#: reads, and the plan choice itself (a plan profiled under
#: ``wave_plan=profiled`` serves ``auto`` too, as in the JAX package)
_NON_PLAN_PARAMS = _NON_CAPTURE_PARAMS | {"wave_plan"}


def plan_signature(dataset, config, device) -> tuple:
    """What a stage plan is measured for: the device type, the grower's
    padded rows, groups, slot pitch, features, categorical flag, the
    layout bounds and the config digest (the JAX package's
    ``programs_signature``; its plans are a TPU's, so none is shared)."""
    _, n_pad = grower_rows(dataset.num_data, config)
    return (torch.device(device).type, int(n_pad), int(dataset.num_groups),
            int(slot_pitch(dataset)), len(dataset.used_features),
            bool(np.asarray(dataset.f_is_categorical).any()),
            COUNT_SPLIT_ROWS, INT32_SCAN_ROWS,
            _config_digest(config, _NON_PLAN_PARAMS))


def grower_key(dataset, config, device, objective,
               plan_digest: str = "", mesh=None) -> tuple:
    """What shapes a grower's captures: its :func:`plan_signature` with
    the device itself and the row count, which sizes the port's buffers,
    the gradient function the fused tree captures, the digest of the
    stage plan its waves follow (two boosters of equal config, one built
    before a plan was installed and one after, never share a grower) and
    the shard mesh (an unsharded booster never adopts a sharded grower)."""
    grad = None if objective is None else objective.device_grad()
    gsig = None if grad is None else (
        f"{grad[0].__module__}.{grad[0].__qualname__}",
        _args_signature(grad[1]))
    if isinstance(mesh, PodMesh):
        shards = mesh.key()
    else:
        shards = None if mesh is None or len(mesh) < 2 else \
            tuple(str(torch.device(d)) for d in mesh)
    return ((str(device), int(dataset.num_data))
            + plan_signature(dataset, config, device)[1:]
            + (gsig, shards, plan_digest))


def default_stage_plan(num_data: int, config) -> list:
    """The legacy doubling plan of a grower of ``num_data`` rows."""
    layout_rows, _ = grower_rows(num_data, config)
    _, _, hist_cols = _hist_layout(layout_rows, config)
    num_leaves = int(config.num_leaves)
    return legacy_stage_plan(num_leaves, _wave_width(num_leaves, hist_cols),
                             hist_cols)


def resolve_stage_plan(signature: tuple, config, num_data: int):
    """(plan, source) a new grower starts with
    (``lightgbm_tpu/ops/grow.py::get_grower_programs``): under
    ``wave_plan`` auto or profiled, a plan profiled for ``signature`` in
    this process ("profiled") or read from the store ``config`` names
    ("persisted"); else the legacy plan ("default")."""
    if str(config.wave_plan).lower() in ("auto", "profiled"):
        cached = stage_plan_mod.cached_plan(signature)
        if cached is not None:
            return cached, "profiled"
        persisted = stage_plan_mod.load_plan(
            signature, stage_plan_mod.store_dir(config))
        if persisted is not None:
            stage_plan_mod.cache_plan(signature, persisted)
            with _PLAN_COUNTS_LOCK:
                PLAN_COUNTS["persisted_loads"] += 1
            obs.inc("grow.plan_persisted_loads")
            return persisted, "persisted"
    return default_stage_plan(num_data, config), "default"


def acquire_grower(dataset, config, device, objective, owner,
                   mesh=None) -> "DeviceGrower":
    """A grower for ``owner`` (a booster): an idle cached grower of equal
    :func:`grower_key`, adopted (:meth:`DeviceGrower.adopt`), or a new
    one, cached.  Without ``grower_cache`` always a new, uncached one.
    Either way its stage plan is :func:`resolve_stage_plan`'s; ``mesh``
    shards its rows (``ops/shard.py``)."""
    sig = plan_signature(dataset, config, device)
    plan, source = resolve_stage_plan(sig, config, dataset.num_data)
    if not bool(getattr(config, "grower_cache", True)):
        return DeviceGrower(dataset, config, device, plan=plan,
                            plan_source=source, mesh=mesh)
    key = grower_key(dataset, config, device, objective,
                     stage_plan_mod.plan_digest(plan), mesh)
    with _GROWER_CACHE_LOCK:
        hit = None
        for gid, entry in _GROWER_CACHE.items():
            if entry[0] == key and (entry[2] is None or entry[2]() is None) \
                    and not _patched(entry[1]):
                hit = entry
                _GROWER_CACHE.move_to_end(gid)
                break
        if hit is not None:
            hit[2] = weakref.ref(owner)
            GROWER_CACHE_COUNTS["hits"] += 1
        else:
            GROWER_CACHE_COUNTS["misses"] += 1
    if hit is not None:
        obs.inc("grow.cache_hits")
        hit[1].adopt(dataset, config, objective, plan_source=source)
        return hit[1]
    obs.inc("grow.cache_misses")
    grower = DeviceGrower(dataset, config, device, plan=plan,
                          plan_source=source, mesh=mesh)
    with _GROWER_CACHE_LOCK:
        _GROWER_CACHE[id(grower)] = [key, grower, weakref.ref(owner)]
        while len(_GROWER_CACHE) > GROWER_CACHE_MAX:
            _GROWER_CACHE.popitem(last=False)
    return grower


def _patched(grower) -> bool:
    """Whether a method was replaced on the grower itself (the plain-loop
    checks run a tree's pieces that way): such a grower stays its
    booster's and is never handed to another."""
    return any(callable(v) and not isinstance(v, torch.Tensor)
               for v in vars(grower).values())


def _rekey_grower(grower: "DeviceGrower") -> None:
    """Put a cached grower's new plan digest into its key (a plan was
    installed on it)."""
    digest = stage_plan_mod.plan_digest(grower.stage_plan)
    with _GROWER_CACHE_LOCK:
        entry = _GROWER_CACHE.get(id(grower))
        if entry is not None and entry[1] is grower:
            entry[0] = entry[0][:-1] + (digest,)


def release_grower(grower: "DeviceGrower") -> None:
    """Mark a cached grower idle (its booster was freed)."""
    with _GROWER_CACHE_LOCK:
        entry = _GROWER_CACHE.get(id(grower))
        if entry is not None and entry[1] is grower:
            entry[2] = None


def clear_grower_cache() -> int:
    """Drop every cached grower (their device buffers go with the last
    reference); returns how many were dropped."""
    with _GROWER_CACHE_LOCK:
        n = len(_GROWER_CACHE)
        _GROWER_CACHE.clear()
    return n


def cached_growers() -> int:
    return len(_GROWER_CACHE)


class DeviceGrower:
    """Grows one tree per call on ``device``.  Owns the ``(G, n_pad)``
    uint8 binned matrix (the transpose of the dataset's ``(N, G)`` one;
    the histogram kernel and the split application both read it per
    group) and the per-feature metadata."""

    def __init__(self, dataset, config, device: torch.device,
                 plan=None, plan_source: str = "default", mesh=None):
        check_slice_config(config, dataset)
        if dataset.num_groups == 0:
            raise LightGBMError("no usable features: every feature is "
                                "constant")
        why = _grower_refusal(config, dataset)
        if why is not None:
            raise LightGBMError(f"the device grower does not take {why}: "
                                f"the host learner trains it")
        self.config = config
        self.device = device
        self.num_data = int(dataset.num_data)
        self.num_groups = int(dataset.num_groups)
        self.num_leaves = int(config.num_leaves)
        self.nb = nb = slot_pitch(dataset)
        self.num_slots = self.num_groups * nb
        # pow2 row bucket (or exact rows, grower_rows): one set of buffer
        # shapes per bucket (the shapes a CUDA-graph capture keys on); pad
        # rows carry leaf id -1 and zero stats
        layout_rows, self.n_pad = grower_rows(self.num_data, config)
        # the fixed-point exponents' row count: the unsharded grower's, so
        # a sharded grower's histograms are bit-equal to it
        self.exp_rows = self.n_pad
        # row sharding (ops/shard.py): shard d owns the global rows
        # [d * local_rows, (d + 1) * local_rows) and its block of the
        # codes; single-controller keeps the per-row state in the global
        # layout here.  A pod process (PodMesh over several processes)
        # holds the codes and leaf ids of its rows [row_lo, row_hi) only;
        # scores, gradients and stat columns stay global
        if isinstance(mesh, PodMesh) and mesh.hosts == 1:
            mesh = mesh.local
        self.pod = mesh if isinstance(mesh, PodMesh) else None
        if self.pod is not None:
            self.mesh = list(self.pod.local)
        else:
            self.mesh = None if mesh is None or len(mesh) < 2 else \
                [torch.device(d) for d in mesh]
        self.shard_spec = None
        if self.mesh is not None:
            self.shard_spec = shard_spec(self.num_data, self.pod
                                         or self.mesh, config)
            self.n_pad = self.shard_spec.n_shards \
                * self.shard_spec.local_rows
        self.row_lo, self.row_hi = (0, self.n_pad) if self.pod is None \
            else process_row_span(self.pod, self.shard_spec.local_rows)
        # one composed CUDA graph a tree needs every shard on this card
        # and no collective of another process
        self._captures = device.type == "cuda" and self.pod is None and (
            self.mesh is None or all(canonical(d) == canonical(device)
                                     for d in self.mesh))
        self.binned_t = torch.zeros((self.num_groups,
                                     self.row_hi - self.row_lo),
                                    dtype=torch.uint8, device=device)
        self._upload_codes(dataset)
        self._shard_codes = None
        self._split_codes()
        self.meta = FeatureMeta.from_dataset(dataset, slot_stride=nb,
                                             device=device)
        self.hyper = SplitHyper.from_config(config)
        self.has_cat = bool(np.asarray(dataset.f_is_categorical).any())
        # each feature's group, slot range, default bin, bins and missing
        # type: what the wave's row routing reads (ops/routing.py)
        self.route_feat = feature_table(dataset, device)
        self.quant_bits, self.striped, self.hist_cols = _hist_layout(
            layout_rows, config)
        # the stripes split the rows at half the JAX grower's rows
        self.stripe_at = layout_rows // 2
        self.col_rows = max(self.stripe_at, self.exp_rows - self.stripe_at) \
            if self.striped else self.exp_rows
        # the int32 scan, exact while |sum q| <= 127 * rows fits int32;
        # past it the f32 fallback (lightgbm_tpu/ops/grow.py:281)
        self.int_scan = bool(self.quant_bits) \
            and self.exp_rows <= INT32_SCAN_ROWS
        self.wave_width = _wave_width(self.num_leaves, self.hist_cols)
        self.signature = plan_signature(dataset, config, device)
        self._set_plan(plan if plan is not None else legacy_stage_plan(
            self.num_leaves, self.wave_width, self.hist_cols), plan_source)
        self._valid = torch.arange(self.n_pad, device=device) < self.num_data
        if self.pod is not None:
            obs.set_gauge("shard.hosts", self.pod.hosts)
        self._set_seeds(config)
        nf = int(self.meta.num_bin.shape[0])
        self._ff_frac = float(config.feature_fraction)
        self._ff_nf = nf
        self._ff_k = max(1, int(np.ceil(nf * self._ff_frac)))
        self._ff_active = self._ff_frac < 1.0 and nf > 1
        # bagging (GBDT.bagging's rounds; redrawn inside fused chunks)
        self._bag_fraction = float(config.bagging_fraction)
        self._bag_freq = int(config.bagging_freq)
        self._bag_on = self._bag_fraction < 1.0 and self._bag_freq > 0
        self._bag_npad = bucket_size(max(self.num_data, 1))
        # constants of the pieces (made here, never inside a capture)
        self._valid_f = self._valid.float()
        if self.striped:
            self._stripe = torch.arange(self.n_pad, device=device) \
                < self.stripe_at
        self._leaf0 = torch.where(self._valid[self.row_lo:self.row_hi], 0,
                                  -1).to(torch.int32)
        self._ctl0 = torch.tensor([1, 0, 0], dtype=torch.int32,
                                  device=device)
        self._neg_row = torch.full((13,), NEG_INF, dtype=torch.float32,
                                   device=device)
        self._bit_pos = torch.arange(32, dtype=torch.int32, device=device)
        # packed-record columns the wave gathers (index tensors on the
        # device: a list index would copy from the host inside a capture)
        self._cols = {k: torch.tensor(v, dtype=torch.int64, device=device)
                      for k, v in (
                          ("left", [F_LEFT_G, F_LEFT_H, F_LEFT_C]),
                          ("right", [F_RIGHT_G, F_RIGHT_H, F_RIGHT_C]),
                          ("record", [F_GAIN, F_LEFT_G, F_LEFT_H, F_LEFT_C,
                                      F_RIGHT_G, F_RIGHT_H, F_RIGHT_C,
                                      F_LEFT_OUT, F_RIGHT_OUT]))}
        self._st = None
        self._graphs = None
        self._composed = {}
        self._grad = None
        #: host seconds of the eager warm-up before the captures, of the
        #: captures and of instantiating the composed graphs, the composed
        #: graphs built and the waves the warm-up ran (chip_smoke.py)
        self.capture_stats = dict(warmup_s=0.0, capture_s=0.0,
                                  instantiate_s=0.0, graphs=0,
                                  warmup_waves=0)
        self._ensure_state(max(int(getattr(config, "fused_chunk", 1)), 1))

    def _upload_codes(self, dataset) -> None:
        """The dataset's codes into :attr:`binned_t`, transposed on the
        grower's device (a device-binned dataset's where they lie).  A pod
        process takes its padded row block [row_lo, row_hi): the dataset's
        own block when it is host-sharded (``load_text_multihost``: its
        span checked against the mesh's), else its rows of the whole
        matrix (``lightgbm_tpu/ops/grow.py::_upload_binned_multihost``)."""
        binned = dataset.binned
        if not isinstance(binned, torch.Tensor):
            binned = torch.from_numpy(np.ascontiguousarray(binned))
        if self.pod is None:
            self.binned_t[:, :self.num_data].copy_(
                binned.to(self.device).t())
            return
        lo, hi = self.row_lo, self.row_hi
        if getattr(dataset, "host_shard", False):
            span = getattr(dataset, "host_row_span", None)
            if span is not None and tuple(span) != (lo, hi):
                raise LightGBMError(
                    f"host-sharded dataset covers padded rows {span} "
                    f"but this process's mesh block is ({lo}, {hi}) — "
                    f"the loader and the grower disagree on the pod "
                    f"layout (num_hosts/devices or bucket drift)")
            if binned.shape[0] != hi - lo:
                raise LightGBMError(
                    f"host-sharded binned block has {binned.shape[0]} "
                    f"rows, mesh block needs {hi - lo}")
            local = binned
        else:
            local = binned[lo:min(hi, self.num_data)]
        self.binned_t.zero_()
        self.binned_t[:, :local.shape[0]].copy_(local.to(self.device).t())

    def _split_codes(self) -> None:
        """Each shard's contiguous ``(G, local_rows)`` block of the codes,
        on its device (a sharded grower only)."""
        if self.mesh is None:
            return
        m = self.shard_spec.local_rows
        blocks = [self.binned_t[:, d * m:(d + 1) * m] for d in
                  range(len(self.mesh))]
        if self._shard_codes is None:
            self._shard_codes = [b.to(dev, copy=True).contiguous()
                                 for b, dev in zip(blocks, self.mesh)]
        else:
            for dst, b in zip(self._shard_codes, blocks):
                dst.copy_(b)

    def _set_plan(self, plan, source: str) -> None:
        """Follow ``plan`` (source: default, profiled or persisted): its
        stages as (width, leaf limit) pairs.  A plan's widths are at most
        :attr:`wave_width`, so the state buffers stay as they are."""
        self.stage_plan = [(int(w), None if c is None else int(c))
                           for w, c in plan]
        if self.stage_plan[-1][1] is not None \
                or max(w for w, _ in self.stage_plan) > self.wave_width:
            raise LightGBMError(f"stage plan {self.stage_plan} does not end "
                                f"in an open stage of width at most "
                                f"{self.wave_width}")
        self.plan_source = source
        self._stages = [(ws, self.num_leaves if cap is None
                         else min(cap, self.num_leaves))
                        for ws, cap in self.stage_plan]

    def install_plan(self, plan, source: str = "profiled") -> None:
        """Grow the next trees under ``plan``: the captured graphs are
        dropped (the next tree captures the new stages) and a cached
        grower's key takes the plan's digest."""
        self._set_plan(plan, source)
        self._drop_graphs()
        _rekey_grower(self)

    def _set_seeds(self, config) -> None:
        """Sampling seeds (lightgbm_tpu/ops/grow.py:364-379): host values
        the key tables are derived from, never captured."""
        self.lr = float(config.learning_rate)
        self._ff_seed = int(config.feature_fraction_seed
                            if config.feature_fraction_seed
                            else config.seed + 2) & 0x7FFFFFFF
        self._quant_seed = (int(config.seed) + 5) & 0x7FFFFFFF
        self._bag_seed = int(config.bagging_seed)

    def adopt(self, dataset, config, objective,
              plan_source: str = "") -> None:
        """Take a new booster's data into this (idle, cached) grower: its
        codes, feature metadata and seeds, and its gradient arguments into
        the tensors the captured fused tree reads (the booster's objective
        then reads those tensors too), so the captured graphs replay for it
        as they were.  Everything else a capture reads is equal by
        :func:`grower_key`, the stage plan included; ``plan_source`` is
        where the new booster's plan resolution found it (a plan this
        grower profiled is then already measured)."""
        dev = self.device
        self._upload_codes(dataset)
        self._split_codes()
        meta = FeatureMeta.from_dataset(dataset, slot_stride=self.nb,
                                        device=dev)
        for dst, src in zip(self.meta, meta):
            dst.copy_(src)
        self.route_feat.copy_(feature_table(dataset, dev))
        self.config = config
        self._set_seeds(config)
        if plan_source in ("profiled", "persisted"):
            self.plan_source = plan_source
        if self._grad is not None and objective is not None:
            fn, args = objective.device_grad()
            _copy_args(self._grad[1], args)
            objective._gargs = self._grad[1]
        self.capture_stats = dict(warmup_s=0.0, capture_s=0.0,
                                  instantiate_s=0.0, graphs=0,
                                  warmup_waves=0)

    # ------------------------------------------------------------------
    def feature_mask_for(self, tree_idx: int) -> torch.Tensor:
        """The feature_fraction mask of global tree ``tree_idx``
        (``iter * num_model + class``); all features when the fraction
        is 1."""
        if not self._ff_active:
            return torch.ones(self._ff_nf, dtype=torch.bool,
                              device=self.device)
        return feature_fraction_mask(self._ff_seed, tree_idx, self._ff_nf,
                                     self._ff_k, self.device)

    def _leaf_output(self, g, h):
        hp = self.hyper
        s = torch.sign(g) * torch.clamp(g.abs() - hp.lambda_l1, min=0.0)
        out = -s / (h + hp.lambda_l2 + 1e-35)
        if hp.max_delta_step <= 0.0:
            return out
        return torch.clamp(out, -hp.max_delta_step, hp.max_delta_step)

    def _splittable(self, total, depth, hess_scale=None):
        """``hess_scale`` dequantizes the hessian column of int32 totals
        (the quantized scan); counts compare directly either way."""
        cfg = self.config
        hess = total[..., 1]
        if hess_scale is not None:
            hess = hess.float() * hess_scale
        ok = (total[..., 2] > 2 * cfg.min_data_in_leaf) \
            & (hess > 2 * cfg.min_sum_hessian_in_leaf)
        if cfg.max_depth > 0:
            ok = ok & (depth < cfg.max_depth)
        return ok

    def _wave_hist(self, leaf_id, gh, pending, scale_exp, qscales,
                   stamp: bool = False):
        """(W, S, 3) histograms of the pending leaves: f32, or int32 in
        quantized units under the int32 scan.  Past the int32 bound the
        quantized histograms are dequantized once, each stripe cast to f32
        before the stripes are summed (an int32 sum of two stripes can
        wrap; counts sum exactly in int32).  ``stamp`` (a tree's waves)
        adds the kernel-1 call's time to the tree's ``hist_ns``."""
        w, k = pending.shape[0], self.hist_cols
        if stamp:
            self._stamp(clock.HIST, clock.OPEN)
        if self.mesh is not None:
            # kernel 1 once a shard, the shards' fixed-point sums reduced
            # (over a pod: across the processes too) before the one
            # conversion; a pod process passes its row block
            out = wave_hist_sharded(self._shard_codes, leaf_id,
                                    gh[self.row_lo:self.row_hi], pending,
                                    g=self.num_groups, nb=self.nb, k=k, w=w,
                                    scale_exp=scale_exp,
                                    leaf_bound=self.num_leaves,
                                    col_rows=self.col_rows, pod=self.pod)
        else:
            out = wave_hist(self.binned_t, leaf_id, gh, pending,
                            g=self.num_groups, nb=self.nb, k=k, w=w,
                            scale_exp=scale_exp, leaf_bound=self.num_leaves,
                            col_rows=self.col_rows)
        if stamp:
            self._stamp(clock.HIST, clock.CLOSE)
        acc = out.permute(2, 0, 1)              # (G*NB, K, W) -> (W, S, K)
        if not self.quant_bits or self.int_scan:
            return _combine_hist_cols(acc, k)
        f32 = lambda a: a.to(torch.float32)
        if k == 6:
            gsum = f32(acc[..., 0]) + f32(acc[..., 1])
            hsum = f32(acc[..., 2]) + f32(acc[..., 3])
            cnt = f32(acc[..., 4] + acc[..., 5])
        else:
            gsum, hsum, cnt = (f32(acc[..., 0]), f32(acc[..., 1]),
                               f32(acc[..., 2]))
        return torch.stack([gsum * qscales[0], hsum * qscales[1], cnt],
                           dim=-1)

    def _refit(self, grad, hess, one_f, leaf_id, scales):
        """(L,) leaf values refit from the full-precision gradients
        (lightgbm_tpu/ops/grow.py:1036-1058): each masked gradient is
        split into three base-128 int8 digits against the quantization
        scale (round to nearest, no noise) and the digits are summed per
        leaf in integers, so the sums are exact in any order."""
        L = self.num_leaves

        def digits(x, s):
            cols, r, sd = [], x, s
            for _ in range(3):
                d = torch.clamp(torch.round(r / sd), -QUANT_MAX, QUANT_MAX)
                r = r - d * sd
                cols.append(d.to(torch.int32))
                sd = sd / 128.0
            return cols

        rows = slice(self.row_lo, self.row_hi)
        dcols = torch.stack(digits((grad * one_f)[rows], scales[0])
                            + digits((hess * one_f)[rows], scales[1]), 1)
        idx = torch.where(leaf_id >= 0, leaf_id, L).long()
        sums6 = torch.zeros((L + 1, 6), dtype=torch.int32,
                            device=self.device).index_add_(0, idx, dcols)
        if self.pod is not None:
            self.pod.allreduce_(sums6, "refit")
        s = sums6[:L].float()
        gsum = (s[:, 0] + s[:, 1] * (1 / 128.0)
                + s[:, 2] * (1 / 16384.0)) * scales[0]
        hsum = (s[:, 3] + s[:, 4] * (1 / 128.0)
                + s[:, 5] * (1 / 16384.0)) * scales[1]
        return self._leaf_output(gsum, hsum)

    def _refit_f32(self, grad, hess, one_f, leaf_id):
        """(L,) leaf values refit past the int32 bound
        (lightgbm_tpu/ops/grow.py:1058-1073): the hi/lo bf16 columns of the
        masked gradients summed per leaf.  The JAX package contracts them
        in f32; here each column is summed exactly in int64 fixed point
        (bf16 * 2**e is exact in f32, :func:`hist_scale_exponents`), so
        the sums are the same in any order, run to run."""
        L = self.num_leaves
        cols = torch.stack(_hi_lo_cols(grad, hess, one_f.to(torch.bfloat16)),
                           1)
        e = hist_scale_exponents(cols, self.exp_rows)
        q = torch.round(cols[self.row_lo:self.row_hi].float()
                        * torch.exp2(e.float())).to(torch.int64)
        idx = torch.where(leaf_id >= 0, leaf_id, L).long()
        sums = torch.zeros((L + 1, 4), dtype=torch.int64,
                           device=self.device).index_add_(0, idx, q)
        if self.pod is not None:
            self.pod.allreduce_(sums, "refit")
        s = (sums[:L].double() * torch.exp2(-e.double())).float()
        return self._leaf_output(s[:, 0] + s[:, 1], s[:, 2] + s[:, 3])

    # ------------------------------------------------------------------
    # the tree's state on the device, and the pieces of a tree
    def _ensure_state(self, capacity: int) -> None:
        """Allocate every tensor a tree's pieces read or write, once, with
        chunk outputs for ``capacity`` trees; a larger capacity
        reallocates them and drops the captured graphs (they hold the old
        buffers' addresses)."""
        st = self._st
        if st is not None and st.capacity >= capacity:
            return
        self._drop_graphs()
        capacity = max(int(capacity), 1 if st is None else st.capacity)
        dev = self.device
        L, S, n, N = self.num_leaves, self.num_slots, self.n_pad, \
            self.num_data
        quant = bool(self.quant_bits)
        i32 = dict(dtype=torch.int32, device=dev)
        f32 = dict(dtype=torch.float32, device=dev)
        hdtype = torch.int32 if self.int_scan else torch.float32
        keep = max(L - 1, 1)
        W = self.wave_width
        self._st = types.SimpleNamespace(
            capacity=capacity,
            # inputs, written by the host before a launch (or, fused, by
            # the sample piece from the key table)
            score=torch.zeros(N, **f32), grad=torch.zeros(N, **f32),
            hess=torch.zeros(N, **f32), row_mask=torch.ones(N, **f32),
            fmask=torch.ones(self._ff_nf, dtype=torch.bool, device=dev),
            lr=torch.zeros((), **f32),
            keys=torch.zeros((capacity, KEY_WORDS), dtype=torch.int64,
                             device=dev),
            # [leaf count, done, waves, tree slot t of the chunk]
            ctl=torch.zeros(4, **i32),
            # one tree's working state
            grad_p=torch.zeros(n, **f32), hess_p=torch.zeros(n, **f32),
            one_f=torch.zeros(n, **f32),
            gh=torch.zeros((n, self.hist_cols), dtype=torch.int8 if quant
                           else torch.bfloat16, device=dev),
            scale_exp=torch.zeros(self.hist_cols, **i32),
            qscales=torch.ones(2, **f32),
            # a pod process's leaf ids are its row block's
            leaf_id=torch.zeros(self.row_hi - self.row_lo, **i32),
            hist=torch.zeros((L + 1, S, 3), dtype=hdtype, device=dev),
            total=torch.zeros((L + 1, 3), dtype=hdtype, device=dev),
            # the winner's exact int32 left totals (int32 scan only)
            bestl=torch.zeros((L + 1, 3), **i32) if self.int_scan else None,
            # the winner's bin set of each leaf (categorical scan only)
            bestc=torch.zeros((L + 1, 256), dtype=torch.bool, device=dev)
            if self.has_cat else None,
            value=torch.zeros(L + 1, **f32), depth=torch.zeros(L + 1, **i32),
            best=torch.zeros((L + 1, 13), **f32),
            rec_i=torch.zeros((L, REC_I_FIELDS), **i32),
            rec_f=torch.zeros((L, REC_F_FIELDS), **f32),
            rec_c=torch.zeros((L, REC_C_WORDS), **i32),
            p_parent=torch.zeros(W, **i32), p_small=torch.zeros(W, **i32),
            p_large=torch.zeros(W, **i32),
            # chunk outputs, slot t per tree
            out_rec_i=torch.zeros((capacity, keep, REC_I_FIELDS), **i32),
            out_rec_f=torch.zeros((capacity, keep, REC_F_FIELDS), **f32),
            out_rec_c=torch.zeros((capacity, keep, REC_C_WORDS), **i32),
            out_nl=torch.zeros(capacity, **i32),
            out_waves=torch.zeros(capacity, **i32),
            out_root=torch.zeros(capacity, **f32),
            out_qscales=torch.ones((capacity, 2), **f32),
            out_clock=torch.zeros((capacity, len(clock.FIELDS)),
                                  dtype=torch.int64, device=dev))

    def _tree_keys(self, tree_idx: int, it: int) -> list:
        """The :data:`KEY_WORDS` key words of a tree, derived on the host
        as the JAX package derives them: the feature_fraction key
        ``fold_in(PRNGKey(ff_seed), tree_idx)``, the int8 noise keys
        ``split(fold_in(PRNGKey(quant_seed), tree_idx))`` and the bagging
        key ``PRNGKey((bagging_seed + it) & 0x7FFFFFFF)`` (zeros where
        unused)."""
        row = [0] * KEY_WORDS
        if self._ff_active:
            row[0:2] = trandom.fold_in(trandom.PRNGKey(self._ff_seed),
                                       tree_idx)
        if self.quant_bits:
            kg, kh = trandom.split(trandom.fold_in(
                trandom.PRNGKey(self._quant_seed), tree_idx))
            row[2:6] = (*kg, *kh)
        if self._bag_on:
            row[6:8] = trandom.PRNGKey((self._bag_seed + it) & 0x7FFFFFFF)
        return row

    def _write_keys(self, rows) -> None:
        """One host-to-device copy of the chunk's key table."""
        host = torch.tensor(rows, dtype=torch.int64)
        if self.device.type == "cuda":
            host = host.pin_memory()
        self._st.keys[:len(rows)].copy_(host, non_blocking=True)

    def _tree_key(self):
        """(KEY_WORDS,) int64 key words of the chunk's current tree slot
        (read on the device: an index tensor, never a host int)."""
        st = self._st
        return st.keys.index_select(0, st.ctl[3:4].long())[0]

    def _stamp(self, field: int, mode: int = clock.SET) -> None:
        """A device-clock stamp into the current tree slot's row."""
        clock.stamp(self._st.out_clock, self._st.ctl, field, mode)

    def _piece_clock(self) -> None:
        """A tree's first piece: its ``start`` stamp (and a zero kernel-1
        sum)."""
        self._stamp(clock.START, clock.OPEN_TREE)

    def _piece_sample(self, redraw: bool) -> None:
        """Fused trees only: gradients from the current score, the
        bagging redraw (``redraw``: the host knows which trees start a
        round) and the feature_fraction mask, into the input buffers.  The
        gradient's time goes to the tree's ``grad_ns``."""
        st = self._st
        key = self._tree_key()
        grad_fn, gargs = self._grad
        self._stamp(clock.GRAD, clock.OPEN)
        g, h = grad_fn(st.score, gargs)
        st.grad.copy_(g)
        st.hess.copy_(h)
        self._stamp(clock.GRAD, clock.CLOSE)
        if redraw:
            st.row_mask.copy_(bag_mask(key[6:8], self._bag_npad,
                                       self.num_data, self._bag_fraction))
        if self._ff_active:
            st.fmask.copy_(feature_mask_from_key(key[0:2], self._ff_nf,
                                                 self._ff_k))

    def _piece_start(self) -> None:
        """Stat columns (and under int8 the quantization draws) from the
        input buffers, and a fresh tree state: one root leaf."""
        st = self._st
        pad = self.n_pad - self.num_data
        valid_f = self._valid_f
        st.grad_p.copy_(F.pad(st.grad, (0, pad)) * valid_f)
        st.hess_p.copy_(F.pad(st.hess, (0, pad)) * valid_f)
        st.one_f.copy_(valid_f * F.pad(st.row_mask, (0, pad)))
        k = self.hist_cols
        if self.quant_bits:
            key = self._tree_key()
            sg, sh, gq, hq = quantize_gh_keys(st.grad_p, st.hess_p,
                                              key[2:4], key[4:6])
            m8 = st.one_f.to(torch.int8)
            if k == 6:
                # striped g, h and count columns: each stripe's int32
                # accumulation stays exact below 127 * 2^24
                s8 = self._stripe.to(torch.int8)
                t8 = 1 - s8
                cols = [gq * m8 * s8, gq * m8 * t8, hq * m8 * s8,
                        hq * m8 * t8, m8 * s8, m8 * t8]
            else:
                cols = [gq * m8, hq * m8, m8]
            st.gh.copy_(torch.stack(cols, 1))
            st.qscales.copy_(torch.stack([sg, sh]))
        else:
            # bf16 (lightgbm_tpu/ops/grow.py:597): g and h are rounded to
            # bf16 BEFORE the histogram, on purpose; .to(torch.bfloat16)
            # rounds to nearest even like XLA's convert, so both packages
            # see the same column values.  grad_p/hess_p are zero past the
            # real rows but NOT bag-masked: the int8 scale above is taken
            # over every real row, out-of-bag ones included, as the JAX
            # package takes it
            one = st.one_f.to(torch.bfloat16)
            if k in (5, 6):
                cols = _hi_lo_cols(st.grad_p, st.hess_p, one)
            else:
                cols = [st.grad_p.to(torch.bfloat16) * one,
                        st.hess_p.to(torch.bfloat16) * one]
            if k in (4, 6):
                # two count stripes (the JAX package's layout; the kernel's
                # fixed-point count is exact either way)
                stripe = self._stripe.to(torch.bfloat16)
                cols += [one * stripe, one * (1.0 - stripe)]
            else:
                cols += [one]
            st.gh.copy_(torch.stack(cols, 1))
            st.scale_exp.copy_(hist_scale_exponents(st.gh, self.exp_rows))
        st.leaf_id.copy_(self._leaf0)
        st.hist.zero_()
        st.total.zero_()
        if st.bestl is not None:
            st.bestl.zero_()
        if st.bestc is not None:
            st.bestc.zero_()
            st.rec_c.zero_()
        st.value.zero_()
        st.depth.zero_()
        st.best.fill_(NEG_INF)
        st.rec_i.fill_(-1)
        st.rec_f.zero_()
        for p in (st.p_parent, st.p_small, st.p_large):
            p.fill_(-1)
        st.p_small[:1].fill_(0)
        st.ctl[:3].copy_(self._ctl0)
        self._stamp(clock.WAVES_START)

    def _piece_wave(self, ws: int) -> None:
        """One wave of width ``ws`` on the tree state (the JAX ``make_wave``
        body).  Reads nothing back: the leaf count, the done flag and the
        wave count stay on the device (``ctl``).  A wave that selects no
        split is an exact no-op on the tree: every scatter lands on the
        junk rows, the pending lists become empty, and ``done`` is set."""
        st = self._st
        dev = self.device
        L, nb = self.num_leaves, self.nb
        quant = self.int_scan
        hist, total, value, depth, best = (st.hist, st.total, st.value,
                                           st.depth, st.best)
        nl = st.ctl[0]
        p_parent, p_small, p_large = (st.p_parent[:ws], st.p_small[:ws],
                                      st.p_large[:ws])
        # 1. fresh histograms of the pending smaller children
        fresh = self._wave_hist(st.leaf_id, st.gh, p_small,
                                None if self.quant_bits else st.scale_exp,
                                st.qscales, stamp=True)
        # root (first wave only): totals from group 0's slots (every row
        # hits one)
        first = st.ctl[2] == 0
        total[0] = torch.where(first, fresh[0, :nb, :].sum(0), total[0])
        rt = total[0].float()
        if quant:
            rt = rt[:2] * st.qscales
        value[0] = torch.where(first, self._leaf_output(rt[0], rt[1]),
                               value[0])
        # 2. larger sibling = parent - smaller (read the parents before
        # the fresh histograms overwrite their slots)
        par = torch.where(p_parent >= 0, p_parent, L).long()
        large = hist[par] - fresh
        sm_ok, lg_ok = p_small >= 0, p_large >= 0
        sm_idx = torch.where(sm_ok, p_small, L).long()
        lg_idx = torch.where(lg_ok, p_large, L).long()
        hist[sm_idx] = torch.where(sm_ok[:, None, None], fresh,
                                   hist[sm_idx])
        hist[lg_idx] = torch.where(lg_ok[:, None, None], large,
                                   hist[lg_idx])

        # 3. find-best for both siblings of every new split, one batched
        # scan over the (2*Ws, S, 3) stack
        ids = torch.cat([torch.where(sm_ok, p_small, -1),
                         torch.where(lg_ok, p_large, -1)]).long()
        idc = ids.clamp(0, L - 1)
        stack = torch.cat([fresh, large])
        packed, catm, lint = find_best_split(
            stack, total[idc], st.fmask, self.meta, self.hyper,
            has_cat=self.has_cat, scales=st.qscales if quant else None)
        ok = self._splittable(total[idc], depth[idc],
                              hess_scale=st.qscales[1] if quant else None)
        ok = ok & (ids >= 0)
        packed[:, F_GAIN] = torch.where(
            ok, packed[:, F_GAIN],
            torch.full_like(packed[:, F_GAIN], NEG_INF))
        safe = torch.where(ids >= 0, ids, L)
        best[safe] = torch.where((ids >= 0)[:, None], packed, best[safe])
        if quant:
            st.bestl[safe] = torch.where((ids >= 0)[:, None], lint,
                                         st.bestl[safe])
        if self.has_cat:
            st.bestc[safe] = torch.where((ids >= 0)[:, None], catm,
                                         st.bestc[safe])

        # 4. select up to Ws best-gain splits within the budget.  Trouble
        # spot (lightgbm_tpu/ops/grow.py:846): lax.top_k breaks ties
        # toward the lower index; torch.topk promises no order on ties, a
        # stable descending sort does.
        top_vals, top_idx = torch.sort(best[:L, F_GAIN], descending=True,
                                       stable=True)
        top_vals, lsel = top_vals[:ws], top_idx[:ws]
        lanes = torch.arange(ws, device=dev)
        sel = (top_vals > 0.0) & (lanes < L - nl)
        napply = sel.sum()
        rank = torch.cumsum(sel.long(), 0) - 1
        vecs = best[lsel]                             # (Ws, 13)
        r_ids = nl + rank
        f = vecs[:, F_FEATURE].long()
        thr = vecs[:, F_THRESHOLD].long()
        dl = vecs[:, F_DEFAULT_LEFT] > 0.5

        # 5. apply the selected splits to leaf_id, in place (on the card
        # one launch of csrc/split_rows.cu)
        words = is_cat = None
        if self.has_cat:
            bits = st.bestc[lsel].view(ws, REC_C_WORDS, 32).to(torch.int32)
            words = (bits << self._bit_pos).sum(dim=2, dtype=torch.int32)
            is_cat = vecs[:, F_IS_CAT] > 0.5
        split_rows(st.leaf_id, self.binned_t, self.route_feat, sel, lsel,
                   r_ids, f, thr, dl, words, is_cat, num_leaves=L)

        # 6. bookkeeping: scatter into the L-padded state
        safe_l = torch.where(sel, lsel, L)
        safe_r = torch.where(sel, r_ids, L)
        sel2 = sel[:, None]
        if quant:
            # exact integer child totals: the winner's left sums from the
            # scan, the right child by subtraction (read the parent before
            # the scatter overwrites its slot)
            lsum = st.bestl[lsel]
            rsum = total[lsel] - lsum
            small_left = lsum[:, 2] <= rsum[:, 2]
        else:
            lsum = vecs.index_select(1, self._cols["left"])
            rsum = vecs.index_select(1, self._cols["right"])
            small_left = vecs[:, F_LEFT_C] <= vecs[:, F_RIGHT_C]
        total[safe_l] = torch.where(sel2, lsum, total[safe_l])
        total[safe_r] = torch.where(sel2, rsum, total[safe_r])
        value[safe_l] = torch.where(sel, vecs[:, F_LEFT_OUT], value[safe_l])
        value[safe_r] = torch.where(sel, vecs[:, F_RIGHT_OUT],
                                    value[safe_r])
        child_d = depth[lsel] + 1
        depth[safe_l] = torch.where(sel, child_d, depth[safe_l])
        depth[safe_r] = torch.where(sel, child_d, depth[safe_r])
        best[safe_l] = torch.where(sel2, self._neg_row, best[safe_l])
        best[safe_r] = torch.where(sel2, self._neg_row, best[safe_r])
        ridx = torch.where(sel, nl - 1 + rank, L - 1)
        new_ri = torch.stack([lsel, r_ids, f, thr, dl.long()],
                             dim=1).to(torch.int32)
        new_rf = vecs.index_select(1, self._cols["record"])
        st.rec_i[ridx] = torch.where(sel2, new_ri, st.rec_i[ridx])
        st.rec_f[ridx] = torch.where(sel2, new_rf, st.rec_f[ridx])
        if self.has_cat:
            st.rec_c[ridx] = torch.where(sel2, words, st.rec_c[ridx])
        # pending for the next wave: the smaller child gets the fresh
        # histogram
        lsel32, r32 = lsel.to(torch.int32), r_ids.to(torch.int32)
        p_parent.copy_(torch.where(sel, lsel32, -1))
        p_small.copy_(torch.where(sel, torch.where(small_left, lsel32, r32),
                                  -1))
        p_large.copy_(torch.where(sel, torch.where(small_left, r32, lsel32),
                                  -1))
        # control words last: every use of the leaf count above is queued
        st.ctl[2:3].add_(1)
        st.ctl[1:2].copy_((napply == 0).to(torch.int32).view(1))
        st.ctl[0:1].add_(napply.to(torch.int32).view(1))

    def _add_leaf_scores(self, score, leaf_vals, leaf_id) -> None:
        """The score update: ``score += leaf_vals[leaf_id]`` over the real
        rows.  Trouble spot (lightgbm_tpu/ops/grow.py:1109-1116): the JAX
        package adds float32(bf16(v)) + float32(bf16(v - hi)) per row
        through a one-hot einsum with one nonzero per row, which is
        exactly this gather; a direct add of the f32 value is more
        accurate but diverges from the JAX package from tree 2 on."""
        vhi = leaf_vals.to(torch.bfloat16)
        vlo = (leaf_vals - vhi.float()).to(torch.bfloat16)
        if self.pod is None:
            lid = leaf_id[:self.num_data].long()
            score.add_(vhi.float()[lid] + vlo.float()[lid])
            return
        # a pod process adds its block, then the blocks are all-gathered
        # (the JAX package's replicate-to-all of the row-sharded score)
        lo, n = self.row_lo, self.num_data
        real = max(0, min(n - lo, self.row_hi - lo))
        block = F.pad(score, (0, self.n_pad - n))[lo:self.row_hi].clone()
        lid = leaf_id[:real].long()
        block[:real].add_(vhi.float()[lid] + vlo.float()[lid])
        score.copy_(self.pod.gather_rows(
            block, self.shard_spec.local_rows)[:n])

    def _piece_finish(self) -> None:
        """The int8 refit, the score update, and the tree's records into
        chunk slot t (then t + 1), between the tree's ``waves_end`` and
        ``end`` stamps."""
        st = self._st
        self._stamp(clock.WAVES_END)
        L = self.num_leaves
        nl = st.ctl[0]
        leaf_vals = st.value[:L]
        if self.quant_bits:
            refit = self._refit(st.grad_p, st.hess_p, st.one_f, st.leaf_id,
                                st.qscales) if self.int_scan \
                else self._refit_f32(st.grad_p, st.hess_p, st.one_f,
                                     st.leaf_id)
            leaf_vals = self._refit_into_records(refit, st.rec_i, st.rec_f,
                                                 nl, st.value)
        # the score update; a stump (root never split) applies nothing
        scaled = leaf_vals * st.lr * (nl > 1).to(torch.float32)
        self._add_leaf_scores(st.score, scaled, st.leaf_id)
        t = st.ctl[3:4].long()
        keep = max(L - 1, 1)
        st.out_rec_i.index_copy_(0, t, st.rec_i[None, :keep])
        st.out_rec_f.index_copy_(0, t, st.rec_f[None, :keep])
        st.out_rec_c.index_copy_(0, t, st.rec_c[None, :keep])
        st.out_nl.index_copy_(0, t, st.ctl[0:1])
        st.out_waves.index_copy_(0, t, st.ctl[2:3])
        st.out_root.index_copy_(0, t, st.value[0:1])
        st.out_qscales.index_copy_(0, t, st.qscales[None])
        self._stamp(clock.END)
        st.ctl[3:4].add_(1)

    # ------------------------------------------------------------------
    # running a tree: the Python loop on the CPU, one launch on the card
    def _run_tree(self, sample) -> None:
        """Grow one tree into chunk slot t.  ``sample`` None: the host
        wrote the gradients and masks; False / True: a fused tree, without
        or with the bagging redraw.  On the CPU the pieces run in a Python
        loop that reads the control words (the plain version); on the card
        the composed graph runs, or the call raises; a mesh over several
        cards runs the loop."""
        if self._captures:
            self._graph(sample).launch()
            return
        self._run_pieces(sample)

    def _run_pieces(self, sample) -> None:
        """The plain version of a tree: the pieces in a Python loop that
        reads the control words (a host read a wave).  The CPU path; the
        card tests and chip_smoke.py run it on CUDA tensors to hold the
        captured tree against it."""
        self._piece_clock()
        if sample is not None:
            self._piece_sample(sample)
        self._piece_start()
        ctl = self._st.ctl
        for ws, limit in self._stages:
            # torchlint: disable-next=TL001 -- the plain loop reads ctl a wave
            while int(ctl[1]) == 0 and int(ctl[0]) < limit:
                self._piece_wave(ws)
        self._piece_finish()

    def _graph(self, sample):
        """The composed graph of a tree variant, warmed up, captured and
        instantiated at first use (``ops/graphs.py``): the pieces once per
        grower, the sample piece once per bagging variant.  The graphs
        read and write only the buffers of ``_ensure_state``; call before
        writing a launch's inputs (the warm-up runs every piece once)."""
        g = self._composed.get(sample)
        if g is not None:
            return g
        from . import graphs
        # one build at a time in the process: its device-wide syncs and
        # captures never overlap another grower's capture (several tenants
        # train on one card in the fleet soak)
        with graphs.BUILD_LOCK, obs.span("grow.build", cat="grow"):
            return self._build_graph(sample)

    def _build_graph(self, sample):
        from . import graphs
        stats = self.capture_stats
        t0 = t_start = time.perf_counter()
        if self._graphs is None:
            # the launch counter and every lazy initialization must exist
            # before the captures: run each piece once, eagerly
            wave_hist.launches.counter(self.device)
            split_rows.launches.counter(self.device)
            clock.stamp.launches.counter(self._st.out_clock.device)
            if self.mesh is not None:
                wave_hist_sharded.launches.counter(self.device)
            self._st.ctl[3:4].zero_()
            self._piece_clock()
            self._piece_start()
            for ws, _ in self._stages:
                self._piece_wave(ws)
            self._piece_finish()
            torch.cuda.synchronize(self.device)
            stats["warmup_waves"] += len(self._stages)
            t1 = time.perf_counter()
            stats["warmup_s"] += t1 - t0
            gs = graphs.GraphSet(self.device)
            self._graphs = dict(
                set=gs, clock=gs.capture(self._piece_clock),
                start=gs.capture(self._piece_start),
                waves=[gs.capture(functools.partial(self._piece_wave, ws))
                       for ws, _ in self._stages],
                finish=gs.capture(self._piece_finish))
            t0 = time.perf_counter()
            stats["capture_s"] += t0 - t1
        pieces = self._graphs
        steps = [(pieces["clock"], None)]
        if sample is not None:
            key = ("sample", bool(sample))
            if key not in pieces:
                self._piece_sample(bool(sample))
                torch.cuda.synchronize(self.device)
                pieces[key] = pieces["set"].capture(
                    functools.partial(self._piece_sample, bool(sample)))
            steps.append((pieces[key], None))
            t1 = time.perf_counter()
            stats["capture_s"] += t1 - t0
            t0 = t1
        steps.append((pieces["start"], None))
        steps.extend((wg, limit) for wg, (_, limit)
                     in zip(pieces["waves"], self._stages))
        steps.append((pieces["finish"], None))
        g = self._composed[sample] = graphs.compose(steps, self._st.ctl)
        t1 = time.perf_counter()
        stats["instantiate_s"] += t1 - t0
        stats["graphs"] += 1
        capture_track.record("grow.tree", capture_track.signature_of(
            (self.n_pad, self.num_groups, self.nb, self.num_leaves,
             self.quant_bits, self.hist_cols, sample)), t_start,
            t1 - t_start)
        return g

    def _drop_graphs(self) -> None:
        for g in self._composed.values():
            g.close()
        self._composed = {}
        self._graphs = None

    # ------------------------------------------------------------------
    def grow_one_iter(self, score, grad, hess, lr=None, feature_mask=None,
                      row_mask=None, tree_idx: int = 0) -> GrowResult:
        """Grow one tree from (num_data,) f32 gradients and return the
        updated score and the split records (device tensors).
        ``row_mask`` is the (num_data,) f32 0/1 in-bag indicator of
        bagging: out-of-bag rows drop out of the histograms and counts but
        are still routed to leaves, so the score update reaches them.
        ``tree_idx`` is the global tree index keying the quantization
        noise.  On the card this is one launch of the captured tree; no
        value is read back."""
        self._ensure_state(1)
        if self._captures:
            self._graph(None)
        st = self._st
        st.score.copy_(score)
        st.grad.copy_(grad)
        st.hess.copy_(hess)
        st.lr.fill_(float(np.float32(self.lr if lr is None else lr)))
        if feature_mask is None:
            st.fmask.fill_(True)
        else:
            st.fmask.copy_(feature_mask)
        if row_mask is None:
            st.row_mask.fill_(1.0)
        else:
            st.row_mask.copy_(row_mask)
        self._write_keys([self._tree_keys(tree_idx, 0)])
        st.ctl[3:4].zero_()
        self._run_tree(None)
        return GrowResult(st.score.clone(), st.out_rec_i[0].clone(),
                          st.out_rec_f[0].clone(), st.out_rec_c[0].clone(),
                          st.out_nl[0].clone(),
                          st.out_root[0].clone(), st.out_waves[0].clone(),
                          st.out_clock[0].clone())

    def fused_train(self, length: int, score, lr: float, it0: int,
                    grad_fn) -> FusedResult:
        """``length`` whole boosting iterations from iteration ``it0``
        (counterpart of ``lightgbm_tpu/ops/grow.py::fused_train``): per
        tree, gradients from the current score (``grad_fn``: the
        objective's ``device_grad`` pair), the bagging redraw on trees
        where ``it % bagging_freq == 0`` (the mask active at ``it0`` is
        drawn first when ``it0`` is not a boundary), the feature_fraction
        mask, growth and the score update.  On the card: one key-table
        copy, then ``length`` launches of the captured tree, no host read
        in between.  Returns device views (valid until the next call)."""
        self._ensure_state(length)
        if self._grad is None:
            self._grad = grad_fn
        elif any(a is not b for a, b in zip(self._grad, grad_fn)):
            raise ValueError("fused_train: the gradient pair is captured "
                             "once per grower and cannot change")
        redraw = [self._bag_on and (it0 + j) % self._bag_freq == 0
                  for j in range(length)]
        if self._captures:
            for r in sorted(set(redraw)):
                self._graph(r)
        st = self._st
        st.score.copy_(score)
        st.lr.fill_(float(np.float32(lr)))
        self._write_keys([self._tree_keys(it0 + j, it0 + j)
                          for j in range(length)])
        st.ctl[3:4].zero_()
        if not self._ff_active:
            st.fmask.fill_(True)
        if not self._bag_on:
            st.row_mask.fill_(1.0)
        elif it0 % self._bag_freq:
            st.row_mask.copy_(self.bag_mask_at(it0 - it0 % self._bag_freq))
        for r in redraw:
            self._run_tree(r)
        return FusedResult(st.score, st.out_rec_i[:length],
                           st.out_rec_f[:length], st.out_rec_c[:length],
                           st.out_nl[:length],
                           st.out_waves[:length], st.out_qscales[:length],
                           st.out_clock[:length])

    def profile_stage_plan(self, require_beat_legacy: bool = False) -> dict:
        """Time kernel 1 (the wave histogram, ``_wave_hist``) at every
        candidate stage width (the plan's widths, the doubling ladder
        below :attr:`wave_width`, and :attr:`wave_width`) on this grower's
        codes and its stat columns (int8 included) made from seeded
        gradients, every row in a pending leaf; fit the fixed and
        per-column wave cost, derive the cheapest plan
        (``ops/stage_plan.py``), keep it for this grower's signature in
        the process and in the store its config names, and grow under it
        (``lightgbm_tpu/ops/grow.py::profile_stage_plan``).  Each width is
        launched once to warm up, then :data:`PROBE_REPS` times, each
        between two CUDA events (on the CPU: the host clock around the
        plain version); its time is the median.
        ``require_beat_legacy`` (``wave_plan=auto``) keeps the legacy
        ladder unless the derived plan beats it by
        ``stage_plan.MIN_IMPROVEMENT`` with its waves at their slowest
        probes and the ladder's at their fastest
        (``stage_plan.plan_beats_spread``); the verdict is kept either
        way.  A grower whose plan is already measured (source
        profiled or persisted) measures nothing.  With telemetry on each
        width is a ``grow.stage_probe`` span and a ``grow.stage.w<W>``
        timing and ``_ms`` gauge, the full width also ``grow.hist.<tag>``.

        Under ``profile_attribution`` each width's probe also gets its
        counted cost (``obs.profile.cost_of``; ``stage_cost``) and a
        ``grow.stage.w<W>_gbytes`` gauge, as the JAX probes attach XLA's
        cost analysis.

        Returns ``{"stage_ms", "spread_ms", "stage_cost", "fixed_ms",
        "col_ms", "residual_ms", "plan", "plan_digest", "installed",
        "profiled"}`` (``spread_ms``: each width's slowest less fastest
        probe)."""
        self._refuse_on_pod("profile_stage_plan")
        if self.plan_source in ("profiled", "persisted"):
            return {"stage_ms": {}, "spread_ms": {}, "stage_cost": {},
                    "fixed_ms": None,
                    "col_ms": None, "residual_ms": {},
                    "plan": list(self.stage_plan),
                    "plan_digest": stage_plan_mod.plan_digest(
                        self.stage_plan),
                    "installed": False, "profiled": False}
        reps = PROBE_REPS
        with _PLAN_COUNTS_LOCK:
            PLAN_COUNTS["profiles"] += 1
        obs.inc("grow.plan_profiles")
        self._ensure_state(1)
        st, dev, k = self._st, self.device, self.hist_cols
        n, N, nb_ = self.n_pad, self.num_data, self.nb
        rng = np.random.default_rng(0)
        grad = rng.standard_normal(N, dtype=np.float32)
        st.grad.copy_(torch.from_numpy(grad))
        st.hess.copy_(torch.from_numpy(np.abs(grad) + np.float32(0.1)))
        st.row_mask.fill_(1.0)
        # the stat columns as a tree's start piece makes them (int8: the
        # quantization draws under the key table's first row)
        st.ctl[3:4].zero_()
        self._piece_start()
        widths = sorted({w for w, _ in self.stage_plan}
                        | set(stage_plan_mod._ladder(self.wave_width))
                        | {self.wave_width})
        scale_exp = None if self.quant_bits else st.scale_exp
        cuda = dev.type == "cuda"
        stage_ms, lo_ms, hi_ms, stage_cost = {}, {}, {}, {}
        for w in widths:
            leaf = rng.integers(0, w, n).astype(np.int32)
            leaf[N:] = -1
            leaf = torch.from_numpy(leaf).to(dev)
            pend = torch.arange(w, dtype=torch.int32, device=dev)
            probe = functools.partial(self._wave_hist, leaf, st.gh, pend,
                                      scale_exp, st.qscales)
            before = wave_hist.launches.read() if cuda else 0
            probe()
            with obs.span("grow.stage_probe", cat="grow", width=w,
                          hist_cols=k):
                if cuda:
                    evs = [torch.cuda.Event(enable_timing=True)
                           for _ in range(reps + 1)]
                    evs[0].record()
                    for ev in evs[1:]:
                        probe()
                        ev.record()
                    # torchlint: disable-next=TL001 -- timing: one read a probe
                    evs[-1].synchronize()
                    times = [a.elapsed_time(b)
                             for a, b in zip(evs, evs[1:])]
                else:
                    times = []
                    for _ in range(reps):
                        t0 = time.perf_counter()
                        probe()
                        times.append((time.perf_counter() - t0) * 1e3)
            if cuda and wave_hist.launches.read() - before != reps + 1:
                raise LightGBMError(f"stage probe at width {w}: kernel 1 "
                                    f"did not launch {reps + 1} times")
            ms = float(np.median(times))
            stage_ms[w] = round(ms, 4)
            lo_ms[w], hi_ms[w] = min(times), max(times)
            if obs.profile.enabled():
                # every real row lies in a pending leaf of the probe
                cost = obs.profile.cost_of(
                    "wave_hist", rows=n, groups=self.num_groups, bins=nb_,
                    k=k, w=w, rows_in_wave=N,
                    stat_bytes=st.gh.element_size())
                stage_cost[w] = cost
                obs.set_gauge(f"grow.stage.w{w}_gbytes",
                              round(cost["bytes_accessed"] / 1e9, 4))
            obs.observe(f"grow.stage.w{w}", ms / 1e3)
            obs.set_gauge(f"grow.stage.w{w}_ms", round(ms, 4))
            if w == self.wave_width:
                # the kernel variant the full-width stage launches
                dtype = "int8" if self.quant_bits else "bf16"
                tag = f"wave_hist_k{k}_{dtype}"
                obs.observe(f"grow.hist.{tag}", ms / 1e3)
                obs.set_gauge(f"grow.hist.{tag}_ms", round(ms, 4))
        fixed, col = stage_plan_mod.fit_wave_costs(
            widths, [stage_ms[w] for w in widths], k, num_data=n)
        residual = {w: round(stage_ms[w] - (fixed + col * w * k), 4)
                    for w in widths}
        plan = stage_plan_mod.derive_stage_plan(
            self.num_leaves, self.wave_width, k, fixed, col,
            measured_ms=stage_ms)
        if require_beat_legacy:
            legacy = legacy_stage_plan(self.num_leaves, self.wave_width, k)
            if not stage_plan_mod.plan_beats_spread(
                    plan, legacy, self.num_leaves, lo_ms, hi_ms):
                plan = legacy
        obs.set_gauge("grow.stage.fixed_ms", round(fixed, 4))
        obs.set_gauge("grow.stage.col_ms", round(col, 6))
        stage_plan_mod.cache_plan(self.signature, plan,
                                  stage_plan_mod.store_dir(self.config))
        installed = plan != self.stage_plan
        if installed:
            self.install_plan(plan, "profiled")
        else:
            # the plan stands, now measured
            self.plan_source = "profiled"
        return {"stage_ms": stage_ms,
                "spread_ms": {w: round(hi_ms[w] - lo_ms[w], 4)
                              for w in widths},
                "stage_cost": stage_cost,
                "fixed_ms": round(fixed, 4), "col_ms": round(col, 6),
                "residual_ms": residual, "plan": plan,
                "plan_digest": stage_plan_mod.plan_digest(plan),
                "installed": installed, "profiled": True}

    def profile_phases(self, grad, hess, reps: int = 20) -> dict:
        """Per-phase attribution of one wave (``lightgbm_tpu/ops/grow.py::
        profile_phases``).  A tree runs as one composed graph, so its
        phases are invisible from the host; this times the wave's phases
        one at a time on this grower's codes and a representative leaf
        state (the rows spread over :attr:`wave_width` leaves, all
        pending), the stat columns made from ``grad``/``hess`` ((N,) f32)
        as a tree's start piece makes them:

        * ``wave_hist``: kernel 1 at the full width (``_wave_hist``);
        * ``find_best``: the split scan over the wave's (2W, S, 3) stack
          of both siblings' histograms, as the wave's step 3 runs it;
        * ``split_apply``: the rows' routing to their children, every
          leaf split (``ops/routing.split_rows``, the wave's step 5);
        * ``score_update``: the score's hi/lo gather of the leaf values
          (``_add_leaf_scores``, as ``_piece_finish`` runs it);
        * the null-dispatch floor, an 8-element add, subtracted from
          every phase and reported as ``dispatch_floor``.

        Each phase runs once to warm up, then ``reps`` times between two
        CUDA events on the card (the host clock on the CPU); its ms is
        the mean.  Sets the ``profile.<phase>_ms`` gauges; under
        ``profile_attribution`` adds ``costs`` (``obs.profile.cost_of``
        per phase) and ``profile.<phase>_gbytes`` gauges.  Returns
        ``{phase: ms, "dispatch_floor": ms[, "costs": {...}]}``."""
        from ..obs import profile as obs_profile
        self._refuse_on_pod("profile_phases")
        reps = max(1, int(reps))
        self._ensure_state(1)
        st, dev = self._st, self.device
        n, N, L, nb = self.n_pad, self.num_data, self.num_leaves, self.nb
        w = self.wave_width
        st.grad.copy_(torch.as_tensor(grad, dtype=torch.float32,
                                      device=dev)[:N])
        st.hess.copy_(torch.as_tensor(hess, dtype=torch.float32,
                                      device=dev)[:N])
        st.row_mask.fill_(1.0)
        st.ctl[3:4].zero_()
        self._piece_start()
        rng = np.random.default_rng(0)
        leaf = rng.integers(0, w, n).astype(np.int32)
        leaf[N:] = -1
        leaf = torch.from_numpy(leaf).to(dev)
        pend = torch.arange(w, dtype=torch.int32, device=dev)
        scale_exp = None if self.quant_bits else st.scale_exp
        quant = self.int_scan
        f = torch.from_numpy(rng.integers(
            0, self._ff_nf, w).astype(np.int64)).to(dev)
        thr = torch.from_numpy(rng.integers(0, nb, w).astype(np.int64)) \
            .to(dev)
        dl = torch.from_numpy(rng.integers(0, 2, w).astype(bool)).to(dev)
        lanes = torch.arange(w, device=dev)
        sel = torch.ones(w, dtype=torch.bool, device=dev)
        words = is_cat = None
        if self.has_cat:
            words = torch.zeros((w, REC_C_WORDS), dtype=torch.int32,
                                device=dev)
            is_cat = torch.zeros(w, dtype=torch.bool, device=dev)
        vals = torch.from_numpy(rng.standard_normal(L).astype(np.float32)) \
            .to(dev)
        score = torch.zeros(N, dtype=torch.float32, device=dev)
        tiny = torch.zeros(8, dtype=torch.float32, device=dev)

        def p_hist():
            return self._wave_hist(leaf, st.gh, pend, scale_exp, st.qscales)

        hists = p_hist()
        # the wave scans both siblings of every split: the fresh smaller
        # children and their larger siblings (parent - fresh)
        stack = torch.cat([hists, hists.flip(0)])
        totals = stack[:, :nb, :].sum(1)

        def p_find():
            return find_best_split(stack, totals, st.fmask, self.meta,
                                   self.hyper, has_cat=self.has_cat,
                                   scales=st.qscales if quant else None)[0]

        def p_apply():
            # every leaf a lane (all W leaves split); a row that goes right
            # is written back into its own leaf, so every rep routes alike
            return split_rows(leaf, self.binned_t, self.route_feat, sel,
                              lanes, lanes, f, thr, dl, words, is_cat,
                              num_leaves=L)

        def p_score():
            self._add_leaf_scores(score, vals, leaf)

        def p_null():
            return tiny + 1.0

        cases = {"null_dispatch": p_null, "wave_hist": p_hist,
                 "find_best": p_find, "split_apply": p_apply,
                 "score_update": p_score}
        cuda = dev.type == "cuda"
        out = {}
        for name, fn in cases.items():
            fn()
            if cuda:
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                for _ in range(reps):
                    fn()
                b.record()
                # torchlint: disable-next=TL001 -- timing: one read a phase
                b.synchronize()
                ms = a.elapsed_time(b) / reps
            else:
                t0 = time.perf_counter()
                for _ in range(reps):
                    fn()
                ms = (time.perf_counter() - t0) / reps * 1e3
            out[name] = ms
        floor = out.pop("null_dispatch")
        out = {k: round(max(v - floor, 0.0), 4) for k, v in out.items()}
        out["dispatch_floor"] = round(floor, 4)
        for name, ms in out.items():
            obs.set_gauge(f"profile.{name}_ms", ms)
        if obs_profile.enabled():
            gh_bytes = st.gh.element_size()
            costs = {
                "wave_hist": obs_profile.cost_of(
                    "wave_hist", rows=n, groups=self.num_groups, bins=nb,
                    k=self.hist_cols, w=w, rows_in_wave=N,
                    stat_bytes=gh_bytes),
                "find_best": obs_profile.cost_of(
                    "find_best", leaves=2 * w, slots=self.num_slots,
                    hist_bytes=stack.element_size()),
                "split_apply": obs_profile.cost_of("split_apply", rows=n,
                                                   w=w),
                "score_update": obs_profile.cost_of("score_update", rows=N,
                                                    leaves=L)}
            for name, cost in costs.items():
                obs.set_gauge(f"profile.{name}_gbytes",
                              round(cost["bytes_accessed"] / 1e9, 4))
            out["costs"] = costs
        return out

    def _refuse_on_pod(self, what: str) -> None:
        """The probes time kernel 1 on one process's view of the rows; a
        pod's processes would measure apart and could adopt different
        plans (``lightgbm_tpu/boosting/gbdt.py:326-342``)."""
        if self.pod is not None:
            raise LightGBMError(f"{what} is not supported under "
                                f"data_sharding=multi_controller")

    def bag_mask_at(self, it: int) -> torch.Tensor:
        """(num_data,) f32 in-bag mask of the bagging round drawn at
        iteration ``it`` (``GBDT.bagging``'s draw)."""
        return bag_mask(trandom.PRNGKey((self._bag_seed + it) & 0x7FFFFFFF),
                        self._bag_npad, self.num_data, self._bag_fraction,
                        self.device)

    def _refit_into_records(self, refit, rec_i, rec_f, nl, value):
        """Write each existing leaf's refit value into the record that
        created it (the last record naming the leaf: a left child keeps
        its parent's id, a right id is fresh), in place; returns the (L,)
        leaf values (0 past the last leaf).  A leaf that a categorical
        split created keeps its growth value (``value``): a sorted-mode
        split's outputs take ``lambda_l2 + cat_l2``, which the refit
        formula would drop (lightgbm_tpu/ops/grow.py:1087-1095)."""
        L = self.num_leaves
        dev = self.device
        exists = torch.arange(L, device=dev) < nl
        recs = torch.arange(L, dtype=torch.int64, device=dev)
        lid, rid = rec_i[:, 0].long(), rec_i[:, 1].long()
        base = torch.full((L + 1,), -1, dtype=torch.int64, device=dev)
        last_l = base.scatter_reduce(0, torch.where(lid >= 0, lid, L), recs,
                                     reduce="amax")
        last_r = base.scatter_reduce(0, torch.where(rid >= 0, rid, L), recs,
                                     reduce="amax")
        crec = torch.maximum(last_l[:L], last_r[:L])
        is_left = last_l[:L] >= last_r[:L]
        do = exists & (crec >= 0)
        if self.has_cat:
            cfeat = rec_i[torch.where(do, crec, 0), 2].long()
            from_cat = do & (self.meta.is_cat[cfeat.clamp(min=0)] == 1)
            refit = torch.where(from_cat, value[:L], refit)
        leaf_vals = torch.where(exists, refit, torch.zeros_like(refit))
        rows = torch.where(do, crec, L - 1)          # junk record row
        cols = torch.where(is_left, REC_F_LEFT_OUT, REC_F_RIGHT_OUT)
        rec_f[rows, cols] = torch.where(do, leaf_vals, rec_f[rows, cols])
        return leaf_vals
