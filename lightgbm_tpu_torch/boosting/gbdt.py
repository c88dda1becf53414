"""GBDT: the boosting loop, record replay into trees, model text.

Counterpart of ``lightgbm_tpu/boosting/gbdt.py``: scores live on the
training device as a (num_model, N) float32 tensor, gradients come from
the objective as torch ops (or from the caller, ``fobj``), and each
iteration grows one tree a class (K = ``num_model``).  Where
``ops/grow.host_learner_reason`` finds nothing and ``device_growth`` is not
``off``, ``ops/grow.DeviceGrower`` grows them and their split records
stay on the device until they are replayed into host ``Tree`` objects
(``_flush_pending``); otherwise the host learner (``tree/learner.py``)
grows them (monotone constraints, forced splits, leaf-renewing
objectives, ``fobj``, ``2 * COUNT_SPLIT_ROWS`` rows or more), renews
their leaf outputs and updates the scores through its partition.
Prediction of a large batch runs through the packed-forest kernel
(``serve/packed.py``), of a small one by the host tree walk in float64.
The model text is the reference's "v2" format, so it loads into the JAX
package and back.  Bagging redraws its row mask
every ``bagging_freq`` iterations and feature_fraction draws a mask per
tree, both from the JAX package's Threefry keys, so the draws are its
draws.  Validation sets (``add_valid``) keep their scores on the device
and take each new tree at evaluation time (``eval_valid``), by the
binned-matrix traversal ``ops/traverse.py``.  An iteration runs along
the JAX package's hooks (``_device_gradients``, ``_adjust_gradients``,
``bagging``, ``_post_bagging_adjust``, ``_tree_multiplier``), which GOSS,
DART and RF override (``goss.py``, ``dart.py``, ``rf.py``).
:meth:`GBDT.train_chunked`
is the fused path (``lightgbm_tpu/boosting/gbdt.py:711-825``): a chunk of
trees runs as ``fused_chunk`` launches of the grower's captured tree with
gradients, bagging redraws, feature masks and int8 noise drawn on the
card and no host read in between; the chunk's records come back in one
asynchronous copy, and the stump check reads the previous chunk's leaf
counts (one host sync a chunk).  With ``snapshot_freq`` it writes atomic
training checkpoints (``robust/checkpoint.py``) that
:meth:`GBDT.resume_from_checkpoint` continues from byte for byte;
:meth:`GBDT.refit_leaves` refits the leaf values on new labels.  Every
dispatch runs under the ``grow.dispatch`` fault site and
``dispatch_retries`` (``robust/retry.py``); with telemetry on, iterations
and chunks record ``train.*`` spans (``obs/``), none of which reads the
card.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import compile_cache, obs
from ..config import Config, resolve_device
from ..data.dataset import BinnedDataset, Metadata
from ..metrics import create_metrics
from ..objectives import create_objective
from ..ops.bagging import bagging_row_mask
from ..ops import stage_plan as stage_plan_mod
from ..ops.grow import (DeviceGrower, acquire_grower, check_slice_config,
                        host_learner_reason, release_grower)
from ..ops.histogram import bucket_size
from ..ops.shard import PodMesh, resolve_shard_mesh, sharding_mode
from ..parallel import create_tree_learner
from ..ops.traverse import add_constant_score, add_tree_score, device_tree
from ..params import PARAM_BY_NAME
from ..robust import checkpoint as _checkpoint
from ..robust import faults
from ..robust.retry import (RetryPolicy, transient_dispatch_errors,
                            with_retries)
from ..tree.tree import Tree, categorical_bitsets, tree_shap_batch
from ..utils.log import LightGBMError, log_info, log_warning

K_EPSILON = 1e-15
MODEL_VERSION = "v2"
_TRANSIENT_DISPATCH = transient_dispatch_errors()


def _replay_records(rec_i, rec_f, rec_c, nl, shrinkage, bias, dataset,
                    config) -> Tree:
    """Replay the host copy of one tree's split records into a ``Tree``;
    a categorical feature's split takes its bin set from the eight words
    of ``rec_c``."""
    tree = Tree(config.num_leaves)
    if nl > 1:
        is_cat = np.asarray(dataset.f_is_categorical)
        for s in range(nl - 1):
            leaf, _right, f, thr, dl = (int(v) for v in rec_i[s])
            gain, _lg, _lh, lc, _rg, _rh, rc, lout, rout = (
                float(v) for v in rec_f[s])
            real_f = dataset.used_features[f]
            mapper = dataset.bin_mappers[real_f]
            missing = dataset.f_missing_type[f]
            if is_cat[f]:
                words = rec_c[s].astype(np.uint32)
                member = [b for b in range(min(mapper.num_bin, 256))
                          if (words[b >> 5] >> (b & 31)) & 1]
                inner, raw = categorical_bitsets(mapper, member)
                tree.split_categorical(leaf, f, real_f, inner, raw, lout,
                                       rout, int(lc), int(rc), gain,
                                       missing)
            else:
                tree.split(leaf, f, real_f, thr, mapper.bin_to_value(thr),
                           lout, rout, int(lc), int(rc), gain, missing,
                           bool(dl))
        tree.apply_shrinkage(shrinkage)
    # a stump applied nothing to the scores, so it carries only the bias
    if abs(bias) > K_EPSILON:
        tree.add_bias(bias)
    return tree


class _PendingTree:
    """Device-side split records of a grown tree, replayed lazily."""

    __slots__ = ("rec_i", "rec_f", "rec_c", "nl", "shrinkage", "bias")

    def __init__(self, rec_i, rec_f, rec_c, nl, shrinkage, bias):
        self.rec_i, self.rec_f, self.rec_c = rec_i, rec_f, rec_c
        self.nl, self.shrinkage, self.bias = nl, shrinkage, bias

    def materialize(self, dataset, config) -> Tree:
        return _replay_records(self.rec_i.cpu().numpy(),
                               self.rec_f.cpu().numpy(),
                               self.rec_c.cpu().numpy(), int(self.nl),
                               self.shrinkage, self.bias, dataset, config)


class _RecStack:
    """The stacked records of a fused chunk (``DeviceGrower.fused_train``:
    rec_i, rec_f, nl, waves, qscales, rec_c): ONE asynchronous device-to-host
    copy into pinned memory serves every tree of the chunk; :meth:`host`
    waits for it (a host sync, counted by the caller)."""

    __slots__ = ("_host", "_event")

    def __init__(self, arrays, device: torch.device):
        self._event = None
        if device.type == "cuda":
            self._host = tuple(torch.empty(a.shape, dtype=a.dtype,
                                           pin_memory=True) for a in arrays)
            for h, a in zip(self._host, arrays):
                h.copy_(a, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(device))
        else:
            self._host = tuple(a.clone() for a in arrays)

    def host(self):
        """(rec_i, rec_f, nl, waves, qscales, rec_c) numpy arrays."""
        if self._event is not None:
            self._event.synchronize()
            self._event = None
        return tuple(h.numpy() for h in self._host)


class _PendingChunkTree:
    """One tree of a fused chunk: index ``idx`` into a shared _RecStack."""

    __slots__ = ("stack", "idx", "shrinkage", "bias")

    def __init__(self, stack, idx, shrinkage, bias):
        self.stack, self.idx = stack, idx
        self.shrinkage, self.bias = shrinkage, bias

    def materialize(self, dataset, config) -> Tree:
        rec_i, rec_f, nl, _, _, rec_c = self.stack.host()
        return _replay_records(rec_i[self.idx], rec_f[self.idx],
                               rec_c[self.idx], int(nl[self.idx]),
                               self.shrinkage, self.bias, dataset, config)


_PENDING = (_PendingTree, _PendingChunkTree)


class _ValidSet:
    """A validation set: its dataset, its binned codes and (num_model, N)
    float32 scores on the training device, its metrics, and how many of
    the models its scores hold."""

    __slots__ = ("dataset", "binned", "score", "metrics", "name",
                 "applied_models")

    def __init__(self, dataset, binned, score, metrics, name,
                 applied_models):
        self.dataset, self.binned, self.score = dataset, binned, score
        self.metrics, self.name = metrics, name
        self.applied_models = applied_models


class GBDT:
    """Gradient Boosting Decision Tree driver."""

    def __init__(self, config: Config):
        self.config = config
        self.models: List = []
        self.iter = 0
        # iterations of a loaded model this booster continues from
        self.num_init_iteration = 0
        self.train_set: Optional[BinnedDataset] = None
        self.objective = None
        self.num_model = 1
        self.shrinkage_rate = config.learning_rate
        self.train_metrics = []
        self.valid_sets: List[_ValidSet] = []
        self.average_output = False
        self.loaded_objective_str = ""
        self.max_feature_idx = 0
        self.feature_names: List[str] = []
        self.feature_infos: List[str] = []
        self._grower: Optional[DeviceGrower] = None
        self.learner = None
        #: an explicit shard mesh (a list of devices, several may name one
        #: card), set before ``init_train``: the device grower's rows under
        #: ``data_sharding=single_controller`` (``ops/shard.py``) and the
        #: workers of a parallel ``tree_learner`` (``parallel/``) -- the
        #: ``LGBM_NetworkInitWithFunctions`` analog
        self.mesh = None
        self._device_stop = False
        # [seconds, trees, waves (int, device tensor or _RecStack), host
        # syncs] per dispatch: a tree of the per-iteration path, a chunk
        # of the fused one
        self._stats: List[list] = []
        self._last_chunk_stack: Optional[_RecStack] = None

    # ------------------------------------------------------------------
    def init_train(self, train_set: BinnedDataset):
        cfg = self.config
        self.device = resolve_device(cfg.device_type)
        # telemetry and fault injection arm from params; in the windowed
        # pipeline this runs once per window, so both stay additive
        obs.configure_from_config(cfg)
        faults.configure_from_config(cfg)
        # the kernel libraries' directory, process-wide as in the JAX
        # package (lightgbm_tpu/boosting/gbdt.py:223); the stage-plan store
        # follows this config alone (stage_plan.store_dir)
        compile_cache.configure_from_config(cfg)
        obs.inc("train.init_train")
        obs.instant("init_train", cat="boost", rows=int(train_set.num_data),
                    features=int(train_set.num_features))
        self._last_chunk_stack = None
        self.release_grower()
        self.train_set = train_set
        check_slice_config(cfg, train_set)
        # objective "none" (custom gradients, fobj): None, as in the JAX
        # package
        self.objective = create_objective(cfg)
        n = train_set.num_data
        md = train_set.metadata
        if self.objective is not None:
            self.objective.init(md, n, self.device)
            self.num_model = self.objective.num_model_per_iteration
            self.class_need_train = [self.objective.class_need_train(k)
                                     for k in range(self.num_model)]
        else:
            self.num_model = max(int(cfg.num_class), 1)
            self.class_need_train = [True] * self.num_model
        self.num_data = n
        self.has_init_score = md.init_score is not None
        self.train_score = self._initial_scores(md, n)
        self.train_metrics = create_metrics(cfg)
        for m in self.train_metrics:
            m.init(md, n)
        self.feature_names = list(train_set.feature_names)
        self.max_feature_idx = train_set.num_total_features - 1
        self.feature_infos = [m.feature_info_str() for m in
                              train_set.bin_mappers]
        self._grower = self.learner = None
        why = self._host_learner_reason(train_set)
        if why is not None and sharding_mode(cfg) == "multi_controller":
            # a pod host cannot fall back to the host learner: its dataset
            # may hold its own rows only, and its peers would wedge in the
            # reduction (lightgbm_tpu/boosting/gbdt.py:369-389)
            raise LightGBMError(
                "data_sharding=multi_controller requires the device grower "
                "(tree_learner=serial and an eligible configuration: no "
                "monotone constraints/renew objective/forced splits, "
                f"dataset under the striped-count bound; here: {why}) — "
                "refusing to fall back on a pod slice")
        if why is None:
            # a cached grower of equal shapes when grower_cache is on
            self._grower = acquire_grower(train_set, cfg, self.device,
                                          self.objective, self,
                                          mesh=self._shard_mesh())
            self._resolve_wave_plan()
        else:
            log_info(f"Using the host tree learner: {why}")
            self._host_learner()
        self.bag_fraction = float(cfg.bagging_fraction)
        self.bag_freq = int(cfg.bagging_freq)
        self.need_bagging = self.bag_fraction < 1.0 and self.bag_freq > 0
        # carried as the JAX package carries it (gbdt.py:288-289); the
        # device grower always reads the hessian column
        self.is_constant_hessian = bool(
            self.objective is not None
            and self.objective.is_constant_hessian and not self.need_bagging)
        # (num_data,) f32 in-bag mask of the current bagging round (device
        # grower); the host learner's bag: an index buffer whose first
        # bag_count rows are in the bag
        self.row_mask: Optional[torch.Tensor] = None
        self.bag_buffer: Optional[torch.Tensor] = None
        self.bag_count = n
        log_info(f"Training on {self.device} ({n} rows, "
                 f"{train_set.num_groups} feature groups)")

    def _resolve_wave_plan(self) -> None:
        """The stage plan's route (``lightgbm_tpu/boosting/gbdt.py:
        324-372``): ``profiled`` measures kernel 1 at each candidate
        width and grows under the derived plan (a plan already measured
        for this signature, in the process or in the store, is adopted
        without measuring); ``auto`` measures once, on first use, from
        ``stage_plan.AUTO_PROFILE_MIN_ROWS`` rows and only with a store
        (a compile cache directory this config names), and takes the
        derived plan only when it beats the legacy ladder by the 2% bar
        at the probes' worst case, keeping the verdict either way (probe times are noisy: without a store two processes of one
        config could grow different trees); otherwise the legacy
        ladder.  ``plan_profile`` keeps the measurement
        (``DeviceGrower.profile_stage_plan``'s result), or None."""
        grower = self._grower
        wp = str(self.config.wave_plan).lower()
        self.plan_profile = None
        if grower.pod is not None:
            # a probe's verdict is timing: two pod hosts measuring apart
            # could adopt different plans, and a host waiting in a
            # reduction its peers never reach wedges the pod; every host
            # keeps the ladder (lightgbm_tpu/boosting/gbdt.py:326-342)
            if wp == "profiled":
                log_warning("wave_plan=profiled is disabled under "
                            "data_sharding=multi_controller (per-host "
                            "timing verdicts may diverge); using the "
                            "fixed ladder")
            return
        if wp == "profiled":
            self.plan_profile = grower.profile_stage_plan()
        elif (wp == "auto" and grower.plan_source == "default"
              and grower.num_data >= stage_plan_mod.AUTO_PROFILE_MIN_ROWS
              and stage_plan_mod.store_dir(self.config) is not None):
            self.plan_profile = grower.profile_stage_plan(
                require_beat_legacy=True)

    def release_grower(self) -> None:
        """Hand the device grower back to the grower cache, idle, for a
        later booster (``LGBM_BoosterFree``, a new ``init_train``); this
        booster trains no more on it.  A booster that is dropped releases
        its grower the same way."""
        if self._grower is not None:
            release_grower(self._grower)
            self._grower = None

    def _host_learner_reason(self, train_set) -> Optional[str]:
        """Why the host learner trains this configuration, or None when
        the device grower does (``device_growth`` on or auto and
        ``ops/grow.host_learner_reason`` None; the JAX package's route,
        ``lightgbm_tpu/boosting/gbdt.py:291-320``)."""
        cfg = self.config
        mode = str(cfg.device_growth).lower()
        if cfg.tree_learner != "serial" and (int(cfg.num_machines) > 1
                                             or self.mesh is not None):
            # the machine-parallel learners drive the host loop
            # (lightgbm_tpu/boosting/gbdt.py:304-305)
            return f"tree_learner={cfg.tree_learner}"
        if mode == "off":
            why = "device_growth=off"
        else:
            why = host_learner_reason(cfg, train_set, self.objective)
        if why is not None and sharding_mode(cfg) == "single_controller":
            log_warning(f"data_sharding=single_controller shards the device "
                        f"grower only; the host learner trains unsharded "
                        f"({why})")
        if why is not None and mode == "on":
            log_warning(f"device_growth=on requested but the configuration "
                        f"is not eligible ({why}); falling back to the host "
                        f"learner")
        return why

    def _shard_mesh(self):
        """The device grower's shard mesh under
        ``data_sharding=single_controller``: :attr:`mesh`, else the
        process's cards (``ops/shard.resolve_shard_mesh``: None, logged,
        below two).  Under ``multi_controller`` the pod's mesh
        (:class:`~lightgbm_tpu_torch.ops.shard.PodMesh`), over
        :attr:`mesh` as this process's shards when it is set."""
        mode = sharding_mode(self.config)
        if mode == "multi_controller":
            if isinstance(self.mesh, PodMesh):
                return self.mesh
            return resolve_shard_mesh(self.config, devices=self.mesh)
        if mode != "single_controller":
            return None
        if self.mesh is not None:
            return self.mesh
        return resolve_shard_mesh(self.config)

    def _pod(self):
        """The grower's pod mesh, or None."""
        return None if self._grower is None else self._grower.pod

    def _forbid_host_path(self, what: str) -> None:
        """The host learner and the whole-data traversals index every
        row's codes; a pod host holds its own row block only, so reaching
        them under ``data_sharding=multi_controller`` fails loudly
        (``lightgbm_tpu/boosting/gbdt.py::_forbid_host_path``)."""
        if self._pod() is not None:
            raise LightGBMError(
                f"{what} is not supported under data_sharding="
                f"multi_controller: it needs the host learner's full "
                f"binned matrix, and a pod-slice host holds only its "
                f"own row block")

    def _host_learner(self):
        """The host learner, made at first use (custom gradients on a
        device-grown booster make it too, over the grower's codes), with
        the forced splits."""
        if self.learner is None:
            cfg = self.config
            codes = (None if self._grower is None
                     else self._grower.binned_t[:, :self.num_data])
            self.learner = create_tree_learner(cfg, self.train_set,
                                               self.device, mesh=self.mesh,
                                               binned_t=codes)
            if getattr(cfg, "forcedsplits_filename", ""):
                import json
                with open(cfg.forcedsplits_filename) as fh:
                    self.learner.forced_splits = json.load(fh)
                log_info(f"Loaded forced splits from "
                         f"{cfg.forcedsplits_filename}")
        return self.learner

    def _train_codes_t(self) -> torch.Tensor:
        """The training rows' ``(G, num_data)`` codes on the device, for
        whole-data traversals."""
        self._forbid_host_path("a traversal of the training rows")
        if self._grower is not None:
            return self._grower.binned_t[:, :self.num_data]
        return self._host_learner().traverse_binned

    def add_valid(self, valid_set: BinnedDataset, name: str) -> None:
        """Score ``valid_set`` (binned with the training set's mappers)
        from the next tree on; evaluated by :meth:`eval_valid`."""
        if not valid_set.check_align(self.train_set):
            raise LightGBMError(
                "cannot add validation data, since it has different bin "
                "mappers with training data")
        metrics = create_metrics(self.config)
        for m in metrics:
            m.init(valid_set.metadata, valid_set.num_data)
        score = self._initial_scores(valid_set.metadata, valid_set.num_data)
        binned = valid_set.binned
        if not isinstance(binned, torch.Tensor):
            binned = torch.from_numpy(binned)
        # models that predate the set are not applied, as in the JAX
        # package
        self.valid_sets.append(_ValidSet(
            valid_set, binned.to(self.device), score, metrics, name,
            len(self.models)))

    def _initial_scores(self, metadata, n: int) -> torch.Tensor:
        """(num_model, n) float32 scores on the device: the set's
        init_score, or zeros."""
        if metadata.init_score is None:
            return torch.zeros((self.num_model, n), dtype=torch.float32,
                               device=self.device)
        init = np.asarray(metadata.init_score, np.float64).reshape(-1)
        if len(init) != n * self.num_model:
            raise LightGBMError(
                f"Initial score size doesn't match data size: got "
                f"{len(init)}, expected num_data * num_model = "
                f"{n} * {self.num_model}")
        return torch.as_tensor(init.reshape(self.num_model, n),
                               dtype=torch.float32, device=self.device)

    def boost_from_average(self, class_id: int) -> float:
        cfg = self.config
        if self.models or self.has_init_score or self.objective is None:
            return 0.0
        if cfg.boost_from_average or self.train_set.num_features == 0:
            init_score = self.objective.boost_from_score(class_id)
            if abs(init_score) > K_EPSILON:
                self.train_score[class_id] += init_score
                log_info(f"Start training from score {init_score:f}")
                return init_score
        elif self.objective.name in ("regression_l1", "quantile", "mape"):
            log_warning(f"Disabling boost_from_average in "
                        f"{self.objective.name} may cause the slow "
                        f"convergence")
        return 0.0

    def bagging(self, it: int) -> None:
        """Redraw the bag when ``it`` starts a bagging round
        (lightgbm_tpu/boosting/gbdt.py:454-463): seed ``(bagging_seed +
        it) & 0x7FFFFFFF``, uniforms over the host learner's bagging pad
        ``bucket_size(num_data)``; the device grower's row mask and the
        host learner's index buffer hold the same draw."""
        if not self.need_bagging or it % self.bag_freq != 0:
            return
        seed = (int(self.config.bagging_seed) + it) & 0x7FFFFFFF
        if self._grower is not None:
            self.row_mask = bagging_row_mask(seed, bucket_size(max(
                self.num_data, 1)), self.num_data, self.bag_fraction,
                self.device)
        if self.learner is not None:
            self.bag_buffer, self.bag_count = self.learner.bagging_state(
                seed, self.bag_fraction)

    def _check_custom_gradients(self, gradients, hessians) -> None:
        """Custom gradients come as both arrays or neither."""
        if (gradients is None) != (hessians is None):
            raise LightGBMError("custom gradients need both gradients and "
                                "hessians")

    def _tree_multiplier(self) -> float:
        return 1.0

    def _adjust_gradients(self, grad, hess):
        return grad, hess

    def _post_bagging_adjust(self, grad, hess):
        return grad, hess

    def _device_gradients(self):
        """(grad (K, N), hess (K, N), per-class boost-from-average biases)
        of the current scores; RF overrides it with its fixed targets."""
        biases = [self.boost_from_average(k) for k in range(self.num_model)]
        grad, hess = self.objective.get_gradients(self.train_score)
        if grad.dim() == 1:
            grad, hess = grad[None], hess[None]
        grad, hess = self._adjust_gradients(grad, hess)
        return grad, hess, biases

    # ------------------------------------------------------------------
    @property
    def tree_stats(self) -> List[Tuple[float, int, int, int]]:
        """(seconds, trees, waves, host syncs) per dispatch: a tree of the
        per-iteration path, a chunk of the fused path.  Seconds are the
        host's clock around the dispatch (a fused chunk is not
        synchronized: its lagged stall check waits for the previous
        one).  Waves are read here, lagged (a host read)."""
        out = []
        for secs, trees, waves, syncs in self._stats:
            if isinstance(waves, _RecStack):
                waves = int(waves.host()[3].sum())
            out.append((secs, trees, int(waves), syncs))
        return out

    def train_one_iter(self, gradients=None, hessians=None) -> bool:
        """One boosting iteration, a tree a class
        (``lightgbm_tpu/boosting/gbdt.py:609-675``); returns True when
        training should stop (every class's tree is a stump: no leaf
        meets the split requirements).  Gradients, the bagging draw and
        the shrinkage come through the hooks GOSS, DART and RF override;
        the trees grow in :meth:`_grow_trees`, with no host read.

        The stump check reads the K trees' leaf counts in one copy as
        soon as they are grown: the one host sync of the per-iteration
        path.  (The JAX package checks with a 4-iteration lag to keep its
        dispatch pipeline full, and trims the extra stumps afterwards.)
        A class with nothing to learn (``class_need_train``) gets a fixed
        stump, which carries the class's score in the first iteration.
        Custom gradients (``fobj``: ``(K, N)``-shaped arrays) and the
        configurations the device grower does not take run on the host
        learner (:meth:`_train_one_iter_host`).  With telemetry on, the
        iteration is a ``train.iter`` span (it syncs with the card only
        under sync profiling)."""
        self._check_custom_gradients(gradients, hessians)
        host = self._grower is None or gradients is not None
        run = (lambda: self._train_one_iter_host(gradients, hessians)) \
            if host else self._train_one_iter
        if not obs.enabled():
            return run()
        with obs.span("train.iter", cat="boost", iteration=self.iter,
                      path="host" if host else "device") as sp:
            out = run()
            sp.sync_value = self.train_score
        obs.sample_device_memory()
        return out

    def _train_one_iter(self) -> bool:
        if self._device_stop:
            return True
        K = self.num_model
        if not any(self.class_need_train):
            # one-class labels: a fixed stump carrying the class's score
            if not self.models:
                for k in range(K):
                    tree = Tree(2)
                    tree.leaf_value[0] = self.objective.boost_from_score(k)
                    self.train_score[k] += tree.leaf_value[0]
                    self.models.append(tree)
            self._device_stop = True
            return True
        t0 = time.perf_counter()
        grad, hess, biases = self._device_gradients()
        self.bagging(self.iter)
        grad, hess = self._post_bagging_adjust(grad, hess)
        shrink = self.shrinkage_rate * self._tree_multiplier()
        nls, waves = self._grow_trees(grad, hess, biases, shrink)
        self.iter += 1
        # the iteration's host sync: every trained class's leaf count
        stump = bool((torch.stack(nls) <= 1).all())
        self._stats.append([time.perf_counter() - t0, len(nls),
                            torch.stack(waves).sum(), 1])
        if stump:
            self._device_stop = True
            self._flush_pending()
            log_warning("Stopped training because there are no more leaves "
                        "that meet the split requirements")
            return True
        return False

    def _train_one_iter_host(self, gradients=None, hessians=None) -> bool:
        """One iteration on the host learner
        (``lightgbm_tpu/boosting/gbdt.py:501-608``): a tree a class from
        the objective's gradients or the caller's, each renewed
        (:meth:`_renew_tree_output`), shrunk and added to the training
        scores through the learner's partition (or, under bagging, by the
        binned traversal of every row).  The validation sets take the
        trees at evaluation time.  Returns True when every class's tree
        is a stump."""
        self._forbid_host_path("host-path training (custom gradients "
                               "or device_growth fallback)")
        learner = self._host_learner()
        if self._grower is not None:
            # a device-grown booster taking custom gradients
            self._flush_pending()
        K = self.num_model
        if gradients is None:
            # the objective's (or RF's fixed) gradients, the hooks applied
            grad, hess, init_scores = self._device_gradients()
        else:
            init_scores = [0.0] * K
            grad = torch.as_tensor(np.asarray(gradients, np.float32)
                                   .reshape(K, -1), device=self.device)
            hess = torch.as_tensor(np.asarray(hessians, np.float32)
                                   .reshape(K, -1), device=self.device)
            grad, hess = self._adjust_gradients(grad, hess)
        if self.bag_buffer is None:
            # the learner was made after the round's draw
            self._sync_fused_bagging()
        self.bagging(self.iter)
        grad, hess = self._post_bagging_adjust(grad, hess)
        shrink = self.shrinkage_rate * self._tree_multiplier()
        should_continue = False
        for k in range(K):
            tree = Tree(2)
            if self.class_need_train[k] and self.train_set.num_features > 0:
                tree = learner.train(
                    grad[k], hess[k], indices_buffer=self.bag_buffer,
                    data_count=self.bag_count
                    if self.bag_buffer is not None else None)
            if tree.num_leaves > 1:
                should_continue = True
                self._renew_tree_output(tree, k)
                tree.apply_shrinkage(shrink)
                self._update_score_host(tree, k)
                if abs(init_scores[k]) > K_EPSILON:
                    tree.add_bias(init_scores[k])
            elif len(self.models) < K:
                if not self.class_need_train[k]:
                    output = (self.objective.boost_from_score(k)
                              if self.objective is not None else 0.0)
                else:
                    output = init_scores[k]
                tree = Tree(2)
                tree.leaf_value[0] = output
                if abs(output) > K_EPSILON:
                    self.train_score[k] += output
            self.models.append(tree)
        if not should_continue:
            log_warning("Stopped training because there are no more leaves "
                        "that meet the split requirements")
            if len(self.models) > K:
                del self.models[-K:]
            return True
        self.iter += 1
        return False

    def _renew_tree_output(self, tree: Tree, class_id: int) -> None:
        """Percentile leaf renewal of the L1-style objectives
        (serial_tree_learner.cpp:780-818,
        ``lightgbm_tpu/boosting/gbdt.py::_renew_tree_output``): each leaf's
        output becomes the objective's percentile of its rows' residuals
        (one copy of the scores and the partition to the host)."""
        obj = self.objective
        if obj is None or not obj.is_renew_tree_output:
            return
        score = self.train_score[class_id].double().cpu().numpy()
        label = np.asarray(obj.label, np.float64)
        w = obj.label_weight if obj.name == "mape" else obj.weights
        for leaf, rows in self.learner.leaf_indices_host().items():
            if len(rows) == 0:
                continue
            residuals = label[rows] - score[rows]
            lw = w[rows] if w is not None else None
            tree.leaf_value[leaf] = obj.renew_tree_output(
                tree.leaf_value[leaf], residuals, lw)

    def _update_score_host(self, tree: Tree, class_id: int) -> None:
        """Add a host-learned tree to the training scores: through the
        partition, or under bagging (out-of-bag rows are in no window) by
        the binned traversal of every row."""
        if self.bag_buffer is not None and self.bag_count < self.num_data:
            dt = device_tree(tree, self.train_set, self.config.num_leaves,
                             self.device)
            self.train_score[class_id] = add_tree_score(
                self.train_score[class_id], self._train_codes_t(), dt, 1.0,
                groups_major=True)
        else:
            self.learner.update_score(self.train_score[class_id], tree)

    def _grow_trees(self, grad, hess, biases, shrink):
        """One tree a class on the device, pending in ``models``; returns
        the trained classes' (leaf counts, waves) as device tensors.  Reads
        nothing back to the host."""
        K = self.num_model
        first_iter = len(self.models) < K
        nls, waves = [], []
        for k in range(K):
            if not self.class_need_train[k]:
                tree = Tree(2)
                if first_iter:
                    tree.leaf_value[0] = self.objective.boost_from_score(k)
                    self.train_score[k] += tree.leaf_value[0]
                self.models.append(tree)
                continue
            tree_idx = self.iter * K + k
            fmask = self._grower.feature_mask_for(tree_idx)
            res = self._dispatch_guard(lambda: self._grower.grow_one_iter(
                self.train_score[k], grad[k], hess[k], shrink,
                feature_mask=fmask, row_mask=self.row_mask,
                tree_idx=tree_idx))
            self.train_score[k] = res.score
            self.models.append(_PendingTree(res.rec_i, res.rec_f, res.rec_c,
                                            res.num_leaves, shrink,
                                            biases[k]))
            nls.append(res.num_leaves)
            waves.append(res.waves)
        return nls, waves

    def _dispatch_guard(self, fn):
        """Run a device-dispatch thunk under the ``grow.dispatch`` fault
        site with ``dispatch_retries`` bounded retries on transient errors
        (``lightgbm_tpu/boosting/gbdt.py::_dispatch_guard``).  The site is
        checked before the dispatch, so a retried dispatch starts from the
        same inputs.  Only injected faults, ``OSError`` and
        ``TimeoutError`` are retried: a CUDA error raises at once
        (``robust/retry.py::transient_dispatch_errors``)."""
        def attempt():
            faults.check("grow.dispatch")
            return fn()
        retries = int(getattr(self.config, "dispatch_retries", 2))
        if retries <= 0:
            return attempt()
        policy = RetryPolicy(max_attempts=retries + 1, base_delay_s=0.05,
                             max_delay_s=1.0,
                             retry_on=_TRANSIENT_DISPATCH)
        return with_retries(attempt, policy, site="grow.dispatch")

    # ------------------------------------------------------------------
    # fused multi-iteration path: a chunk of trees per dispatch
    def _fused_grad_fn(self):
        """The objective's ``device_grad`` pair when fused training is
        sound for the current state, else None
        (``lightgbm_tpu/boosting/gbdt.py:680-704``): plain GBDT, one model
        per iteration, features to split on, and an objective with a pure
        device gradient that has a class to train."""
        if (self._grower is None or type(self) is not GBDT
                or self.num_model != 1
                or self.train_set.num_features == 0
                or self.objective is None
                or not self.class_need_train[0]):
            return None
        return self.objective.device_grad()

    def fused_eligible(self) -> bool:
        """Whether :meth:`train_chunked` will actually fuse."""
        return self._fused_grad_fn() is not None

    def train_chunked(self, n_iters: int, chunk: int = 20,
                      snapshot_freq: int = 0,
                      snapshot_path: str = "") -> bool:
        """Train ``n_iters`` boosting iterations, ``chunk`` whole
        iterations a dispatch when the configuration allows (see
        :meth:`_train_chunked_inner`).  Returns True when training stopped
        early.  With ``snapshot_freq > 0`` each dispatch is also cut at
        the snapshot boundaries and an atomic checkpoint
        (``<snapshot_path>.snapshot_iter_N`` and its exact-score sidecar,
        :meth:`save_checkpoint`) is written every ``snapshot_freq``
        iterations (``lightgbm_tpu/boosting/gbdt.py::train_chunked``); a
        killed run resumes from the last one
        (:meth:`resume_from_checkpoint`)."""
        freq = int(snapshot_freq)
        if freq <= 0 or n_iters <= 0:
            return self._train_chunked_inner(n_iters, chunk)
        path = str(snapshot_path
                   or self.config.output_model or "LightGBM_model.txt")
        done = 0
        while done < n_iters:
            step = min(n_iters - done, freq - self.iter % freq)
            before = self.iter
            stopped = self._train_chunked_inner(step, chunk)
            done += self.iter - before
            if (self.iter > before and self.iter % freq == 0
                    and not stopped):
                with obs.span("train.snapshot", cat="boost",
                              iteration=self.iter):
                    self.save_checkpoint(
                        f"{path}.snapshot_iter_{self.iter}")
                obs.inc("train.snapshots")
            if stopped:
                return True
        return False

    def _train_chunked_inner(self, n_iters: int, chunk: int = 20) -> bool:
        """The chunked training core (``lightgbm_tpu/boosting/gbdt.py:
        750-825``).  Each chunk is ``DeviceGrower.fused_train``: one
        key-table copy and ``chunk`` launches of the captured tree on the
        card, no host read between its first and last tree.  Same
        gradients, trees and scores as the per-iteration path; the stall
        check reads the PREVIOUS chunk's leaf counts (their copy landed
        while this chunk was queued), and ``_flush_pending`` trims the
        trailing stump iterations.  A remainder shorter than the chunk
        runs per-iteration (another chunk length would capture nothing
        new but needs the same checks)."""
        fg = self._fused_grad_fn()
        chunk = min(chunk, n_iters)
        if fg is None or chunk <= 1:
            for _ in range(n_iters):
                if self.train_one_iter():
                    return True
            return False
        done = 0
        fused_ran = False
        while done < n_iters:
            if self._device_stop:
                return True
            k = min(chunk, n_iters - done)
            if k < chunk:
                if fused_ran:
                    self._sync_fused_bagging()
                for _ in range(k):
                    if self.train_one_iter():
                        return True
                return False
            t0 = time.perf_counter()
            bias = self.boost_from_average(0) if not self.models else 0.0
            shrink = self.shrinkage_rate
            out = self._dispatch_guard(lambda: self._grower.fused_train(
                chunk, self.train_score[0], shrink, self.iter, fg))
            self.train_score[0].copy_(out.score)
            stack = _RecStack((out.rec_i, out.rec_f, out.nl, out.waves,
                               out.qscales, out.rec_c), self.device)
            for i in range(chunk):
                self.models.append(_PendingChunkTree(
                    stack, i, shrink, bias if i == 0 else 0.0))
            self.iter += chunk
            done += chunk
            fused_ran = True
            # lagged stall check: the previous chunk's records
            prev, self._last_chunk_stack = self._last_chunk_stack, stack
            stall = prev is not None and (prev.host()[2] <= 1).all()
            self._stats.append([time.perf_counter() - t0, chunk, stack,
                                int(prev is not None)])
            if obs.enabled():
                self._obs_chunk(t0, chunk)
            if stall:
                self._trim_device_stumps()
                return True
        if fused_ran:
            self._sync_fused_bagging()
        return False

    def _obs_chunk(self, t0: float, chunk: int) -> None:
        """Record one fused chunk: a ``train.chunk`` span and ``chunk``
        ``train.iter`` observations of the chunk's mean, so iteration
        counts and percentiles compare with the per-iteration path.
        Without sync profiling this times the host's dispatch, not the
        card (the chunk is not waited for)."""
        if obs.STATE.sync:
            obs._wait_for(self.train_score)
        dt = time.perf_counter() - t0
        reg = obs.registry()
        reg.observe("train.chunk", dt)
        reg.inc("train.fused_chunks")
        reg.set_gauge("train.fused_chunk_len", chunk)
        obs.STATE.trace.add("train.chunk", cat="boost", t0=t0, dur=dt,
                            args={"iteration": self.iter, "chunk": chunk})
        for _ in range(chunk):
            reg.observe("train.iter", dt / chunk)
        obs.sample_device_memory()

    def _sync_fused_bagging(self) -> None:
        """Set ``row_mask`` (and the host learner's ``bag_buffer``) to
        what a per-iteration run would hold at
        ``self.iter`` (``lightgbm_tpu/boosting/gbdt.py:827``): fused chunks
        redraw their masks on the card, so a later per-iteration step
        (the chunk remainder, ``Booster.update``) first takes the draw of
        the last round that started at or before ``self.iter - 1``."""
        if not self.need_bagging or self.iter <= 0:
            return
        last_done = self.iter - 1
        start = last_done - last_done % self.bag_freq
        if self._grower is not None:
            self.row_mask = self._grower.bag_mask_at(start)
        if self.learner is not None:
            self.bag_buffer, self.bag_count = self.learner.bagging_state(
                (int(self.config.bagging_seed) + start) & 0x7FFFFFFF,
                self.bag_fraction)

    def _trim_device_stumps(self) -> None:
        """Stop after the lagged check saw a chunk of stumps, dropping the
        trailing stump iterations (a first stump carrying the
        boost-from-average bias stays)."""
        self._device_stop = True
        self._flush_pending()
        log_warning("Stopped training because there are no more leaves "
                    "that meet the split requirements")

    def _flush_pending(self):
        """Replay every device-grown tree into a host ``Tree``, then drop
        trailing stump iterations (the stop condition), keeping a first
        stump that carries the boost-from-average bias."""
        pending = [i for i, m in enumerate(self.models)
                   if isinstance(m, _PENDING)]
        if pending:
            with obs.span("flush_pending", cat="boost", trees=len(pending)):
                for i in pending:
                    self.models[i] = self.models[i].materialize(
                        self.train_set, self.config)
        nm = max(self.num_model, 1)
        while (len(self.models) > nm
               and all(t.num_leaves <= 1 for t in self.models[-nm:])):
            del self.models[-nm:]
            self.iter -= 1
            self._device_stop = True

    def eval_train(self) -> List[Tuple[str, str, float, bool]]:
        score = self.train_score.double().cpu().numpy()
        return [("training", name, value, m.bigger_is_better)
                for m in self.train_metrics
                for name, value in m.eval(score, self.objective)]

    def _catch_up_valid_scores(self) -> None:
        """Add the models each valid set has not taken yet to its scores: a
        tree by the binned traversal, a stump (the boost-from-average bias,
        or a one-class constant) as its constant."""
        if not self.valid_sets:
            return
        self._flush_pending()
        total = len(self.models)
        for v in self.valid_sets:
            while v.applied_models < total:
                idx = v.applied_models
                tree = self.models[idx]
                k = idx % self.num_model
                if tree.num_leaves > 1:
                    dt = device_tree(tree, self.train_set,
                                     self.config.num_leaves, self.device)
                    v.score[k] = add_tree_score(v.score[k], v.binned, dt, 1.0)
                elif abs(tree.leaf_value[0]) > K_EPSILON:
                    v.score[k] = add_constant_score(v.score[k],
                                                    tree.leaf_value[0])
                v.applied_models = idx + 1

    def eval_valid(self) -> List[Tuple[str, str, float, bool]]:
        self._catch_up_valid_scores()
        out = []
        for v in self.valid_sets:
            # torchlint: disable-next=TL001 -- metrics run on the host in f64
            score = v.score.double().cpu().numpy()
            out.extend((v.name, name, value, m.bigger_is_better)
                       for m in v.metrics
                       for name, value in m.eval(score, self.objective))
        return out

    def num_iterations(self) -> int:
        return len(self.models) // max(self.num_model, 1)

    def rollback_one_iter(self) -> None:
        """Remove the last iteration's trees and their scores
        (gbdt.cpp:414-430; ``lightgbm_tpu/boosting/gbdt.py::
        rollback_one_iter``): each tree is subtracted from the training
        scores by the binned traversal of every row, and from a valid
        set's scores when that set has taken it (valid sets take trees at
        evaluation time).  A stump is not subtracted, as in the JAX
        package."""
        if not self.models:
            return
        self._forbid_host_path("rollback_one_iter")
        self._flush_pending()
        K = self.num_model
        base = len(self.models) - K
        for k in range(K):
            tree = self.models[base + k]
            if tree.num_leaves > 1:
                dt = device_tree(tree, self.train_set, self.config.num_leaves,
                                 self.device)
                self.train_score[k] = add_tree_score(
                    self.train_score[k], self._train_codes_t(), dt, -1.0,
                    groups_major=True)
                for v in self.valid_sets:
                    if v.applied_models > base + k:
                        v.score[k] = add_tree_score(v.score[k], v.binned,
                                                    dt, -1.0)
        del self.models[-K:]
        for v in self.valid_sets:
            v.applied_models = min(v.applied_models, len(self.models))
        self.iter -= 1
        self._last_chunk_stack = None

    # ------------------------------------------------------------------
    # prediction (raw host data)
    def _early_stop_instance(self):
        """Row-wise prediction early stopping
        (src/boosting/prediction_early_stop.cpp): binary stops a row once
        2*|margin| exceeds the threshold, multiclass once the top-two
        class margin does; checked every ``pred_early_stop_freq``
        iterations."""
        cfg = self.config
        if not cfg.pred_early_stop:
            return None
        obj_name = (self.objective.name if self.objective is not None
                    else (self.loaded_objective_str.split()[0]
                          if self.loaded_objective_str else ""))
        margin = float(cfg.pred_early_stop_margin)
        freq = max(int(cfg.pred_early_stop_freq), 1)
        if obj_name.startswith("binary") and self.num_model == 1:
            return freq, lambda out: 2.0 * np.abs(out[0]) > margin
        if self.num_model > 1:
            def mc(out):
                part = np.partition(out, self.num_model - 2, axis=0)
                return part[-1] - part[-2] > margin
            return freq, mc
        log_warning("pred_early_stop is only supported for binary and "
                    "multiclass objectives; ignoring")
        return None

    def _predict_raw_packed(self, data, end_iter, start_iteration):
        """Batch prediction through the packed-forest kernel
        (``serve/packed.py``, ``csrc/forest_predict.cu``): the tree slice
        is flattened into padded tensors on ``config.device_type`` and the
        batch routes through every tree in one launch.  Leaf routing is
        the host walk's; values are summed in float32 (the host walk sums
        in float64: ~1e-6 relative apart).

        The pack is cached per (slice, model count, device): training
        more trees changes ``len(self.models)`` and invalidates it;
        editing a Tree's leaves in place does not."""
        from ..serve.packed import pack_ensemble, predict_scores
        key = (start_iteration, end_iter, len(self.models), self.num_model,
               self.config.device_type)
        cached = getattr(self, "_packed_cache", None)
        if cached is None or cached[0] != key:
            pe = pack_ensemble(self.models, self.num_model,
                               start_iteration=start_iteration,
                               num_iteration=end_iter - start_iteration,
                               num_features=self.max_feature_idx + 1,
                               device=resolve_device(
                                   self.config.device_type))
            self._packed_cache = cached = (key, pe)
        return predict_scores(cached[1], data)

    def _device_predict_wanted(self, n: int, early,
                               on_card: bool = False) -> bool:
        """``device_predict`` force/off override the
        ``device_predict_min_rows`` threshold of auto; rows already on the
        card (``on_card``) take the kernel at any count.  Row-wise early
        stopping is host-only (the kernel runs every tree): it refuses
        rows on the card rather than copy them off it."""
        mode = str(self.config.device_predict).lower()
        if mode == "off":
            return False
        if early is not None:
            if on_card:
                raise LightGBMError(
                    "pred_early_stop walks the trees on the host; predict "
                    "rows on the card without it, or pass them as a host "
                    "array")
            return False
        if mode == "force" or on_card:
            return True
        return n >= int(self.config.device_predict_min_rows)

    def predict_raw(self, data: np.ndarray, num_iteration: int = -1,
                    start_iteration: int = 0,
                    batch_rows: Optional[int] = None) -> np.ndarray:
        """(num_model, N) float64 raw scores of iterations
        ``[start_iteration, start_iteration + num_iteration)``: through
        the packed-forest kernel (:meth:`_device_predict_wanted`) or by the
        host tree walk in float64.  ``data`` is a float32 or float64
        matrix, or a tensor (the raw rows of a tensor Dataset, read where
        they lie by the kernel: a tensor on the card always goes through
        it, unless ``device_predict=off``); the kernel reads either type as
        it is.
        ``batch_rows``: the rows of the whole batch when ``data`` is one
        chunk of it (the route is chosen on it, so every chunk takes the
        same one)."""
        self._flush_pending()
        if not isinstance(data, torch.Tensor):
            data = np.asarray(data)
        n = data.shape[0]
        total_iter = self.num_iterations()
        start_iteration = max(0, min(int(start_iteration), total_iter))
        end_iter = total_iter if num_iteration <= 0 \
            else min(start_iteration + num_iteration, total_iter)
        early = self._early_stop_instance()
        on_card = (isinstance(data, torch.Tensor) and data.is_cuda
                   and resolve_device(self.config.device_type).type
                   == "cuda")
        if (n > 0 and end_iter > start_iteration
                and self._device_predict_wanted(
                    n if batch_rows is None else int(batch_rows), early,
                    on_card)):
            out = self._predict_raw_packed(data, end_iter, start_iteration)
        else:
            if isinstance(data, torch.Tensor):
                data = data.cpu().numpy()
            out = self._predict_raw_host(
                np.ascontiguousarray(data, np.float64), start_iteration,
                end_iter, early)
        if self.average_output and end_iter > start_iteration:
            out /= (end_iter - start_iteration)
        return out

    def _predict_raw_host(self, data, start_iteration, end_iter, early):
        out = np.zeros((self.num_model, data.shape[0]), np.float64)
        active = None if early is None else np.ones(data.shape[0], bool)
        for it in range(start_iteration, end_iter):
            for k in range(self.num_model):
                tree = self.models[it * self.num_model + k]
                if active is None or active.all():
                    out[k] += tree.predict(data)
                else:
                    out[k, active] += tree.predict(data[active])
            if early is not None and (it + 1 - start_iteration) \
                    % early[0] == 0:
                active &= ~early[1](out)
                if not active.any():
                    break
        return out

    def predict(self, data, num_iteration: int = -1, raw_score=False,
                pred_leaf=False, start_iteration: int = 0,
                batch_rows: Optional[int] = None, pred_contrib=False):
        """Converted (or raw) predictions, (N,) or (N, num_model); with
        ``pred_leaf`` the (N, trees) leaf index of each tree of the slice,
        by the host walk; with ``pred_contrib`` the TreeSHAP feature
        contributions (:meth:`_predict_contrib`).  ``batch_rows`` as in
        :meth:`predict_raw`."""
        self._flush_pending()
        if pred_contrib:
            return self._predict_contrib(data, num_iteration)
        if pred_leaf:
            data = np.ascontiguousarray(data, np.float64)
            total_iter = self.num_iterations()
            start_iteration = max(0, min(start_iteration, total_iter))
            end_iter = total_iter if num_iteration <= 0 \
                else min(start_iteration + num_iteration, total_iter)
            base = start_iteration * self.num_model
            n_trees = max(end_iter - start_iteration, 0) * self.num_model
            leaves = np.zeros((data.shape[0], n_trees), np.int32)
            for i in range(n_trees):
                leaves[:, i] = self.models[base + i].predict_leaf(data)
            return leaves
        raw = self.predict_raw(data, num_iteration, start_iteration,
                               batch_rows)
        # averaged-output models (RF) already emit converted values
        if not raw_score and not self.average_output:
            if self.objective is not None:
                raw = self.objective.convert_output(raw)
            elif self.loaded_objective_str:
                raw = _convert_by_name(self.loaded_objective_str, raw)
        return raw[0] if self.num_model == 1 else raw.T

    def _predict_contrib(self, data, num_iteration: int = -1) -> np.ndarray:
        """(N, F + 1) TreeSHAP contributions, the last column the expected
        value, or (N, num_model * (F + 1)) for several models, of the first
        ``num_iteration`` iterations (``lightgbm_tpu/boosting/gbdt.py::
        _predict_contrib``): host float64, rows in chunks of 4,096."""
        data = np.ascontiguousarray(np.asarray(data, np.float64))
        n = data.shape[0]
        nf = self.max_feature_idx + 1
        total_iter = self.num_iterations()
        end_iter = total_iter if num_iteration <= 0 \
            else min(num_iteration, total_iter)
        out = np.zeros((n, self.num_model, nf + 1), np.float64)
        chunk = 4096
        for lo in range(0, n, chunk):
            hi = min(lo + chunk, n)
            for it in range(end_iter):
                for k in range(self.num_model):
                    tree_shap_batch(self.models[it * self.num_model + k],
                                    data[lo:hi], out[lo:hi, k])
        if self.num_model == 1:
            return out[:, 0, :]
        return out.reshape(n, -1)

    def feature_importance(self, importance_type: str = "split",
                           iteration: int = -1) -> np.ndarray:
        """(num_features,) float64 per-feature split counts ("split") or
        summed positive split gains ("gain") over the first ``iteration``
        iterations (all when ``<= 0``), as the JAX package's
        ``feature_importance``."""
        self._flush_pending()
        out = np.zeros(self.max_feature_idx + 1, np.float64)
        total_iter = self.num_iterations()
        end_iter = total_iter if iteration <= 0 \
            else min(iteration, total_iter)
        for tree in self.models[:end_iter * self.num_model]:
            for node in range(tree.num_leaves - 1):
                f = tree.split_feature[node]
                if importance_type == "split":
                    out[f] += 1
                else:
                    out[f] += max(tree.split_gain[node], 0.0)
        return out

    # ------------------------------------------------------------------
    # model text (gbdt_model_text.cpp:243-330 format "v2")
    def model_to_string(self, start_iteration: int = 0,
                        num_iteration: int = -1) -> str:
        """The model text of iterations ``[start_iteration,
        start_iteration + num_iteration)`` (to the last when
        ``num_iteration <= 0``), numbered from 0; the feature importances
        block counts every tree, as the JAX package's does."""
        self._flush_pending()
        label_index = (int(self.config.label_column or 0)
                       if str(self.config.label_column).isdigit() else 0)
        lines = ["tree", f"version={MODEL_VERSION}",
                 f"num_class={max(int(self.config.num_class), 1)}",
                 f"num_tree_per_iteration={self.num_model}",
                 f"label_index={label_index}",
                 f"max_feature_idx={self.max_feature_idx}"]
        if self.objective is not None:
            lines.append(f"objective={self.objective.to_string()}")
        elif self.loaded_objective_str:
            lines.append(f"objective={self.loaded_objective_str}")
        if self.average_output:
            lines.append("average_output")
        lines.append("feature_names=" + " ".join(self.feature_names))
        lines.append("feature_infos=" + " ".join(self.feature_infos))

        total_iter = self.num_iterations()
        start_iteration = max(0, min(int(start_iteration), total_iter))
        num_used = total_iter * self.num_model
        if num_iteration > 0:
            num_used = min((start_iteration + num_iteration)
                           * self.num_model, num_used)
        start_model = start_iteration * self.num_model
        tree_strs = [f"Tree={i - start_model}\n"
                     + self.models[i].to_string()
                     for i in range(start_model, num_used)]
        lines.append("tree_sizes=" + " ".join(str(len(s) + 1)
                                              for s in tree_strs))
        lines.append("")
        body = "\n".join(lines)
        for s in tree_strs:
            body += s + "\n"
        body += "end of trees\n"
        counts = self.feature_importance("split").astype(np.int64)
        body += "\nfeature importances:\n"
        for i in np.argsort(-counts, kind="stable"):
            if counts[i] > 0:
                body += f"{self.feature_names[i]}={counts[i]}\n"
        body += "\nparameters:\n"
        body += self._params_string()
        body += "\nend of parameters\n"
        return body

    def _params_string(self) -> str:
        out = []
        for p in PARAM_BY_NAME.values():
            v = getattr(self.config, p.name, p.default)
            if isinstance(v, list):
                v = ",".join(str(x) for x in v)
            out.append(f"[{p.name}: {v}]")
        return "\n".join(out)

    # ------------------------------------------------------------------
    # training checkpoints (lightgbm_tpu/boosting/gbdt.py:1377-1487)
    def save_checkpoint(self, path: str) -> None:
        """Atomic training checkpoint: the full model text at ``path`` and
        a ``.state.npz`` sidecar with the exact float32 training scores,
        the iteration counter and the host learner's feature_fraction RNG
        state (when it trains), both written temp-then-rename.  Reads the
        scores off the card (one host sync).  Under
        ``data_sharding=multi_controller`` this is the pod commit protocol
        (``robust/checkpoint.py``): every host acks its state digest, host
        0 writes the files and the commit marker only once every ack has
        landed, and peers wait for the marker; a host killed mid-window
        leaves the snapshot uncommitted."""
        self._flush_pending()
        if self._pod() is not None:
            self._save_checkpoint_pod(path)
            return
        _checkpoint.atomic_write_text(path, self.model_to_string())
        rng = getattr(self.learner, "_rng", None)
        _checkpoint.save_train_state(
            path + ".state.npz", self.train_score.cpu().numpy(), self.iter,
            rng_state=rng.get_state() if rng is not None else None)
        log_info(f"Saved training checkpoint to {path}")

    def _save_checkpoint_pod(self, path: str) -> None:
        """The pod commit protocol of :meth:`save_checkpoint`
        (``lightgbm_tpu/boosting/gbdt.py::_save_checkpoint_pod``)."""
        from ..parallel.network import network_policy_from_config
        pod = self._pod()
        rank, hosts = pod.rank, pod.hosts
        model_str = self.model_to_string()
        score = self.train_score.cpu().numpy()
        # the digest covers the trees only: the parameters echo differs
        # per host (host_rank), the trees must not
        digest = _checkpoint.pod_state_digest(
            model_str.split("\nparameters:", 1)[0], score, self.iter)
        attempts, timeout_s = network_policy_from_config(self.config)
        deadline = max(10.0, float(attempts) * float(timeout_s))
        _checkpoint.write_pod_ack(path, rank, digest)
        if rank == 0:
            _checkpoint.await_pod_acks(path, hosts, digest,
                                       timeout_s=deadline)
            # clear before the commit marker: a peer starts its next ack
            # only after it saw this commit, so clearing after it could
            # delete a peer's fresh ack
            _checkpoint.clear_pod_acks(path, hosts)
            _checkpoint.atomic_write_text(path, model_str)
            rng = getattr(self.learner, "_rng", None)
            _checkpoint.save_train_state(
                path + ".state.npz", score, self.iter,
                rng_state=rng.get_state() if rng is not None else None)
            _checkpoint.commit_pod(path, digest)
            log_info(f"Committed pod checkpoint {path} ({hosts} host acks)")
        else:
            _checkpoint.await_pod_commit(path, digest, timeout_s=deadline)

    def resume_from_checkpoint(self, path: str) -> "GBDT":
        """Adopt a :meth:`save_checkpoint` snapshot after ``init_train`` on
        the same data: the snapshot's trees replace the model list, the
        sidecar's scores are copied into the training score buffer on the
        card (in place: a captured tree reads it by address), and the
        bagging draw of the last redraw boundary is re-made.  Bagging,
        feature_fraction and int8 quantization are Threefry draws keyed on
        the iteration, and the host learner's feature_fraction stream is
        restored from the sidecar, so continued boosting is byte-identical
        to the uninterrupted run."""
        if self.train_set is None:
            raise LightGBMError(
                "resume_from_checkpoint requires init_train first "
                "(the training scores are sized by the dataset)")
        if self._pod() is not None and not _checkpoint.has_pod_commit(path):
            # a snapshot some host never acked may be mid-write or differ
            # across the pod; resuming from it would diverge the pod
            raise LightGBMError(
                f"snapshot {path} has no pod commit marker "
                f"({_checkpoint.pod_commit_path(path)}); refusing to "
                f"resume a pod slice from an uncommitted snapshot")
        state = _checkpoint.load_train_state(path + ".state.npz")
        if state is None:
            raise LightGBMError(
                f"snapshot {path} has no state sidecar "
                f"({path}.state.npz); cannot resume exactly")
        score, it, rng_state = state
        if score.shape != (self.num_model, self.num_data):
            raise LightGBMError(
                f"snapshot scores have shape {score.shape}, this dataset "
                f"needs {(self.num_model, self.num_data)} — resume must use "
                f"the SAME training data")
        loaded = GBDT.load_model_from_file(path)
        if len(loaded.models) != it * max(self.num_model, 1):
            raise LightGBMError(
                f"snapshot {path} holds {len(loaded.models)} trees but "
                f"claims iteration {it}")
        self.models = list(loaded.models)
        self.iter = int(it)
        self.train_score.copy_(torch.from_numpy(score).to(self.device))
        self._device_stop = False
        self._last_chunk_stack = None
        rng = getattr(self.learner, "_rng", None)
        if rng_state is not None and rng is not None:
            rng.set_state(rng_state)
        # the per-iteration path continues mid-round: re-make the bagging
        # draw active after iteration (iter - 1)
        self._sync_fused_bagging()
        log_info(f"Resumed training from {path} (iteration {self.iter})")
        return self

    # ------------------------------------------------------------------
    # leaf refit on new data (reference GBDT::RefitTree, gbdt.cpp:265-288;
    # lightgbm_tpu/boosting/gbdt.py:1207-1290)
    def _refit_objective(self):
        """A fresh objective for refit gradients (the live training
        objective keeps its own labels): the trained objective's name, or
        a loaded model's objective line with its ``key:value`` extras."""
        if self.objective is not None:
            name = self.objective.name
            extras = {}
        elif self.loaded_objective_str:
            toks = self.loaded_objective_str.split()
            name = toks[0]
            extras = dict(t.split(":", 1) for t in toks[1:] if ":" in t)
        else:
            name = "regression"
            extras = {}
        if name in ("none", ""):
            raise LightGBMError(
                "refit requires an objective; this model was trained "
                "with a custom objective function")
        keys = ("sigmoid", "alpha", "fair_c", "poisson_max_delta_step",
                "tweedie_variance_power", "scale_pos_weight",
                "is_unbalance", "reg_sqrt", "num_class", "max_position",
                "label_gain")
        params = {k: getattr(self.config, k) for k in keys}
        params.update(extras)
        params["objective"] = name
        params["num_class"] = max(self.num_model, 1)
        return create_objective(Config(params))

    def refit_leaves(self, data, label, decay_rate: float = 0.9,
                     leaf_ids=None) -> "GBDT":
        """Refit every tree's leaf values in place against ``label``,
        keeping the routing: a leaf that receives rows takes ``decay *
        old + (1 - decay) * optimal * learning_rate``, where ``optimal``
        is the regularized leaf output of the new rows' gradients; a leaf
        without rows keeps its value bit for bit.

        ``data`` is a dense raw-feature matrix, walked on the host; or
        ``leaf_ids`` gives each tree's (N,) leaf ids (None for a stump),
        as the pipeline's binned traversal on the card does, and the raw
        scores are summed from the leaf values.  The gradients are the
        objective's on ``config.device_type``.  Drops the packed-forest
        cache, so the next prediction or ``swap()`` packs the new
        values."""
        self._flush_pending()
        label = np.asarray(label, np.float64)
        device = resolve_device(self.config.device_type)
        obj = self._refit_objective()
        md = Metadata(len(label))
        md.set_label(label)
        obj.init(md, len(label), device)
        if leaf_ids is None:
            arr = np.ascontiguousarray(np.asarray(data, np.float64))
            raw = self.predict_raw(arr)
            leaf_ids = [tree.predict_leaf(arr) if tree.num_leaves > 1
                        else None for tree in self.models]
        else:
            raw = scores_from_leaves(self.models, leaf_ids, self.num_model,
                                     len(label))
        grad, hess = obj.get_gradients(
            torch.as_tensor(raw, dtype=torch.float32, device=device))
        if grad.dim() == 1:
            grad, hess = grad[None], hess[None]
        grad = grad.double().cpu().numpy()
        hess = hess.double().cpu().numpy()
        shrink = float(self.config.learning_rate)
        for idx, tree in enumerate(self.models):
            k = idx % self.num_model
            refit_tree_leaves(tree, leaf_ids[idx], grad[k], hess[k],
                              self.config, decay_rate, shrink)
        # in-place leaf edits: the packed cache's key sees only the count
        self._packed_cache = None
        return self

    def save_model_to_file(self, filename, start_iteration: int = 0,
                           num_iteration: int = -1) -> None:
        with open(filename, "w") as fh:
            fh.write(self.model_to_string(start_iteration, num_iteration))
        log_info(f"Finished saving model to file {filename}")

    @classmethod
    def load_model_from_string(cls, text: str, config=None) -> "GBDT":
        config = config or Config({})
        booster = cls(config)
        header, _, rest = text.partition("Tree=")
        kv: Dict[str, str] = {}
        for line in header.splitlines():
            if "=" in line:
                k, v = line.split("=", 1)
                kv[k.strip()] = v
            elif line.strip() == "average_output":
                booster.average_output = True
        booster.num_model = int(kv.get("num_tree_per_iteration", 1))
        booster.max_feature_idx = int(kv.get("max_feature_idx", 0))
        booster.feature_names = kv.get("feature_names", "").split()
        booster.feature_infos = kv.get("feature_infos", "").split()
        booster.loaded_objective_str = kv.get("objective", "")
        config.num_class = int(kv.get("num_class", 1))
        if rest:
            blocks = ("Tree=" + rest).split("end of trees")[0]
            for block in blocks.split("Tree=")[1:]:
                booster.models.append(Tree.from_string(block))
        booster.iter = len(booster.models) // max(booster.num_model, 1)
        booster.num_init_iteration = booster.iter
        return booster

    @classmethod
    def load_model_from_file(cls, filename, config=None) -> "GBDT":
        with open(filename) as fh:
            return cls.load_model_from_string(fh.read(), config)


def scores_from_leaves(models, leaf_ids, num_model: int,
                       n: int) -> np.ndarray:
    """(num_model, n) float64 raw scores summed from each tree's leaf
    values at the given (N,) leaf ids (None: a stump, its leaf 0)."""
    raw = np.zeros((max(num_model, 1), n), np.float64)
    for idx, tree in enumerate(models):
        k = idx % max(num_model, 1)
        if leaf_ids[idx] is None:
            raw[k] += tree.leaf_value[0]
        else:
            raw[k] += tree.leaf_value[np.asarray(leaf_ids[idx])]
    return raw


def _refit_leaf_optimum(sum_grad: np.ndarray, sum_hess: np.ndarray,
                        config) -> np.ndarray:
    """Vectorized regularized leaf output (the reference's
    ``FeatureHistogram::CalculateSplittedLeafOutput``):
    ``-ThresholdL1(sum_grad, l1) / (sum_hess + l2)``, clipped to
    ``+-max_delta_step`` when that is set."""
    l1 = float(config.lambda_l1)
    l2 = float(config.lambda_l2)
    thr = np.sign(sum_grad) * np.maximum(np.abs(sum_grad) - l1, 0.0)
    denom = sum_hess + l2
    safe = denom > 0.0
    out = np.where(safe, -thr / np.where(safe, denom, 1.0), 0.0)
    mds = float(getattr(config, "max_delta_step", 0.0))
    if mds > 0.0:
        out = np.clip(out, -mds, mds)
    return out


def refit_tree_leaves(tree: Tree, leaf_ids, grad: np.ndarray,
                      hess: np.ndarray, config, decay_rate: float,
                      shrinkage: float) -> None:
    """Refit one tree's leaf values in place from new-data gradients (one
    ``np.bincount`` a statistic).  ``leaf_ids`` is the per-row leaf
    assignment, or None for a stump (every row in leaf 0).  Empty leaves
    keep their old value; the routing arrays are untouched."""
    n_leaves = max(int(tree.num_leaves), 1)
    if leaf_ids is None:
        cnt = np.array([len(grad)], np.int64)
        sg = np.array([float(np.sum(grad))])
        sh = np.array([float(np.sum(hess))])
    else:
        leaf_ids = np.asarray(leaf_ids)
        cnt = np.bincount(leaf_ids, minlength=n_leaves)[:n_leaves]
        sg = np.bincount(leaf_ids, weights=grad,
                         minlength=n_leaves)[:n_leaves]
        sh = np.bincount(leaf_ids, weights=hess,
                         minlength=n_leaves)[:n_leaves]
    optimal = _refit_leaf_optimum(sg, sh, config) * shrinkage
    old = tree.leaf_value[:n_leaves]
    tree.leaf_value[:n_leaves] = np.where(
        cnt > 0, decay_rate * old + (1.0 - decay_rate) * optimal, old)


def _convert_by_name(objective_str: str, raw: np.ndarray) -> np.ndarray:
    """Output transform for models loaded from text (no live objective),
    by the objective line's name: the JAX package's
    ``lightgbm_tpu/boosting/gbdt.py::_convert_by_name``."""
    name = objective_str.split()[0] if objective_str else ""
    params = dict(p.split(":", 1) for p in objective_str.split()[1:]
                  if ":" in p)
    if name in ("binary", "multiclassova", "cross_entropy"):
        sigmoid = float(params.get("sigmoid", 1.0))
        return 1.0 / (1.0 + np.exp(-sigmoid * raw))
    if name in ("poisson", "gamma", "tweedie"):
        return np.exp(raw)
    if name == "multiclass":
        e = np.exp(raw - raw.max(axis=0, keepdims=True))
        return e / e.sum(axis=0, keepdims=True)
    if name == "cross_entropy_lambda":
        return np.log1p(np.exp(raw))
    return raw
