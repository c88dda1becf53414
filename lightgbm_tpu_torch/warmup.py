"""Warm-up ahead of time: build a deployment's kernels and capture its
graphs before its first window.

Counterpart of ``lightgbm_tpu/warmup.py``.  The JAX package precompiles
XLA programs into its persistent cache; the port compiles no program per
shape, so a cold process pays two other bills, and warm-up pays them up
front:

* :func:`warmup_train` -- declare (rows, features, config): it trains a
  synthetic dataset of that shape (or a given dataset) through the real
  training path far enough to build every kernel library the run uses
  (``ops/build.py``, into ``compile_cache_dir``) and to capture every CUDA
  graph: one fused chunk and the per-iteration remainder.  Its grower is
  then left idle in the grower cache (``ops/grow.py``, ``grower_cache``),
  where a booster of equal key replays its graphs without a capture.
  Sparse or low-cardinality deployments should warm from a sample of
  their own data (``dataset=`` / ``data=``) so the groups and bins, and
  the grower key, match.
* :func:`warmup_serve` -- builds the forest kernel's library and runs it
  over the declared row buckets on a synthetic forest of the declared
  iterations and leaves.

The reports' ``cache_misses`` count kernel libraries built fresh (0 for a
restarted process pointed at the same directory), ``cache_hits`` those
found built, ``captures`` the CUDA-graph captures made.  Entry points:
``task=warmup`` (CLI) and ``LGBM_WarmupTrain`` / ``LGBM_WarmupServe``.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from . import compile_cache, obs
from .config import Config, resolve_device
from .utils.log import LightGBMError, log_info

__all__ = ["warmup_train", "warmup_serve", "run_warmup"]

#: seed of the synthetic warm-up data
SYNTH_SEED = 20260803


def _synth_dataset(rows: int, features: int, cfg: Config):
    """A synthetic (rows, features) dataset with labels of the objective's
    kind, generated and binned on the training device (the host never
    holds the matrix).  Dense standard-normal features bin to the full
    ``max_bin`` ladder."""
    from .data.dataset import BinnedDataset

    dev = resolve_device(cfg.device_type)
    gen = torch.Generator(device=dev).manual_seed(SYNTH_SEED)
    x = torch.randn((int(rows), int(features)), generator=gen,
                    device=dev, dtype=torch.float32)
    ds = BinnedDataset.construct_from_device_matrix(x, cfg, device=dev)
    u = torch.rand(int(rows), generator=gen, device=dev).cpu().numpy()
    obj = str(cfg.objective)
    if obj in ("binary", "cross_entropy", "cross_entropy_lambda"):
        label = (u < 0.5).astype(np.float32)
    elif obj in ("multiclass", "multiclassova"):
        k = max(int(cfg.num_class), 2)
        label = np.minimum((u * k).astype(np.int64), k - 1) \
            .astype(np.float32)
    elif obj in ("poisson", "gamma", "tweedie"):
        label = (u + 0.1).astype(np.float32)
    else:
        label = (u - 0.5).astype(np.float32)
    ds.metadata.set_label(label)
    return ds


def _warmup_iters(num_iterations: int, chunk: int) -> int:
    """Iterations that build and capture what the full run does: one fused
    chunk (its graphs do not depend on the iteration count) and the
    per-iteration remainder when the count does not divide evenly."""
    n = max(int(num_iterations), 1)
    chunk = max(int(chunk), 0)
    if chunk <= 1 or n <= chunk:
        return n
    return chunk + n % chunk


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def warmup_train(rows: int, features: int = 0,
                 params: Optional[dict] = None,
                 config: Optional[Config] = None, dataset=None) -> dict:
    """Build and capture the training path of one declared shape (see the
    module docstring); returns the report."""
    from .boosting import create_boosting

    cfg = config if config is not None else Config(params or {})
    compile_cache.configure_from_config(cfg)
    before = compile_cache.counters()
    t0 = time.perf_counter()
    with obs.span("warmup.train", cat="warmup", rows=int(rows)):
        if dataset is None:
            if int(rows) <= 0 or int(features) <= 0:
                raise LightGBMError(
                    "warmup_train needs rows > 0 and features > 0 "
                    "(or an explicit dataset)")
            dataset = _synth_dataset(int(rows), int(features), cfg)
        bst = create_boosting(cfg)
        bst.init_train(dataset)
        grower = bst._grower
        chunk = max(int(getattr(cfg, "fused_chunk", 20)), 0)
        iters = _warmup_iters(cfg.num_iterations, chunk)
        bst.train_chunked(iters, chunk=chunk if chunk > 1 else 1)
        _sync(bst.device)
        # idle in the grower cache for the first booster of equal key
        bst.release_grower()
    after = compile_cache.counters()
    report = {
        "kind": "train",
        "rows": int(dataset.num_data),
        "row_bucket": None if grower is None else int(grower.n_pad),
        "features": int(dataset.num_features),
        "iterations_run": iters,
        "fused_chunk": chunk,
        "device_growth": grower is not None,
        "elapsed_s": round(time.perf_counter() - t0, 3),
        "cache_dir": compile_cache.cache_dir(),
        "cache_misses": after["misses"] - before["misses"],
        "cache_hits": after["hits"] - before["hits"],
        "captures": after["captures"] - before["captures"],
    }
    log_info(f"[warmup] train shape ({report['rows']}, "
             f"{report['features']}) bucket={report['row_bucket']} in "
             f"{report['elapsed_s']}s (libraries built "
             f"{report['cache_misses']}, found {report['cache_hits']}; "
             f"captures {report['captures']})")
    return report


def _synth_forest(num_iterations: int, num_leaves: int, features: int,
                  num_model: int) -> list:
    """Trees of ``num_leaves`` leaves each (a chain of splits at 0 on the
    features in turn): the declared forest's size, not its values."""
    from .tree.tree import Tree

    trees = []
    for t in range(max(int(num_iterations), 1) * max(int(num_model), 1)):
        tree = Tree(max(int(num_leaves), 2))
        leaf = 0
        for s in range(max(int(num_leaves), 2) - 1):
            f = (t + s) % max(int(features), 1)
            leaf = tree.split(leaf, f, f, 0, 0.0, 0.0, 0.0, 1, 1, 1.0, 0,
                              False)
        trees.append(tree)
    return trees


def warmup_serve(rows: Sequence[int], features: int,
                 params: Optional[dict] = None,
                 config: Optional[Config] = None) -> dict:
    """Build the forest kernel and run it over each declared row bucket
    (empty: :func:`~.serve.engine.warmup_bucket_ladder` at
    ``device_predict_min_rows``) on a forest of the declared
    ``num_iterations`` x ``num_class`` trees of ``num_leaves`` leaves, on
    ``device``."""
    from .serve.engine import row_bucket, warmup_bucket_ladder
    from .serve.packed import pack_ensemble, predict_scores

    cfg = config if config is not None else Config(params or {})
    compile_cache.configure_from_config(cfg)
    before = compile_cache.counters()
    t0 = time.perf_counter()
    buckets = [int(r) for r in rows if int(r) > 0]
    if not buckets:
        buckets = warmup_bucket_ladder(
            getattr(cfg, "device_predict_min_rows", None))
    buckets = sorted({row_bucket(b) for b in buckets})
    k = max(int(cfg.num_class), 1)
    dev = resolve_device(cfg.device_type)
    with obs.span("warmup.serve", cat="warmup"):
        pe = pack_ensemble(_synth_forest(cfg.num_iterations, cfg.num_leaves,
                                         features, k), k,
                           num_features=int(features), device=dev)
        for b in buckets:
            predict_scores(pe, np.zeros((b, int(features))))
        _sync(dev)
    after = compile_cache.counters()
    report = {
        "kind": "serve",
        "row_buckets": buckets,
        "programs": len(buckets),
        "features": int(features),
        "elapsed_s": round(time.perf_counter() - t0, 3),
        "cache_dir": compile_cache.cache_dir(),
        "cache_misses": after["misses"] - before["misses"],
        "cache_hits": after["hits"] - before["hits"],
    }
    log_info(f"[warmup] serve buckets {buckets} in {report['elapsed_s']}s "
             f"(libraries built {report['cache_misses']}, found "
             f"{report['cache_hits']})")
    return report


def run_warmup(cfg: Config) -> List[dict]:
    """``task=warmup``: warm every declared training row count
    (``warmup_rows``, with ``warmup_features``), a ``data=`` file's exact
    binned shape, and the serving buckets ``warmup_serve_rows`` (an entry
    of 0: the server's default buckets)."""
    reports: List[dict] = []
    obs.configure_from_config(cfg)
    compile_cache.configure_from_config(cfg)
    rows_list = [int(r) for r in (cfg.warmup_rows or [])]
    features = int(getattr(cfg, "warmup_features", 0) or 0)
    if getattr(cfg, "data", ""):
        from .cli import _load_dataset
        ds = _load_dataset(cfg.data, cfg)
        reports.append(warmup_train(ds.num_data, ds.num_features,
                                    config=cfg, dataset=ds))
        features = features or int(ds.num_total_features)
    for rows in rows_list:
        reports.append(warmup_train(rows, features, config=cfg))
    serve_raw = list(cfg.warmup_serve_rows or [])
    if serve_raw and features > 0:
        reports.append(warmup_serve([int(r) for r in serve_raw
                                     if int(r) > 0], features, config=cfg))
    if not reports:
        raise LightGBMError(
            "task=warmup needs a declared shape: set warmup_rows=... "
            "and warmup_features=... (or data=<sample file>)")
    return reports
