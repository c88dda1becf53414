"""Command line: train, predict, convert_model, refit, pipeline, warmup,
soak.

Counterpart of ``lightgbm_tpu/cli.py`` (the reference ``Application``,
``src/application/application.cpp``): ``key=value`` arguments and a
``config=`` file, the side files ``<data>.weight``/``.query``/``.init``,
snapshots, and metrics every ``metric_freq`` iterations.  Run it as
``python -m lightgbm_tpu_torch config=train.conf [key=value ...]``;
training, prediction and the soak run on ``device`` (default ``cuda``).
``python -m lightgbm_tpu_torch soak [key=value ...]`` (``task=soak``) runs
the fleet chaos soak, prints its verdict and exits non-zero when a gate
fails.  ``two_round=true`` loads a text file in two streamed passes
(``data/stream_loader.py``); prediction streams its file in chunks.
``data_sharding=multi_controller`` with ``coordinator_address=host:port
num_hosts=N host_rank=r`` (or the ``LGBM_TPU_*`` env triple) makes N
processes, one a host, train one model: host 0 finds the bins, every host
streams and bins its own row block (``load_text_multihost``), and every
host writes the same model text.
"""

from __future__ import annotations

import json
import sys
import time
from typing import Dict, List

import numpy as np

from .boosting import create_boosting
from .boosting.gbdt import GBDT
from .config import Config, parse_config_str
from .data.dataset import BinnedDataset
from .data.parser import (load_init_score_file, load_query_file,
                          load_text_file, load_weight_file)
from .engine import steps_to_boundary
from .ops.shard import multihost_shutdown, sharding_mode
from .utils.file_io import exists, open_text
from .utils.log import LightGBMError, log_info, log_warning


def parse_cli_args(argv: List[str]) -> Dict[str, str]:
    params: Dict[str, str] = {}
    for arg in argv:
        if "=" not in arg:
            continue
        k, v = arg.split("=", 1)
        params[k.strip()] = v.strip()
    if params.get("config"):
        with open_text(params["config"]) as fh:
            file_params = parse_config_str(fh.read())
        # arguments take precedence over the config file
        file_params.update(params)
        params = file_params
    return params


def _load_dataset(path: str, cfg: Config, reference=None) -> BinnedDataset:
    """A training or validation file: a binary dataset file, or a text
    file binned on the host (with ``reference``, against its mappers), with
    its side files."""
    if BinnedDataset.is_binary_file(path):
        return BinnedDataset.load_binary(path)
    if sharding_mode(cfg) == "multi_controller" and reference is None:
        # the pod's load: host 0 finds the bins, every host streams and
        # bins its own row block
        from .data.stream_loader import load_text_multihost
        ds, _ = load_text_multihost(path, cfg,
                                    categorical=_parse_categorical(
                                        cfg, 1 << 30))
    elif cfg.two_round:
        # two streamed passes, never the float64 matrix
        # (dataset_loader.cpp:161-264)
        from .data.stream_loader import load_text_two_round
        ds, _ = load_text_two_round(path, cfg,
                                    categorical=_parse_categorical(
                                        cfg, 1 << 30),
                                    reference=reference)
    else:
        arr, label, names = load_text_file(path, cfg)
        ds = BinnedDataset.construct_from_matrix(
            arr, cfg, _parse_categorical(cfg, arr.shape[1]),
            feature_names=names, reference=reference)
        if label is not None:
            ds.metadata.set_label(label)
    md = ds.metadata
    w = load_weight_file(path + ".weight")
    if w is not None:
        md.set_weights(w)
    q = load_query_file(path + ".query")
    if q is not None:
        md.set_query(q)
    init = load_init_score_file(path + ".init")
    if init is not None:
        md.set_init_score(init.T.reshape(-1) if init.ndim > 1 else init)
    return ds


def _parse_categorical(cfg: Config, num_features: int) -> List[int]:
    out = []
    for c in getattr(cfg, "categorical_feature", []) or []:
        c = str(c)
        if c.startswith("name:"):
            continue
        try:
            out.append(int(c))
        except ValueError:
            pass
    return [c for c in out if 0 <= c < num_features]


def run_train(cfg: Config) -> None:
    start = time.time()
    train_ds = _load_dataset(cfg.data, cfg)
    log_info(f"Finished loading data in {time.time() - start:.6f} seconds")
    booster = create_boosting(cfg)
    booster.init_train(train_ds)
    valid_paths = cfg.valid if isinstance(cfg.valid, list) else [cfg.valid]
    for i, vp in enumerate(v for v in valid_paths if v):
        booster.add_valid(_load_dataset(str(vp), cfg, reference=train_ds),
                          f"valid_{i + 1}")
    num_iters = int(cfg.num_iterations)
    snapshot_freq = int(getattr(cfg, "snapshot_freq", -1) or -1)
    metric_freq = max(int(cfg.metric_freq), 1)
    fused_cap = max(int(getattr(cfg, "fused_chunk", 20)), 0)
    out_model = cfg.output_model or "LightGBM_model.txt"
    if getattr(cfg, "resume_training", False):
        from .robust.checkpoint import latest_snapshot
        snap = latest_snapshot(out_model)
        if snap is not None:
            booster.resume_from_checkpoint(snap)
        else:
            log_warning(f"resume_training requested but no resumable "
                        f"{out_model}.snapshot_iter_* found; training "
                        f"from scratch")
    start = time.time()
    # fused driving between metric and snapshot boundaries, as
    # engine.train does (GBDT.train_chunked)
    can_fuse = fused_cap > 1 and booster.fused_eligible()
    it = booster.iter
    while it < num_iters:
        step = 1
        if can_fuse:
            step = num_iters - it
            if booster.train_metrics or booster.valid_sets:
                step = min(step, steps_to_boundary(it, metric_freq))
            if snapshot_freq > 0:
                step = min(step, steps_to_boundary(it, snapshot_freq))
        if step > 1:
            before = booster.iter
            finished = booster.train_chunked(step, chunk=min(step,
                                                             fused_cap))
            advanced = max(booster.iter - before, 1)
        else:
            finished = booster.train_one_iter()
            advanced = 1
        it_done = it + advanced - 1
        if (it_done + 1) % metric_freq == 0 or it_done == num_iters - 1:
            for dname, mname, value, _ in (booster.eval_train()
                                           + booster.eval_valid()):
                log_info(f"Iteration:{it_done + 1}, {dname} {mname} : "
                         f"{value:g}")
        for j in range(it, it + advanced):
            log_info(f"{time.time() - start:.6f} seconds elapsed, "
                     f"finished iteration {j + 1}")
        if snapshot_freq > 0 and (it_done + 1) % snapshot_freq == 0:
            booster.save_checkpoint(
                f"{out_model}.snapshot_iter_{it_done + 1}")
        it += advanced
        if finished:
            break
    booster.save_model_to_file(out_model)
    log_info("Finished training")


def run_predict(cfg: Config) -> None:
    """Predict a data file into ``output_result``, one row a line, in
    chunks behind the double-buffered reader (``predictor.hpp:170-259``):
    host memory holds one chunk, not the file."""
    from .data.stream_loader import iter_parsed_chunks
    booster = GBDT.load_model_from_file(cfg.input_model
                                        or "LightGBM_model.txt", cfg)
    out = cfg.output_result or "LightGBM_predict_result.txt"
    # checked before the output file is truncated: the chunks are lazy
    if not exists(cfg.data):
        raise LightGBMError(f"could not open data file {cfg.data}")
    nf = booster.max_feature_idx + 1
    kw = dict(num_iteration=int(getattr(cfg, "num_iteration_predict", -1)
                                or -1),
              raw_score=bool(cfg.predict_raw_score),
              pred_leaf=bool(cfg.predict_leaf_index),
              pred_contrib=bool(cfg.predict_contrib))
    n_rows = 0
    with open(out, "w") as fh:
        for x, _ in iter_parsed_chunks(cfg.data, cfg, nf):
            if x.shape[0] == 0:
                continue
            if x.shape[1] < nf:
                x = np.pad(x, ((0, 0), (0, nf - x.shape[1])),
                           constant_values=np.nan)
            pred = np.asarray(booster.predict(x[:, :nf], **kw))
            pred2 = pred.reshape(-1, 1) if pred.ndim == 1 else pred
            np.savetxt(fh, pred2, delimiter="\t", fmt="%g")
            n_rows += pred2.shape[0]
    log_info(f"Finished prediction of {n_rows} rows, saved to {out}")


def run_convert_model(cfg: Config) -> None:
    booster = GBDT.load_model_from_file(cfg.input_model
                                        or "LightGBM_model.txt", cfg)
    out = cfg.convert_model or "gbdt_prediction.cpp"
    lines = ["#include <cmath>", "#include <cstdint>", ""]
    for i, tree in enumerate(booster.models):
        lines.append(tree.to_if_else(i, False))
    calls = " + ".join(f"PredictTree{i}(arr)"
                       for i in range(len(booster.models))) or "0.0"
    lines.append("double Predict(const double* arr) {\n"
                 f"  return {calls};\n}}\n")
    with open(out, "w") as fh:
        fh.write("\n".join(lines))
    log_info(f"Finished converting model to C++ code {out}")


def run_refit(cfg: Config) -> None:
    from .basic import Booster
    booster = Booster(model_file=cfg.input_model or "LightGBM_model.txt",
                      params={"device": cfg.device_type})
    arr, label, _ = load_text_file(cfg.data, cfg)
    new_booster = booster.refit(arr, label,
                                decay_rate=float(cfg.refit_decay_rate))
    new_booster.save_model(cfg.output_model or "LightGBM_model.txt")
    log_info("Finished refitting")


def run_pipeline(cfg: Config) -> None:
    """The windowed-retrain pipeline over the training file: its rows
    replayed as ``pipeline_windows`` equal windows, each scored by the
    served model, then retrained and swapped in; the last window's model
    goes to ``output_model``."""
    from .pipeline import PreppedWindow, RetrainPipeline

    arr, label, _ = load_text_file(cfg.data, cfg)
    if label is None:
        raise LightGBMError("task=pipeline requires labeled data")
    nw = max(int(cfg.pipeline_windows), 1)
    bounds = np.linspace(0, arr.shape[0], nw + 1).astype(np.int64)
    payloads = [(int(bounds[i]), int(bounds[i + 1])) for i in range(nw)]
    cats = _parse_categorical(cfg, arr.shape[1])
    objective = str(cfg.objective)

    def prep(payload):
        lo, hi = payload
        return PreppedWindow(label=label[lo:hi], dense=arr[lo:hi],
                             eval_label=label[lo:hi],
                             eval_dense=arr[lo:hi])

    def eval_fn(pred, pw):
        y = np.asarray(pw.eval_label, np.float64)
        p = np.asarray(pred, np.float64)
        if objective.startswith("binary"):
            return {"prev_model_error":
                    round(float(np.mean((p >= 0.5) != (y >= 0.5))), 5)}
        if p.ndim > 1:
            return {"prev_model_error":
                    round(float(np.mean(np.argmax(p, axis=1) != y)), 5)}
        return {"prev_model_rmse":
                round(float(np.sqrt(np.mean((p - y) ** 2))), 6)}

    ckpt_dir = str(getattr(cfg, "pipeline_checkpoint_dir", "") or "")
    pipe = None
    if getattr(cfg, "resume_training", False):
        from .robust.checkpoint import has_pipeline_checkpoint
        if not ckpt_dir:
            raise LightGBMError("task=pipeline resume_training needs "
                                "pipeline_checkpoint_dir")
        if has_pipeline_checkpoint(ckpt_dir):
            pipe = RetrainPipeline.resume(ckpt_dir, cfg, categorical=cats,
                                          keep_boosters=False)
        else:
            log_warning(f"resume_training requested but no pipeline "
                        f"checkpoint in {ckpt_dir}; starting at window 0")
    if pipe is None:
        pipe = RetrainPipeline(cfg, categorical=cats, keep_boosters=False)
    results = pipe.run(payloads, prep, eval_fn=eval_fn,
                       on_window=lambda r: log_info(
                           "pipeline window " + json.dumps(r.to_json())))
    if pipe.overlap_fraction is not None:
        log_info(f"pipeline prep overlap fraction: "
                 f"{pipe.overlap_fraction:.3f}")
    booster = pipe.final_booster()
    if booster is not None:
        booster.save_model_to_file(cfg.output_model or "LightGBM_model.txt")
    log_info(f"Finished pipeline ({len(results)} windows)")


def run_soak(cfg: Config) -> None:
    """The composed fleet chaos soak (``soak/``): the scenario's M-tenant
    fleet, mixed-tenant load and per-tenant retrains under the seed-keyed
    fault timeline, on ``device``; prints the SLO-gated verdict and raises
    when any gate fails.  The scenario comes from ``LGBM_TPU_SOAK``,
    ``soak_scenario`` or the ``soak_*`` params; ``soak_out`` also writes
    the verdict to a file."""
    from .soak import SoakScenario, run_and_report
    sc = SoakScenario.from_config(cfg)
    verdict = run_and_report(sc, device=cfg.device_type)
    print(json.dumps(verdict, sort_keys=True, default=str))
    if sc.out:
        log_info(f"soak verdict written to {sc.out}")
    if not verdict["ok"]:
        raise LightGBMError(
            "soak verdict FAILED: "
            + ", ".join(name for name, g in verdict["gates"].items()
                        if not g["ok"]))
    log_info("Finished soak (verdict ok)")


def run_warmup(cfg: Config) -> None:
    """Build the kernels and capture the graphs of a declared deployment
    (``warmup.run_warmup``)."""
    from .warmup import run_warmup as _run
    _run(cfg)
    log_info("Finished warmup")


TASKS = {"train": run_train, "predict": run_predict,
         "prediction": run_predict, "test": run_predict,
         "convert_model": run_convert_model, "refit": run_refit,
         "refit_tree": run_refit, "warmup": run_warmup,
         "pipeline": run_pipeline, "soak": run_soak}


def main(argv=None) -> int:
    argv = list(argv if argv is not None else sys.argv[1:])
    # `warmup|pipeline|soak key=value...` subcommand sugar
    if argv and argv[0] in ("warmup", "pipeline", "soak"):
        argv = argv[1:] + [f"task={argv[0]}"]
    argv = ["resume_training=true" if a == "--resume" else a for a in argv]
    params = parse_cli_args(argv)
    if not params:
        print("usage: python -m lightgbm_tpu_torch config=train.conf "
              "[key=value...]\n"
              "       python -m lightgbm_tpu_torch warmup warmup_rows=N "
              "warmup_features=F [key=value...]")
        return 1
    cfg = Config(params)
    from . import compile_cache
    compile_cache.configure_from_config(cfg)
    from .robust import faults
    faults.configure_from_config(cfg)
    run = TASKS.get(str(cfg.task))
    if run is None:
        raise LightGBMError(f"unknown task: {cfg.task}")
    run(cfg)
    if sharding_mode(cfg) == "multi_controller":
        multihost_shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
