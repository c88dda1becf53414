"""Single-source-of-truth parameter schema of the PyTorch/CUDA port.

A copy of ``lightgbm_tpu/params.py`` (the port imports nothing of the JAX
package): every parameter keeps its name, aliases, default and check, so a
config written for ``lightgbm_tpu`` loads here unchanged.  Two differences:

* ``device_type`` (alias ``device``) defaults to ``cuda`` and accepts
  ``cuda`` or ``cpu`` (``gpu`` maps to ``cuda``);
* the knobs in :data:`IGNORED_PARAMS` only steer the JAX package's TPU
  programs; they are accepted and ignored here (``Config`` logs a warning
  when one is set).

Parameters that select behaviour the port does not have yet (other
objectives, bagging, quantized histograms, ...) are accepted by the schema
and refused by the trainer with an error that names them.  The descriptions
below are the JAX package's.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence


@dataclasses.dataclass(frozen=True)
class Param:
    name: str
    type: type
    default: Any
    aliases: tuple = ()
    check: Optional[str] = None      # human-readable constraint, e.g. ">= 0.0"
    desc: str = ""
    section: str = "core"

    def coerce(self, value):
        """Coerce a raw (possibly string) value to this param's type."""
        if self.type is bool:
            if isinstance(value, str):
                v = value.strip().lower()
                if v in ("true", "1", "yes", "+"):
                    return True
                if v in ("false", "0", "no", "-"):
                    return False
                raise ValueError(f"cannot parse bool from {value!r} for {self.name}")
            return bool(value)
        if self.type is int:
            if isinstance(value, str):
                return int(float(value.strip()))
            if isinstance(value, float) and value != int(value):
                raise ValueError(f"{self.name} expects an int, got {value}")
            return int(value)
        if self.type is float:
            if isinstance(value, str):
                value = value.strip()
            return float(value)
        if self.type is str:
            return str(value).strip() if isinstance(value, str) else str(value)
        if self.type is list:
            return _coerce_list(value)
        return value


def _coerce_list(value):
    if value is None:
        return []
    if isinstance(value, (list, tuple)):
        return list(value)
    if isinstance(value, str):
        value = value.strip()
        if not value:
            return []
        return [v for v in value.replace(" ", ",").split(",") if v != ""]
    return [value]


def _p(name, type_, default, aliases=(), check=None, desc="", section="core"):
    return Param(name, type_, default, tuple(aliases), check, desc, section)


# ---------------------------------------------------------------------------
# The schema.  Sections mirror the reference's config.h ordering:
# core, learning control, IO, objective, metric, network, device.
# ---------------------------------------------------------------------------

PARAM_SCHEMA: Sequence[Param] = (
    # -- core -------------------------------------------------------------
    _p("config", str, "", ("config_file",),
       desc="path to a key=value config file (CLI)", section="core"),
    _p("task", str, "train", ("task_type",),
       desc="train, predict (prediction), convert_model, refit "
            "(refit_tree), warmup (AOT compile warmup into the "
            "persistent cache, docs/ColdStart.md), pipeline (windowed-"
            "retrain pipeline over the data file, docs/Pipeline.md), "
            "soak (composed fleet chaos soak to an SLO-gated verdict, "
            "docs/Soak.md)",
       section="core"),
    _p("objective", str, "regression",
       ("objective_type", "app", "application"),
       desc="regression, regression_l1, huber, fair, poisson, quantile, mape, "
            "gamma, tweedie, binary, multiclass, multiclassova, cross_entropy, "
            "cross_entropy_lambda, lambdarank",
       section="core"),
    _p("boosting", str, "gbdt", ("boosting_type", "boost"),
       desc="gbdt, rf (random_forest), dart, goss", section="core"),
    _p("data", str, "", ("train", "train_data", "train_data_file", "data_filename"),
       desc="path of training data (CLI)", section="core"),
    _p("valid", list, [], ("test", "valid_data", "valid_data_file",
                           "test_data", "test_data_file", "valid_filenames"),
       desc="paths of validation data, comma separated (CLI)", section="core"),
    _p("num_iterations", int, 100,
       ("num_iteration", "n_iter", "num_tree", "num_trees", "num_round",
        "num_rounds", "num_boost_round", "n_estimators"),
       check=">= 0", desc="number of boosting iterations", section="core"),
    _p("learning_rate", float, 0.1, ("shrinkage_rate", "eta"),
       check="> 0.0", desc="shrinkage rate", section="core"),
    _p("num_leaves", int, 31, ("num_leaf", "max_leaves", "max_leaf"),
       check="> 1", desc="max number of leaves in one tree", section="core"),
    _p("tree_learner", str, "serial",
       ("tree", "tree_type", "tree_learner_type"),
       desc="serial, feature (feature_parallel), data (data_parallel), "
            "voting (voting_parallel)", section="core"),
    _p("num_threads", int, 0, ("num_thread", "nthread", "nthreads", "n_jobs"),
       desc="number of host threads (0 = default)", section="core"),
    _p("device_type", str, "cuda", ("device",),
       desc="device for training: cuda (default) or cpu (the plain PyTorch "
            "path). The reference's gpu maps to cuda", section="core"),
    _p("seed", int, 0, ("random_seed", "random_state"),
       desc="master seed; deterministically derives data/feature/bagging/drop "
            "seeds like the reference", section="core"),

    # -- learning control -------------------------------------------------
    _p("max_depth", int, -1, (),
       desc="limit tree depth, <= 0 means no limit", section="learning"),
    _p("min_data_in_leaf", int, 20,
       ("min_data_per_leaf", "min_data", "min_child_samples"),
       check=">= 0", desc="minimal number of data in one leaf", section="learning"),
    _p("min_sum_hessian_in_leaf", float, 1e-3,
       ("min_sum_hessian_per_leaf", "min_sum_hessian", "min_hessian",
        "min_child_weight"),
       check=">= 0.0", desc="minimal sum of hessians in one leaf", section="learning"),
    _p("bagging_fraction", float, 1.0,
       ("sub_row", "subsample", "bagging"),
       check="0.0 < x <= 1.0", desc="row subsample ratio (without replacement)",
       section="learning"),
    _p("pos_bagging_fraction", float, 1.0,
       ("pos_sub_row", "pos_subsample", "pos_bagging"),
       check="0.0 < x <= 1.0", desc="positive-class bagging fraction (binary)",
       section="learning"),
    _p("neg_bagging_fraction", float, 1.0,
       ("neg_sub_row", "neg_subsample", "neg_bagging"),
       check="0.0 < x <= 1.0", desc="negative-class bagging fraction (binary)",
       section="learning"),
    _p("bagging_freq", int, 0, ("subsample_freq",),
       desc="bagging frequency; 0 disables bagging", section="learning"),
    _p("bagging_seed", int, 3, ("bagging_fraction_seed",),
       desc="bagging random seed", section="learning"),
    _p("feature_fraction", float, 1.0,
       ("sub_feature", "colsample_bytree"),
       check="0.0 < x <= 1.0", desc="feature subsample ratio per tree",
       section="learning"),
    _p("feature_fraction_seed", int, 2, (),
       desc="feature_fraction random seed", section="learning"),
    _p("early_stopping_round", int, 0,
       ("early_stopping_rounds", "early_stopping"),
       desc="stop if one validation metric does not improve in this many rounds",
       section="learning"),
    _p("first_metric_only", bool, False, (),
       desc="only use the first metric for early stopping", section="learning"),
    _p("max_delta_step", float, 0.0, ("max_tree_output", "max_leaf_output"),
       desc="limit the max output of tree leaves, <= 0 means no constraint",
       section="learning"),
    _p("lambda_l1", float, 0.0, ("reg_alpha",), check=">= 0.0",
       desc="L1 regularization", section="learning"),
    _p("lambda_l2", float, 0.0, ("reg_lambda", "lambda"), check=">= 0.0",
       desc="L2 regularization", section="learning"),
    _p("min_gain_to_split", float, 0.0, ("min_split_gain",), check=">= 0.0",
       desc="minimal gain to perform split", section="learning"),
    _p("drop_rate", float, 0.1, ("rate_drop",), check="0.0 <= x <= 1.0",
       desc="dart: dropout rate", section="learning"),
    _p("max_drop", int, 50, (),
       desc="dart: max number of dropped trees per iteration, <=0 no limit",
       section="learning"),
    _p("skip_drop", float, 0.5, (), check="0.0 <= x <= 1.0",
       desc="dart: probability of skipping drop", section="learning"),
    _p("xgboost_dart_mode", bool, False, (),
       desc="dart: use xgboost dart normalization", section="learning"),
    _p("uniform_drop", bool, False, (),
       desc="dart: uniform (vs weighted) drop", section="learning"),
    _p("drop_seed", int, 4, (), desc="dart: drop random seed", section="learning"),
    _p("top_rate", float, 0.2, (), check="0.0 <= x <= 1.0",
       desc="goss: retain ratio of large-gradient data", section="learning"),
    _p("other_rate", float, 0.1, (), check="0.0 <= x <= 1.0",
       desc="goss: sample ratio of small-gradient data", section="learning"),
    _p("min_data_per_group", int, 100, (), check="> 0",
       desc="minimal data per categorical group", section="learning"),
    _p("max_cat_threshold", int, 32, (), check="> 0",
       desc="max number of categories on one side of a categorical split",
       section="learning"),
    _p("cat_l2", float, 10.0, (), check=">= 0.0",
       desc="L2 regularization in categorical split", section="learning"),
    _p("cat_smooth", float, 10.0, (), check=">= 0.0",
       desc="smoothing of categorical bin statistics", section="learning"),
    _p("max_cat_to_onehot", int, 4, (), check="> 0",
       desc="use one-vs-other categorical split when #categories <= this",
       section="learning"),
    _p("top_k", int, 20, ("topk",), check="> 0",
       desc="voting parallel: number of top features voted per worker",
       section="learning"),
    _p("monotone_constraints", list, [],
       ("mc", "monotone_constraint"),
       desc="per-feature monotone constraints: 1 increasing, -1 decreasing, 0 none",
       section="learning"),
    _p("feature_contri", list, [],
       ("feature_contrib", "fc", "fp", "feature_penalty"),
       desc="per-feature split-gain multipliers", section="learning"),
    _p("forcedsplits_filename", str, "",
       ("fs", "forced_splits_filename", "forced_splits_file", "forced_splits"),
       desc="path to a JSON file of forced splits", section="learning"),
    _p("refit_decay_rate", float, 0.9, (), check="0.0 <= x <= 1.0",
       desc="decay rate of leaf values in the refit task and in the "
            "pipeline's refit/warm window policies: new leaf value = "
            "decay * old + (1 - decay) * optimal-on-new-data",
       section="learning"),
    _p("window_policy", str, "fresh", (),
       check="fresh/refit/warm",
       desc="how each retrain window of the windowed pipeline "
            "(lightgbm_tpu.pipeline, docs/Pipeline.md) starts: fresh = "
            "train a new booster from scratch (the reference harness's "
            "behaviour; byte-identical to the serial loop); refit = "
            "keep the previous ensemble's routing structure and re-fit "
            "leaf values against the new labels with refit_decay_rate "
            "(no new trees); warm = refit, then continue boosting "
            "pipeline_warm_iterations new trees on top (tree count "
            "grows per window — pad-boundary crossings re-trace the "
            "serving kernel)", section="learning"),
    _p("pipeline_warm_iterations", int, 0, (), check=">= 0",
       desc="extra boosting iterations per window under "
            "window_policy=warm; 0 = num_iterations", section="learning"),
    _p("verbosity", int, 1, ("verbose",),
       desc="<0 fatal only, 0 error/warning, 1 info, >1 debug", section="io"),

    # -- IO / dataset -----------------------------------------------------
    _p("max_bin", int, 255, (), check="> 1",
       desc="max number of bins for feature values", section="io"),
    _p("min_data_in_bin", int, 3, (), check="> 0",
       desc="minimal number of data inside one bin", section="io"),
    _p("bin_construct_sample_cnt", int, 200000, ("subsample_for_bin",),
       check="> 0", desc="number of sampled rows to construct bins", section="io"),
    _p("histogram_pool_size", float, -1.0, ("hist_pool_size",),
       desc="max cache size in MB for historical histograms; < 0 = no limit",
       section="io"),
    _p("data_random_seed", int, 1, ("data_seed",),
       desc="random seed for sampling data rows for bin construction",
       section="io"),
    _p("output_model", str, "LightGBM_model.txt",
       ("model_output", "model_out"),
       desc="filename of output model (CLI)", section="io"),
    _p("snapshot_freq", int, -1, ("save_period",),
       desc="checkpoint frequency in iterations; <=0 disables", section="io"),
    _p("input_model", str, "", ("model_input", "model_in"),
       desc="filename of input model for continued train / predict", section="io"),
    _p("output_result", str, "LightGBM_predict_result.txt",
       ("predict_result", "prediction_result", "predict_name",
        "prediction_name", "pred_name", "name_pred"),
       desc="filename of prediction result (CLI predict task)", section="io"),
    _p("initscore_filename", str, "",
       ("init_score_filename", "init_score_file", "init_score",
        "input_init_score"),
       desc="path of initial-score file; '' means <data>.init if exists",
       section="io"),
    _p("valid_data_initscores", list, [],
       ("valid_data_init_scores", "valid_init_score_file", "valid_init_score"),
       desc="init-score files of validation data", section="io"),
    _p("pre_partition", bool, False, ("is_pre_partition",),
       desc="distributed: data is already partitioned across machines", section="io"),
    _p("enable_bundle", bool, True, ("is_enable_bundle", "bundle"),
       desc="enable exclusive feature bundling (EFB)", section="io"),
    _p("max_conflict_rate", float, 0.0, (), check="0.0 <= x < 1.0",
       desc="max conflict rate for EFB bundling", section="io"),
    _p("is_enable_sparse", bool, True,
       ("is_sparse", "enable_sparse", "sparse"),
       desc="enable sparse optimization (host-side)", section="io"),
    _p("sparse_threshold", float, 0.8, (), check="0.0 < x <= 1.0",
       desc="zero-ratio threshold treating a feature group as sparse", section="io"),
    _p("use_missing", bool, True, (),
       desc="enable special handling of missing values", section="io"),
    _p("zero_as_missing", bool, False, (),
       desc="treat zero as missing (and unrecorded sparse entries)", section="io"),
    _p("two_round", bool, False,
       ("two_round_loading", "use_two_round_loading"),
       desc="two-pass loading for data bigger than memory", section="io"),
    _p("save_binary", bool, False, ("is_save_binary", "is_save_binary_file"),
       desc="save dataset to binary cache file", section="io"),
    _p("header", bool, False, ("has_header",),
       desc="input data has a header line", section="io"),
    _p("label_column", str, "", ("label",),
       desc="label column: index or name: prefix", section="io"),
    _p("weight_column", str, "", ("weight",),
       desc="weight column: index or name: prefix", section="io"),
    _p("group_column", str, "",
       ("group", "group_id", "query_column", "query", "query_id"),
       desc="query/group id column for ranking", section="io"),
    _p("ignore_column", list, [],
       ("ignore_feature", "blacklist"),
       desc="columns to ignore", section="io"),
    _p("categorical_feature", list, [],
       ("cat_feature", "categorical_column", "cat_column"),
       desc="categorical feature indices or name: list", section="io"),
    _p("predict_raw_score", bool, False,
       ("is_predict_raw_score", "predict_rawscore", "raw_score"),
       desc="predict raw scores only", section="io"),
    _p("predict_leaf_index", bool, False,
       ("is_predict_leaf_index", "leaf_index"),
       desc="predict leaf indices", section="io"),
    _p("predict_contrib", bool, False,
       ("is_predict_contrib", "contrib"),
       desc="predict SHAP feature contributions", section="io"),
    _p("num_iteration_predict", int, -1, (),
       desc="number of iterations used in prediction, <=0 all", section="io"),
    _p("pred_early_stop", bool, False, (),
       desc="use early stopping in prediction", section="io"),
    _p("pred_early_stop_freq", int, 10, (),
       desc="frequency of checking prediction early stopping", section="io"),
    _p("pred_early_stop_margin", float, 10.0, (),
       desc="threshold margin for prediction early stopping", section="io"),
    _p("convert_model_language", str, "", (),
       desc="convert_model target language (cpp supported)", section="io"),
    _p("convert_model", str, "gbdt_prediction.cpp",
       ("convert_model_file",),
       desc="output of convert_model task", section="io"),
    _p("metrics_enabled", bool, False, ("telemetry", "obs_enabled"),
       desc="enable the structured telemetry subsystem (lightgbm_tpu.obs): "
            "metrics registry (per-phase/iteration timing histograms with "
            "p50/p95/max), JIT recompile tracking per shape signature, and "
            "device memory peaks; near-zero overhead when false. "
            "Independent of `verbosity` (which only gates stderr logging). "
            "Env override: LGBM_TPU_METRICS=<path|1>. See "
            "docs/Observability.md", section="io"),
    _p("metrics_path", str, "", ("metrics_file",),
       desc="write the telemetry metrics JSON snapshot to this path at the "
            "end of train() (implies metrics_enabled)", section="io"),
    _p("events_path", str, "", ("events_file",),
       desc="write the trace-event buffer as JSONL (one event per line: "
            "t_unix, name, cat, kind, dur_s, args) to this path at process "
            "exit (implies metrics_enabled). The streaming counterpart of "
            "trace_path for jq/pandas post-processing; the per-window "
            "feature-gain events land here. Env override: "
            "LGBM_TPU_EVENTS=<path.jsonl>. See docs/Observability.md",
       section="io"),
    _p("stream_path", str, "", ("stream_file",),
       desc="append a rolling-window telemetry snapshot line (JSONL time "
            "series: counter rates, gauge means, p50/p95/p99 over the "
            "last window, latest SLO digest) every obs_export_interval "
            "seconds via the background exporter (implies "
            "metrics_enabled; docs/Observability.md \"Streaming & "
            "SLOs\"). Export is bounded-queue + drop-counter: it can "
            "never stall training or serving. Env override: "
            "LGBM_TPU_STREAM=<path.jsonl>", section="io"),
    _p("prom_path", str, "", ("prometheus_path",),
       desc="atomically rewrite a Prometheus text-exposition file at this "
            "path every obs_export_interval seconds (implies "
            "metrics_enabled): counters as _total, gauges, timings as "
            "summaries with rolling-window quantiles. Env override: "
            "LGBM_TPU_PROM=<path>", section="io"),
    _p("obs_export_interval", float, 5.0, (), check="> 0.0",
       desc="seconds between background telemetry exporter flushes "
            "(stream_path / prom_path / the scrape endpoint)",
       section="io"),
    _p("obs_http_port", int, 0, (), check=">= 0",
       desc="opt-in localhost Prometheus scrape endpoint: serve the "
            "text exposition at http://127.0.0.1:<port>/metrics "
            "(implies metrics_enabled). 0 disables (default — the "
            "library never binds a socket unasked). Env override: "
            "LGBM_TPU_OBS_HTTP=<port>", section="io"),
    _p("pipeline_windows", int, 4, (), check="> 0",
       desc="task=pipeline (CLI): number of equal row windows the "
            "training file is replayed as through the windowed-retrain "
            "pipeline (docs/Pipeline.md); each window is scored against "
            "the previously served model (test-then-train), then "
            "retrained per window_policy and hot-swapped into serving",
       section="io"),
    _p("pipeline_rebin", bool, True, (),
       desc="windowed pipeline: allow drift-triggered re-find-bin. "
            "When false, every window is constructed against the first "
            "window's bin mappers unconditionally — program signatures "
            "stay frozen (zero retraces) and, with window_policy=fresh, "
            "the pipelined loop is byte-identical to the serial one",
       section="io"),
    _p("pipeline_drift_threshold", float, 0.1, (), check=">= 0.0",
       desc="windowed pipeline: re-run find-bin when a window's "
            "noise-adjusted bin-occupancy drift (mean per-group total-"
            "variation distance vs the cached mappers' occupancy, minus "
            "the expected sampling noise — docs/Pipeline.md) exceeds "
            "this; a rebind changes program signatures, so expect a "
            "one-off retrace on that window", section="io"),
    _p("trace_path", str, "", ("trace_file",),
       desc="write a Chrome-trace / Perfetto timeline of the run to this "
            "path at the end of train() (implies metrics_enabled). Open at "
            "https://ui.perfetto.dev. Env override: LGBM_TPU_TRACE=<path>",
       section="io"),
    _p("trace_context_enabled", bool, False, ("trace_context",),
       desc="causal trace-context propagation (obs/tracing.py, implies "
            "metrics_enabled): spans gain trace_id/span_id/parent_id and "
            "the ids flow across thread boundaries — pipeline prep "
            "thread -> train -> hot-swap -> the serve requests answered "
            "by that model, micro-batch submit -> worker flush, fleet "
            "replica dispatch, checkpoint -> resume — so one exported "
            "trace shows a request's causal chain back to the training "
            "window that produced its model (docs/Observability.md "
            "\"Tracing & attribution\"). Off: zero context objects are "
            "allocated. Env override: LGBM_TPU_TRACE_CTX=1",
       section="io"),
    _p("profile_attribution", bool, False, (),
       desc="attach XLA cost-analysis estimates (FLOPs / bytes accessed "
            "per compiled program) to the device profiling probes "
            "(profile_stage_plan / profile_phases / profile_psum, implies "
            "metrics_enabled); bench.py --explain turns this on to emit "
            "the phase-attribution report with achieved-GFLOP/s figures",
       section="io"),
    _p("pipeline_checkpoint_dir", str, "", (),
       desc="windowed pipeline: directory for per-window fault-tolerance "
            "checkpoints (docs/Robustness.md). After every completed "
            "window the pipeline atomically persists the trained model, "
            "the bin-mapper cache and a manifest (write-temp-then-"
            "rename; the manifest is the commit point), so a killed run "
            "resumes from the last completed window via "
            "resume_training=true / RetrainPipeline.resume(dir). Empty "
            "disables checkpointing", section="io"),
    _p("resume_training", bool, False, ("resume",),
       desc="resume an interrupted run instead of starting over "
            "(docs/Robustness.md). task=train: adopt the highest "
            "<output_model>.snapshot_iter_N whose .state.npz sidecar "
            "exists and continue boosting from it — byte-identical to "
            "the uninterrupted run because the sidecar restores the "
            "exact float32 training scores. task=pipeline: reload "
            "pipeline_checkpoint_dir's manifest and continue at the "
            "first uncheckpointed window. CLI sugar: --resume. Warns "
            "and trains from scratch when nothing resumable exists",
       section="io"),
    _p("fault_spec", str, "", (),
       desc="deterministic fault injection for chaos testing "
            "(docs/Robustness.md): comma-separated "
            "site[:key=value|persist]* entries armed at the named "
            "sites (grow.dispatch, serve.dispatch, pipeline.prep, "
            "net.connect, io.write, ...), e.g. "
            "'serve.dispatch:persist' or 'pipeline.prep:at=2'. Modes: "
            "n= (first N calls), at= (exact invocation), after=, "
            "p=/seed= (seed-keyed probabilistic, reproducible), "
            "persist; error=fault/oserror/timeout picks the raised "
            "flavor. Env override: LGBM_TPU_FAULTS. NEVER set in "
            "production", section="io"),
    _p("soak_scenario", str, "", (),
       desc="task=soak: path to a JSON SoakScenario file (docs/Soak.md) "
            "overriding the individual soak_* params. Env override: "
            "LGBM_TPU_SOAK=<path-or-inline-JSON> takes precedence over "
            "everything", section="io"),
    _p("soak_tenants", int, 2, (), check=">= 1",
       desc="task=soak: cache nodes in the fleet — one FleetServer "
            "tenant per node, each retrained through its own "
            "RetrainPipeline (docs/Soak.md)", section="io"),
    _p("soak_windows", int, 3, (), check=">= 1",
       desc="task=soak: retrain windows per tenant (a tenant's cadence "
            "subsamples these)", section="io"),
    _p("soak_requests_per_window", int, 4096, (), check=">= 256",
       desc="task=soak: synthetic cache-admission requests per window "
            "(must be >= 2*soak_sample_rows so the labelable-row trim "
            "keeps every window shape-stable)", section="io"),
    _p("soak_sample_rows", int, 1024, (), check=">= 64",
       desc="task=soak: training rows per window after the tail trim "
            "(exact, so same-shape swaps stay zero-retrace)",
       section="io"),
    _p("soak_replicas", int, 1, (), check=">= 1",
       desc="task=soak: fleet serving replicas", section="io"),
    _p("soak_seed", int, 7, (),
       desc="task=soak: the chaos seed — the fault timeline, traces and "
            "sampling all derive from it, so the same seed replays the "
            "same soak byte-for-byte (docs/Soak.md)", section="io"),
    _p("soak_kills", int, 1, (), check=">= 0",
       desc="task=soak: scheduled kill-and-resume points (a retrain "
            "window's ingestion dies mid-window; the driver resumes "
            "from the checkpoint and the verdict gates on byte-"
            "identical reconvergence)", section="io"),
    _p("soak_device_deaths", int, 0, (), check=">= 0",
       desc="task=soak: transient device-death bursts injected on the "
            "serving dispatch path (host fallback + breaker recovery; "
            "dark time is charged to the availability objective)",
       section="io"),
    _p("soak_poison_batches", int, 1, (), check=">= 0",
       desc="task=soak: malformed query micro-batches the fleet must "
            "isolate per-request", section="io"),
    _p("soak_dead_peers", int, 1, (), check=">= 0",
       desc="task=soak: dead-ingest-peer timeouts on the query-load "
            "feed (soak.load site)", section="io"),
    _p("soak_clock_skews", int, 1, (), check=">= 0",
       desc="task=soak: clock faults injected at the driver's SLO "
            "clock stamps (soak.clock site; max 2 — run start and "
            "verdict)", section="io"),
    _p("soak_slo", str, "", (),
       desc="task=soak: SLO spec the verdict evaluates (obs/slo.py "
            "grammar); empty uses the scenario default "
            "'availability>=0.999,p95_ms<=250,burn<=14;"
            "source=serve.fleet;window_s=600'", section="io"),
    _p("soak_checkpoint_dir", str, "", (),
       desc="task=soak: working directory for per-tenant pipeline "
            "checkpoints + the telemetry stream; empty uses a fresh "
            "temp dir", section="io"),
    _p("soak_out", str, "", (),
       desc="task=soak: write the verdict JSON here (SOAK_r*.json "
            "rounds wrap it with the bench round envelope); empty "
            "prints to stdout only", section="io"),

    # -- objective --------------------------------------------------------
    _p("num_class", int, 1, ("num_classes",), check="> 0",
       desc="number of classes for multiclass objectives", section="objective"),
    _p("is_unbalance", bool, False, ("unbalance", "unbalanced_sets"),
       desc="binary: auto-reweight unbalanced labels", section="objective"),
    _p("scale_pos_weight", float, 1.0, (), check="> 0.0",
       desc="binary: weight of positive labels", section="objective"),
    _p("sigmoid", float, 1.0, (), check="> 0.0",
       desc="sigmoid steepness for binary/lambdarank", section="objective"),
    _p("boost_from_average", bool, True, (),
       desc="start from the average label instead of 0", section="objective"),
    _p("reg_sqrt", bool, False, (),
       desc="regression on sqrt(label) (undone at prediction)", section="objective"),
    _p("alpha", float, 0.9, (), check="> 0.0",
       desc="parameter of huber/quantile loss", section="objective"),
    _p("fair_c", float, 1.0, (), check="> 0.0",
       desc="parameter of fair loss", section="objective"),
    _p("poisson_max_delta_step", float, 0.7, (), check="> 0.0",
       desc="parameter of poisson hessian safeguard", section="objective"),
    _p("tweedie_variance_power", float, 1.5, (), check="1.0 <= x < 2.0",
       desc="tweedie variance power", section="objective"),
    _p("max_position", int, 20, (), check="> 0",
       desc="lambdarank NDCG optimization position cutoff", section="objective"),
    _p("label_gain", list, [], (),
       desc="lambdarank gain per label level, default 2^l - 1", section="objective"),

    # -- metric -----------------------------------------------------------
    _p("metric", list, [],
       ("metrics", "metric_types"),
       desc="metric names, '' uses objective default, 'None' disables",
       section="metric"),
    _p("metric_freq", int, 1, ("output_freq",), check="> 0",
       desc="metric output frequency", section="metric"),
    _p("is_provide_training_metric", bool, False,
       ("training_metric", "is_training_metric", "train_metric"),
       desc="output metrics on training data", section="metric"),
    _p("eval_at", list, [1, 2, 3, 4, 5],
       ("ndcg_eval_at", "ndcg_at", "map_eval_at", "map_at"),
       desc="evaluation positions for NDCG/MAP", section="metric"),

    # -- network ----------------------------------------------------------
    _p("num_machines", int, 1, ("num_machine",), check="> 0",
       desc="number of workers in the mesh axis (distributed)", section="network"),
    _p("local_listen_port", int, 12400, ("local_port",),
       desc="accepted for reference compatibility; unused on TPU (ICI mesh)",
       section="network"),
    _p("time_out", int, 120, (), desc="socket timeout in minutes (compat; unused)",
       section="network"),
    _p("machine_list_filename", str, "",
       ("machine_list_file", "machine_list", "mlist"),
       desc="machine list file (compat; unused on TPU)", section="network"),
    _p("machines", str, "", ("workers", "nodes"),
       desc="machine list (compat; unused on TPU)", section="network"),
    _p("network_timeout", float, 30.0, (), check="> 0.0",
       desc="per-operation socket timeout in SECONDS for the host-level "
            "point-to-point helpers (parallel/network.py connect/send/"
            "recv and the jax.distributed coordinator probe): a dead "
            "peer fails the operation with context instead of blocking "
            "the worker mesh forever. Distinct from the reference's "
            "time_out (minutes; kept for config compatibility, unused)",
       section="network"),
    _p("network_retries", int, 5, (), check="> 0",
       desc="max connect attempts (first try included) for the "
            "point-to-point helpers, with capped exponential backoff "
            "between attempts; exhausting them raises 'peer unreachable "
            "after N attempts' instead of hanging", section="network"),
    _p("coordinator_address", str, "", (),
       desc="host:port of the jax.distributed coordinator for "
            "data_sharding=multi_controller (docs/Sharding.md): rank 0 "
            "hosts it, every rank dials it during bring-up. Empty = "
            "read the LGBM_TPU_COORDINATOR env var (launchers usually "
            "set the env triple instead of editing per-host configs). "
            "All three of coordinator_address/num_hosts/host_rank must "
            "resolve or bring-up fails fast", section="network"),
    _p("num_hosts", int, 0, (), check=">= 0",
       desc="process count of the multi_controller pod slice (one "
            "process per host). 0 = read LGBM_TPU_NUM_HOSTS. Bring-up "
            "verifies jax.process_count() matches and fails fast on "
            "mismatch", section="network"),
    _p("host_rank", int, -1, (), check=">= -1",
       desc="this process's rank in [0, num_hosts) for "
            "multi_controller; rank 0 hosts the coordinator, runs "
            "streaming round 1 (count + reservoir + find-bin), "
            "broadcasts the BinMapper reference, and owns the pod "
            "checkpoint manifest. -1 = read LGBM_TPU_HOST_RANK",
       section="network"),

    # -- device -----------------------------------------------------------
    _p("gpu_platform_id", int, -1, (), desc="compat; ignored", section="device"),
    _p("gpu_device_id", int, -1, (), desc="compat; ignored", section="device"),
    _p("gpu_use_dp", bool, False, (),
       desc="use float64 histogram accumulation on device (maps the reference's "
            "gpu_use_dp); default float32", section="device"),
    _p("tpu_double_precision", bool, False, (),
       desc="alias-level switch for float64 accumulation on TPU", section="device"),
    _p("tpu_rows_per_block", int, 0, (),
       desc="rows per Pallas histogram grid block; 0 = auto", section="device"),
    _p("hist_kernel", str, "auto", (),
       check="auto/pallas/einsum/interpret",
       desc="wave-histogram implementation for the device grower: "
            "einsum = XLA one-hot matmul (default; fastest measured for "
            "bf16), pallas = VMEM-resident Pallas TPU kernel "
            "(ops/hist_pallas.py; serves full-width waves whose stat "
            "columns fit one 128-lane tile, bf16 or int8 — the int8 "
            "variant accumulates int8->int32 on the MXU and is "
            "byte-identical to the int8 einsum), interpret = Pallas "
            "interpreter mode (CPU testing/CI parity), auto = einsum. "
            "Routing per dispatch is recorded as grow.hist.* counters",
       section="device"),
    _p("grad_quant_bits", int, 0, ("gradient_quant_bits", "quant_bits"),
       check=">= 0",
       desc="int8-quantized gradient histograms for the device grower: "
            "0 (default) = full-precision bf16 hi/lo wave histograms; 8 = "
            "stochastically round grad/hess to int8 against a per-tree "
            "global scale so the wave contraction runs on the MXU's native "
            "int8->int32 path. Below ~16.9M rows (ops/grow."
            "INT32_SCAN_ROWS) the histograms stay INTEGER end-to-end "
            "through the find-best prefix-sum scan — counts, default-bin "
            "reconstruction and histogram subtraction are exact — and are "
            "dequantized only at gain/leaf-value math; larger datasets "
            "dequantize once in f32 before the scan. Leaf values are "
            "refit from full-precision gradients after growth either way "
            "(Shi et al., Quantized Training of GBDT, NeurIPS 2022). "
            "Ignored with gpu_use_dp. Only 0 and 8 are accepted",
       section="device"),
    _p("wave_plan", str, "auto", (),
       check="auto/fixed/profiled",
       desc="wave-stage plan for the device grower (ops/stage_plan.py): "
            "fixed = the byte-stable doubling plan; profiled = time the "
            "wave histogram kernel (csrc/wave_hist.cu) at every candidate "
            "stage width on the real codes at init, fit the fixed-vs-per-"
            "column wave cost and grow under the cheapest plan; auto = "
            "adopt a plan already measured for this (shape, config) "
            "signature (in process or in the store), else measure ON "
            "FIRST USE from 2^19 training rows when this config names a "
            "compile cache directory (the verdict is kept there: probe "
            "times are noisy, and an unkept plan would let same-config "
            "processes grow different trees), taking the derived plan "
            "only when it beats the doubling plan by 2% with its waves at "
            "their slowest probes and the doubling plan's at their "
            "fastest. Measured plans are kept in "
            "<compile_cache_dir>/stage_plans, so later boosters and "
            "fresh processes measure nothing",
       section="device"),
    _p("find_best_fusion", str, "auto", (),
       check="auto/fused/two_pass",
       desc="find-best placement inside the device grower's wave "
            "(ops/grow.py): fused = the wave's histogram contraction "
            "feeds the per-feature gain scan in ONE traced program per "
            "wave — the fresh and subtracted sibling histogram stacks "
            "are scanned in place and only the packed winner records "
            "plus the parent-minus-sibling residuals survive the wave, "
            "never a concatenated (2*wave, slots, stats) tensor "
            "round-tripping through HBM; two_pass = the legacy layout "
            "(histograms materialize, then a second scan pass reduces "
            "them); auto = fused, unless wave_plan=profiled measured "
            "two-pass faster for this (shape, config) and persisted "
            "that verdict beside the stage plan. Both paths are "
            "byte-identical in every guaranteed regime (f32, int8 "
            "einsum, int8 Pallas, striped columns, sharded "
            "single-controller); the mode joins programs_signature so "
            "switching retraces instead of reusing a stale program. "
            "Per-wave dispatch equivalents are recorded as "
            "grow.fused_find.* counters and the "
            "grow.wave_dispatch_factor gauge", section="device"),
    _p("grower_cache", bool, True, (),
       desc="share the device grower's jitted programs process-wide, "
            "keyed on (shape signature, config hash): a warm retrain "
            "window re-dispatches into already-traced programs (zero new "
            "traces; obs counters grow.cache_hits/grow.cache_misses). "
            "Disable only to debug trace-level issues", section="device"),
    _p("device_growth", str, "auto", ("tpu_device_growth",),
       check="auto/on/off",
       desc="fully on-device wave-synchronized tree growth (one dispatch "
            "per boosting iteration, no per-split host sync). auto and on "
            "= the device grower when the config is eligible (no monotone "
            "constraints/forced splits/renew-tree objectives/custom "
            "objective, fewer than 2^25 rows), else the host-driven "
            "learner; off = always use the host-driven learner",
       section="device"),
    _p("device_predict", str, "auto", ("tpu_device_predict",),
       check="auto/force/off",
       desc="routing for batch prediction (GBDT.predict_raw): auto = "
            "the packed-forest device kernel (serve/packed.py: whole "
            "ensemble flattened into padded device arrays, one jitted "
            "dispatch per batch, works for file-loaded models) when the "
            "batch has at least device_predict_min_rows rows, host tree "
            "walk below; force = always the device kernel; off = always "
            "the host walk. Row-wise pred_early_stop always takes the "
            "host path. Leaf routing is bit-identical between the two; "
            "accumulated values differ ~1e-6 relative (float32 device "
            "accumulation, docs/Serving.md)", section="device"),
    _p("device_predict_min_rows", int, 65536, (),
       check=">= 0",
       desc="batch size at which device_predict=auto switches from the "
            "host tree walk to the packed-forest device kernel: below "
            "it the host walk wins on latency (no transfer, no "
            "dispatch), above it the single fused device dispatch wins "
            "on throughput. Tune per deployment; the PredictionServer "
            "(lightgbm_tpu.serve) always uses the device kernel",
       section="device"),
    _p("serve_replicas", int, 1, (), check=">= 0",
       desc="device replicas for multi-tenant fleet serving "
            "(lightgbm_tpu.serve.FleetServer / LGBM_FleetCreate): the "
            "packed fleet arrays are copied onto this many local "
            "devices and request micro-batch queues round-robin across "
            "them, each replica degrading to the host tree walk "
            "independently through its own circuit breaker "
            "(docs/Serving.md). 0 = one replica per local device; 1 "
            "(default) = single-device serving", section="device"),
    _p("fleet_value_dtype", str, "f32", (),
       check="f32/bf16",
       desc="leaf-value storage dtype of the packed model fleet "
            "(lightgbm_tpu.serve.FleetServer): f32 (default) serves "
            "byte-identical to each tenant's solo PackedEnsemble; bf16 "
            "halves the leaf-table bytes for inference throughput — "
            "leaf ROUTING stays exact (the hi/lo threshold compare is "
            "untouched), only the accumulated VALUES quantize to ~3 "
            "decimal digits, mirroring the training-side int8 contract "
            "(routing exact, values quantize; docs/Serving.md)",
       section="device"),
    _p("train_row_bucketing", bool, True, ("row_bucketing",),
       desc="pad the training row count to a pow2 bucket (ops/histogram."
            "bucket_size, min 1024 — the same ladder the bagging buffer "
            "and the serving path already use) before the device "
            "grower's program-cache signature, so ONE compiled program "
            "family covers a whole traffic range of retrain-window sizes "
            "instead of one program per exact row count (the real row "
            "count travels as a traced scalar; padded rows carry zero "
            "gradient/hessian/count, exactly like the chunk pad). Trees "
            "are byte-identical to the unbucketed path. Auto-disabled "
            "with grad_quant_bits=8 (the stochastic rounding stream is "
            "keyed on the padded shape), for objectives whose fused "
            "device gradient is not row-local (lambdarank), and when "
            "the pow2 bucket would cross the striped-count bound "
            "(datasets over 2^24 rows fall back to exact rows, logged). "
            "See docs/ColdStart.md", section="device"),
    _p("data_sharding", str, "off", (),
       check="off/single_controller/multi_controller",
       desc="data-parallel training for the device grower "
            "(docs/Sharding.md): single_controller row-shards the "
            "binned matrix and every per-row buffer across a local "
            "device mesh with shard_map from ONE process, runs the "
            "fused K-trees-per-dispatch scan on all chips, and "
            "psum-reduces the wave histograms over the mesh axis as "
            "the growth loop's sole cross-device sync — find-best runs "
            "replicated on the global histograms, so every device "
            "grows the identical tree. Under grad_quant_bits=8's int32 "
            "scan, models are BYTE-identical to the single-device "
            "fused path; f32 histograms are bit-reproducible "
            "run-to-run. Falls back (logged) to unsharded training "
            "with fewer than 2 devices. multi_controller extends the "
            "same program to a pod slice: N processes (one per host) "
            "initialize jax.distributed against coordinator_address/"
            "num_hosts/host_rank, build ONE global mesh, and run the "
            "identical fused scan — program signatures are "
            "mesh-invariant, so a pod run is byte-identical to "
            "single_controller under the int32 quant scan; bring-up "
            "failures RAISE (a host silently falling back would wedge "
            "the slice on the psum). off (default) = unsharded; the "
            "multiprocess tree_learner=data/feature/voting mesh remains "
            "the socket-level fallback", section="device"),
    _p("shard_devices", int, 0, (), check=">= 0",
       desc="device count for data_sharding=single_controller: the "
            "first N local devices form the one-axis mesh; 0 (default) "
            "= all local devices", section="device"),
    _p("compile_cache_dir", str, "", ("xla_cache_dir",),
       desc="directory where the CUDA kernel libraries are built and "
            "found (lightgbm_tpu_torch.compile_cache), so a FRESH process "
            "builds nothing, and where profiled wave-stage plans are kept "
            "(stage_plans/) — the cross-process completion of the "
            "in-process grower_cache. Empty = use the "
            "LGBM_TPU_COMPILE_CACHE env var if set, else the package's "
            "build directory and no plan store. Warm a deployment's "
            "shapes with the warmup entry points (task=warmup / "
            "LGBM_WarmupTrain)",
       section="device"),
    _p("compile_cache_min_entry_bytes", int, 0, (),
       check=">= 0",
       desc="skip persisting compiled executables smaller than this "
            "many bytes (0 = persist everything, the default: the "
            "warm-cold-start contract and the CI zero-miss smoke need "
            "even sub-second glue ops cached). Raise it when a "
            "deployment wants a lean cache dir at the cost of a few "
            "small recompiles", section="device"),
    _p("compile_cache_strict_keys", bool, False, (),
       desc="sharing-safety knob for a compile cache dir mounted across "
            "heterogeneous hosts: include compiler/runtime build "
            "metadata in the cache key, so an executable compiled by a "
            "different jaxlib/XLA build is never reused (a guaranteed "
            "miss instead of trusting serialized-executable "
            "compatibility). Leave off for identical builds — strict "
            "keys make every software update a full cold start",
       section="device"),
    _p("warmup_rows", list, [], (),
       desc="task=warmup (CLI) / lightgbm_tpu.warmup: comma-separated "
            "training row counts to precompile grower programs for "
            "(each is padded to its pow2 bucket under "
            "train_row_bucketing, so one entry covers the whole "
            "bucket's window-size range)", section="device"),
    _p("warmup_features", int, 0, (),
       check=">= 0",
       desc="task=warmup: feature count of the declared training/"
            "serving shape (ignored when a data= file is given — the "
            "file's binned shape is used instead)", section="device"),
    _p("warmup_serve_rows", list, [], (),
       desc="task=warmup: serving batch-row buckets to precompile the "
            "packed-forest traversal for; unset = skip the serving "
            "warmup; a 0 entry = the PredictionServer warmup defaults "
            "(128/1024/8192 plus the device_predict_min_rows bucket)",
       section="device"),
    _p("fused_chunk", int, 20, (),
       check=">= 0",
       desc="boosting iterations fused into one dispatch by the "
            "multi-iteration training path (GBDT.train_chunked): each tree "
            "one launch of the captured tree graph, gradients and "
            "bagging/feature_fraction/int8 draws on the card, no host read "
            "inside the chunk. engine.train caps each dispatch at the next "
            "evaluation boundary so the callback cadence is unchanged; <= 1 "
            "disables fusing", section="device"),
    _p("dispatch_retries", int, 2, (), check=">= 0",
       desc="bounded retries (with short backoff) around a device "
            "dispatch that raises a TRANSIENT runtime error (the JAX "
            "runtime error type, OSError/TimeoutError, and injected "
            "faults) before the failure propagates — a preempted or "
            "briefly wedged accelerator gets dispatch_retries more "
            "chances; deterministic programs re-dispatch identically "
            "so a retry never changes results. 0 disables",
       section="device"),
    _p("deterministic", bool, True, (),
       desc="bit-deterministic device reductions where possible", section="device"),
)


PARAM_BY_NAME = {p.name: p for p in PARAM_SCHEMA}

#: TPU-only knobs of the JAX package, accepted and ignored by the port: it
#: has one histogram kernel (no einsum/Pallas choice, no Pallas grid) and
#: traces or compiles no XLA programs.  (``device_growth`` has a meaning:
#: ``off`` trains on the host learner.)
IGNORED_PARAMS = frozenset({
    "hist_kernel", "tpu_rows_per_block", "find_best_fusion",
    "compile_cache_min_entry_bytes", "compile_cache_strict_keys",
})

# alias -> canonical name (includes the canonical names themselves)
PARAM_ALIASES = {}
for _param in PARAM_SCHEMA:
    PARAM_ALIASES[_param.name] = _param.name
    for _a in _param.aliases:
        # first writer wins, like the reference alias table
        PARAM_ALIASES.setdefault(_a, _param.name)

# objective aliases resolved at value level (Config.set handles these)
OBJECTIVE_ALIASES = {
    "regression": "regression",
    "regression_l2": "regression",
    "l2": "regression",
    "mean_squared_error": "regression",
    "mse": "regression",
    "l2_root": "regression",
    "root_mean_squared_error": "regression",
    "rmse": "regression",
    "regression_l1": "regression_l1",
    "l1": "regression_l1",
    "mean_absolute_error": "regression_l1",
    "mae": "regression_l1",
    "huber": "huber",
    "fair": "fair",
    "poisson": "poisson",
    "quantile": "quantile",
    "mape": "mape",
    "mean_absolute_percentage_error": "mape",
    "gamma": "gamma",
    "tweedie": "tweedie",
    "binary": "binary",
    "multiclass": "multiclass",
    "softmax": "multiclass",
    "multiclassova": "multiclassova",
    "multiclass_ova": "multiclassova",
    "ova": "multiclassova",
    "ovr": "multiclassova",
    "cross_entropy": "cross_entropy",
    "xentropy": "cross_entropy",
    "cross_entropy_lambda": "cross_entropy_lambda",
    "xentlambda": "cross_entropy_lambda",
    "lambdarank": "lambdarank",
    "none": "none",
    "null": "none",
    "custom": "none",
    "na": "none",
}

METRIC_ALIASES = {
    "l1": "l1", "mean_absolute_error": "l1", "mae": "l1", "regression_l1": "l1",
    "l2": "l2", "mean_squared_error": "l2", "mse": "l2", "regression_l2": "l2",
    "regression": "l2",
    "l2_root": "rmse", "root_mean_squared_error": "rmse", "rmse": "rmse",
    "quantile": "quantile",
    "mape": "mape", "mean_absolute_percentage_error": "mape",
    "huber": "huber",
    "fair": "fair",
    "poisson": "poisson",
    "gamma": "gamma",
    "gamma_deviance": "gamma_deviance", "gamma-deviance": "gamma_deviance",
    "tweedie": "tweedie",
    "ndcg": "ndcg", "lambdarank": "ndcg",
    "map": "map", "mean_average_precision": "map",
    "auc": "auc",
    "binary_logloss": "binary_logloss", "binary": "binary_logloss",
    "binary_error": "binary_error",
    "multi_logloss": "multi_logloss", "multiclass": "multi_logloss",
    "softmax": "multi_logloss", "multiclassova": "multi_logloss",
    "multiclass_ova": "multi_logloss", "ova": "multi_logloss", "ovr": "multi_logloss",
    "multi_error": "multi_error",
    "cross_entropy": "cross_entropy", "xentropy": "cross_entropy",
    "cross_entropy_lambda": "cross_entropy_lambda", "xentlambda": "cross_entropy_lambda",
    "kullback_leibler": "kldiv", "kldiv": "kldiv",
    "": "", "none": "none", "null": "none", "na": "none", "custom": "none",
}

BOOSTING_ALIASES = {
    "gbdt": "gbdt", "gbrt": "gbdt",
    "dart": "dart",
    "goss": "goss",
    "rf": "rf", "random_forest": "rf",
}

TREE_LEARNER_ALIASES = {
    "serial": "serial",
    "feature": "feature", "feature_parallel": "feature",
    "data": "data", "data_parallel": "data",
    "voting": "voting", "voting_parallel": "voting",
}
