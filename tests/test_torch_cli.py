"""The port's file input and command line (``utils/file_io.py``,
``data/parser.py``, ``cli.py``) on the CPU: ``test_api.py::
test_cli_train_and_predict`` re-pointed at the port; the parser on TSV,
CSV (with a header) and LibSVM files and the ``.weight``/``.query``/
``.init`` side files against ``lightgbm_tpu.data.parser``; the loaded
dataset's codes and fields against the JAX CLI's ``_load_dataset``;
``convert_model``, ``refit`` and ``warmup``; ``task=soak``; and the
refusal by name of ``data_sharding=multi_controller`` (``two_round`` and
the chunked prediction: ``tests/test_torch_stream_loader.py``)."""

import gzip

import json

import numpy as np
import pytest
import torch

import parity_data as pd
from lightgbm_tpu.cli import _load_dataset as jax_load_dataset
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.data import parser as jparser
from lightgbm_tpu_torch import LightGBMError
from lightgbm_tpu_torch.cli import _load_dataset, main
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.data import parser


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """This module's torch CPU ops on one thread (several test workers
    share the machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    x = pd.make_features()
    y, _, _ = pd.make_labels(x)
    return x[:1500], y[:1500], x[1500:], y[1500:]


def test_cli_train_and_predict(tmp_path, data):
    x, y, xt, yt = data
    train_file = tmp_path / "train.csv"
    pred_file = tmp_path / "test.csv"
    np.savetxt(train_file, np.column_stack([y, x]), delimiter=",")
    np.savetxt(pred_file, np.column_stack([yt, xt]), delimiter=",")
    model_file = tmp_path / "model.txt"
    out_file = tmp_path / "pred.txt"
    assert main([f"data={train_file}", "objective=binary", "num_leaves=15",
                 "num_iterations=5", f"output_model={model_file}",
                 "verbosity=-1", "device=cpu"]) == 0
    assert model_file.exists()
    assert main(["task=predict", f"data={pred_file}",
                 f"input_model={model_file}", f"output_result={out_file}",
                 "verbosity=-1", "device=cpu"]) == 0
    preds = np.loadtxt(out_file)
    assert preds.shape[0] == len(yt)
    assert ((preds > 0.5) == (yt > 0)).mean() > 0.7
    # the same run from a config file, the arguments over the file
    conf = tmp_path / "train.conf"
    conf.write_text(f"data = {train_file}\nobjective = binary # comment\n"
                    f"num_leaves = 7\nnum_iterations = 5\n"
                    f"output_model = {tmp_path / 'm2.txt'}\n")
    assert main([f"config={conf}", "num_leaves=15", "verbosity=-1",
                 "device=cpu"]) == 0
    trees = lambda p: p.read_text().split("\nparameters:\n")[0]
    assert trees(tmp_path / "m2.txt") == trees(model_file)


def _write(path, lines, gz=False):
    opener = gzip.open if gz else open
    with opener(path, "wt") as fh:
        fh.write("\n".join(lines) + "\n")


@pytest.mark.parametrize("fmt", ["tsv", "csv_header", "libsvm", "tsv_gz"])
def test_parser_and_side_files_equal_jax(tmp_path, data, fmt):
    x, y, _, _ = data
    x = x[:200]
    y = y[:200]
    name = "d.txt.gz" if fmt == "tsv_gz" else "d.txt"
    path = str(tmp_path / name)
    rows = np.column_stack([y, x])
    if fmt in ("tsv", "tsv_gz"):
        lines = ["\t".join("nan" if np.isnan(v) else repr(float(v))
                           for v in r) for r in rows]
    elif fmt == "csv_header":
        lines = [",".join(["label"] + [f"f{i}" for i in range(x.shape[1])])]
        lines += [",".join("" if np.isnan(v) else repr(float(v))
                           for v in r) for r in rows]
    else:
        lines = [" ".join([repr(float(r[0]))]
                          + [f"{j}:{float(v)!r}" for j, v in
                             enumerate(r[1:]) if v != 0 and not np.isnan(v)])
                 for r in rows]
    _write(path, lines, gz=fmt == "tsv_gz")
    params = {"header": fmt == "csv_header", "verbosity": -1}
    tx, ty, tn = parser.load_text_file(path, Config(params))
    jx, jy, jn = jparser.load_text_file(path, JConfig(params))
    np.testing.assert_array_equal(tx, jx)
    np.testing.assert_array_equal(ty, jy)
    assert tn == jn
    np.savetxt(path + ".weight", np.linspace(0.5, 1.5, 200))
    np.savetxt(path + ".query", np.array([50, 70, 80]), fmt="%d")
    np.savetxt(path + ".init", np.linspace(-1, 1, 200))
    for load in ("load_weight_file", "load_query_file",
                 "load_init_score_file"):
        side = {"load_weight_file": ".weight", "load_query_file": ".query",
                "load_init_score_file": ".init"}[load]
        got = getattr(parser, load)(path + side)
        want = getattr(jparser, load)(path + side)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype
    assert parser.load_weight_file(path + ".missing") is None
    if fmt != "libsvm":
        params = {**params, "objective": "lambdarank", "max_bin": 63}
        td = _load_dataset(path, Config({**params, "device": "cpu"}))
        jd = jax_load_dataset(path, JConfig(params))
        np.testing.assert_array_equal(td.binned, np.asarray(jd.binned))
        for f in ("label", "weights", "query_boundaries", "init_score"):
            np.testing.assert_array_equal(getattr(td.metadata, f),
                                          np.asarray(getattr(jd.metadata,
                                                             f)))


def test_convert_model_refit_and_warmup_tasks(tmp_path, data):
    x, y, _, _ = data
    train_file = tmp_path / "train.tsv"
    np.savetxt(train_file, np.column_stack([y, x]), delimiter="\t")
    model = tmp_path / "model.txt"
    base = ["verbosity=-1", "device=cpu"]
    assert main([f"data={train_file}", "objective=binary", "num_leaves=7",
                 "num_iterations=3", f"output_model={model}"] + base) == 0
    cpp = tmp_path / "model.cpp"
    assert main(["task=convert_model", f"input_model={model}",
                 f"convert_model={cpp}"] + base) == 0
    code = cpp.read_text()
    assert code.count("double PredictTree") == 3
    assert "double Predict(const double* arr)" in code
    refit = tmp_path / "refit.txt"
    assert main(["task=refit", f"data={train_file}",
                 f"input_model={model}", f"output_model={refit}"]
                + base) == 0
    assert refit.read_text().count("Tree=") == 3
    assert main(["warmup", "warmup_rows=600", "warmup_features=4",
                 "warmup_serve_rows=64", "objective=binary",
                 "num_leaves=7", "num_iterations=2"] + base) == 0


@pytest.mark.parametrize("argv, name", [
    (["data_sharding=multi_controller", "objective=binary"],
     "multi_controller"),
])
def test_unported_tasks_refused_by_name(tmp_path, data, argv, name):
    """``name`` is no longer refused: the pod's CLI training without a
    coordinator raises the JAX package's load error (the pod legs
    themselves: tests/test_torch_multihost_pod.py)."""
    x, y, _, _ = data
    train_file = tmp_path / "train.csv"
    np.savetxt(train_file, np.column_stack([y, x])[:100], delimiter=",")
    assert f"data_sharding={name}" in argv
    with pytest.raises(LightGBMError, match="load_text_multihost: no "
                                            "coordinator configured"):
        main(argv + [f"data={train_file}", "device=cpu", "verbosity=-1"])


SOAK = {"tenants": 1, "windows": 2, "requests_per_window": 2048,
        "sample_rows": 512, "num_iterations": 4, "poison_batches": 0,
        "dead_peers": 0}


@pytest.mark.parametrize("argv", [["soak"], ["task=soak"]],
                         ids=["subcommand", "task"])
def test_soak_writes_its_verdict(tmp_path, monkeypatch, capsys, argv):
    """``soak`` (and ``task=soak``) runs the fleet chaos soak on ``device``,
    prints the verdict and writes it to ``soak_out``; a failing gate
    raises (the process exits non-zero)."""
    from lightgbm_tpu_torch import obs
    from lightgbm_tpu_torch.obs.state import STATE
    monkeypatch.setattr(STATE, "exporter", None)
    monkeypatch.setattr(STATE, "rolling", None)
    monkeypatch.setattr(STATE, "enabled", STATE.enabled)
    monkeypatch.setenv("LGBM_TPU_SOAK", json.dumps(
        dict(SOAK, out=str(tmp_path / "verdict.json"),
             checkpoint_dir=str(tmp_path / "ok"))))
    assert main(argv + ["device=cpu", "verbosity=-1"]) == 0
    verdict = json.loads((tmp_path / "verdict.json").read_text())
    assert verdict["ok"] and verdict["chip_pending"]
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) \
        == verdict
    monkeypatch.setenv("LGBM_TPU_SOAK", json.dumps(
        dict(SOAK, kills=0, device_deaths=1, device_death_persist=True,
             checkpoint_dir=str(tmp_path / "fail"))))
    with pytest.raises(LightGBMError, match="availability"):
        main(argv + ["device=cpu", "verbosity=-1"])
    STATE.exporter.stop()
    obs.reset()


def test_unknown_task_and_usage():
    assert main([]) == 1
    with pytest.raises(LightGBMError, match="unknown task"):
        main(["task=nope", "device=cpu"])
