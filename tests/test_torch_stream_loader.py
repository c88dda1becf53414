"""The two-round streaming loader and the chunked CLI prediction of the
port (``data/stream_loader.py``, ``BinnedDataset.construct_streaming_*``,
``cli.py``) against the JAX package's, on files written from seeded numpy
data:

* csv with a header and a named label column in the middle, tsv, and
  libsvm, each at a sample smaller than the file and one covering it:
  codes and mappers byte-equal to ``lightgbm_tpu.data.stream_loader.
  load_text_two_round``, labels equal, and, with the whole file sampled,
  equal to the port's in-memory ``construct_from_matrix``;
* a truncated ``feature:value`` token names the same file and line in
  both packages;
* a consumer that stops early leaves no reader thread after 1 s;
* the CLI's ``two_round=true`` training equals the JAX CLI's (the host
  learners), and its chunked prediction writes the JAX CLI's file.
"""

import threading
import time

import numpy as np
import pytest
import torch

from lightgbm_tpu.cli import main as jmain
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.data import stream_loader as jsl
from lightgbm_tpu_torch.cli import main as tmain
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.data import stream_loader as tsl
from lightgbm_tpu_torch.data.dataset import BinnedDataset
from lightgbm_tpu_torch.utils.log import LightGBMError

ROWS, FEATURES = 1800, 6


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
    rng = np.random.default_rng(7)
    x = rng.standard_normal((ROWS, FEATURES))
    x[:, 2] = np.round(x[:, 2] * 3)          # few distinct values
    x[rng.random(ROWS) < 0.2, 3] = 0.0       # implicit zeros
    x[rng.random(ROWS) < 0.05, 4] = np.nan
    y = (x[:, 0] + 0.5 * x[:, 1] + rng.standard_normal(ROWS) * 0.3
         > 0).astype(np.float64)
    return x, y


def _fmt(v):
    return "na" if np.isnan(v) else repr(float(v))


def write_file(path, x, y, kind):
    """csv: a header and the label named ``target`` in column 2; tsv: the
    label first, missing values as ``na``; libsvm: nonzero
    ``index:value`` tokens."""
    lines = []
    if kind == "csv":
        names = [f"f{j}" for j in range(FEATURES)]
        names.insert(2, "target")
        lines.append(",".join(names))
        for row, lab in zip(x, y):
            # "nan" tokens: every row parses in one float pass
            toks = [repr(float(v)) for v in row]
            toks.insert(2, _fmt(lab))
            lines.append(",".join(toks))
    elif kind == "tsv":
        for row, lab in zip(x, y):
            lines.append("\t".join([_fmt(lab)] + [_fmt(v) for v in row]))
    else:
        for row, lab in zip(x, y):
            toks = [f"{j}:{float(v)!r}" for j, v in enumerate(row)
                    if v != 0.0 and not np.isnan(v)]
            lines.append(" ".join([_fmt(lab)] + toks))
    path.write_text("\n".join(lines) + "\n")
    return path


PARAMS = {"csv": {"header": True, "label_column": "name:target"},
          "tsv": {}, "libsvm": {}}


def _mapper_states(ds):
    return [repr(sorted(m.to_state().items())) for m in ds.bin_mappers]


@pytest.mark.parametrize("sample", [500, 5000])
@pytest.mark.parametrize("kind", ["csv", "tsv", "libsvm"])
def test_two_round_codes_equal_jax(tmp_path, data, kind, sample):
    x, y = data
    path = str(write_file(tmp_path / f"d.{kind}", x, y, kind))
    params = {**PARAMS[kind], "bin_construct_sample_cnt": sample,
              "max_bin": 63, "verbose": -1}
    jds, jlab = jsl.load_text_two_round(path, JConfig(params))
    tds, tlab = tsl.load_text_two_round(path, Config(params))
    assert tds.binned.dtype == np.uint8
    np.testing.assert_array_equal(tds.binned, np.asarray(jds.binned))
    assert _mapper_states(tds) == _mapper_states(jds)
    assert [g.feature_indices for g in tds.groups] == \
        [g.feature_indices for g in jds.groups]
    assert tds.feature_names == jds.feature_names
    np.testing.assert_array_equal(tlab, jlab)
    np.testing.assert_array_equal(tds.metadata.label,
                                  np.asarray(jds.metadata.label))
    if sample >= ROWS and kind != "libsvm":
        # the whole file sampled: the in-memory construction's codes
        mem = BinnedDataset.construct_from_matrix(x, Config(params))
        np.testing.assert_array_equal(tds.binned, mem.binned)
        assert _mapper_states(tds) == _mapper_states(mem)


def test_group_bin_boundaries_equal_jax(tmp_path, data):
    x, y = data
    path = str(write_file(tmp_path / "d.tsv", x, y, "tsv"))
    jds, _ = jsl.load_text_two_round(path, JConfig({"verbose": -1}))
    tds, _ = tsl.load_text_two_round(path, Config({"verbose": -1}))
    np.testing.assert_array_equal(tds.group_bin_boundaries(),
                                  jds.group_bin_boundaries())


def test_truncated_token_names_file_and_line(tmp_path, data):
    x, y = data
    path = write_file(tmp_path / "bad.libsvm", x[:40], y[:40], "libsvm")
    lines = path.read_text().splitlines()
    lines[16] = lines[16].rsplit(":", 1)[0] + ":"      # line 17: "3:"
    path.write_text("\n".join(lines) + "\n")
    errors = []
    for mod, cfg in ((jsl, JConfig({})), (tsl, Config({}))):
        with pytest.raises(Exception) as ei:
            mod.load_text_two_round(str(path), cfg)
        errors.append(str(ei.value))
    assert "line 17" in errors[1] and str(path) in errors[1]
    assert errors[1] == errors[0]


def test_reader_thread_ends_when_the_consumer_stops(tmp_path, data,
                                                    monkeypatch):
    x, y = data
    path = str(write_file(tmp_path / "d.tsv", x, y, "tsv"))
    monkeypatch.setattr(tsl, "_CHUNK_BYTES", 256)
    gen = tsl._chunk_reader(path, False)
    first_line, lines = next(gen)
    assert first_line == 1 and lines
    gen.close()
    deadline = time.monotonic() + 1.0
    alive = lambda: [t for t in threading.enumerate()
                     if t.name == "lgbm-stream-reader"]
    while alive() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert not alive()
    # a parse error stops the consumer the same way
    bad = tmp_path / "bad.libsvm"
    bad.write_text("1 0:1.0\n0 1:\n" * 200)
    with pytest.raises(LightGBMError, match="line 2"):
        list(tsl.iter_parsed_chunks(str(bad), Config({}), 2))
    time.sleep(0.2)
    assert not alive()


def test_cli_two_round_train_and_chunked_predict_equal_jax(tmp_path, data,
                                                           monkeypatch):
    x, y = data
    train = write_file(tmp_path / "train.tsv", x[:1500], y[:1500], "tsv")
    np.savetxt(str(train) + ".weight",
               np.random.default_rng(3).uniform(0.5, 1.5, 1500))
    # prediction rows one column short: both CLIs pad them with NaN
    test = tmp_path / "test.tsv"
    test.write_text("\n".join("\t".join([_fmt(lab)] + [_fmt(v) for v in
                                                       row[:-1]])
                              for row, lab in zip(x[1500:], y[1500:]))
                    + "\n")
    for mod in (tsl, jsl):
        monkeypatch.setattr(mod, "_CHUNK_BYTES", 4096)   # many chunks
    common = ["objective=binary", "num_leaves=7", "num_iterations=3",
              "two_round=true", "bin_construct_sample_cnt=700",
              "device_growth=off", "verbosity=-1"]
    jm, tm = tmp_path / "jm.txt", tmp_path / "tm.txt"
    jmain([f"data={train}", f"output_model={jm}"] + common)
    assert tmain([f"data={train}", f"output_model={tm}", "device=cpu"]
                 + common) == 0
    jtrees = jm.read_text().split("\nparameters:\n")[0].split("Tree=")[1:]
    ttrees = tm.read_text().split("\nparameters:\n")[0].split("Tree=")[1:]
    assert len(jtrees) == len(ttrees) == 3
    for a, b in zip(jtrees, ttrees):
        fields = lambda t, k: t.split(f"\n{k}=")[1].split("\n")[0]
        for k in ("split_feature", "left_child", "right_child",
                  "leaf_count"):
            assert fields(a, k) == fields(b, k), k
        np.testing.assert_allclose(
            np.asarray(fields(b, "leaf_value").split(), float),
            np.asarray(fields(a, "leaf_value").split(), float),
            rtol=1e-5, atol=1e-7)
    jp, tp, tp2 = (tmp_path / n for n in ("jp.txt", "tp.txt", "tp2.txt"))
    jmain(["task=predict", f"data={test}", f"input_model={jm}",
           f"output_result={jp}", "verbosity=-1"])
    assert tmain(["task=predict", f"data={test}", f"input_model={jm}",
                  f"output_result={tp}", "verbosity=-1",
                  "device=cpu"]) == 0
    assert tp.read_text() == jp.read_text()
    assert len(tp.read_text().splitlines()) == 300
    assert tmain(["task=predict", f"data={test}", f"input_model={tm}",
                  f"output_result={tp2}", "verbosity=-1",
                  "device=cpu"]) == 0
    np.testing.assert_allclose(np.loadtxt(tp2), np.loadtxt(jp), atol=1e-5)
    # a missing data file raises before the output file is touched
    tp.write_text("kept\n")
    with pytest.raises(LightGBMError, match="could not open"):
        tmain(["task=predict", f"data={tmp_path / 'none.tsv'}",
               f"input_model={tm}", f"output_result={tp}", "device=cpu"])
    assert tp.read_text() == "kept\n"
