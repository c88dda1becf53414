"""A later change adds a configuration, its data generator, its
objective's reference, a traffic mix, a cell and a per-layer metric as
new files and entries only: in a copy of the benchmark, a new cell over
new files runs, is judged by the new objective's reference and reports
the new metric, and no file that was there is edited."""

import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def test_new_cell_and_metric_from_new_files(tmp_path):
    from benchmark import run
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()
              and p.name != "BENCHMARK.json"}
    b = root / "benchmark"
    cfg = json.loads((b / "configs" / "higgs.json").read_text())
    cfg.update(name="blobs", data="blobs", train_rows=6000,
               reduced=["train_rows"])
    cfg["params"].update(num_leaves=15, objective="cross_entropy")
    (b / "configs" / "blobs.json").write_text(json.dumps(cfg))
    # rows of 6 normal columns; labels are probabilities, as the
    # cross-entropy objective takes them
    (b / "data" / "blobs.py").write_text(
        "import torch\n"
        "from benchmark.data import generator\n\n\n"
        "def make(n, seed, stream, device, **_):\n"
        "    g = generator(seed, stream, device)\n"
        "    x = torch.randn((n, 6), generator=g, device=device)\n"
        "    y = torch.sigmoid(2.0 * x[:, 0] - x[:, 1] * x[:, 2])\n"
        "    return x, y\n")
    (b / "reference" / "objectives" / "cross_entropy.py").write_text(
        "import math\n"
        "import torch\n\n\n"
        "def init_score(y):\n"
        "    p = min(max(float(y.double().mean()), 1e-15), 1 - 1e-15)\n"
        "    return math.log(p / (1.0 - p))\n\n\n"
        "def gradients(score, y):\n"
        "    z = torch.sigmoid(score.float())\n"
        "    return z - y.float(), z * (1.0 - z)\n")
    (b / "traffic" / "fused_train_short.json").write_text(json.dumps(
        {"loop": "fused_train", "chunk": 4, "judged_chunks": 2,
         "sample_among": 1, "trace_steps": 1,
         "metric": "train_iters_per_s"}))
    (b / "limits" / "blobs.train.json").write_text(json.dumps(
        {"codes_mismatch": {"limit": 0}, "split_regret": {"limit": 1e-5},
         "leaf_gap": {"limit": 1e-5}, "median_leaf_gap": {"limit": None},
         "score_gap": {"limit": 1e-4}}))
    (b / "metrics" / "leaves_per_tree.train.py").write_text(
        "def read(facts):\n"
        "    return sum(t.num_leaves for t in facts['trees']) / "
        "len(facts['trees'])\n")
    doc = json.loads((root / "BENCHMARK.json").read_text())
    doc["configs"].append({"name": "blobs", "source": cfg["source"],
                           "file": "benchmark/configs/blobs.json",
                           "reduced": ["train_rows"], "why": "a test"})
    doc["workloads"].append({"name": "blobs.train",
                             "config": "blobs",
                             "traffic": "fused_train_short", "chips": 1,
                             "why": "a test"})
    for m in doc["end_to_end"]:
        if m["name"] == "train_iters_per_s":
            m["workloads"].append("blobs.train")
    doc["per_layer"].append({"name": "leaves_per_tree.train", "unit": "leaves",
                             "better": "higher", "source": "program_counter",
                             "layer": "grower", "moves": "train_iters_per_s",
                             "workloads": ["blobs.train"]})
    (root / "BENCHMARK.json").write_text(json.dumps(doc))
    run.set_env()
    res = run.run("blobs.train", 77, 0.2, True, device_name="cpu",
                  out_root=tmp_path / "out", root=root)
    assert res["correct"], res["checks"]
    assert 2 <= res["metrics"]["leaves_per_tree.train"]["value"] <= 15
    assert {p: p.read_bytes() for p in before} == before
    # the judge reads the new objective's reference: with the binary
    # one's gradients in its place, the same training is not correct
    (b / "reference" / "objectives" / "cross_entropy.py").write_bytes(
        (b / "reference" / "objectives" / "binary.py").read_bytes())
    res = run.run("blobs.train", 77, 0.2, False, device_name="cpu",
                  out_root=tmp_path / "out", root=root)
    assert not res["correct"], res["checks"]
