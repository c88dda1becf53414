"""lightgbm_tpu_torch stands alone: importing it, its serving package,
chip_smoke.py's forest generators (synthetic_forests.py) or running the
histogram microbenchmark (scripts/ubench_hist_cuda.py) pulls in neither
JAX nor the JAX package, and its training and serving entry points
default to the GPU and raise without one instead of running on the
CPU."""

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _python(code, env=None):
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300,
                          env=env)


def test_import_pulls_in_no_jax():
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "import lightgbm_tpu_torch, lightgbm_tpu_torch.convert\n"
        "import lightgbm_tpu_torch.ops.grow, lightgbm_tpu_torch.ops.hist_cuda\n"
        "import lightgbm_tpu_torch.ops.bagging, lightgbm_tpu_torch.ops.split\n"
        "import lightgbm_tpu_torch.ops.histogram, lightgbm_tpu_torch.ops.traverse\n"
        "import lightgbm_tpu_torch.ops.routing\n"
        "import lightgbm_tpu_torch.callback\n"
        "import lightgbm_tpu_torch.data.stream_loader\n"
        "import lightgbm_tpu_torch.data.distributed\n"
        "import lightgbm_tpu_torch.ops.shard, lightgbm_tpu_torch.parallel\n"
        "import lightgbm_tpu_torch.parallel.network\n"
        "import lightgbm_tpu_torch.parallel.data_parallel\n"
        "import lightgbm_tpu_torch.parallel.feature_parallel\n"
        "import lightgbm_tpu_torch.parallel.voting_parallel\n"
        "import lightgbm_tpu_torch.utils.random, runpy\n"
        "import lightgbm_tpu_torch.serve, synthetic_forests\n"
        "runpy.run_path('scripts/ubench_hist_cuda.py')\n"
        "new = set(sys.modules) - before\n"
        "bad = sorted(m for m in new if m.split('.')[0] in "
        "('jax', 'jaxlib', 'lightgbm_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    out = _python(code)
    assert out.returncode == 0, out.stdout + out.stderr


def test_default_device_raises_without_a_card():
    code = (
        "import numpy as np, torch, lightgbm_tpu_torch as lt\n"
        "assert not torch.cuda.is_available()\n"
        "x = np.random.default_rng(0).standard_normal((200, 3))\n"
        "y = (x[:, 0] > 0).astype(float)\n"
        "try:\n"
        "    lt.train({'objective': 'binary', 'verbose': -1},\n"
        "             lt.Dataset(x, y), 2)\n"
        "except lt.LightGBMError as e:\n"
        "    print('raised:', e)\n"
        "else:\n"
        "    raise SystemExit('trained without a card')\n")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = _python(code, env=env)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "device_type=cuda" in out.stdout


def test_serve_pulls_in_no_jax():
    """The serving package alone, in a fresh interpreter."""
    code = (
        "import sys\n"
        "import lightgbm_tpu_torch.serve\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'lightgbm_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    out = _python(code)
    assert out.returncode == 0, out.stdout + out.stderr


def test_server_defaults_to_the_card_and_raises_without_one():
    code = (
        "import torch, lightgbm_tpu_torch as lt\n"
        "from lightgbm_tpu_torch.serve import PredictionServer\n"
        "assert not torch.cuda.is_available()\n"
        "text = open('tests/fixtures/ref_binary.model.txt').read()\n"
        "try:\n"
        "    PredictionServer(lt.Booster(model_str=text))\n"
        "except lt.LightGBMError as e:\n"
        "    print('raised:', e)\n"
        "else:\n"
        "    raise SystemExit('served without a card')\n")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = _python(code, env=env)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "device_type=cuda" in out.stdout


def test_ubench_runs_without_jax_on_the_cpu():
    """The microbenchmark's entry point, rehearsed on the CPU at a tiny
    size (its timings there say nothing of the card): one JSON line a
    case, and no JAX module loaded."""
    code = (
        "import json, sys, runpy\n"
        "sys.argv = ['ubench_hist_cuda.py', '--device', 'cpu', '--rows',\n"
        "            '4000', '--iters', '1', '--cases',\n"
        "            'hist3_w4,pallas2_w4_ch4096,apply_fused_w25']\n"
        "runpy.run_path('scripts/ubench_hist_cuda.py', run_name='__main__')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'lightgbm_tpu'))\n"
        "sys.exit(1 if bad else 0)\n")
    out = _python(code)
    assert out.returncode == 0, out.stdout + out.stderr
    lines = [json.loads(l) for l in out.stdout.splitlines()]
    assert [r["case"] for r in lines] == ["setup", "hist3_w4",
                                          "pallas2_w4_ch4096",
                                          "apply_fused_w25"]
    assert lines[0]["device"] == "cpu"


def test_operations_modules_pull_in_no_jax():
    """obs (the rolling windows, SLOs, the exporter and the attribution
    included), robust, the pipeline and the soak, in a fresh
    interpreter."""
    code = (
        "import sys\n"
        "import lightgbm_tpu_torch.obs, lightgbm_tpu_torch.robust\n"
        "import lightgbm_tpu_torch.obs.rolling, lightgbm_tpu_torch.obs.slo\n"
        "import lightgbm_tpu_torch.obs.export\n"
        "import lightgbm_tpu_torch.obs.profile\n"
        "import lightgbm_tpu_torch.pipeline, lightgbm_tpu_torch.soak\n"
        "import lightgbm_tpu_torch.soak.workload\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'lightgbm_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    out = _python(code)
    assert out.returncode == 0, out.stdout + out.stderr


def test_soak_defaults_to_the_card_and_raises_without_one():
    code = (
        "import torch, lightgbm_tpu_torch as lt\n"
        "from lightgbm_tpu_torch.soak import SoakDriver, SoakScenario\n"
        "assert not torch.cuda.is_available()\n"
        "sc = SoakScenario(tenants=1, windows=1, kills=0)\n"
        "try:\n"
        "    SoakDriver(sc).run()\n"
        "except lt.LightGBMError as e:\n"
        "    print('raised:', e)\n"
        "else:\n"
        "    raise SystemExit('a soak without a card')\n")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = _python(code, env=env)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "device_type=cuda" in out.stdout


def test_pipeline_defaults_to_the_card_and_raises_without_one():
    code = (
        "import torch, lightgbm_tpu_torch as lt\n"
        "from lightgbm_tpu_torch.pipeline import RetrainPipeline\n"
        "assert not torch.cuda.is_available()\n"
        "try:\n"
        "    RetrainPipeline({'objective': 'binary'})\n"
        "except lt.LightGBMError as e:\n"
        "    print('raised:', e)\n"
        "else:\n"
        "    raise SystemExit('a pipeline without a card')\n")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = _python(code, env=env)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "device_type=cuda" in out.stdout
