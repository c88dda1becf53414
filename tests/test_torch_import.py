"""lightgbm_tpu_torch stands alone: importing it pulls in neither JAX nor
the JAX package, and its training entry point defaults to the GPU and
raises without one instead of running on the CPU."""

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
