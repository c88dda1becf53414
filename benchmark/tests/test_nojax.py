"""No run may load JAX or the JAX package: the check compares each
loaded module's top-level name whole."""

import subprocess
import sys
from pathlib import Path

from benchmark.run import forbidden_modules

ROOT = Path(__file__).resolve().parents[2]


def test_top_level_names_compared_whole():
    mods = ["lightgbm_tpu_torch", "lightgbm_tpu_torch.ops.grow", "jaxtyping",
            "numpy", "lightgbm_tpu_tools", "jax", "jax.numpy", "jaxlib.xla",
            "lightgbm_tpu", "lightgbm_tpu.basic", "flax.linen"]
    assert forbidden_modules(mods) == ["flax.linen", "jax", "jax.numpy",
                                       "jaxlib.xla", "lightgbm_tpu",
                                       "lightgbm_tpu.basic"]


def test_harness_and_program_load_no_jax():
    code = ("import sys, importlib, pkgutil\n"
            "import benchmark, benchmark.run, benchmark.control\n"
            "import benchmark.loops as L, benchmark.metrics.common\n"
            "for m in pkgutil.iter_modules(L.__path__):\n"
            "    importlib.import_module('benchmark.loops.' + m.name)\n"
            "import lightgbm_tpu_torch, lightgbm_tpu_torch.engine\n"
            "from benchmark.run import forbidden_modules\n"
            "print(forbidden_modules(list(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
