"""lightgbm_tpu_torch: the PyTorch/CUDA port of lightgbm_tpu.

Trains a binary GBDT on an NVIDIA GPU: binning on the host (or, for a
float32 tensor, codes on its device), device gradients, and
leaf-wise tree growth in waves whose histograms come from a hand-written
CUDA kernel (``csrc/wave_hist.cu``).  Predicts and serves on the card
through a packed forest and a second hand-written kernel
(``csrc/forest_predict.cu``, ``serve/``).  Imports nothing of JAX or of
the JAX package.  Training and serving run on ``device='cuda'`` by
default and raise when no card is present; ``device='cpu'`` takes the
plain PyTorch path.  Validation sets are scored on the training device
as trees are added (``engine.train``'s ``valid_sets``, callbacks and early
stopping).  The fork's C ABI (``c_api.py``, ``capi_embed.py``, the native
library of ``src/capi_cuda/``) and the command line (``python -m
lightgbm_tpu_torch``) drive the same paths.
"""

from .basic import Booster, Dataset
from .config import Config
from .engine import cv, train
from .utils.log import LightGBMError

__version__ = "0.1.0"

__all__ = ["Booster", "Config", "Dataset", "LightGBMError", "cv", "train"]
