"""Row bucketing and the int8 quantization of gradients (the parts of
``lightgbm_tpu/ops/histogram.py`` the port needs).

The grower pads its row buffers to a power-of-two bucket so that one set of
buffer shapes serves a whole range of dataset sizes.

``grad_quant_bits=8`` stochastically rounds each tree's gradients and
hessians to int8 against one global scale per column (Shi et al.,
*Quantized Training of Gradient Boosting Decision Trees*, NeurIPS 2022), so
the wave histograms accumulate exactly in int32.  The rounding noise comes
from the port's Threefry (``utils/random.py``), keyed as the JAX package
keys it, so the int8 columns are the JAX package's byte for byte.  Element
``i`` of a Threefry draw depends on ``i`` and the key only, so the noise of
a row does not depend on how far the caller padded the rows.
"""

from __future__ import annotations

import torch

from ..utils import random as trandom

#: int8 quantization range: symmetric [-127, 127] (-128 unused, so
#: negation stays exact)
QUANT_MAX = 127.0


def bucket_size(count: int, minimum: int = 1024) -> int:
    """Smallest power of two >= ``count`` (and >= ``minimum``)."""
    b = minimum
    while b < count:
        b <<= 1
    return b


def quant_scales(grad: torch.Tensor, hess: torch.Tensor, eps: float = 1e-30):
    """() f32 scales mapping max|g| and max|h| onto the int8 range."""
    sg = torch.clamp(grad.abs().max(), min=eps) / QUANT_MAX
    sh = torch.clamp(hess.abs().max(), min=eps) / QUANT_MAX
    return sg, sh


def stochastic_round_with(x: torch.Tensor, scale: torch.Tensor,
                          u: torch.Tensor) -> torch.Tensor:
    """``floor(x / scale + u)`` clipped to +-127, as int8: unbiased for
    ``u`` uniform in [0, 1)."""
    q = torch.floor(x / scale + u)
    return torch.clamp(q, -QUANT_MAX, QUANT_MAX).to(torch.int8)


def stochastic_round_int8(x: torch.Tensor, scale: torch.Tensor,
                          key) -> torch.Tensor:
    """:func:`stochastic_round_with` with the noise drawn from ``key`` at
    ``x``'s shape."""
    u = trandom.uniform(key, tuple(x.shape), device=x.device)
    return stochastic_round_with(x, scale, u)


def quantize_gh(grad: torch.Tensor, hess: torch.Tensor, key):
    """(scale_g, scale_h, g_int8, h_int8) of one tree's gradients; ``key``
    is ``fold_in(PRNGKey(seed), tree_idx)``, split into the g and h
    keys."""
    kg, kh = trandom.split(key)
    sg, sh = quant_scales(grad, hess)
    return (sg, sh, stochastic_round_int8(grad, sg, kg),
            stochastic_round_int8(hess, sh, kh))
