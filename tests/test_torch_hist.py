"""The wave histogram of the port (ops/hist_cuda.py) against the JAX
package's Pallas kernel, run in interpret mode on the CPU as
tests/test_hist_pallas.py runs it.

On the CPU the port's wrapper takes its plain PyTorch version; the CUDA
kernel itself is held against that plain version on the card
(tests/test_torch_cuda.py, and chip_smoke.py at full size)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from lightgbm_tpu.ops.hist_pallas import wave_hist_pallas
from lightgbm_tpu_torch.ops import hist_cuda


def _inputs(n=2048, g=3, nb=64, k=3, w=5, seed=0, quant=True):
    rng = np.random.default_rng(seed)
    binned = rng.integers(0, nb, (n, g)).astype(np.uint8)
    leaf = rng.integers(-1, w + 1, n).astype(np.int32)
    if quant:
        ghk = rng.integers(-127, 128, (n, k)).astype(np.int8)
    else:
        ghk = rng.standard_normal((n, k)).astype(np.float32)
    pending = np.arange(w, dtype=np.int32)
    return binned, leaf, ghk, pending


def _port(binned, leaf, ghk, pending, **kw):
    gh = torch.from_numpy(ghk)
    if gh.dtype == torch.float32:
        gh = gh.to(torch.bfloat16)
    out = hist_cuda.wave_hist(
        torch.from_numpy(np.ascontiguousarray(binned.T)),
        torch.from_numpy(leaf), gh, torch.from_numpy(pending), **kw)
    return out.float().numpy() if out.dtype != torch.int32 else out.numpy()


def _jax(binned, leaf, ghk, pending, **kw):
    gh = jnp.asarray(ghk)
    if gh.dtype == jnp.float32:
        gh = gh.astype(jnp.bfloat16)
    return np.asarray(wave_hist_pallas(jnp.asarray(binned),
                                       jnp.asarray(leaf), gh,
                                       jnp.asarray(pending), interpret=True,
                                       **kw))


@pytest.mark.parametrize("g,k,w", [(3, 3, 5), (2, 6, 4), (5, 3, 16)])
def test_int8_exact_against_pallas(g, k, w):
    """int8 -> int32 accumulation is associative: byte-equal to the JAX
    kernel, odd group counts included (its pair loop's tail)."""
    args = _inputs(g=g, k=k, w=w, seed=g + k)
    kw = dict(g=g, nb=64, k=k, w=w)
    got = _port(*args, **kw)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, _jax(*args, **kw))


@pytest.mark.parametrize("nb", [64, 256])
def test_bf16_against_pallas(nb):
    """bf16 products are exact in both; the f32 sums differ only in
    order, so rtol 1e-5 of each cell's magnitude (plus a 1e-5 floor for
    cells that cancel to ~0) bounds the difference."""
    g, k, w = 3, 3, 7
    args = _inputs(nb=nb, g=g, k=k, w=w, seed=7, quant=False)
    kw = dict(g=g, nb=nb, k=k, w=w)
    got = _port(*args, **kw)
    want = _jax(*args, **kw)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _oracle(binned, leaf, ghk, pending, g, nb, k, w):
    out = np.zeros((g * nb, k, w), np.float64)
    for wi in range(w):
        rows = (leaf == pending[wi]) & (pending[wi] >= 0)
        for gi in range(g):
            idx = gi * nb + binned[rows, gi].astype(np.int64)
            for kk in range(k):
                np.add.at(out[:, kk, wi], idx,
                          ghk[rows, kk].astype(np.float64))
    return out


@pytest.mark.parametrize("w,k", [(43, 3), (128, 3), (40, 6)])
def test_wide_waves_port_only(w, k):
    """W*K > 128: the TPU kernel refuses these widths (one 128-lane tile);
    the port serves every width.  Checked against a scalar oracle, with
    empty (-1) slots that must stay zero."""
    g, nb = 3, 64
    binned, leaf, ghk, pending = _inputs(n=3000, g=g, nb=nb, k=k, w=w,
                                         seed=w)
    pending[-3:] = -1
    got = _port(binned, leaf, ghk, pending, g=g, nb=nb, k=k, w=w)
    want = _oracle(binned, leaf, ghk, pending, g, nb, k, w)
    np.testing.assert_array_equal(got, want.astype(np.int32))
    assert not got[..., -3:].any()


def test_scale_exponents_keep_sums_in_int64():
    """The fixed-point exponent puts n * max|col| * 2**e at or below
    2**62 and uses the headroom (more than 2**61)."""
    rng = np.random.default_rng(3)
    n = 2_000_000
    for scale in (1e-6, 0.25, 1.0, 3.0, 1e5):
        col = torch.from_numpy((rng.standard_normal((64, 3)) * scale)
                               .astype(np.float32)).to(torch.bfloat16)
        e = hist_cuda.hist_scale_exponents(col, n).numpy()
        amax = col.float().abs().amax(0).double().numpy()
        bound = n * amax * np.exp2(e.astype(np.float64))
        assert (bound <= 2.0 ** 62).all() and (bound > 2.0 ** 59).all()
    zero = torch.zeros((8, 3), dtype=torch.bfloat16)
    assert hist_cuda.hist_scale_exponents(zero, n).tolist() == [0, 0, 0]


def test_rejects_bad_inputs():
    binned, leaf, ghk, pending = _inputs()
    bt = torch.from_numpy(np.ascontiguousarray(binned.T))
    kw = dict(g=3, nb=64, k=3, w=5)
    with pytest.raises(ValueError, match="bf16 or int8"):
        hist_cuda.wave_hist(bt, torch.from_numpy(leaf),
                            torch.from_numpy(ghk).float(),
                            torch.from_numpy(pending), **kw)
    with pytest.raises(ValueError, match="K must be"):
        hist_cuda.wave_hist(bt, torch.from_numpy(leaf),
                            torch.zeros((2048, 2), dtype=torch.int8),
                            torch.from_numpy(pending), **{**kw, "k": 2})
    with pytest.raises(ValueError, match="leaf_id"):
        hist_cuda.wave_hist(bt, torch.from_numpy(leaf).long(),
                            torch.from_numpy(ghk), torch.from_numpy(pending),
                            **kw)
