"""The wave histograms of the port (ops/hist_cuda.py) against the JAX
package's Pallas kernels, run in interpret mode on the CPU as
tests/test_hist_pallas.py runs them.

On the CPU the port's wrappers take their plain PyTorch version; the CUDA
kernels themselves are held against that plain version on the card
(tests/test_torch_cuda.py, and chip_smoke.py at full size)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from lightgbm_tpu.ops.hist_pallas import (_wave_hist_pallas_v2,
                                          wave_hist_pallas)
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
    # f32 stat columns are a mode of the kernel (the host learner's); f64
    # ones are not
    with pytest.raises(ValueError, match="bf16, int8 or f32"):
        hist_cuda.wave_hist(bt, torch.from_numpy(leaf),
                            torch.from_numpy(ghk).double(),
                            torch.from_numpy(pending), **kw)
    with pytest.raises(ValueError, match="K must be"):
        hist_cuda.wave_hist(bt, torch.from_numpy(leaf),
                            torch.zeros((2048, 2), dtype=torch.int8),
                            torch.from_numpy(pending), **{**kw, "k": 2})
    with pytest.raises(ValueError, match="leaf_id"):
        hist_cuda.wave_hist(bt, torch.from_numpy(leaf).long(),
                            torch.from_numpy(ghk), torch.from_numpy(pending),
                            **kw)


@pytest.mark.parametrize("w,pending", [
    (5, None),
    (4, [2, 0, 2, -1]),                 # a duplicate id and an empty slot
    (50, "dup"),                        # W*K = 150 > 128: two lane tiles
], ids=["w5", "w4_dup_empty", "w50_dup"])
def test_v2_against_pallas_v2(w, pending):
    """wave_hist_v2's plain version (the one the CPU path takes) against
    the JAX v2 kernel in interpret mode, within 1e-4 of each cell's sum of
    |stats| plus 1e-6 (the same f32 sums in another order).  Rows of leaf
    -1 carry zero stats, as the grower's padding does, so an empty slot is
    zero in both."""
    g, nb, k, n = 3, 64, 3, 2048
    binned, leaf, ghk, _ = _inputs(n=n, g=g, nb=nb, k=k, w=w, seed=w,
                                   quant=False)
    ghk[leaf < 0] = 0.0
    if pending is None:
        pend = np.arange(w, dtype=np.int32)
    elif pending == "dup":
        pend = np.random.default_rng(1).integers(0, w // 2, w) \
            .astype(np.int32)
        assert len(set(pend.tolist())) < w
    else:
        pend = np.asarray(pending, np.int32)
    kw = dict(g=g, nb=nb, k=k, w=w)
    bt = torch.from_numpy(np.ascontiguousarray(binned.T))
    gh = torch.from_numpy(ghk).to(torch.bfloat16)
    got = hist_cuda.wave_hist_v2(bt, torch.from_numpy(leaf), gh,
                                 torch.from_numpy(pend), ch=512, **kw)
    want = np.asarray(_wave_hist_pallas_v2(
        jnp.asarray(binned), jnp.asarray(leaf),
        jnp.asarray(ghk).astype(jnp.bfloat16), jnp.asarray(pend), ch=512,
        interpret=True, **kw))
    mag = hist_cuda.wave_hist_reference(bt, torch.from_numpy(leaf),
                                        gh.abs(), torch.from_numpy(pend),
                                        **kw).numpy()
    assert got.dtype == torch.float32 and got.shape == (g * nb, k, w)
    assert (np.abs(got.numpy() - want) <= 1e-4 * mag + 1e-6).all()
    for a, b in zip(*np.nonzero(pend[:, None] == pend[None, :])):
        np.testing.assert_array_equal(got[..., a], got[..., b])
    if (pend < 0).any():
        assert not got[..., pend < 0].any()


def test_v2_refuses_int8_and_bad_geometry():
    binned, leaf, ghk, pending = _inputs()
    bt = torch.from_numpy(np.ascontiguousarray(binned.T))
    kw = dict(g=3, nb=64, k=3, w=5)
    args = (bt, torch.from_numpy(leaf), torch.from_numpy(ghk),
            torch.from_numpy(pending))
    with pytest.raises(ValueError, match="bf16"):
        hist_cuda.wave_hist_v2(*args, **kw)
    gh = torch.from_numpy(ghk).float().to(torch.bfloat16)
    args = args[:2] + (gh,) + args[3:]
    with pytest.raises(ValueError, match="multiple of 128"):
        hist_cuda.wave_hist_v2(*args, ch=1000, **kw)
    with pytest.raises(ValueError, match="multiple of 32"):
        hist_cuda.wave_hist_v2(*args, **{**kw, "nb": 48})


@pytest.mark.parametrize("n,g,nb,k,w,ch", [
    (2_000_000, 28, 64, 3, 128, 4096),
    (10_518_528, 28, 64, 3, 4, 4096),
    (2_000_000, 28, 256, 3, 128, 2048),
    (1000, 3, 64, 3, 50, 128),
    (4096, 3, 32, 3, 1, 128),
])
def test_v2_geometry_covers_every_row_once(n, g, nb, k, w, ch):
    """Every (output row, column, row block of ch) is covered by exactly
    one work item; columns pad to a multiple of 16 (16 at W=4), not 64."""
    geo = hist_cuda._v2_geometry(n, g, nb, k, w, ch, 132)
    assert geo.b_pad % 16 == 0 and k * w <= geo.b_pad < k * w + 16 * geo.ctiles
    assert geo.n_tile <= 192 and geo.b_pad == geo.ctiles * geo.n_tile
    assert geo.rows_per_split % ch == 0
    assert (geo.splits - 1) * geo.rows_per_split < n <= \
        geo.splits * geo.rows_per_split
    # persistent CTAs: two a SM for tiles of at most 32 columns
    assert geo.grid == min(geo.items, 132 * (2 if geo.n_tile <= 32 else 1))
    blocks = -(-n // ch)
    seen = np.zeros((g * nb, geo.b_pad, blocks), np.int32)
    for rows_out, cols, rows in hist_cuda._v2_items(geo, n, g, nb):
        assert rows.start % ch == 0 and len(rows) > 0
        seen[rows_out.start:rows_out.stop, cols.start:cols.stop,
             rows.start // ch:-(-rows.stop // ch)] += 1
    assert (seen == 1).all()
    if w == 4:
        assert geo.b_pad == 16


@pytest.mark.parametrize("w", [1, 16, 33, 128, 200])
@pytest.mark.parametrize("k", [3, 6])
@pytest.mark.parametrize("quant", [False, True])
def test_geometry_owns_every_cell_once(w, k, quant):
    """wave_hist's launch shape at the training shape (28 groups, NB=256,
    2M rows), bf16 and int8: within each part every (group, bin, stat,
    slot) cell is held by exactly one CTA; in each group tile every row of
    the wave is read once, by the CTA that holds its slot (at W=1 every
    row is read once, at wider waves only the rows of the wave); the
    shared memory fits a CTA."""
    n, g, nb = 2_000_000, 28, 256
    geo = hist_cuda._geometry(n, g, nb, k, w, quant, 132)
    assert geo.smem <= 227 * 1024 and geo.tiles * geo.wt >= w
    assert (geo.tiles == 1) == (w * nb * k * (4 if quant else 8)
                                <= hist_cuda._SMEM_BUDGET)
    gen = torch.Generator().manual_seed(w + k)
    leaf = torch.randint(0, 2 * w + 1, (n,), generator=gen)
    slot = torch.where(leaf < w, leaf, -1).to(torch.int16)
    owned = np.zeros((geo.splits, g, w), np.int32)   # x NB x K, uniformly
    reads = {}
    for cta, groups, own, rows in hist_cuda._cta_work(geo, slot, g, w):
        owned[cta[0], groups.start:groups.stop, own.start:own.stop] += 1
        s = slot[rows].long()
        hit = s >= 0
        assert ((s[hit] >= own.start) & (s[hit] < own.stop)).all()
        if w > 1:
            assert hit.all()
        cover = reads.setdefault(cta[1], torch.zeros(n, dtype=torch.int32))
        cover.index_add_(0, rows, torch.ones_like(rows, dtype=torch.int32))
    assert (owned == 1).all()
    assert len(reads) == -(-g // geo.gb)
    for cover in reads.values():
        want = torch.ones(n) if w == 1 else (slot >= 0).float()
        assert torch.equal(cover.float(), want)


def _fixed_inputs(n=3000, g=3, nb=64, k=3, w=6, seed=0):
    rng = np.random.default_rng(seed)
    bt = torch.from_numpy(rng.integers(0, nb, (g, n)).astype(np.uint8))
    leaf = torch.from_numpy(rng.integers(-1, w + 1, n).astype(np.int32))
    ghk = torch.from_numpy((rng.standard_normal((n, k)) * 3)
                           .astype(np.float32)).to(torch.bfloat16)
    ghk[leaf < 0] = 0
    pending = torch.arange(w, dtype=torch.int32)
    return bt, leaf, ghk, pending


@pytest.mark.parametrize("nb,k,w", [(64, 3, 6), (256, 6, 9)])
def test_fixed_reference_against_plain_and_pallas(nb, k, w):
    """wave_hist_fixed_reference (the exact oracle of the bf16 kernel)
    against the f32 plain version within 1e-4 of each cell's sum of
    |stats| plus 1e-6, and against the JAX kernel in interpret mode as
    test_bf16_against_pallas holds the plain version."""
    g, n = 3, 2048                  # the JAX kernel's chunk divides n
    bt, leaf, ghk, pending = _fixed_inputs(n, g, nb, k, w, seed=nb + k)
    kw = dict(g=g, nb=nb, k=k, w=w)
    scale = hist_cuda.hist_scale_exponents(ghk, n)
    got = hist_cuda.wave_hist_fixed_reference(bt, leaf, ghk, pending, scale,
                                              **kw)
    ref = hist_cuda.wave_hist_reference(bt, leaf, ghk, pending, **kw)
    mag = hist_cuda.wave_hist_reference(bt, leaf, ghk.abs(), pending, **kw)
    assert got.dtype == torch.float32 and got.shape == (g * nb, k, w)
    assert ((got - ref).abs() <= 1e-4 * mag + 1e-6).all()
    if k * w <= 128:
        want = _jax(bt.numpy().T, leaf.numpy(), ghk.float().numpy(),
                    pending.numpy(), **kw)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_fixed_reference_is_order_free():
    """Integer sums do not depend on their order: permuting the rows
    leaves the fixed-point histogram bit-identical (the exactness the
    bf16 kernel relies on), where the f32 plain version may move."""
    g, nb, k, w, n = 3, 64, 3, 5, 4000
    bt, leaf, ghk, pending = _fixed_inputs(n, g, nb, k, w, seed=21)
    perm = torch.from_numpy(np.random.default_rng(5).permutation(n))
    kw = dict(g=g, nb=nb, k=k, w=w)
    scale = hist_cuda.hist_scale_exponents(ghk, n)
    a = hist_cuda.wave_hist_fixed_reference(bt, leaf, ghk, pending, scale,
                                            **kw)
    b = hist_cuda.wave_hist_fixed_reference(
        bt[:, perm].contiguous(), leaf[perm].contiguous(),
        ghk[perm].contiguous(), pending, scale, **kw)
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """This module's torch CPU ops on one thread: with several test
    workers on one machine, each op's OpenMP team of one thread a core
    oversubscribes the cores, and the port's test files ran 10-60x
    slower than alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
