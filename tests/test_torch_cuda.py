"""lightgbm_tpu_torch on the card: the CUDA kernels (wave histograms,
packed-forest prediction) against their plain version, Threefry on the
card against the CPU, training on cuda against training on the CPU path,
and Booster.predict through the forest kernel.

Every test here needs an NVIDIA GPU and nvcc; without them they skip.
This file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.ops import hist_cuda

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernel has no CPU mode)")
    return torch.device("cuda")


def _inputs(dev, n, g, nb, k, w, quant, seed=0):
    rng = np.random.default_rng(seed)
    bins = torch.from_numpy(rng.integers(0, nb, (g, n)).astype(np.uint8))
    leaf = torch.from_numpy(rng.integers(-1, w + 1, n).astype(np.int32))
    if quant:
        ghk = torch.from_numpy(rng.integers(-127, 128, (n, k))
                               .astype(np.int8))
    else:
        ghk = torch.from_numpy(rng.standard_normal((n, k))
                               .astype(np.float32)).to(torch.bfloat16)
    pending = torch.arange(w, dtype=torch.int32)
    pending[-1] = -1                                   # an empty slot
    return [t.to(dev) for t in (bins, leaf, ghk, pending)]


@pytest.mark.parametrize("n,g,nb,k,w,quant", [
    (50_000, 5, 256, 3, 37, False),
    (50_000, 5, 256, 3, 37, True),
    (40_003, 3, 64, 6, 130, True),      # odd n: the scalar-load path
    (40_003, 4, 128, 5, 9, False),
])
def test_kernel_matches_plain_on_card(cuda_device, n, g, nb, k, w, quant):
    """int8 byte-equal to the plain version; bf16 within 1e-4 of each
    cell's sum of |stats| (the plain version's f32 atomics sum in any
    order) and bit-identical across runs."""
    bins, leaf, ghk, pending = _inputs(cuda_device, n, g, nb, k, w, quant)
    kw = dict(g=g, nb=nb, k=k, w=w)
    before = hist_cuda.wave_hist.launches.read()
    a = hist_cuda.wave_hist(bins, leaf, ghk, pending, **kw)
    b = hist_cuda.wave_hist(bins, leaf, ghk, pending, **kw)
    assert hist_cuda.wave_hist.launches.read() == before + 2
    ref = hist_cuda.wave_hist_reference(bins, leaf, ghk, pending, **kw)
    assert torch.equal(a, b)
    assert not a[..., -1].any()
    if quant:
        assert torch.equal(a, ref)
    else:
        mag = hist_cuda.wave_hist_reference(bins, leaf, ghk.abs(), pending,
                                            **kw)
        assert ((a - ref).abs() <= 1e-4 * mag + 1e-6).all()


def test_wrapper_refuses_what_the_kernel_does_not_take(cuda_device):
    bins, leaf, ghk, pending = _inputs(cuda_device, 4096, 2, 64, 3, 4,
                                       False)
    kw = dict(g=2, nb=64, k=3, w=4)
    with pytest.raises(ValueError, match="contiguous"):
        hist_cuda.wave_hist(bins.t().contiguous().t(), leaf, ghk, pending,
                            **kw)
    with pytest.raises(ValueError, match="different devices"):
        hist_cuda.wave_hist(bins, leaf.cpu(), ghk, pending, **kw)


def test_training_on_card_matches_cpu_path(cuda_device):
    """Same data, same params: the cuda run (kernel histograms) and the
    CPU run (plain histograms) grow the same first tree and predict
    within 1e-4; every wave's histogram came from the kernel."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((20_000, 6))
    x[rng.random(x.shape) < 0.05] = np.nan
    y = (np.nan_to_num(x[:, 0]) + 0.5 * np.nan_to_num(x[:, 1]) ** 2
         + 0.3 * rng.standard_normal(len(x)) > 0.4).astype(float)
    params = {"objective": "binary", "num_leaves": 31, "max_bin": 63,
              "verbose": -1}
    hist_cuda.wave_hist.launches.reset()
    on_card = lt.train(params, lt.Dataset(x, y), 5)
    gb = on_card._gbdt
    assert gb.device.type == "cuda"
    assert hist_cuda.wave_hist.launches.read() \
        == sum(s[2] for s in gb.tree_stats) \
        + gb._grower.capture_stats["warmup_waves"]
    on_cpu = lt.train({**params, "device": "cpu"}, lt.Dataset(x, y), 5)
    assert on_card.num_trees() == on_cpu.num_trees() == 5
    t_card, t_cpu = gb.models[0], on_cpu._gbdt.models[0]
    n = t_card.num_leaves
    assert n == t_cpu.num_leaves
    np.testing.assert_array_equal(t_card.split_feature[:n - 1],
                                  t_cpu.split_feature[:n - 1])
    np.testing.assert_array_equal(t_card.threshold_in_bin[:n - 1],
                                  t_cpu.threshold_in_bin[:n - 1])
    np.testing.assert_allclose(on_card.predict(x, raw_score=True),
                               on_cpu.predict(x, raw_score=True), atol=1e-4)


@pytest.mark.parametrize("n,g,nb,w,dup", [
    (50_000, 5, 256, 37, False),
    (40_003, 3, 64, 50, True),          # odd n, W*K > 128, duplicate ids
    (70_000, 4, 128, 4, False),
])
def test_v2_kernel_matches_plain_on_card(cuda_device, n, g, nb, w, dup):
    """wave_hist_v2 (tensor-core one-hot product) within 1e-4 of each
    cell's sum of |stats| plus 1e-6 of the plain version, bit-identical
    across runs, empty slot zero, duplicate slots equal."""
    bins, leaf, ghk, pending = _inputs(cuda_device, n, g, nb, 3, w, False)
    if dup:
        pending[: w // 2] = pending[w // 2: 2 * (w // 2)]
    kw = dict(g=g, nb=nb, k=3, w=w)
    before = hist_cuda.wave_hist_v2.launches
    a = hist_cuda.wave_hist_v2(bins, leaf, ghk, pending, ch=2048, **kw)
    b = hist_cuda.wave_hist_v2(bins, leaf, ghk, pending, ch=2048, **kw)
    assert hist_cuda.wave_hist_v2.launches == before + 2
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    ref = hist_cuda.wave_hist_reference(bins, leaf, ghk, pending, **kw)
    mag = hist_cuda.wave_hist_reference(bins, leaf, ghk.abs(), pending, **kw)
    assert ((a - ref).abs() <= 1e-4 * mag + 1e-6).all()
    assert not a[..., -1].any()
    if dup:
        assert torch.equal(a[..., : w // 2], a[..., w // 2: 2 * (w // 2)])


@pytest.mark.parametrize("w", [1, 33, 128, 200])
@pytest.mark.parametrize("k", [3, 6])
def test_kernel_bf16_equals_fixed_reference(cuda_device, w, k):
    """The bf16 kernel's sums are exact integers in fixed point: it must
    equal wave_hist_fixed_reference bit for bit, at a one-slot wave (W=1,
    every row read unsorted), a ragged slot tile (W=33), the full-width
    wave (W=128, four slot tiles at NB=256) and a wave past 255 leaves
    (W=200)."""
    n, g, nb = 30_016, 3, 256
    bins, leaf, ghk, pending = _inputs(cuda_device, n, g, nb, k, w, False,
                                       seed=w + k)
    pending[0] = 0                      # W=1: the slot is not empty
    leaf = torch.randint(0, 2 * w + 1, (n,), device=cuda_device,
                         dtype=torch.int32)
    kw = dict(g=g, nb=nb, k=k, w=w)
    scale = hist_cuda.hist_scale_exponents(ghk, n)
    a = hist_cuda.wave_hist(bins, leaf, ghk, pending, scale_exp=scale, **kw)
    want = hist_cuda.wave_hist_fixed_reference(bins, leaf, ghk, pending,
                                               scale, **kw)
    assert torch.equal(a.view(torch.int32), want.view(torch.int32))
    if w > 1:
        assert not a[..., -1].any()


@pytest.mark.parametrize("w,k", [(1, 3), (33, 3), (128, 3), (200, 6)])
def test_kernel_int8_byte_equal(cuda_device, w, k):
    n, g, nb = 30_016, 3, 256
    bins, leaf, ghk, pending = _inputs(cuda_device, n, g, nb, k, w, True,
                                       seed=w)
    pending[0] = 0
    leaf = torch.randint(-1, 2 * w + 1, (n,), device=cuda_device,
                         dtype=torch.int32)
    kw = dict(g=g, nb=nb, k=k, w=w)
    a = hist_cuda.wave_hist(bins, leaf, ghk, pending, **kw)
    assert torch.equal(a, hist_cuda.wave_hist_reference(bins, leaf, ghk,
                                                        pending, **kw))


@pytest.mark.parametrize("w,k", [(1, 3), (40, 3), (64, 6), (76, 5)])
def test_kernel_f32_equals_fixed_reference(cuda_device, w, k):
    """Full-f32 stat columns (the host learner's) in the wave mode: the
    int64 fixed-point sums equal wave_hist_fixed_reference bit for bit."""
    n, g, nb = 30_016, 3, 256
    bins, leaf, _, pending = _inputs(cuda_device, n, g, nb, k, w, False,
                                     seed=w)
    pending[0] = 0
    ghk = torch.randn((n, k), device=cuda_device) * 3.0
    leaf = torch.randint(0, 2 * w + 1, (n,), device=cuda_device,
                         dtype=torch.int32)
    kw = dict(g=g, nb=nb, k=k, w=w)
    scale = hist_cuda.hist_scale_exponents(ghk, n)
    a = hist_cuda.wave_hist(bins, leaf, ghk, pending, scale_exp=scale, **kw)
    want = hist_cuda.wave_hist_fixed_reference(bins, leaf, ghk, pending,
                                               scale, **kw)
    assert torch.equal(a.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("m,dtype", [(1, torch.float32),
                                     (1537, torch.float32),
                                     (200_003, torch.float32),
                                     (50_000, torch.bfloat16),
                                     (70_001, torch.int8)])
def test_rows_kernel_equals_fixed_reference(cuda_device, m, dtype):
    """The one-slot list mode over a ragged window of a permuted row
    buffer: f32 and bf16 stats bit-equal to the fixed-point plain version,
    int8 byte-equal to the int32 plain version; launches counted."""
    n, g, nb, k = 250_000, 7, 256, 3
    gen = torch.Generator(device=cuda_device).manual_seed(m)
    bins = torch.randint(0, nb, (g, n), device=cuda_device,
                         dtype=torch.uint8, generator=gen)
    if dtype == torch.int8:
        ghk = torch.randint(-127, 128, (n, k), device=cuda_device,
                            dtype=torch.int8, generator=gen)
    else:
        ghk = (torch.randn((n, k), device=cuda_device, generator=gen)
               * 2.0).to(dtype)
    buf = torch.randperm(n, device=cuda_device, generator=gen).to(
        torch.int32)
    rows = buf[17:17 + m]
    kw = dict(g=g, nb=nb, k=k)
    before = hist_cuda.wave_hist_rows.launches.read()
    if dtype == torch.int8:
        a = hist_cuda.wave_hist_rows(bins, ghk, rows, **kw)
        assert torch.equal(a, hist_cuda.wave_hist_rows_reference(
            bins, ghk, rows, **kw))
    else:
        scale = hist_cuda.exponents_for_rows(ghk.abs().amax(0).float(), m)
        a = hist_cuda.wave_hist_rows(bins, ghk, rows, scale_exp=scale, **kw)
        want = hist_cuda.wave_hist_rows_fixed_reference(bins, ghk, rows,
                                                        scale, **kw)
        assert torch.equal(a.view(torch.int32), want.view(torch.int32))
    assert hist_cuda.wave_hist_rows.launches.read() == before + 1


def test_rows_kernel_reads_codes_at_their_pitch(cuda_device):
    """The list mode over a column slice of wider codes (the host learner
    over a device grower's ``(G, n_pad)`` codes): the kernel reads each
    group at the codes' pitch, bit-equal to the plain version over the
    same view and to a contiguous copy."""
    n, n_pad, g, nb, k = 30_001, 32_768, 5, 256, 3
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    wide = torch.randint(0, nb, (g, n_pad), device=cuda_device,
                         dtype=torch.uint8, generator=gen)
    bins = wide[:, :n]
    ghk = torch.randn((n, k), device=cuda_device, generator=gen)
    rows = torch.randperm(n, device=cuda_device, generator=gen).to(
        torch.int32)[:20_000]
    kw = dict(g=g, nb=nb, k=k)
    scale = hist_cuda.exponents_for_rows(ghk.abs().amax(0), rows.shape[0])
    a = hist_cuda.wave_hist_rows(bins, ghk, rows, scale_exp=scale, **kw)
    want = hist_cuda.wave_hist_rows_fixed_reference(bins, ghk, rows, scale,
                                                    **kw)
    assert torch.equal(a.view(torch.int32), want.view(torch.int32))
    b = hist_cuda.wave_hist_rows(bins.contiguous(), ghk, rows,
                                 scale_exp=scale, **kw)
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("extra,cols", [({}, 4), ({"gpu_use_dp": True}, 6),
                                        ({"grad_quant_bits": 8}, 6),
                                        ({"gpu_use_dp": True,
                                          "count_split": 0}, 5)])
def test_striped_layout_tree_on_card_equals_cpu(cuda_device, monkeypatch,
                                                extra, cols):
    """The striped and gpu_use_dp layouts (COUNT_SPLIT_ROWS lowered to
    force them at 30,000 rows): the trees grown on the card have the CPU
    path's structure, leaf values within 1e-5 of the tree's largest (5e-5
    with gpu_use_dp) and predictions within 1e-4 (the objective's exp
    differs in the last bits between the card and the CPU, so even int8
    trees after the first are not byte-equal;
    test_bagged_quantized_tree_on_card_equals_cpu holds injected
    gradients byte for byte)."""
    from lightgbm_tpu_torch.ops import grow
    extra = dict(extra)
    if extra.pop("count_split", 1):
        monkeypatch.setattr(grow, "COUNT_SPLIT_ROWS", 20_000)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((30_000, 6))
    y = (x[:, 0] + 0.5 * x[:, 1] ** 2 + 0.3 * rng.standard_normal(len(x))
         > 0.4).astype(float)
    params = {"objective": "binary", "num_leaves": 63, "max_bin": 63,
              "verbose": -1, **extra}
    card = lt.train(params, lt.Dataset(x, y), 3)
    cpu = lt.train({**params, "device": "cpu"}, lt.Dataset(x, y), 3)
    assert card._gbdt._grower.hist_cols == cols
    assert card.num_trees() == cpu.num_trees() == 3
    for tc, tp in zip(card._gbdt.models, cpu._gbdt.models):
        nl = tc.num_leaves
        assert nl == tp.num_leaves
        np.testing.assert_array_equal(tc.split_feature[:nl - 1],
                                      tp.split_feature[:nl - 1])
        np.testing.assert_array_equal(tc.threshold_in_bin[:nl - 1],
                                      tp.threshold_in_bin[:nl - 1])
        # the card sums exactly, the CPU in f32 in row order; gpu_use_dp's
        # four hi/lo columns are summed apart and added, and a small
        # leaf's value cancels: 5e-5 of the tree's largest there
        tol = 5e-5 if "gpu_use_dp" in params else 1e-5
        np.testing.assert_allclose(
            tc.leaf_value[:nl], tp.leaf_value[:nl], rtol=tol,
            atol=tol * np.abs(tp.leaf_value[:nl]).max())
    np.testing.assert_allclose(card.predict(x, raw_score=True),
                               cpu.predict(x, raw_score=True), atol=1e-4)


@pytest.mark.parametrize("extra", [
    {"objective": "binary", "monotone_constraints": "1,-1,0,0,0,0"},
    {"objective": "regression_l1"},
    {"objective": "quantile", "alpha": 0.9, "bagging_fraction": 0.7,
     "bagging_freq": 1},
    {"objective": "binary", "device_growth": "off", "boosting": "goss",
     "learning_rate": 0.5}], ids=["monotone", "l1", "quantile_bag", "goss"])
def test_host_learner_on_card_matches_cpu(cuda_device, extra):
    """The host learner on the card (window histograms from the list
    mode, f32 stats in fixed point) against the CPU path (f32 plain
    version): the same trees, predictions within 1e-4."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((30_000, 6))
    y = x[:, 0] + 0.5 * x[:, 1] ** 2 + 0.3 * rng.standard_normal(len(x))
    if extra["objective"] == "binary":
        y = (y > 0.4).astype(float)
    params = {"num_leaves": 31, "max_bin": 63, "verbose": -1, **extra}
    hist_cuda.wave_hist_rows.launches.reset()
    card = lt.train(params, lt.Dataset(x, y), 4)
    assert card._gbdt.learner is not None and card._gbdt._grower is None
    assert hist_cuda.wave_hist_rows.launches.read() > 0
    cpu = lt.train({**params, "device": "cpu"}, lt.Dataset(x, y), 4)
    for tc, tp in zip(card._gbdt.models, cpu._gbdt.models):
        nl = tc.num_leaves
        assert nl == tp.num_leaves
        np.testing.assert_array_equal(tc.split_feature[:nl - 1],
                                      tp.split_feature[:nl - 1])
        np.testing.assert_array_equal(tc.threshold_in_bin[:nl - 1],
                                      tp.threshold_in_bin[:nl - 1])
    np.testing.assert_allclose(card.predict(x, raw_score=True),
                               cpu.predict(x, raw_score=True), atol=1e-4)


def test_v2_register_fragment_layout(cuda_device):
    """NB=32, W=1: a warpgroup's 64 output rows straddle two groups, and
    every output row is held to its own exact value (integer stats, so
    every sum is exact in f32): pins the wgmma register-A layout."""
    n, g, nb = 4096, 3, 32
    r = np.arange(n)
    bins = np.stack([(r * (2 * gi + 1) + 5 * gi) % nb for gi in range(g)])
    ghk = np.stack([(r % 7) - 3, r % 5, np.ones(n)], 1).astype(np.float32)
    leaf = np.where(r % 3 == 0, 1, 0).astype(np.int32)
    want = np.zeros((g * nb, 3))
    for gi in range(g):
        for kk in range(3):
            np.add.at(want[:, kk], gi * nb + bins[gi][leaf == 0],
                      ghk[leaf == 0, kk])
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(cuda_device)
    out = hist_cuda.wave_hist_v2(t(bins.astype(np.uint8)), t(leaf),
                                 t(ghk).to(torch.bfloat16),
                                 t(np.zeros(1, np.int32)), g=g, nb=nb, k=3,
                                 w=1, ch=128)
    got = out[..., 0].cpu().double().numpy()
    for row in range(g * nb):
        np.testing.assert_array_equal(got[row], want[row],
                                      err_msg=f"output row {row}")


@pytest.mark.parametrize("nb,w,dup", [(64, 4, False), (64, 128, False),
                                      (256, 128, False), (64, 50, True)])
def test_v2_new_tiles_match_plain(cuda_device, nb, w, dup):
    """wave_hist_v2's column tiles (16 columns at W=4, two of 192 at
    W=128), NB=256 and duplicate ids: within 1e-4 of each cell's sum of
    |stats| plus 1e-6 of the plain version, bit-identical across two
    launches."""
    n, g = 60_000, 4
    bins, leaf, ghk, pending = _inputs(cuda_device, n, g, nb, 3, w, False,
                                       seed=nb + w)
    if dup:
        pending[: w // 2] = pending[w // 2: 2 * (w // 2)]
    kw = dict(g=g, nb=nb, k=3, w=w)
    a = hist_cuda.wave_hist_v2(bins, leaf, ghk, pending, **kw)
    b = hist_cuda.wave_hist_v2(bins, leaf, ghk, pending, **kw)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    ref = hist_cuda.wave_hist_reference(bins, leaf, ghk, pending, **kw)
    mag = hist_cuda.wave_hist_reference(bins, leaf, ghk.abs(), pending, **kw)
    assert ((a - ref).abs() <= 1e-4 * mag + 1e-6).all()
    assert not a[..., -1].any()


#: sha256 of the model text of test_255_leaf_model_text_unchanged's run,
#: taken on the card with the histogram kernel before its redesign
MODEL_TEXT_SHA256 = \
    "b24bc0863199f28012adbeb8933dfb134acc3277541ae85fa83c36230453cb0e"


def test_255_leaf_model_text_unchanged(cuda_device):
    """A 255-leaf training run on the card: its model text is the same
    byte for byte as before the histogram kernel's redesign (the sums are
    exact integers either way)."""
    import hashlib
    rng = np.random.default_rng(11)
    x = rng.standard_normal((60_000, 10))
    y = (x[:, 0] + 0.5 * x[:, 1] * x[:, 2] + 0.3 * rng.standard_normal(len(x))
         > 0).astype(float)
    params = {"objective": "binary", "num_leaves": 255, "max_bin": 255,
              "verbose": -1}
    text = lt.train(params, lt.Dataset(x, y), 3).model_to_string()
    assert hashlib.sha256(text.encode()).hexdigest() == MODEL_TEXT_SHA256


def test_threefry_on_card_equals_cpu(cuda_device):
    from lightgbm_tpu_torch.utils import random as trandom
    key = trandom.fold_in(trandom.PRNGKey(12345), 7)
    for shape in (1, 28, 4097, (3, 1000)):
        on_card = trandom.uniform(key, shape, device=cuda_device)
        on_cpu = trandom.uniform(key, shape)
        assert on_card.device.type == "cuda"
        assert torch.equal(on_card.cpu().view(torch.int32),
                           on_cpu.view(torch.int32))


def _quantized_tree_on_card_and_cpu(cuda_device, cols):
    """One int8 tree with bagging and feature_fraction from injected
    gradients, grown on the card and on the CPU path at a ``cols``-column
    layout: both records, byte for byte."""
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.data.dataset import BinnedDataset
    from lightgbm_tpu_torch.ops.bagging import bagging_row_mask
    from lightgbm_tpu_torch.ops.grow import DeviceGrower
    rng = np.random.default_rng(3)
    x = rng.standard_normal((30_000, 8))
    params = {"objective": "binary", "num_leaves": 31, "max_bin": 63,
              "grad_quant_bits": 8, "feature_fraction": 0.8, "seed": 4,
              "verbose": -1}
    cfg = Config(params)
    ds = BinnedDataset.construct_from_matrix(x, cfg)
    grad = rng.standard_normal(len(x)).astype(np.float32)
    hess = (0.05 + rng.random(len(x))).astype(np.float32)
    out = []
    for dev in (cuda_device, torch.device("cpu")):
        grower = DeviceGrower(ds, cfg, dev)
        assert grower.hist_cols == cols
        mask = bagging_row_mask(9, 32768, len(x), 0.8, device=dev)
        t = lambda a: torch.from_numpy(a).to(dev)
        res = grower.grow_one_iter(t(np.zeros(len(x), np.float32)),
                                   t(grad), t(hess),
                                   feature_mask=grower.feature_mask_for(3),
                                   row_mask=mask, tree_idx=3)
        out.append([r.cpu() for r in (res.rec_i, res.rec_f, res.score)]
                   + [res.num_leaves])
    assert out[0][3] == out[1][3] == 31
    for a, b in zip(out[0][:3], out[1][:3]):
        assert torch.equal(a, b)


def test_bagged_quantized_tree_on_card_equals_cpu(cuda_device):
    """grad_quant_bits=8 with bagging and feature_fraction: integer
    histograms and scan, so the tree grown on the card (kernel
    histograms) has the CPU path's records byte for byte."""
    _quantized_tree_on_card_and_cpu(cuda_device, 3)


def test_striped_quantized_tree_on_card_equals_cpu(cuda_device,
                                                   monkeypatch):
    """The same at the striped int8 K=6 layout (COUNT_SPLIT_ROWS lowered
    to force it at 30,000 rows): still integer sums and an integer scan,
    so the card's records equal the CPU path's byte for byte."""
    from lightgbm_tpu_torch.ops import grow
    monkeypatch.setattr(grow, "COUNT_SPLIT_ROWS", 20_000)
    _quantized_tree_on_card_and_cpu(cuda_device, 6)


# -- the packed-forest kernel (csrc/forest_predict.cu) --------------------

def _assert_bit_equal(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def _forest_inputs(dev, seed, *, num_model=1, cats=(), nf=7, iters=20,
                   leaves=63, rows=30_000, dtype=torch.float64):
    import synthetic_forests as synthetic
    g = synthetic.random_forest(seed, num_iterations=iters,
                                num_leaves=leaves, num_features=nf,
                                cat_features=cats, num_model=num_model)
    x = synthetic.query_rows(g, rows, seed + 1, cat_features=cats)
    return g, torch.from_numpy(x).to(dev, dtype)


@pytest.mark.parametrize("num_model,cats,nf,dtype", [
    (1, (1, 4), 7, torch.float64),      # NaN/zero missing, bitsets
    (3, (2,), 7, torch.float64),        # multiclass
    (1, (0,), 7, torch.float32),        # f32 rows, widened on the card
    (1, (3,), 60, torch.float64),       # staged past the default 48 KB
])
def test_forest_kernel_bit_equal_to_plain(cuda_device, num_model, cats, nf,
                                          dtype):
    """Leaves and tree-order scores of the kernel equal its plain version
    bit for bit, on random deep forests and edge-case rows, whole and on
    iteration slices."""
    from lightgbm_tpu_torch.serve import packed
    g, x = _forest_inputs(cuda_device, 7, num_model=num_model, cats=cats,
                          nf=nf, dtype=dtype)
    for start, num in ((0, -1), (3, 5)):
        pe = packed.pack_gbdt(g, start, num, device=cuda_device)
        assert pe.max_depth >= 16
        kw = dict(num_model=pe.num_model, max_depth=pe.max_depth)
        for leaves in (False, True):
            before = packed.forest_predict.launches
            got = packed.forest_predict(pe.tables(), x, leaves=leaves, **kw)
            assert packed.forest_predict.launches == before + 1
            want = packed.forest_predict_reference(pe.tables(), x,
                                                   leaves=leaves, **kw)
            torch.cuda.synchronize()
            _assert_bit_equal(got, want)


@pytest.mark.parametrize("value_dtype", ["f32", "bf16"])
def test_fleet_kernel_bit_equal_to_plain(cuda_device, value_dtype):
    """A mixed-tenant batch over tenants of different pads: the kernel
    equals its plain version bit for bit, and each tenant's rows equal its
    solo pack's."""
    import synthetic_forests as synthetic
    from lightgbm_tpu_torch.serve import fleet, packed
    gs = [synthetic.random_forest(s, num_iterations=it, num_leaves=lv,
                                  num_features=6, cat_features=(2,))
          for s, it, lv in ((1, 10, 31), (2, 25, 63), (3, 4, 8))]
    fl, packs = fleet.pack_fleet(gs, device=cuda_device,
                                 value_dtype=value_dtype)
    x = torch.from_numpy(synthetic.query_rows(gs[1], 20_000, 4,
                                              cat_features=(2,))) \
        .to(cuda_device)
    tid = torch.randint(0, 3, (len(x),), device=cuda_device,
                        dtype=torch.int32)
    kw = dict(num_model=1, max_depth=fl.max_depth)
    for leaves in (False, True):
        got = packed.forest_predict(fl.tables(), x, tid, leaves=leaves, **kw)
        want = packed.forest_predict_reference(fl.tables(), x, tid,
                                               leaves=leaves, **kw)
        torch.cuda.synchronize()
        _assert_bit_equal(got, want)
    if value_dtype == "f32":
        scores = packed.forest_predict(fl.tables(), x, tid, **kw)
        for m, pe in enumerate(packs):
            rows = tid == m
            solo = packed.forest_predict(pe.tables(), x[rows],
                                         num_model=1, max_depth=pe.max_depth)
            _assert_bit_equal(scores[:, rows], solo)


def test_booster_predict_runs_the_kernel(cuda_device, monkeypatch):
    """Booster.predict of 65536 rows or more on a card launches the
    kernel once and walks no host tree; it predicts the training score on
    both routes."""
    from lightgbm_tpu_torch.serve import packed
    from lightgbm_tpu_torch.tree.tree import Tree
    rng = np.random.default_rng(5)
    x = rng.standard_normal((70_000, 6))
    x[rng.random(x.shape) < 0.05] = np.nan
    y = (np.nan_to_num(x[:, 0]) - np.nan_to_num(x[:, 2]) > 0).astype(float)
    booster = lt.train({"objective": "binary", "num_leaves": 31,
                        "verbose": -1}, lt.Dataset(x, y), 5)
    g = booster._gbdt
    score = g.train_score[0].double().cpu().numpy()
    real = Tree.predict
    monkeypatch.setattr(Tree, "predict", lambda *a: pytest.fail(
        "Tree.predict on the packed path"))
    before = packed.forest_predict.launches
    dev = booster.predict(x, raw_score=True)
    assert packed.forest_predict.launches == before + 1
    np.testing.assert_allclose(dev, score, atol=1e-5)
    monkeypatch.setattr(Tree, "predict", real)
    g.config.device_predict = "off"
    np.testing.assert_allclose(booster.predict(x, raw_score=True), score,
                               atol=1e-5)
    loaded = lt.Booster(model_str=booster.model_to_string(),
                        params={"device_predict": "force"})
    np.testing.assert_array_equal(loaded.predict(x[:100], raw_score=True),
                                  dev[:100])


def _both_routes(pe_or_fl, x, tid=None, *, rows_list, leaves_too=True):
    """The wrapper's own route and each route forced, bit for bit against
    the plain version, at every row count of ``rows_list``; returns the
    routes the wrapper chose."""
    from lightgbm_tpu_torch.serve import packed
    tables, rec = pe_or_fl.tables(), pe_or_fl.records
    m_, t, n = tables.split_feature.shape
    kw = dict(num_model=pe_or_fl.num_model, max_depth=pe_or_fl.max_depth)
    chosen = []
    for rows in rows_list:
        xr = x[:rows]
        tr = None if tid is None else tid[:rows]
        for leaves in ((False, True) if leaves_too else (False,)):
            want = packed.forest_predict_reference(tables, xr, tr,
                                                   leaves=leaves, **kw)
            before = dict(packed.forest_predict.routes)
            got = packed.forest_predict(tables, xr, tr, leaves=leaves,
                                        records=rec, **kw)
            route = [r for r in before
                     if packed.forest_predict.routes[r] == before[r] + 1]
            assert len(route) == 1
            chosen.append(route[0])
            torch.cuda.synchronize()
            _assert_bit_equal(got, want)
            for forced in ("rows", "trees"):
                geo = packed.forest_geometry(
                    rows, t, n, x.shape[1], x.dtype == torch.float64, leaves,
                    pe_or_fl.num_model, tenants=m_ if tid is not None else 1,
                    route=forced)
                got = packed.launch_forest(rec, xr, tr, geo, leaves=leaves,
                                           **kw)
                torch.cuda.synchronize()
                _assert_bit_equal(got, want)
    return chosen


def _last_trees_route_rows(route_of):
    """The most rows ``route_of(rows)`` sends to the trees route (above
    the few rows it walks on the rows route), or None where it sends every
    larger batch there."""
    lo, hi = 100, 1 << 24
    assert route_of(lo) == "trees"
    if route_of(hi) == "trees":
        return None
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if route_of(mid) == "trees":
            lo = mid
        else:
            hi = mid
    return lo


@pytest.mark.parametrize("nf,dtype,num_model,iters", [
    (53, torch.float64, 1, 12),     # the fork harness's row width
    (53, torch.float32, 1, 12),
    (53, torch.float64, 1, 8),      # rows wide for 8 trees: a later cut
    (130, torch.float64, 1, 12),    # few rows resident: no cut
    (7, torch.float32, 3, 12),      # K=3: per-class sums in shared memory
])
def test_forest_routes_bit_equal_on_both_sides_of_the_crossover(
        cuda_device, nf, dtype, num_model, iters):
    """Both routes of the kernel, forced and as the wrapper picks them,
    equal the plain version bit for bit (scores through their int32 bits,
    and leaves) at one row, and below and above the crossover where the
    shape has one."""
    import synthetic_forests as synthetic
    from lightgbm_tpu_torch.serve import packed
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    g = synthetic.random_forest(21, num_iterations=iters, num_leaves=31,
                                num_features=nf, cat_features=(3,),
                                num_model=num_model)
    pe = packed.pack_gbdt(g, device=cuda_device)
    _, t, n = pe.tables().split_feature.shape

    def route_of(rows, leaves=False):
        # the leaves tile takes shared memory: fewer rows resident on the
        # rows route may move the leaves' crossover
        return packed.forest_geometry(rows, t, n, nf, dtype == torch.float64,
                                      leaves, num_model, sm_count=sms).route
    cut = _last_trees_route_rows(route_of)
    rows_list = (1, 100) + ((cut, cut + 1, cut + 300) if cut else (20_000,))
    x = torch.from_numpy(synthetic.query_rows(g, rows_list[-1], 22,
                                              cat_features=(3,))) \
        .to(cuda_device, dtype)
    chosen = _both_routes(pe, x, rows_list=rows_list)
    assert chosen == [route_of(r, leaves) for r in rows_list
                      for leaves in (False, True)]
    assert chosen[4::2] == (["trees", "rows", "rows"] if cut else ["trees"])


@pytest.mark.parametrize("case,dtype", [
    ("large_trees", torch.float32),   # 2^13 padded nodes: no chunk fits
    ("many_tenants", torch.float64),  # more tenants than the grouping counts
    ("wide_rows", torch.float64),     # 1,000 f64 columns: rows not staged
    ("wide_rows", torch.float32),     # 2,000 f32 columns
])
def test_rows_route_from_global_memory(cuda_device, case, dtype):
    """The rows route where the trees, or the trees and the rows, do not
    fit a block's shared memory: its tree chunks are read from global
    memory (and each row's own tenant's, in a fleet walked without
    grouping), and without a stage each visit reads its query value from
    global memory.  Scores and leaves equal the plain version bit for
    bit."""
    import synthetic_forests as synthetic
    from lightgbm_tpu_torch.serve import fleet, packed
    nf = {"wide_rows": 1000 if dtype == torch.float64 else 2000}.get(case, 7)
    leaves = 12_000 if case == "large_trees" else 31
    g, x = _forest_inputs(cuda_device, 23, cats=(3,), nf=nf, iters=4,
                          leaves=leaves, rows=3000, dtype=dtype)
    tid, tenants = None, 1
    pe = packed.pack_gbdt(g, device=cuda_device)
    if case == "many_tenants":
        gs = [g] + [synthetic.random_forest(s, num_iterations=it,
                                            num_leaves=31, num_features=nf,
                                            cat_features=(3,))
                    for s, it in ((24, 6), (25, 2))]
        pe = fleet.pack_fleet(gs, device=cuda_device)[0]
        tid = torch.randint(0, 3, (len(x),), device=cuda_device,
                            dtype=torch.int32)
        tenants = packed.MAX_GROUP_TENANTS + 1
    tables, rec = pe.tables(), pe.records
    _, t, n = tables.split_feature.shape
    if case == "large_trees":
        assert n == 1 << 13
    kw = dict(num_model=1, max_depth=pe.max_depth)
    for want_leaves in (False, True):
        geo = packed.forest_geometry(len(x), t, n, nf, dtype == torch.float64,
                                     want_leaves, 1, tenants=tenants,
                                     route="rows")
        assert (geo.route, geo.smem_trees, geo.group_blocks) == ("rows",
                                                                False, 0)
        assert geo.stage_rows == (case != "wide_rows")
        before = packed.forest_predict.routes["rows"]
        got = packed.launch_forest(rec, x, tid, geo, leaves=want_leaves, **kw)
        assert packed.forest_predict.routes["rows"] == before + 1
        want = packed.forest_predict_reference(tables, x, tid,
                                               leaves=want_leaves, **kw)
        torch.cuda.synchronize()
        _assert_bit_equal(got, want)


@pytest.mark.parametrize("value_dtype", ["f32", "bf16"])
def test_fleet_routes_bit_equal_with_grouping(cuda_device, value_dtype):
    """A four-tenant fleet at the fork's 53 columns: the trees route, and
    the rows route with its rows grouped by tenant, equal the plain version
    bit for bit; a tenant swap rewrites the node records the kernel
    reads."""
    import synthetic_forests as synthetic
    from lightgbm_tpu_torch.serve import fleet, packed
    gs = [synthetic.random_forest(s, num_iterations=it, num_leaves=lv,
                                  num_features=53, cat_features=(2,))
          for s, it, lv in ((1, 10, 31), (2, 25, 63), (3, 4, 8), (4, 8, 31))]
    fl, packs = fleet.pack_fleet(gs, device=cuda_device,
                                 value_dtype=value_dtype)
    x = torch.from_numpy(synthetic.query_rows(gs[1], 20_000, 4,
                                              cat_features=(2,))) \
        .to(cuda_device)
    tid = torch.randint(0, 4, (len(x),), device=cuda_device,
                        dtype=torch.int32)
    chosen = _both_routes(fl, x, tid, rows_list=(1, 100, 20_000))
    assert chosen == ["trees"] * 4 + ["rows"] * 2
    geo = packed.forest_geometry(20_000, fl.tree_pad, fl.node_pad, 53, True,
                                 False, 1, tenants=4)
    assert geo.group_blocks > 0 and geo.smem_trees and geo.stage_rows
    fleet.write_tenant(fl, 1, packs[3])
    _both_routes(fl, x, tid, rows_list=(20_000,), leaves_too=False)


def test_500_tree_small_requests_take_the_trees_route(cuda_device):
    """1- and 100-row requests against a 500-tree forest go through the
    trees route, through the entry points a user calls, and equal the
    plain version bit for bit."""
    import synthetic_forests as synthetic
    from lightgbm_tpu_torch.serve import PredictionServer, packed
    g = synthetic.random_forest(9, num_iterations=500, num_leaves=63,
                                num_features=28, cat_features=(3, 11))
    x = synthetic.query_rows(g, 100, 10, cat_features=(3, 11))
    server = PredictionServer(g, device=cuda_device)
    server.warmup()
    pe = server._snapshot().packed
    for rows in (1, 100):
        before = dict(packed.forest_predict.routes)
        got = server.predict(x[:rows], raw_score=True)
        assert packed.forest_predict.routes["trees"] == before["trees"] + 1
        assert packed.forest_predict.routes["rows"] == before["rows"]
        want = packed.forest_predict_reference(
            pe.tables(), torch.from_numpy(x[:rows]).to(cuda_device),
            num_model=1, max_depth=pe.max_depth)[0]
        np.testing.assert_array_equal(
            got, want.cpu().numpy().astype(np.float64))


def _valid_rows(seed, n=60_000, f=12):
    """float32 rows with NaNs and exact zeros, and labels."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, f)).astype(np.float32)
    x[rng.random((n, f)) < 0.05] = np.nan
    x[:, 3] = np.where(rng.random(n) < 0.6, 0.0, x[:, 3])
    y = (np.nan_to_num(x[:, 0]) + 0.5 * x[:, 1] > 0).astype(np.float32)
    return x, y


def test_device_binning_equals_cpu_on_card(cuda_device):
    """construct_from_device_matrix on a card tensor: mappers and codes
    equal to the same call on a CPU tensor and to the host build, and a
    reference-built validation set's codes too."""
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.data.dataset import BinnedDataset
    x, _ = _valid_rows(11)
    cfg = Config({"objective": "binary", "max_bin": 255,
                  "bin_construct_sample_cnt": 20_000, "verbose": -1})
    on_card = BinnedDataset.construct_from_device_matrix(
        torch.from_numpy(x[:50_000]).to(cuda_device), cfg)
    on_cpu = BinnedDataset.construct_from_device_matrix(
        torch.from_numpy(x[:50_000]), cfg)
    host = BinnedDataset.construct_from_matrix(x[:50_000], cfg)
    assert on_card.binned.device.type == "cuda"
    assert [m.feature_info_str() for m in on_card.bin_mappers] == \
        [m.feature_info_str() for m in host.bin_mappers]
    np.testing.assert_array_equal(on_card.binned.cpu().numpy(),
                                  on_cpu.binned.numpy())
    np.testing.assert_array_equal(on_card.binned.cpu().numpy(), host.binned)
    valid = BinnedDataset.construct_from_device_matrix(
        x[50_000:], cfg, reference=on_card, device=cuda_device)
    np.testing.assert_array_equal(
        valid.binned.cpu().numpy(),
        BinnedDataset.construct_from_matrix(x[50_000:], cfg,
                                            reference=host).binned)


def test_valid_scoring_on_card_equals_cpu(cuda_device):
    """engine.train with a device-binned validation set and early
    stopping on the card: every tree's leaves by the traversal on the
    card equal those on the CPU and the host walk's, the validation
    scores equal the CPU traversal's sums and follow Booster.predict."""
    from lightgbm_tpu_torch.ops import traverse
    x, y = _valid_rows(12)
    params = {"objective": "binary", "num_leaves": 31, "max_bin": 63,
              "learning_rate": 0.3, "verbose": -1,
              "metric": ["binary_logloss", "auc"]}
    xt = torch.from_numpy(x).to(cuda_device)
    train = lt.Dataset(xt[:50_000], y[:50_000])
    valid = train.create_valid(xt[50_000:], y[50_000:])
    evals = {}
    booster = lt.train(params, train, 30, valid_sets=[valid],
                       early_stopping_rounds=3, evals_result=evals,
                       verbose_eval=False)
    assert booster.best_iteration > 0
    assert len(evals["valid_0"]["auc"]) == booster.current_iteration()
    gb = booster._gbdt
    vs = gb.valid_sets[0]
    assert vs.binned.device.type == "cuda"
    binned_cpu = vs.binned.cpu()
    score_cpu = torch.zeros(len(x) - 50_000)
    for tree in gb.models:
        on_card = traverse.device_tree(tree, gb.train_set, 31, cuda_device)
        on_cpu = traverse.device_tree(tree, gb.train_set, 31, "cpu")
        leaves = traverse.traverse(vs.binned, on_card).cpu()
        assert torch.equal(leaves, traverse.traverse(binned_cpu, on_cpu))
        np.testing.assert_array_equal(leaves.numpy(),
                                      tree.predict_leaf(x[50_000:]))
        score_cpu = traverse.add_tree_score(score_cpu, binned_cpu, on_cpu,
                                            1.0)
    assert torch.equal(vs.score[0].cpu(), score_cpu)
    np.testing.assert_allclose(vs.score[0].double().cpu().numpy(),
                               booster.predict(x[50_000:], raw_score=True),
                               atol=1e-5)


# -- the captured tree (ops/graphs.py, csrc/graph_loop.cu) ----------------

def _graph_grower(dev, params, rows=6_000, seed=11):
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.data.dataset import BinnedDataset
    from lightgbm_tpu_torch.ops.grow import DeviceGrower
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, 8))
    cfg = Config({"objective": "binary", "max_bin": 63, "verbose": -1,
                  "min_data_in_leaf": 5, **params})
    ds = BinnedDataset.construct_from_matrix(x, cfg)
    grad = torch.from_numpy(rng.standard_normal(rows).astype(np.float32))
    hess = torch.from_numpy((0.05 + rng.random(rows)).astype(np.float32))
    return DeviceGrower(ds, cfg, dev), grad.to(dev), hess.to(dev)


@pytest.mark.parametrize("params", [
    {"num_leaves": 31},
    {"num_leaves": 255, "min_data_in_leaf": 2},
    {"num_leaves": 31, "grad_quant_bits": 8, "feature_fraction": 0.8},
    {"num_leaves": 255, "min_data_in_leaf": 2, "grad_quant_bits": 8},
], ids=["bf16_31", "bf16_255", "int8_31_ff", "int8_255"])
def test_captured_tree_equals_eager_loop_on_card(cuda_device, params):
    """One launch of the composed graph grows the tree the plain loop of
    the same pieces grows on the card (a host read a wave), bit for bit:
    records, leaf count, waves and score; the loop's wave count equals
    the device's, and every wave launched wave_hist once."""
    grower, grad, hess = _graph_grower(cuda_device, params)
    score = torch.zeros(grower.num_data, device=cuda_device)
    mask = grower.feature_mask_for(2)
    got = grower.grow_one_iter(score, grad, hess, 0.1, feature_mask=mask,
                               tree_idx=2)
    st = grower._st
    st.score.copy_(score)
    st.grad.copy_(grad)
    st.hess.copy_(hess)
    st.fmask.copy_(mask)
    st.ctl[3:4].zero_()
    grower._run_pieces(None)
    assert int(got.num_leaves) >= 3
    assert int(got.num_leaves) == int(st.out_nl[0])
    assert int(got.waves) == int(st.out_waves[0])
    assert torch.equal(got.rec_i, st.out_rec_i[0])
    assert torch.equal(got.rec_f.view(torch.int32),
                       st.out_rec_f[0].view(torch.int32))
    assert torch.equal(got.score.view(torch.int32),
                       st.score.view(torch.int32))
    hist_cuda.wave_hist.launches.reset()
    again = grower.grow_one_iter(score, grad, hess, 0.1, feature_mask=mask,
                                 tree_idx=2)
    assert torch.equal(again.rec_i, got.rec_i)
    assert hist_cuda.wave_hist.launches.read() == int(again.waves)


def test_fused_chunk_makes_no_host_sync(cuda_device):
    """A chunk of the fused path (the key-table copy, the launches and
    the records' asynchronous copy) runs under sync debug mode "error";
    its trees equal those of per-iteration training."""
    from lightgbm_tpu_torch.boosting.gbdt import _RecStack
    rng = np.random.default_rng(5)
    x = rng.standard_normal((8_000, 8))
    y = (x[:, 0] + 0.5 * rng.standard_normal(len(x)) > 0).astype(float)
    params = {"objective": "binary", "num_leaves": 31, "max_bin": 63,
              "verbose": -1, "bagging_freq": 2, "bagging_fraction": 0.8,
              "feature_fraction": 0.8}
    fused = lt.Booster(params, lt.Dataset(x, y))
    gb = fused._gbdt
    fused.update_chunked(4, chunk=4)          # captures the graphs
    fg = gb._fused_grad_fn()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = gb._grower.fused_train(4, gb.train_score[0], 0.1, 4, fg)
        _RecStack((out.rec_i, out.rec_f, out.nl, out.waves, out.qscales),
                  cuda_device)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    plain = lt.Booster(params, lt.Dataset(x, y))
    for _ in range(4):
        plain.update()
    assert fused.model_to_string() == plain.model_to_string()
    assert [s[3] for s in plain._gbdt.tree_stats] == [1, 1, 1, 1]


def test_capture_memory_does_not_grow_with_the_wave_budget(cuda_device):
    """The wave graphs are loop bodies, one a stage: the memory the
    captures take stays within twice the peak of one eager tree, at 31
    and at 255 leaves (the budget of waves grows 8x)."""
    for leaves in (31, 255):
        grower, grad, hess = _graph_grower(cuda_device,
                                           {"num_leaves": leaves,
                                            "min_data_in_leaf": 2},
                                           rows=200_000)
        st = grower._st
        st.grad.copy_(grad)
        st.hess.copy_(hess)
        st.ctl[3:4].zero_()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        grower._run_pieces(None)
        torch.cuda.synchronize()
        eager = torch.cuda.max_memory_allocated() - base
        before = torch.cuda.memory_reserved()
        grower._graph(None)
        torch.cuda.synchronize()
        captured = torch.cuda.memory_reserved() - before
        assert captured <= 2 * eager + (8 << 20), (leaves, captured, eager)


# -- the new objectives on the card ---------------------------------------

def _rank_rows(seed=3, n_queries=300):
    """Queries of 2-700 documents (every bucket from 8 to 1024), 20
    features, relevance 0-4."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(2, 200, n_queries)
    sizes[:3] = [700, 300, 9]
    n = int(sizes.sum())
    x = rng.standard_normal((n, 20))
    util = x[:, 0] + np.abs(x[:, 1]) + 0.7 * rng.standard_normal(n)
    y = np.digitize(util, np.quantile(util, [0.5, 0.75, 0.9, 0.97]))
    return x, y.astype(np.float64), sizes


def test_kernel_bf16_equals_fixed_reference_at_136_groups(cuda_device):
    """The lambdarank configuration's shape (MSLR-WEB10K: 136 feature
    groups, NB=256, W=128): bit-equal to wave_hist_fixed_reference."""
    n, g, nb, k, w = 60_000, 136, 256, 3, 128
    bins, leaf, ghk, pending = _inputs(cuda_device, n, g, nb, k, w, False,
                                       seed=136)
    leaf = torch.randint(0, 2 * w + 1, (n,), device=cuda_device,
                         dtype=torch.int32)
    kw = dict(g=g, nb=nb, k=k, w=w)
    scale = hist_cuda.hist_scale_exponents(ghk, n)
    a = hist_cuda.wave_hist(bins, leaf, ghk, pending, scale_exp=scale,
                            leaf_bound=2 * w + 1, **kw)
    want = hist_cuda.wave_hist_fixed_reference(bins, leaf, ghk, pending,
                                               scale, **kw)
    assert torch.equal(a.view(torch.int32), want.view(torch.int32))
    assert a[..., :-1].abs().sum() > 0


def test_lambdarank_gradient_on_card_equals_cpu(cuda_device):
    """The (B, P, P) pair batches on the card against the same objective
    on the CPU: within 1e-5 of the sum of a row's pair terms (summation
    order), on buckets 8 to 1024."""
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.data.dataset import Metadata
    from lightgbm_tpu_torch.objectives import create_objective
    _, y, sizes = _rank_rows()
    md = Metadata(len(y))
    md.set_label(y)
    md.set_query(sizes)
    score = np.random.default_rng(4).standard_normal(len(y)) \
        .astype(np.float32)
    out = []
    for dev in (torch.device("cpu"), cuda_device):
        obj = create_objective(Config({"objective": "lambdarank"}))
        obj.init(md, len(y), dev)
        fn, args = obj.device_grad()
        out.append([t.cpu().numpy() for t in
                    fn(torch.from_numpy(score).to(dev), args)])
    assert 1024 in obj.bucket_sizes
    (cg, ch), (dg, dh) = out
    mag = np.abs(cg).max()
    np.testing.assert_allclose(dg, cg, rtol=1e-4, atol=1e-5 * mag)
    np.testing.assert_allclose(dh, ch, rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("objective", ["lambdarank", "regression"])
def test_captured_chunk_of_a_new_objective_equals_plain_loop(cuda_device,
                                                             objective):
    """A fused chunk whose sample piece runs the objective's device_grad
    (lambdarank's sorts and pair batches; L2) inside the captured tree:
    no host sync (sync debug mode "error"), and records, leaves, waves
    and scores bit-equal to the plain loop of the same pieces on the
    card, and to per-iteration training's model text."""
    x, y, sizes = _rank_rows()
    params = {"objective": objective, "num_leaves": 63, "max_bin": 63,
              "min_data_in_leaf": 20, "verbose": -1}
    group = sizes if objective == "lambdarank" else None
    fused = lt.Booster(params, lt.Dataset(x, y, group=group))
    gb = fused._gbdt
    assert gb.fused_eligible()
    fused.update_chunked(4, chunk=4)          # captures the graphs
    fg = gb._fused_grad_fn()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        gb._grower.fused_train(4, gb.train_score[0].clone(), 0.1, 4, fg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    plain = lt.Booster(params, lt.Dataset(x, y, group=group))
    grower = plain._gbdt._grower
    grower._graph = lambda sample: None
    grower._run_tree = grower._run_pieces
    plain.update_chunked(4, chunk=4)
    got = gb._last_chunk_stack.host()
    want = plain._gbdt._last_chunk_stack.host()
    for a, b in zip(got, want):
        assert a.tobytes() == b.tobytes()
    assert torch.equal(gb.train_score.view(torch.int32),
                       plain._gbdt.train_score.view(torch.int32))
    per = lt.Booster(params, lt.Dataset(x, y, group=group))
    for _ in range(4):
        per.update()
    assert per.model_to_string() == plain.model_to_string()


def _categorical_rows(n=12_000, seed=3):
    """Two categorical columns (40 and 4 categories: the sorted-subset
    and the one-hot scan) and two numerical ones, with a binary label
    and a 3-class one."""
    rng = np.random.default_rng(seed)
    x = np.stack([rng.integers(0, 40, n), rng.integers(0, 4, n),
                  rng.standard_normal(n), rng.random(n)], 1).astype(float)
    lut = rng.standard_normal((40, 3))
    z = lut[x[:, 0].astype(int)] + 0.5 * (x[:, 1] == 2)[:, None] \
        + np.outer(x[:, 2], [-0.5, 0.0, 0.5])
    y3 = np.argmax(z + rng.gumbel(size=z.shape), axis=1).astype(float)
    yb = (z[:, 0] + 0.3 * rng.standard_normal(n) > 0).astype(float)
    return x, yb, y3


@pytest.mark.parametrize("quant", [0, 8])
def test_categorical_captured_chunk_equals_plain_loop(cuda_device, quant):
    """A fused chunk of categorical trees (membership state, bitset
    routing and records inside the captured tree) makes no host sync
    (sync debug mode "error"); its records (the bin sets included),
    leaves, waves and scores equal the plain loop of the same pieces on
    the card bit for bit, and per-iteration training's model text."""
    x, yb, _ = _categorical_rows()
    params = {"objective": "binary", "num_leaves": 63, "max_bin": 63,
              "grad_quant_bits": quant, "verbose": -1}
    data = lambda: lt.Dataset(x, yb, categorical_feature=[0, 1])
    fused = lt.Booster(params, data())
    gb = fused._gbdt
    fused.update_chunked(4, chunk=4)          # captures the graphs
    fg = gb._fused_grad_fn()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        gb._grower.fused_train(4, gb.train_score[0].clone(), 0.1, 4, fg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    plain = lt.Booster(params, data())
    grower = plain._gbdt._grower
    grower._graph = lambda sample: None
    grower._run_tree = grower._run_pieces
    plain.update_chunked(4, chunk=4)
    got = gb._last_chunk_stack.host()
    want = plain._gbdt._last_chunk_stack.host()
    for a, b in zip(got, want):
        assert a.tobytes() == b.tobytes()
    per = lt.Booster(params, data())
    for _ in range(4):
        per.update()
    text = per.model_to_string()
    assert "cat_threshold=" in text
    assert text == plain.model_to_string()


def test_multiclass_categorical_on_card_matches_cpu_path(cuda_device):
    """K=3 softmax with categorical columns: the card's per-iteration
    trees (one captured launch a class, one host sync an iteration, no
    sync inside a tree's launch) have the CPU path's splits, and predict
    (N, 3) within 1e-4 of it; every wave's histogram came from the
    kernel."""
    x, _, y3 = _categorical_rows()
    params = {"objective": "multiclass", "num_class": 3, "num_leaves": 31,
              "max_bin": 63, "verbose": -1}
    data = lambda: lt.Dataset(x, y3, categorical_feature=[0, 1])
    hist_cuda.wave_hist.launches.reset()
    on_card = lt.train(params, data(), 4)
    gb = on_card._gbdt
    assert [s[1] for s in gb.tree_stats] == [3] * 4
    assert [s[3] for s in gb.tree_stats] == [1] * 4
    assert hist_cuda.wave_hist.launches.read() \
        == sum(s[2] for s in gb.tree_stats) \
        + gb._grower.capture_stats["warmup_waves"]
    grower = gb._grower
    score = gb.train_score[1].clone()
    grad, hess = (t[1].contiguous() for t in
                  gb.objective.get_gradients(gb.train_score))
    mask = grower.feature_mask_for(13)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        grower.grow_one_iter(score, grad, hess, 0.1, feature_mask=mask,
                             tree_idx=13)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    on_cpu = lt.train({**params, "device": "cpu"}, data(), 4)
    gb._flush_pending()
    on_cpu._gbdt._flush_pending()
    for t_card, t_cpu in zip(gb.models[:3], on_cpu._gbdt.models[:3]):
        n = t_card.num_leaves
        assert n == t_cpu.num_leaves > 2
        np.testing.assert_array_equal(t_card.split_feature[:n - 1],
                                      t_cpu.split_feature[:n - 1])
        assert t_card.cat_threshold == t_cpu.cat_threshold
    assert sum(t.num_cat for t in gb.models) > 0
    np.testing.assert_allclose(on_card.predict(x, raw_score=True),
                               on_cpu.predict(x, raw_score=True), atol=1e-4)


# -- GOSS, DART and RF on the card ----------------------------------------

def test_goss_selection_on_card_equals_cpu(cuda_device):
    """goss_partition on card tensors: buffer, count and multiplier
    bit-equal to the CPU's on the same scores (ties included), and the
    grower's mask drawn with no host sync."""
    from lightgbm_tpu_torch.ops.bagging import goss_partition, goss_row_mask
    from lightgbm_tpu_torch.utils import random as trandom
    rng = np.random.default_rng(5)
    n_pad, num_data = 1 << 17, 100_003
    s = np.abs(rng.standard_normal(n_pad)).astype(np.float32)
    s[::7] = 0.5                                   # ties at the threshold
    s[num_data:] = 0.0
    key = trandom.PRNGKey(1234)
    cpu = goss_partition(key, torch.from_numpy(s), n_pad, num_data, 0.2,
                         0.1)
    dev_s = torch.from_numpy(s).to(cuda_device)
    card = goss_partition(key, dev_s, n_pad, num_data, 0.2, 0.1)
    for a, b in zip(card, cpu):
        assert torch.equal(a.cpu(), b)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        mask, mult = goss_row_mask(key, dev_s, n_pad, num_data, 0.2, 0.1)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want = torch.zeros(n_pad)
    want[cpu[0][:int(cpu[1])].long()] = 1.0
    assert torch.equal(mask.cpu(), want[:num_data])
    assert torch.equal(mult.cpu(), cpu[2][:num_data])


def test_dart_iteration_with_drops_on_card(cuda_device):
    """DART with a drop every iteration on the card against the CPU path:
    the same drops, the same splits, the dropped trees' traversal of the
    grower's (G, n_pad) codes on the card equal to the CPU's, and the
    training and validation scores equal to Booster.predict."""
    from lightgbm_tpu_torch.ops import traverse
    x, y = _valid_rows(21, n=40_000)
    params = {"objective": "binary", "boosting": "dart", "num_leaves": 31,
              "max_bin": 63, "learning_rate": 0.2, "drop_rate": 1.0,
              "skip_drop": 0.0, "max_drop": 2, "drop_seed": 4,
              "verbose": -1}
    boosters = {}
    for dev in ("cuda", "cpu"):
        d = lt.Dataset(x[:30_000], y[:30_000])
        b = lt.Booster({**params, "device": dev}, d)
        b.add_valid(d.create_valid(x[30_000:], y[30_000:]), "v")
        drops = []
        for _ in range(4):
            assert not b.update()
            drops.append(list(b._gbdt.drop_index))
        boosters[dev] = (b, drops)
    (card, card_drops), (cpu, cpu_drops) = boosters["cuda"], boosters["cpu"]
    assert card_drops == cpu_drops and card_drops[-1]
    gb = card._gbdt
    assert gb.traversals > 0
    gb._flush_pending()
    cpu._gbdt._flush_pending()
    for t_card, t_cpu in zip(gb.models[:2], cpu._gbdt.models[:2]):
        n = t_card.num_leaves
        assert n == t_cpu.num_leaves > 2
        np.testing.assert_array_equal(t_card.split_feature[:n - 1],
                                      t_cpu.split_feature[:n - 1])
    tree = gb.models[0]
    codes = gb._grower.binned_t[:, :gb.num_data]
    on_card = traverse.traverse(codes, traverse.device_tree(
        tree, gb.train_set, 31, cuda_device), groups_major=True).cpu()
    np.testing.assert_array_equal(on_card.numpy(),
                                  tree.predict_leaf(x[:30_000]))
    pred = card.predict(x[:30_000], raw_score=True)
    scale = np.abs(pred).max()
    assert np.abs(gb.train_score[0].double().cpu().numpy() - pred).max() \
        <= 1e-5 * scale
    card.eval_valid()
    vpred = card.predict(x[30_000:], raw_score=True)
    assert np.abs(gb.valid_sets[0].score[0].double().cpu().numpy()
                  - vpred).max() <= 1e-5 * scale


def _pipeline_windows(seed_base, n=20_000, nf=10):
    from lightgbm_tpu_torch.pipeline import PreppedWindow

    def prep(w):
        rng = np.random.default_rng(seed_base + w)
        x = rng.standard_normal((n, nf))
        y = (x[:, 0] + 0.5 * x[:, 1] + 0.3 * rng.standard_normal(n)
             > 0).astype(np.float64)
        return PreppedWindow(label=y, dense=x, eval_dense=x[:5000],
                             eval_label=y[:5000])
    return prep


PIPE_CARD = {"objective": "binary", "num_leaves": 31, "max_bin": 255,
             "min_data_in_leaf": 50, "min_sum_hessian_in_leaf": 5.0,
             "feature_fraction": 0.8, "bagging_freq": 5,
             "bagging_fraction": 0.8, "num_iterations": 10,
             "fused_chunk": 5, "verbosity": -1, "device": "cuda"}


def test_pipeline_three_windows_on_card_equal_serial_loop(cuda_device):
    """Three windows of the pipeline on the card (prep thread, fresh
    growers capturing their graphs, swaps into a server on the card, a
    prober thread predicting throughout) give the byte-identical models
    of a serial loop of fresh GBDTs with reference= binning."""
    import threading
    from lightgbm_tpu_torch.boosting.gbdt import GBDT
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.data.dataset import BinnedDataset
    from lightgbm_tpu_torch.pipeline import RetrainPipeline
    prep = _pipeline_windows(500)
    pipe = RetrainPipeline(PIPE_CARD, window_policy="fresh",
                           rebin_on_drift=False, eval_chunk_rows=2048)
    stop, errors, answered = threading.Event(), [], [0]
    xq = np.random.default_rng(1).standard_normal((64, 10))

    def prober():
        while not stop.is_set():
            if pipe.server._model is None:
                continue
            try:
                assert np.isfinite(pipe.server.predict(xq)).all()
                answered[0] += 1
            except Exception as e:              # noqa: BLE001
                errors.append(e)

    t = threading.Thread(target=prober, daemon=True)
    t.start()
    try:
        res = pipe.run(range(3), prep,
                       eval_fn=lambda pred, pw: {"n": len(pred)})
    finally:
        stop.set()
        t.join()
    assert not errors and answered[0] > 0
    cfg = Config(PIPE_CARD)
    ref = None
    for w, r in enumerate(res):
        pw = prep(w)
        ds = BinnedDataset.construct_from_matrix(pw.dense, cfg,
                                                 reference=ref)
        ds.metadata.set_label(pw.label)
        ref = ref or ds
        g = GBDT(cfg)
        g.init_train(ds)
        g.train_chunked(10, chunk=5)
        assert r.booster.model_to_string() == g.model_to_string(), w
    assert [r.eval_metrics for r in res[1:]] == [{"n": 5000}] * 2


def test_refit_leaf_ids_on_card_equal_host_walk(cuda_device):
    """The warm policy's leaf ids (ops/traverse.py over the grower's codes
    on the card) equal the host walk of the rows for every copied tree,
    and its training scores summed from them equal predict(raw_score)."""
    from lightgbm_tpu_torch.pipeline import RetrainPipeline
    prep = _pipeline_windows(600)
    pipe = RetrainPipeline(PIPE_CARD, window_policy="warm",
                           warm_iterations=5, rebin_on_drift=False,
                           serve=False)
    res = pipe.run(range(2), prep)
    assert [r.policy for r in res] == ["fresh", "warm"]
    x1 = prep(1).dense
    copied = res[0].booster.models
    ids = pipe.last_leaf_ids
    assert len(ids) == len(copied)
    for tree, got in zip(copied, ids):
        if tree.num_leaves > 1:
            np.testing.assert_array_equal(got, tree.predict_leaf(x1))
    from lightgbm_tpu_torch.boosting.gbdt import scores_from_leaves
    warm = res[1].booster
    summed = scores_from_leaves(warm.models[:len(ids)], ids, 1, len(x1))
    raw = warm.predict_raw(x1, num_iteration=len(ids))
    np.testing.assert_allclose(summed, raw, rtol=0,
                               atol=1e-6 * np.abs(raw).max())


def _cache_window(seed, n=60_000, nf=12):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, nf)).astype(np.float32)
    y = (x[:, 0] + 0.5 * x[:, 1] + 0.3 * rng.standard_normal(n)
         > 0).astype(np.float32)
    return x, y


def test_grower_cache_replays_without_recapture_on_card(cuda_device):
    """Three windows of the fork's sampling (bagging, feature_fraction),
    fused: windows 1-2 take window 0's grower and capture nothing; every
    model's trees equal those of a fresh grower (grower_cache=false)."""
    from lightgbm_tpu_torch import compile_cache
    from lightgbm_tpu_torch.obs import capture_track
    from lightgbm_tpu_torch.ops import grow
    params = {"objective": "binary", "num_leaves": 31, "max_bin": 63,
              "feature_fraction": 0.8, "bagging_freq": 5,
              "bagging_fraction": 0.8, "min_data_in_leaf": 50,
              "fused_chunk": 10, "verbosity": -1}
    cut = lambda s: s.split("\nparameters:\n")[0]
    compile_cache.clear()
    try:
        for cache in (True, False):
            texts, captures, hits = [], [], []
            for w in range(3):
                x, y = _cache_window(w)
                c0 = capture_track.COUNTS["captures"]
                h0 = grow.GROWER_CACHE_COUNTS["hits"]
                b = lt.train({**params, "grower_cache": cache},
                             lt.Dataset(x, label=y), num_boost_round=20)
                captures.append(capture_track.COUNTS["captures"] - c0)
                hits.append(grow.GROWER_CACHE_COUNTS["hits"] - h0)
                texts.append(cut(b.model_to_string()))
                del b
            if cache:
                assert captures[0] > 0 and captures[1:] == [0, 0]
                assert hits == [0, 1, 1]
                cached = texts
            else:
                assert min(captures) > 0 and hits == [0, 0, 0]
                assert texts == cached
    finally:
        compile_cache.clear()


def test_fleet_server_on_the_forest_kernel(cuda_device):
    """A two-tenant FleetServer on the card: each tenant's rows equal its
    solo PredictionServer's bit for bit through forest_predict, a fitting
    swap is an index copy, and the micro-batching queues answer as
    predict does."""
    from lightgbm_tpu_torch.serve import (FleetServer, PredictionServer,
                                          packed)
    boosters = []
    for w in range(2):
        x, y = _cache_window(10 + w, n=20_000)
        boosters.append(lt.train(
            {"objective": "binary", "num_leaves": 31, "verbosity": -1},
            lt.Dataset(x, label=y), num_boost_round=8))
    xq, _ = _cache_window(20, n=5_000)
    tids = (np.arange(5_000) % 2).astype(np.int32)
    before = packed.forest_predict.launches
    fs = FleetServer(boosters, replicas=2)
    got = fs.predict(tids, xq)
    assert packed.forest_predict.launches == before + 1
    for m, b in enumerate(boosters):
        rows = np.nonzero(tids == m)[0]
        np.testing.assert_array_equal(
            got[rows], PredictionServer(b).predict(xq[rows]))
    fleet0 = fs.fleet
    assert fs.swap_tenant(0, boosters[1]) is True and fs.fleet is fleet0
    np.testing.assert_array_equal(fs.predict(0, xq), fs.predict(1, xq))
    with fs:
        fut = fs.submit(tids[:100], xq[:100])
        np.testing.assert_array_equal(fut.result(timeout=60),
                                      fs.predict(tids[:100], xq[:100]))


@pytest.mark.parametrize("quant", [False, True])
def test_kernel_at_every_ladder_width_matches_plain(cuda_device, quant):
    """Kernel 1 at each width a stage plan may take for 255 leaves (the
    doubling ladder 4-64 and the full 128), as the stage probes launch
    it: int8 byte-equal to the plain version, bf16 within 1e-4 of each
    cell's sum of |stats|."""
    from lightgbm_tpu_torch.ops import stage_plan
    for w in stage_plan._ladder(128) + [128]:
        bins, leaf, ghk, pending = _inputs(cuda_device, 60_001, 7, 256, 3,
                                           w, quant, seed=w)
        kw = dict(g=7, nb=256, k=3, w=w)
        got = hist_cuda.wave_hist(bins, leaf, ghk, pending, **kw)
        ref = hist_cuda.wave_hist_reference(bins, leaf, ghk, pending, **kw)
        if quant:
            assert torch.equal(got, ref), w
        else:
            mag = hist_cuda.wave_hist_reference(bins, leaf, ghk.abs(),
                                                pending, **kw)
            assert ((got - ref).abs() <= 1e-4 * mag + 1e-6).all(), w


def test_learning_rate_reaches_the_captured_tree(cuda_device):
    """The learning rate is a buffer the captured tree reads, written each
    launch: a schedule per iteration and a reset between fused chunks
    give each tree its own rate, and the training score equals the
    model's predictions of the training rows."""
    x, y = _cache_window(30, n=30_000)
    params = {"objective": "binary", "num_leaves": 31, "verbosity": -1,
              "device_predict": "force"}
    ds = lt.Dataset(x, label=y)
    b = lt.train(params, ds, 4, learning_rates=[0.3, 0.2, 0.1, 0.05],
                 keep_training_booster=True)
    b.reset_parameter({"learning_rate": 0.02})
    b.update_chunked(4, chunk=4)
    gb = b._gbdt
    gb._flush_pending()
    assert [t.shrinkage for t in gb.models[1:]] == [0.2, 0.1, 0.05] + \
        [0.02] * 4
    score = gb.train_score[0].double().cpu().numpy()
    np.testing.assert_allclose(score, gb.predict_raw(x)[0], atol=1e-5)


def test_profile_stage_plan_on_card(cuda_device, tmp_path):
    """wave_plan=profiled on the card: kernel 1 launched once to warm up
    and ``PROBE_REPS`` times at each candidate width, the plan kept for
    the signature and adopted by a second booster without a profile."""
    from lightgbm_tpu_torch.ops import grow, stage_plan
    x, y = _cache_window(31, n=50_000)
    params = {"objective": "binary", "num_leaves": 63, "verbosity": -1,
              "wave_plan": "profiled"}
    before = hist_cuda.wave_hist.launches.read()
    b = lt.Booster(params, lt.Dataset(x, label=y))
    prof = b._gbdt.plan_profile
    try:
        widths = sorted(prof["stage_ms"])
        assert widths == [4, 8, 16, 32, 62]
        assert hist_cuda.wave_hist.launches.read() - before == \
            (grow.PROBE_REPS + 1) * len(widths)
        assert all(v >= 0 for v in prof["spread_ms"].values())
        assert b._gbdt._grower.stage_plan == prof["plan"]
        p0 = grow.PLAN_COUNTS["profiles"]
        b2 = lt.Booster(params, lt.Dataset(x, label=y))
        assert grow.PLAN_COUNTS["profiles"] == p0
        assert b2._gbdt._grower.stage_plan == prof["plan"]
        for _ in range(2):
            b2.update()
        assert b2.num_trees() == 2
    finally:
        stage_plan.forget_plan(b._gbdt._grower.signature)


def test_tensor_on_the_card_predicts_through_the_kernel(cuda_device):
    """Rows already on the card take the forest kernel below
    ``device_predict_min_rows`` (the init score of a small tensor Dataset
    is not copied to the host); ``device_predict=off`` walks them on the
    host, and row-wise early stopping refuses them."""
    from lightgbm_tpu_torch.basic import LightGBMError
    from lightgbm_tpu_torch.serve import packed
    x, y = _cache_window(32, n=5_000)
    b = lt.train({"objective": "binary", "num_leaves": 15, "verbosity": -1},
                 lt.Dataset(x, label=y), 3)
    gb = b._gbdt
    assert len(x) < int(gb.config.device_predict_min_rows)
    xd = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
        cuda_device)
    before = packed.forest_predict.launches
    got = gb.predict_raw(xd)
    assert packed.forest_predict.launches == before + 1
    walk = gb.predict_raw(x)             # host rows below the threshold
    assert packed.forest_predict.launches == before + 1
    np.testing.assert_allclose(got, walk, atol=1e-5)
    gb.config.device_predict = "off"
    np.testing.assert_array_equal(gb.predict_raw(xd), walk)
    assert packed.forest_predict.launches == before + 1
    gb.config.device_predict = "auto"
    gb.config.pred_early_stop = True
    with pytest.raises(LightGBMError, match="pred_early_stop"):
        gb.predict_raw(xd)
