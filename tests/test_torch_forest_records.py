"""The forest kernel's node-record table and launch geometry
(lightgbm_tpu_torch/serve/packed.py), on the CPU.

* ``forest_records`` decodes back to the pack's fields exactly, for solo
  packs, a K=3 slice, categorical nodes, stumps, a bf16 fleet (after a
  tenant swap too) and the widest values a pack can hold (node pads of
  2^17, split features past 2^16);
* the plain version run on the decoded tables equals it run on the pack,
  and both equal the JAX package's packed prediction;
* ``forest_geometry``, whose numbers csrc/forest_predict.cu launches with,
  never asks for more than a block's 227 KB of shared memory, stages the
  fork's 53-column rows, and picks the route that the card measured
  faster at every shape of the committed sweep.

tests/test_torch_cuda.py runs both routes of the kernel on the card.
"""

import copy
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb  # noqa: F401 -- the JAX package, for parity
import synthetic_forests as synthetic
from lightgbm_tpu.serve import packed as jpacked
from lightgbm_tpu.tree.tree import Tree as JTree
from lightgbm_tpu_torch.serve import fleet, packed
from lightgbm_tpu_torch.utils.log import LightGBMError


_BITS = {torch.float32: torch.int32, torch.uint32: torch.int32,
         torch.bfloat16: torch.int16}


def _assert_tables_equal(a, b):
    """Field by field, bit for bit (NaN thresholds included)."""
    for f in packed.ARRAY_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        bits = _BITS.get(x.dtype)
        assert torch.equal(x.view(bits) if bits else x,
                           y.view(bits) if bits else y), f


def _jax_trees(models):
    out = []
    for t in models:
        j = JTree(t.max_leaves)
        for k, v in vars(t).items():
            if k in vars(j):
                setattr(j, k, copy.deepcopy(v))
        out.append(j)
    return out


@pytest.mark.parametrize("num_model,cats,slice_,stumps", [
    (1, (), (0, -1), False),
    (1, (1, 4), (0, -1), True),         # bitsets; one tree in 16 a stump
    (3, (2,), (3, 5), True),            # a K=3 iteration slice
])
def test_records_decode_to_the_pack(num_model, cats, slice_, stumps):
    # no denormals: the JAX package's CPU program flushes them to zero
    g = synthetic.random_forest(3, num_iterations=24, num_leaves=31,
                                num_features=7, cat_features=cats,
                                num_model=num_model, denormals=False)
    if not stumps:
        g.models = [t for t in g.models if t.num_leaves > 1]
    pe = packed.pack_gbdt(g, *slice_, device="cpu")
    rec = pe.records
    assert rec is pe.records                    # built once, kept
    assert rec.blob.shape[-1] == packed.record_words(pe.split_feature.shape[1])
    assert rec.blob.shape[-1] % 4 == 0
    _assert_tables_equal(packed.decode_records(rec), pe.tables())
    # the trees past the last that is not a zero-valued stump are padding
    real = [i for i, t in enumerate(packed.tree_slice(g.models, num_model,
                                                      *slice_))
            if t.num_leaves > 1 or t.leaf_value[0] != 0]
    assert rec.live.tolist() == [real[-1] + 1]
    assert bool(pe.is_stump[rec.live[0]:].all())
    x = torch.from_numpy(synthetic.query_rows(g, 300, 4, cat_features=cats,
                                              denormals=False))
    kw = dict(num_model=pe.num_model, max_depth=pe.max_depth)
    for leaves in (False, True):
        a = packed.forest_predict_reference(pe.tables(), x, leaves=leaves,
                                            **kw)
        b = packed.forest_predict_reference(packed.decode_records(rec), x,
                                            leaves=leaves, **kw)
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    # and the JAX package's packed prediction routes the same way
    jpe = jpacked.pack_ensemble(_jax_trees(g.models), num_model, *slice_,
                                num_features=7)
    np.testing.assert_array_equal(
        packed.forest_predict_reference(
            packed.decode_records(rec), x, leaves=True,
            **kw)[:, :pe.num_trees].numpy(),
        jpacked.predict_leaves(jpe, x.numpy()))


def test_records_of_an_all_stump_model():
    g = synthetic.random_forest(4, num_iterations=3, num_leaves=2,
                                num_features=3)
    for t in g.models:
        t.num_leaves = 1
    pe = packed.pack_gbdt(g, device="cpu")
    assert bool(pe.is_stump.all()) and pe.max_depth == 0
    _assert_tables_equal(packed.decode_records(pe.records), pe.tables())
    # biases are not padding
    assert pe.records.live.tolist() == [pe.num_trees]
    x = torch.zeros((5, 3), dtype=torch.float64)
    got = packed.forest_predict_reference(
        packed.decode_records(pe.records), x, num_model=1, max_depth=0)
    want = sum(np.float32(t.leaf_value[0]) for t in g.models)
    np.testing.assert_allclose(got.numpy()[0], want, rtol=1e-6)


def test_records_hold_the_widest_fields():
    """Node pads of 2^17, split features past 2^16, every decision type,
    any f32 bit pattern in the thresholds: all survive the record."""
    rng = np.random.default_rng(0)
    n, t = 1 << 17, 2
    shape = (1, t, n)
    ints = lambda lo, hi: torch.from_numpy(
        rng.integers(lo, hi, shape).astype(np.int32))
    bits = lambda: torch.from_numpy(rng.integers(
        -(1 << 31), 1 << 31, shape, dtype=np.int64).astype(np.int32)) \
        .view(torch.float32)
    tables = packed.ForestTables(
        split_feature=ints(0, packed.MAX_SPLIT_FEATURE),
        threshold_hi=bits(), threshold_lo=bits(),
        decision_type=ints(0, 16), left_child=ints(-n - 1, n),
        right_child=ints(-n - 1, n), cat_start=ints(0, 1 << 30),
        cat_len=ints(0, 5),
        cat_words=torch.from_numpy(rng.integers(
            0, 1 << 32, (1, 8), dtype=np.uint64).astype(np.uint32)
            .view(np.int32)).view(torch.uint32),
        leaf_value=torch.from_numpy(rng.standard_normal(
            (1, t, n + 1)).astype(np.float32)),
        is_stump=torch.tensor([[True, False]]))
    assert int(tables.split_feature.max()) > 1 << 16
    _assert_tables_equal(packed.decode_records(packed.forest_records(tables)),
                         tables)
    for field, value in (("split_feature", packed.MAX_SPLIT_FEATURE),
                         ("decision_type", 16), ("decision_type", -1)):
        bad = getattr(tables, field).clone()
        bad[0, 1, 7] = value
        with pytest.raises(LightGBMError, match="records"
                           if field == "split_feature" else "decision"):
            packed.forest_records(tables._replace(**{field: bad}))


def test_fleet_records_follow_a_tenant_swap():
    gs = [synthetic.random_forest(s, num_iterations=it, num_leaves=lv,
                                  num_features=6, cat_features=(2,))
          for s, it, lv in ((1, 10, 31), (2, 25, 63), (3, 4, 8))]
    fl, packs = fleet.pack_fleet(gs, device="cpu", value_dtype="bf16")
    rec = fl.records
    decoded = packed.decode_records(rec, torch.bfloat16)
    _assert_tables_equal(decoded, fl.tables())
    x = torch.from_numpy(synthetic.query_rows(gs[1], 400, 5,
                                              cat_features=(2,)))
    tid = torch.from_numpy(np.arange(400, dtype=np.int32) % 3)
    kw = dict(num_model=1, max_depth=fl.max_depth)
    for leaves in (False, True):
        a = packed.forest_predict_reference(fl.tables(), x, tid,
                                            leaves=leaves, **kw)
        b = packed.forest_predict_reference(decoded, x, tid, leaves=leaves,
                                            **kw)
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert rec.live.tolist() == [10, 25, 4]
    fleet.write_tenant(fl, 0, packs[2])
    assert fl.records is rec and rec.blob.data_ptr() == \
        fl.records.blob.data_ptr()
    assert rec.live.tolist() == [4, 25, 4]
    _assert_tables_equal(packed.decode_records(fl.records, torch.bfloat16),
                         fl.tables())
    _assert_tables_equal(packed.decode_records(fl.records, torch.bfloat16),
                         fleet.stack_packs([packs[2], packs[1], packs[2]],
                                           "bf16").tables())


def test_the_wrapper_reads_records_on_the_cpu_as_the_tables():
    g = synthetic.random_forest(8, num_iterations=6, num_leaves=15,
                                num_features=5, cat_features=(0,))
    pe = packed.pack_gbdt(g, device="cpu")
    x = torch.from_numpy(synthetic.query_rows(g, 50, 9, cat_features=(0,)))
    kw = dict(num_model=1, max_depth=pe.max_depth)
    assert torch.equal(
        packed.forest_predict(pe.tables(), x, records=pe.records, **kw),
        packed.forest_predict_reference(pe.tables(), x, **kw))


GEOMETRY_SHAPES = [(16, 256), (512, 64), (192, 32), (4, 4096), (1, 1 << 17)]


@pytest.mark.parametrize("x_f64", [False, True])
@pytest.mark.parametrize("leaves", [False, True])
def test_geometry_fits_shared_memory(x_f64, leaves):
    """At nf = 1..256, f32 and f64 rows, scores and leaves, K 1 and 3, one
    and four tenants, small and large batches: every launch fits a block's
    shared memory, its size is the layout's, and the rows route stages
    rows up to 128 columns whenever a tree chunk fits beside them."""
    xb = 8 if x_f64 else 4
    for nf in range(1, 257):
        for trees, nodes in GEOMETRY_SHAPES:
            for k in (1, 3):
                if trees % k:
                    continue
                for rows, tenants in ((1, 1), (100, 4), (2_000_000, 1),
                                      (500_000, 4)):
                    geo = packed.forest_geometry(
                        rows, trees, nodes, nf, x_f64, leaves, k,
                        tenants=tenants)
                    assert 0 < geo.smem_bytes <= packed.SMEM_PER_BLOCK
                    assert 0 < geo.threads <= packed.MAX_THREADS
                    if geo.route == "trees":
                        assert geo.smem_bytes == packed.trees_smem_bytes(
                            geo.rows_per_block, geo.chunk_trees, nf, xb, k,
                            leaves)
                        assert 1 <= geo.chunk_trees <= trees
                        assert geo.grid * geo.rows_per_block >= rows
                        continue
                    assert geo.threads == geo.rows_per_block
                    # the kernel has no chunk ring without a row stage
                    assert geo.stage_rows or not geo.smem_trees
                    assert geo.smem_bytes == packed.rows_smem_bytes(
                        geo.rows_per_block, geo.chunk_trees,
                        packed.record_words(nodes), nf, xb, k, leaves,
                        geo.smem_trees, geo.stage_rows)
                    assert 1 <= geo.chunk_trees <= trees
                    assert bool(geo.group_blocks) == (
                        tenants > 1 and geo.smem_trees)
                    assert geo.grid * geo.rows_per_block >= rows
                    if nf <= 128 and nodes <= 256:
                        assert geo.stage_rows and geo.smem_trees


def test_geometry_routes_and_the_fork_width():
    sms = 132
    cut = packed.TREES_ROUTE_ROWS_PER_SM * sms
    for rows in (1, 100, cut):
        assert packed.forest_geometry(rows, 512, 64, 28, True, False,
                                      1).route == "trees"
    assert packed.forest_geometry(cut + 1, 512, 64, 28, True, False,
                                  1).route == "rows"
    # a few rows against a few trees: one thread walks them sooner
    for rows, trees in ((1, 16), (8, 8)):
        assert packed.forest_geometry(rows, trees, 32, 53, True, False,
                                      1).route == "rows"
    assert packed.forest_geometry(1, 32, 32, 53, True, False,
                                  1).route == "trees"
    # the fork's rows are wide for its 8 trees (424 bytes, 53 a tree): the
    # rows route spends its time staging them, and the trees route wins
    # far longer; with deep trees beside them the rows route keeps few
    # rows resident, and the trees route wins at every size
    wide = (packed.TREES_ROUTE_ROWS_PER_SM
            + packed.WIDE_ROWS_PER_SM_PER_BYTE * (53 - 32)) * sms
    for rows, route in ((100_000, "trees"), (wide, "trees"),
                        (wide + 1, "rows")):
        assert packed.forest_geometry(rows, 8, 32, 53, True, False,
                                      1).route == route
    geo = packed.forest_geometry(10 ** 7, 8, 256, 53, True, False, 1,
                                 route="rows")
    assert packed.resident_rows(geo) <= packed.FEW_RESIDENT_ROWS
    assert packed.forest_geometry(10 ** 7, 8, 256, 53, True, False,
                                  1).route == "trees"
    # the fork harness's rows: 53 columns, f64, 31-leaf trees, 2M rows
    geo = packed.forest_geometry(2_000_000, 8, 32, 53, True, False, 1)
    assert (geo.route, geo.stage_rows, geo.smem_trees) == ("rows", True,
                                                           True)
    assert geo.chunk_trees >= packed.MIN_CHUNK_TREES
    # several blocks an SM where a useful chunk fits beside them
    geo = packed.forest_geometry(2_000_000, 512, 64, 28, True, False, 1)
    assert 2 * (geo.smem_bytes + 1024) <= packed.SMEM_PER_SM
    assert geo.chunk_trees >= packed.MIN_CHUNK_TREES
    # the fork's rows: more than one block's rows resident an SM
    geo = packed.forest_geometry(2_000_000, 8, 32, 53, True, False, 1)
    resident = packed.SMEM_PER_SM // (geo.smem_bytes + 1024) \
        * geo.rows_per_block
    assert resident > packed.MAX_THREADS
    # a tree too large for the ring walks from global memory
    geo = packed.forest_geometry(2_000_000, 2, 1 << 17, 28, True, True, 1)
    assert not geo.smem_trees and geo.stage_rows
    # a forced route, as the measurements force it
    assert packed.forest_geometry(10, 512, 64, 28, True, False, 1,
                                  route="rows").route == "rows"
    with pytest.raises(ValueError, match="route"):
        packed.forest_geometry(10, 8, 8, 4, True, False, 1, route="cols")


def test_route_choice_is_the_faster_route_measured():
    """At every shape of the committed sweeps (both routes forced and timed
    on the card by scripts/compare_forest_cuda.py --sweep in six calls:
    forests of 4 to 512 trees, 16 to 256 padded nodes, rows of 112 to
    2400 bytes, a four-tenant fleet, 1 to 300,000 rows), the route the
    wrapper picks is the faster one or within 5% or 1.25 us of it: where
    both routes take about 10 us, the faster one changes by about 1 us
    from one forest of a shape to the next, which the choice does not
    separate."""
    path = Path(__file__).parent / "fixtures" / "forest_route_sweep.json"
    sweeps = json.loads(path.read_text())
    checked = 0
    for sweep in sweeps["sweeps"]:
        for f in sweep["forests"]:
            for rows, rows_us, trees_us in zip(f["rows"], f["rows_us"],
                                               f["trees_us"]):
                route = packed.forest_geometry(
                    rows, f["trees"], f["nodes"], f["nf"], f["x_f64"], False,
                    1, tenants=f["tenants"],
                    sm_count=sweeps["sm_count"]).route
                took = trees_us if route == "trees" else rows_us
                best = min(rows_us, trees_us)
                assert took <= max(1.05 * best, best + 1.25), (f["name"],
                                                               rows)
                checked += 1
    assert checked == 1710
