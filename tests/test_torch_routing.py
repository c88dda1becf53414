"""A wave's row routing (``lightgbm_tpu_torch/ops/routing.py``) on the CPU.

* the wrapper ``split_rows`` takes the plain version for CPU tensors and
  updates the leaf ids in place, launching nothing;
* the plain version equals an oracle routed lane by lane through the host
  learner's ``ops/partition.goes_left`` over bundled groups, every missing
  type, both default sides, categorical bin sets, rows in no leaf and in
  leaves no lane splits, garbage in unselected lanes, one lane and the
  full width;
* the wrapper refuses inputs of the wrong shape, dtype or device;
* ``feature_table`` holds the dataset's feature fields.

The kernel against the plain version is in ``test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

import _routing_cases as rc
from lightgbm_tpu_torch.ops import routing


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """This module's torch CPU ops on one thread (several test workers
    share the machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


#: (rows, leaves, lanes, selected, categorical, padded row blocks)
CASES = {
    "bundled_w96": (10_003, 255, 96, 60, False, 0),
    "one_lane_two_leaves": (4_099, 2, 1, 1, False, 0),
    "full_width": (20_001, 255, 128, 128, False, 0),
    "categorical": (9_998, 63, 30, 30, True, 0),
    "none_selected": (5_000, 31, 16, 0, False, 0),
    "sharded_blocks": (8_192, 255, 64, 40, False, 4),
    "max_leaves": (6_001, routing.MAX_LEAVES, 128, 100, True, 0),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_routing_equals_the_partition_oracle(name):
    n, L, ws, nsel, cat, blocks = CASES[name]
    args = rc.make_case(n, L, ws, nsel=nsel, cat=cat, pad_blocks=blocks,
                        seed=len(name))
    want = rc.oracle(*args)
    got = routing.split_rows_reference(*args, num_leaves=L)
    assert torch.equal(got, want)
    if nsel == 0:
        assert torch.equal(got, args[0])
    else:
        assert not torch.equal(got, args[0])


def test_wrapper_routes_cpu_tensors_in_place_through_the_plain_version():
    args = rc.make_case(7_777, 255, 96, nsel=70, cat=True, seed=3)
    leaf = args[0]
    want = routing.split_rows_reference(*args, num_leaves=255)
    before = routing.split_rows.launches.read()
    out = routing.split_rows(*args, num_leaves=255)
    assert out is leaf
    assert torch.equal(leaf, want)
    assert routing.split_rows.launches.read() == before


def test_wrapper_refuses_what_it_does_not_take():
    args = rc.make_case(1_000, 31, 8, nsel=4, seed=1)

    def with_arg(i, value):
        a = list(args)
        a[i] = value
        return a
    with pytest.raises(ValueError, match="leaf_id"):
        routing.split_rows(*with_arg(0, args[0].long()), num_leaves=31)
    with pytest.raises(ValueError, match="codes"):
        routing.split_rows(*with_arg(1, args[1].int()), num_leaves=31)
    with pytest.raises(ValueError, match="r_ids"):
        routing.split_rows(*with_arg(5, args[5].int()), num_leaves=31)
    with pytest.raises(ValueError, match="come together"):
        routing.split_rows(*with_arg(9, torch.zeros((8, 8),
                                                    dtype=torch.int32)),
                           num_leaves=31)
    with pytest.raises(ValueError, match="different devices"):
        routing.split_rows(*with_arg(3, args[3].to("meta")), num_leaves=31)


def test_feature_table_holds_the_dataset_fields():
    import lightgbm_tpu_torch as lt
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2_000, 5))
    x[:, 1] = np.where(rng.random(2_000) < 0.7, 0.0, x[:, 1])
    x[rng.random(x.shape) < 0.05] = np.nan
    ds = lt.Dataset(x, (x[:, 0] > 0).astype(float),
                    params={"max_bin": 31, "verbose": -1}).construct()
    h = ds._handle
    t = routing.feature_table(h, "cpu").numpy()
    assert t.dtype == np.int32
    nb = np.asarray(h.f_num_bin)
    db = np.asarray(h.f_default_bin)
    np.testing.assert_array_equal(t[:, routing.FEAT_GROUP], h.f_group)
    np.testing.assert_array_equal(t[:, routing.FEAT_OFFSET], h.f_offset)
    np.testing.assert_array_equal(t[:, routing.FEAT_WIDTH], nb - (db == 0))
    np.testing.assert_array_equal(t[:, routing.FEAT_DEFAULT], db)
    np.testing.assert_array_equal(t[:, routing.FEAT_NUM_BIN], nb)
    np.testing.assert_array_equal(t[:, routing.FEAT_MISSING],
                                  h.f_missing_type)
