"""Build port objects from arrays: trees and bin mappers of a model trained
elsewhere (the JAX package, or the reference), and packed ensembles,
handed over as numpy arrays.

A GBDT's state is its trees and its bin mappers; a served model's is its
packed tables.  The caller extracts the fields to numpy; this module
imports nothing of the package they came from.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from .basic import Booster
from .boosting.gbdt import GBDT
from .config import Config
from .data.binning import BinMapper
from .serve.packed import ARRAY_FIELDS, PackedEnsemble
from .tree.tree import Tree

#: Tree fields taken from the arrays, with their dtypes
TREE_FIELDS = {
    "split_feature": np.int32, "split_feature_inner": np.int32,
    "split_gain": np.float64,
    "threshold": np.float64, "threshold_in_bin": np.int32,
    "decision_type": np.int8, "left_child": np.int32,
    "right_child": np.int32, "leaf_value": np.float64,
    "leaf_count": np.int64, "internal_value": np.float64,
    "internal_count": np.int64,
}


def tree_from_arrays(arrays: Mapping) -> Tree:
    """One ``Tree`` from a mapping with ``num_leaves``, the
    :data:`TREE_FIELDS` arrays and optionally ``shrinkage``, ``num_cat``,
    ``cat_boundaries`` and ``cat_threshold``.  A tree that walks a binned
    matrix (``ops/traverse.py``) reads ``split_feature_inner`` (the
    used-feature index; the raw one when absent) and, with categorical
    splits, its bitsets over inner bins ``cat_boundaries_inner`` and
    ``cat_threshold_inner`` (the raw ones when absent)."""
    n = int(arrays["num_leaves"])
    tree = Tree(max(n, 2))
    tree.num_leaves = n
    for name, dt in TREE_FIELDS.items():
        if name not in arrays:
            continue
        src = np.asarray(arrays[name], dt)
        dst = getattr(tree, name)
        dst[:len(src)] = src[:len(dst)]
    if "split_feature_inner" not in arrays:
        tree.split_feature_inner = tree.split_feature.copy()
    tree.shrinkage = float(arrays.get("shrinkage", 1.0))
    tree.num_cat = int(arrays.get("num_cat", 0))
    if tree.num_cat:
        tree.cat_boundaries = [int(v) for v in arrays["cat_boundaries"]]
        tree.cat_threshold = [int(v) for v in arrays["cat_threshold"]]
        tree.cat_boundaries_inner = [int(v) for v in arrays.get(
            "cat_boundaries_inner", tree.cat_boundaries)]
        tree.cat_threshold_inner = [int(v) for v in arrays.get(
            "cat_threshold_inner", tree.cat_threshold)]
    for node in range(n - 1):
        for child in (tree.left_child[node], tree.right_child[node]):
            if child < 0:
                tree.leaf_parent[~child] = node
    return tree


def booster_from_arrays(trees: Sequence[Mapping], params=None, *,
                        max_feature_idx: int, feature_names=None,
                        objective: str = "binary sigmoid:1",
                        num_tree_per_iteration: int = 1,
                        average_output: bool = False,
                        feature_infos=None) -> Booster:
    """A port ``Booster`` that predicts with the given trees.  ``objective``
    is the model text's objective line (it picks the output transform);
    ``average_output`` (a random forest's) averages the trees' sum over
    the iterations instead; ``feature_infos`` fills the model text's line
    of that name."""
    gbdt = GBDT(Config(dict(params or {})))
    gbdt.average_output = bool(average_output)
    gbdt.models = [tree_from_arrays(t) for t in trees]
    gbdt.num_model = int(num_tree_per_iteration)
    gbdt.iter = len(gbdt.models) // gbdt.num_model
    gbdt.max_feature_idx = int(max_feature_idx)
    gbdt.feature_names = (list(feature_names) if feature_names is not None
                          else [f"Column_{i}"
                                for i in range(max_feature_idx + 1)])
    gbdt.loaded_objective_str = objective
    if feature_infos is not None:
        gbdt.feature_infos = list(feature_infos)
    return Booster.from_gbdt(gbdt, params)


def bin_mappers_from_arrays(states: Sequence[Mapping]):
    """Port ``BinMapper``s from the mappers' state mappings (the fields of
    ``BinMapper.to_state``: bin boundaries, default bin, missing type,
    ...)."""
    return [BinMapper.from_state(dict(s)) for s in states]


#: PackedEnsemble fields with their dtypes (the JAX package's)
PACKED_DTYPES = {
    "split_feature": np.int32, "threshold_hi": np.float32,
    "threshold_lo": np.float32, "decision_type": np.int32,
    "left_child": np.int32, "right_child": np.int32, "cat_start": np.int32,
    "cat_len": np.int32, "cat_words": np.uint32, "leaf_value": np.float32,
    "is_stump": np.bool_,
}


def packed_from_arrays(fields: Mapping, *, num_model: int, max_depth: int,
                       num_trees: int, num_features: int,
                       device="cuda") -> PackedEnsemble:
    """A port ``PackedEnsemble`` on ``device`` from the arrays of a packed
    ensemble (the JAX package's ``PackedEnsemble`` fields, as numpy) and
    its static values."""
    out = {}
    for name in ARRAY_FIELDS:
        arr = np.array(fields[name], PACKED_DTYPES[name], order="C")
        if arr.dtype == np.uint32:
            # uint32 moves as its int32 bits (see serve/packed.py)
            out[name] = torch.from_numpy(arr.view(np.int32)).to(
                device).view(torch.uint32)
        else:
            out[name] = torch.from_numpy(arr).to(device)
    return PackedEnsemble(**out, num_model=int(num_model),
                          max_depth=int(max_depth), num_trees=int(num_trees),
                          num_features=int(num_features))
