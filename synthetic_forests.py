"""Random forests and query rows that reach every branch of the packed-forest
decision: deep paths, NaN- and zero-missing nodes, multi-word categorical
bitsets, thresholds at the edges of float32 (denormal, past its range),
and query values at, and one float64 ulp either side of, thresholds.

A helper of ``chip_smoke.py`` and the tests, not part of the package: it
holds ``lightgbm_tpu_torch/csrc/forest_predict.cu`` against its plain
version (``chip_smoke.py``, ``tests/test_torch_cuda.py``) and the port
against the JAX package (``tests/test_torch_serve.py``).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from lightgbm_tpu_torch.boosting.gbdt import GBDT
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.tree.tree import (K_CATEGORICAL_MASK,
                                          K_DEFAULT_LEFT_MASK, Tree)

#: numerical thresholds drawn now and then besides N(0, 1) ones
SPECIAL_THRESHOLDS = (0.0, 2.5, -3.5, 1e30, 1e300, -1e300)
#: and with ``denormals``: below float32's normal range (1e-310 is below
#: its denormal range too, so it splits as 0 does)
DENORMAL_THRESHOLDS = (1e-40, -1e-40, 1e-310)


def random_tree(rng: np.random.Generator, num_leaves: int,
                num_features: int, cat_features: Sequence[int] = (),
                max_category: int = 128, denormals: bool = True) -> Tree:
    """One tree of ``num_leaves`` leaves.  Half of the splits split the
    newest leaf, so paths run deep; each node draws its missing type
    (none, zero, NaN) and default direction; a split on one of
    ``cat_features`` takes a bitset of up to ``max_category // 32``
    words; ``denormals`` adds thresholds below float32's normal range."""
    special = SPECIAL_THRESHOLDS + (DENORMAL_THRESHOLDS if denormals else ())
    tree = Tree(max(num_leaves, 2))
    for _ in range(num_leaves - 1):
        leaf = (tree.num_leaves - 1 if rng.random() < 0.5
                else int(rng.integers(tree.num_leaves)))
        f = int(rng.integers(num_features))
        missing = int(rng.integers(3))
        default_left = bool(rng.random() < 0.5)
        if f in cat_features:
            node = tree._split_common(leaf, f, f, 0.0, 0.0, 1, 1, 1.0)
            n_words = int(rng.integers(1, max_category // 32 + 1))
            words = rng.integers(0, 1 << 32, n_words, dtype=np.uint64)
            tree.decision_type[node] = (K_CATEGORICAL_MASK
                                        | K_DEFAULT_LEFT_MASK * default_left
                                        | missing << 2)
            tree.threshold[node] = tree.num_cat
            tree.threshold_in_bin[node] = tree.num_cat
            tree.num_cat += 1
            tree.cat_threshold.extend(int(w) for w in words)
            tree.cat_boundaries.append(len(tree.cat_threshold))
            tree.num_leaves += 1
        else:
            thr = (float(rng.choice(special))
                   if rng.random() < 0.15 else float(rng.standard_normal()))
            tree.split(leaf, f, f, 0, thr, 0.0, 0.0, 1, 1, 1.0, missing,
                       default_left)
    tree.leaf_value[:num_leaves] = rng.standard_normal(num_leaves) * 0.1
    return tree


def random_forest(seed: int, *, num_iterations: int, num_leaves: int,
                  num_features: int, cat_features: Sequence[int] = (),
                  num_model: int = 1, max_category: int = 128,
                  denormals: bool = True) -> GBDT:
    """A loaded-like ``GBDT`` of ``num_iterations * num_model`` random
    trees (:func:`random_tree`); one tree in 16 is a stump carrying a
    bias (none in the last iteration, which a trained model's stop rule
    would drop), the others have 2 to ``num_leaves`` leaves."""
    rng = np.random.default_rng(seed)
    gbdt = GBDT(Config({"objective": "multiclass" if num_model > 1
                        else "binary", "num_class": num_model,
                        "verbose": -1}))
    last = (num_iterations - 1) * num_model
    for i in range(num_iterations * num_model):
        if i < last and rng.random() < 1 / 16:
            tree = Tree(2)
            tree.leaf_value[0] = float(rng.standard_normal()) * 0.1
        else:
            tree = random_tree(rng, int(rng.integers(2, num_leaves + 1)),
                               num_features, cat_features, max_category,
                               denormals)
        gbdt.models.append(tree)
    gbdt.num_model = num_model
    gbdt.iter = num_iterations
    gbdt.max_feature_idx = num_features - 1
    gbdt.feature_names = [f"Column_{i}" for i in range(num_features)]
    gbdt.feature_infos = ["none"] * num_features
    gbdt.loaded_objective_str = ("binary sigmoid:1" if num_model == 1 else
                                 f"multiclass num_class:{num_model}")
    return gbdt


def query_rows(gbdt: GBDT, n: int, seed: int, *, near: bool = True,
               cat_features: Sequence[int] = (), max_category: int = 128,
               denormals: bool = True) -> np.ndarray:
    """(n, features) float64 query rows: N(0, 1.5) values with NaNs,
    zeros, integers and (with ``denormals``) float32 denormals; category
    values from -3 past ``max_category``, some a hair below or above an
    integer.  ``near`` also puts about 10% of the numerical cells on a
    threshold of the forest or one float64 ulp either side of it, and
    some +-inf.  Rows with ``near=False`` route as the float64 host walk
    routes them (the hi/lo pairs are exact there)."""
    rng = np.random.default_rng(seed)
    nf = gbdt.max_feature_idx + 1
    x = rng.standard_normal((n, nf)) * 1.5
    u = rng.random((n, nf))
    x[u < 0.05] = np.nan
    x[(u >= 0.05) & (u < 0.10)] = 0.0
    x[(u >= 0.10) & (u < 0.12)] = np.round(x[(u >= 0.10) & (u < 0.12)])
    den = (u >= 0.12) & (u < 0.13)
    x[den] = rng.choice([1e-40, -1e-40, 1e-36] if denormals else [1e-36],
                        int(den.sum()))
    for f in cat_features:
        cats = rng.integers(-3, max_category + 10, n).astype(np.float64)
        v = rng.random(n)
        cats[v < 0.03] = np.nan
        hair = (v >= 0.03) & (v < 0.06)
        cats[hair] += rng.choice([-1e-12, 1e-12, -0.5, 0.5], int(hair.sum()))
        x[:, f] = cats
    if near:
        thr = [[] for _ in range(nf)]
        for tree in gbdt.models:
            for node in range(tree.num_leaves - 1):
                if not int(tree.decision_type[node]) & K_CATEGORICAL_MASK:
                    thr[tree.split_feature[node]].append(tree.threshold[node])
        for f in range(nf):
            if f in cat_features or not thr[f]:
                continue
            pick = np.nonzero(u[:, f] >= 0.90)[0]
            t = rng.choice(np.asarray(thr[f]), len(pick))
            step = rng.integers(-1, 2, len(pick))
            x[pick, f] = np.where(step < 0, np.nextafter(t, -np.inf),
                                  np.where(step > 0,
                                           np.nextafter(t, np.inf), t))
            inf = np.nonzero((u[:, f] >= 0.13) & (u[:, f] < 0.135))[0]
            x[inf, f] = rng.choice([np.inf, -np.inf], len(inf))
    return x
