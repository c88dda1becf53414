"""Plotting (counterpart of ``lightgbm_tpu/plotting.py``, after the
reference's ``python-package/lightgbm/plotting.py``): feature importance
and metric curves with matplotlib, a tree as a graphviz digraph.  Both
libraries are imported inside the functions, so the package imports
where they are missing (the card machine has neither)."""

from __future__ import annotations

import numpy as np

from .basic import Booster
from .sklearn import LGBMModel

__all__ = ["plot_importance", "plot_metric", "plot_tree",
           "create_tree_digraph"]


def _to_booster(booster):
    """The ``Booster`` of a Booster or a fitted estimator."""
    if isinstance(booster, LGBMModel):
        return booster.booster_
    if isinstance(booster, Booster):
        return booster
    raise TypeError("booster must be Booster or LGBMModel")


def plot_importance(booster, ax=None, height=0.2, xlim=None, ylim=None,
                    title="Feature importance", xlabel="Feature importance",
                    ylabel="Features", importance_type="split",
                    max_num_features=None, ignore_zero=True, figsize=None,
                    grid=True, **kwargs):
    """A horizontal bar of each feature's importance (``split`` counts or
    ``gain``), in increasing order; returns the axes."""
    import matplotlib.pyplot as plt
    bst = _to_booster(booster)
    importance = bst.feature_importance(importance_type)
    names = bst.feature_name()
    tuples = sorted(zip(names, importance), key=lambda x: x[1])
    if ignore_zero:
        tuples = [t for t in tuples if t[1] > 0]
    if max_num_features is not None and max_num_features > 0:
        tuples = tuples[-max_num_features:]
    if not tuples:
        raise ValueError("cannot plot trees with zero importance")
    labels, values = zip(*tuples)
    if ax is None:
        _, ax = plt.subplots(1, 1, figsize=figsize)
    ylocs = np.arange(len(values))
    ax.barh(ylocs, values, align="center", height=height, **kwargs)
    for x, y in zip(values, ylocs):
        ax.text(x + 1, y, str(int(x) if float(x).is_integer() else x),
                va="center")
    ax.set_yticks(ylocs)
    ax.set_yticklabels(labels)
    if xlim is not None:
        ax.set_xlim(xlim)
    if ylim is not None:
        ax.set_ylim(ylim)
    if title:
        ax.set_title(title)
    if xlabel:
        ax.set_xlabel(xlabel)
    if ylabel:
        ax.set_ylabel(ylabel)
    ax.grid(grid)
    return ax


def plot_metric(booster, metric=None, dataset_names=None, ax=None,
                xlim=None, ylim=None, title="Metric during training",
                xlabel="Iterations", ylabel="auto", figsize=None, grid=True):
    """One metric's curve over the iterations for each data set of an
    ``evals_result`` dict or a fitted estimator; returns the axes."""
    import matplotlib.pyplot as plt
    if isinstance(booster, LGBMModel):
        eval_results = booster.evals_result_
    elif isinstance(booster, dict):
        eval_results = booster
    else:
        raise TypeError("booster must be dict or LGBMModel")
    if not eval_results:
        raise ValueError("eval results cannot be empty")
    if ax is None:
        _, ax = plt.subplots(1, 1, figsize=figsize)
    names = dataset_names or list(eval_results.keys())
    for name in names:
        metrics = eval_results[name]
        m = metric or next(iter(metrics))
        results = metrics[m]
        ax.plot(range(len(results)), results, label=name)
    ax.legend(loc="best")
    if title:
        ax.set_title(title)
    ax.set_xlabel(xlabel)
    ax.set_ylabel(metric or "metric" if ylabel == "auto" else ylabel)
    ax.grid(grid)
    return ax


def create_tree_digraph(booster, tree_index=0, show_info=None, precision=3,
                        name=None, comment=None, **kwargs):
    """Tree ``tree_index`` as a ``graphviz.Digraph``: split nodes with
    their feature and threshold, leaves with their values, and the
    ``show_info`` fields (``leaf_count``, ``split_gain``,
    ``internal_count``)."""
    import graphviz
    bst = _to_booster(booster)
    bst._gbdt._flush_pending()
    if tree_index >= len(bst._gbdt.models):
        raise IndexError("tree_index is out of range")
    tree = bst._gbdt.models[tree_index]
    feature_names = bst.feature_name()
    show_info = show_info or []
    graph = graphviz.Digraph(name=name, comment=comment, **kwargs)

    def add(idx, parent=None, decision=None):
        if idx < 0:
            leaf = ~idx
            node_name = f"leaf{leaf}"
            label = f"leaf {leaf}: {tree.leaf_value[leaf]:.{precision}f}"
            if "leaf_count" in show_info:
                label += f"\ncount: {tree.leaf_count[leaf]}"
            graph.node(node_name, label=label)
        else:
            node_name = f"split{idx}"
            f = int(tree.split_feature[idx])
            fname = feature_names[f] if f < len(feature_names) else str(f)
            dt = int(tree.decision_type[idx])
            op = "==" if dt & 1 else "<="
            label = f"{fname} {op} {tree.threshold[idx]:.{precision}g}"
            if "split_gain" in show_info:
                label += f"\ngain: {tree.split_gain[idx]:.{precision}f}"
            if "internal_count" in show_info:
                label += f"\ncount: {tree.internal_count[idx]}"
            graph.node(node_name, label=label)
            add(int(tree.left_child[idx]), node_name, "yes")
            add(int(tree.right_child[idx]), node_name, "no")
        if parent is not None:
            graph.edge(parent, node_name, decision)
        return node_name

    add(0 if tree.num_leaves > 1 else -1)
    return graph


def plot_tree(booster, ax=None, tree_index=0, figsize=None, show_info=None,
              precision=3, **kwargs):
    """:func:`create_tree_digraph` rendered to PNG by graphviz and shown
    on matplotlib axes; returns the axes."""
    import matplotlib.pyplot as plt
    import matplotlib.image as mpimg
    import io
    graph = create_tree_digraph(booster, tree_index=tree_index,
                                show_info=show_info, precision=precision,
                                **kwargs)
    if ax is None:
        _, ax = plt.subplots(1, 1, figsize=figsize)
    s = io.BytesIO(graph.pipe(format="png"))
    img = mpimg.imread(s)
    ax.imshow(img)
    ax.axis("off")
    return ax
