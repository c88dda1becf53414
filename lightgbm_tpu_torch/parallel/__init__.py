"""The tree-learner factory (counterpart of
``lightgbm_tpu/parallel/__init__.py::create_tree_learner``, reference
``TreeLearner::CreateTreeLearner``, ``src/treelearner/tree_learner.cpp:
9-33``).

``tree_learner`` picks the learner.  ``num_machines`` workers over the
process's cards, or an explicit ``mesh`` (a list of devices; several may
name one card), make the network of the data-, feature- and
voting-parallel learners (``parallel/network.py``).  With one machine and
no mesh every mode runs the serial learner, with a warning, as the
reference does.  These learners run in one process; with
``data_sharding=multi_controller`` (one process a host) they are refused
with the JAX package's error: the pod is the data-parallel plane.
"""

from ..tree.learner import SerialTreeLearner
from ..utils.log import LightGBMError, log_warning


def create_tree_learner(config, dataset, device, mesh=None,
                        binned_t=None) -> SerialTreeLearner:
    """The learner ``config.tree_learner`` names over ``dataset`` on
    ``device``; ``binned_t`` is the ``(G, N)`` codes on ``device`` when a
    device grower already holds them."""
    kind = config.tree_learner
    if kind not in ("serial", "feature", "data", "voting"):
        raise LightGBMError(f"unknown tree_learner: {kind}")
    from ..ops.shard import sharding_mode
    if (kind != "serial" and int(config.num_machines) > 1
            and sharding_mode(config) == "multi_controller"):
        raise LightGBMError(
            f"tree_learner={kind} cannot be combined with "
            f"data_sharding=multi_controller (the pod slice IS the "
            f"data-parallel plane); use tree_learner=serial")
    if int(config.num_machines) <= 1 and mesh is None:
        if kind != "serial":
            log_warning(
                f"tree_learner={kind} with num_machines=1: running the "
                f"serial learner (set num_machines>1 or pass a mesh to "
                f"enable the parallel learners)")
        return SerialTreeLearner(config, dataset, device, binned_t)
    from .network import create_network
    net = create_network(config, mesh)
    if kind == "serial":
        log_warning("num_machines>1 with tree_learner=serial: running "
                    "single-device serial training")
        return SerialTreeLearner(config, dataset, device, binned_t)
    if kind == "feature":
        from .feature_parallel import FeatureParallelTreeLearner
        return FeatureParallelTreeLearner(config, dataset, device, net,
                                          binned_t)
    if kind == "data":
        from .data_parallel import DataParallelTreeLearner
        return DataParallelTreeLearner(config, dataset, device, net,
                                       binned_t)
    from .voting_parallel import VotingParallelTreeLearner
    return VotingParallelTreeLearner(config, dataset, device, net, binned_t)
