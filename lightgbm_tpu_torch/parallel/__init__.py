"""The tree-learner factory (counterpart of
``lightgbm_tpu/parallel/__init__.py::create_tree_learner``, reference
``TreeLearner::CreateTreeLearner``).

The port has the serial learner only: a parallel ``tree_learner`` with
more than one machine is refused by name before training starts
(``ops/grow.py::unported_options``, ROADMAP item 7), and with one machine
every mode runs the serial learner, as the reference does.
"""

from ..tree.learner import SerialTreeLearner
from ..utils.log import LightGBMError, log_warning


def create_tree_learner(config, dataset, device,
                        binned_t=None) -> SerialTreeLearner:
    """The serial learner over ``dataset``; ``binned_t`` is the ``(G, N)``
    codes on ``device`` when a device grower already holds them."""
    kind = config.tree_learner
    if kind not in ("serial", "feature", "data", "voting"):
        raise LightGBMError(f"unknown tree_learner: {kind}")
    if kind != "serial" and int(config.num_machines) > 1:
        raise LightGBMError(f"not ported to lightgbm_tpu_torch yet: "
                            f"tree_learner={kind} with num_machines="
                            f"{int(config.num_machines)} (distributed "
                            f"learners)")
    if kind != "serial":
        log_warning(f"tree_learner={kind} with num_machines=1: running the "
                    f"serial learner")
    return SerialTreeLearner(config, dataset, device, binned_t)
