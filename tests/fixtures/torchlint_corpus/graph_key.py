"""TL101 fixture: graph-key completeness around ``plan_signature`` /
``grower_key``.

Planted: a capture-shaping constant missing from the key, a config
attribute excluded from the key but read inside a captured piece, and a
launch-time attribute (written into a buffer before each launch) hashed
into the key.  Exempt variants: a constant that IS in the key, a
refusal bound, a host bookkeeping bound, a value baked into a captured
piece (keyed), an ``int(...)`` structural config read, and a suppressed
occurrence.
"""

import hashlib

import torch

from lightgbm_tpu_torch.obs import capture_track

COUNT_SPLIT_ROWS = 1 << 24
STRIPE_ROWS = 1 << 20
MAX_ROWS = 1 << 31
GROWER_CACHE_MAX = 8
_GROWER_CACHE = {}

SEED_PARAMS = frozenset({"seed", "bagging_seed"})
_NON_CAPTURE_PARAMS = SEED_PARAMS | {"learning_rate", "verbosity"}


def _config_digest(config, exclude=_NON_CAPTURE_PARAMS):
    items = sorted((k, repr(v)) for k, v in config.to_dict().items()
                   if k not in exclude)
    return hashlib.sha1(repr(items).encode()).hexdigest()


def plan_signature(num_data, config):
    # COUNT_SPLIT_ROWS is keyed; STRIPE_ROWS (below) is not
    return (num_data, COUNT_SPLIT_ROWS, _config_digest(config))


def grower_key(num_data, config, device):
    return (str(device),) + plan_signature(num_data, config)


def check_rows(num_data):
    if num_data >= MAX_ROWS:            # a refusal: selects no layout
        raise ValueError("too many rows")


class Grower:
    def __init__(self, num_data, config, graphs):
        self.config = config
        self.num_data = num_data
        self.striped = num_data >= STRIPE_ROWS   # PLANT: TL101
        self.counted = num_data >= COUNT_SPLIT_ROWS
        self.num_leaves = int(config.num_leaves)
        self.frac = float(config.bagging_fraction)
        self.shrink = float(config.min_gain_to_split)  # PLANT: TL101
        self.lr = float(config.learning_rate)
        self.st = torch.zeros(4)
        self.graph = graphs.capture(self._piece_finish)
        capture_track.record("grow.tree", capture_track.signature_of(
            (num_data, self.num_leaves)), 0.0, 0.0)

    def launch(self):
        self.st[0:1].fill_(self.lr)          # excluded: fine
        self.st[1:2].fill_(self.shrink)      # keyed but written per launch
        self.graph.replay()

    def _piece_finish(self):
        self.st.mul_(self.frac)              # baked in: keyed, fine
        self.st.add_(self.config.verbosity)  # PLANT: TL101

    def evict_needed(self):
        # host bookkeeping bound: the compare never meets a shape
        return len(_GROWER_CACHE) > GROWER_CACHE_MAX


def suppressed_variant(num_data):
    # torchlint: disable-next=TL101 -- probe-only layout, never cached
    return num_data >= STRIPE_ROWS
