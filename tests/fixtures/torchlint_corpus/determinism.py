"""TL131 fixture: nondeterminism taint reaching serialized bytes.

Planted: wall-clock into a checkpoint payload (directly and through a
helper's return value), an unseeded RNG draw reaching a digest, a torch
draw on the global generator reaching a digest, and a set hash-order
materialization feeding a model string sink.  Exempt
variants: seeded RNG, telemetry (not a sink), sorted() order, and a
suppressed occurrence.
"""

import time

import numpy as np
import torch


def plan_digest(plan):
    return repr(plan)


def save_pipeline_checkpoint(directory, model_str, meta):
    del directory, model_str, meta


def observe(name, value):
    del name, value


def commit_bad(directory, model_str):
    meta = {"rows": 4, "at": time.time()}
    save_pipeline_checkpoint(directory, model_str, meta)  # PLANT: TL131


def stamp():
    return time.time()


def commit_indirect_bad(directory, model_str):
    save_pipeline_checkpoint(directory, model_str,        # PLANT: TL131
                             {"at": stamp()})


def digest_bad(plan):
    jitter = np.random.uniform()
    return plan_digest([plan, jitter])                    # PLANT: TL131


def torch_draw_bad(plan):
    noise = torch.rand(4)
    return plan_digest((plan, noise))                     # PLANT: TL131


def seeded_torch_draw_is_clean(plan, seed):
    gen = torch.Generator().manual_seed(seed)
    return plan_digest((plan, torch.rand(4, generator=gen)))


def model_string_bad(features):
    order = list(set(features))  # torchlint: disable=TL005
    return save_model(order)                              # PLANT: TL131


def save_model(columns):
    return "\n".join(str(c) for c in columns)


def commit_good(directory, model_str, seed):
    rng = np.random.default_rng(seed)
    meta = {"rows": 4, "noise_seed": int(rng.integers(1 << 30))}
    save_pipeline_checkpoint(directory, model_str, meta)
    # telemetry is not a sink: wall-clock timings are fine
    observe("checkpoint_s", time.time())


def model_string_good(features):
    return save_model(sorted(set(features)))


def suppressed_variant(directory, model_str):
    meta = {"at": time.time()}
    # torchlint: disable-next=TL131
    save_pipeline_checkpoint(directory, model_str, meta)
