"""The yardstick's counts: the operations and bytes a phase needs, and
the card's published peaks, frozen here so that a change to the program
cannot move them.

The per-launch formulas are those of the program's ``obs/profile.py::
cost_of`` (each input byte read once, each output byte written once),
with one correction for kernel 1: a wave reads the leaf id of every row
but the codes and stats only of the rows in its leaves (the list kernel
reads the counting sort's list; only a one-leaf wave lists every row),
and writes one histogram a leaf it builds.

Peaks: one NVIDIA H100 SXM (NVIDIA's data sheet, dense): 3.35 TB/s of
HBM3, 67 TFLOP/s float32 outside the tensor cores, 989 TFLOP/s bf16 on
them, at the full 700 W power limit.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BF16_TC_FLOPS = 989e12
NUM_BINS = 256
#: the split scan's float32 operations per (leaf, slot): both scan
#: directions, each 3 running sums, the two children's gains (3
#: operations each) and one compare
FIND_OPS_PER_SLOT = 2 * (3 + 2 * 3 + 1)
#: the split scan's float32 record of a leaf
RECORD_WORDS = 13


def least_seconds(nbytes: float, flops: float) -> float:
    """The least time the card needs: the larger of the bytes at HBM
    bandwidth and the operations at the float32 peak."""
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS)


def wave_hist(rows: int, rows_in_waves: int, leaves_built: int, waves: int,
              groups: int, k: int, stat_bytes: int = 2) -> Tuple[float, float]:
    """(bytes, flops) of kernel 1 over ``waves`` launches that together
    list ``rows_in_waves`` rows and build ``leaves_built`` histograms of
    ``groups`` groups, ``k`` stat columns (``stat_bytes`` each)."""
    nbytes = (waves * rows * 4 + rows_in_waves * (groups + stat_bytes * k)
              + leaves_built * groups * NUM_BINS * k * 4)
    return float(nbytes), float(rows_in_waves * groups * k)


def find_best(leaves_scanned: int, features: int) -> Tuple[float, float]:
    slots = features * NUM_BINS
    return (float(leaves_scanned * (slots * 3 * 4 + 3 * 4 + RECORD_WORDS * 4)),
            float(leaves_scanned * slots * FIND_OPS_PER_SLOT))


def split_apply(rows: int, waves: int, splits: int) -> Tuple[float, float]:
    # each row a wave: one code, its leaf id read and written; each split
    # its (feature, threshold, child) words
    return float(waves * rows * (1 + 4 + 4) + splits * 3 * 4), \
        float(waves * rows * 4)


def score_update(rows: int, leaves: int) -> Tuple[float, float]:
    return float(rows * (4 + 4 + 4) + leaves * 4), float(rows * 2)


def gradients(rows: int) -> Tuple[float, float]:
    # score and label read, gradient and hessian written (f32); a
    # sigmoid and four operations a row
    return float(rows * 16), float(rows * 5)


def binning(rows: int, columns: int, used: int) -> Tuple[float, float]:
    # the float32 rows read, one code a used column written; a search of
    # 8 compares a value
    return float(rows * columns * 4 + rows * used), float(rows * used * 8)


def tree_work(rows: int, bag_rows: int, groups: int, features: int,
              k: int, waves: int, leaf_counts: Iterable[int],
              smaller_counts: Iterable[int]) -> Dict[str, Tuple[float, float]]:
    """Counted work of one tree by phase: ``smaller_counts`` are the
    bagged rows of the smaller child of each split, ``leaf_counts`` those
    of each leaf."""
    smaller = list(smaller_counts)
    splits = len(smaller)
    leaves = len(list(leaf_counts))
    built = 1 + splits
    return {
        "gradients": gradients(rows),
        "wave_hist": wave_hist(rows, bag_rows + sum(smaller), built, waves,
                               groups, k),
        "find_best": find_best(1 + 2 * splits, features),
        "split_apply": split_apply(rows, waves, splits),
        "score_update": score_update(rows, leaves),
    }
