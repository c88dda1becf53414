"""Text data parsers: CSV / TSV / LibSVM with format auto-detection.

Counterpart of ``lightgbm_tpu/data/parser.py`` (the reference parser,
``src/io/parser.cpp:1-169``): sniff the delimiter and format from sample
lines, then parse the label and feature columns into a float64 matrix; the
side files ``<data>.weight``, ``.query`` and ``.init`` load beside it.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..utils.file_io import exists, open_text
from ..utils.log import log_info


def _sniff(lines: List[str]) -> str:
    """'libsvm', 'tsv' or 'csv' by a vote of the sample lines (reference
    ``Parser::CreateParser``)."""
    def is_libsvm(line):
        toks = line.split()
        if not toks:
            return False
        colon = sum(1 for t in toks[1:] if ":" in t)
        return colon > 0 and colon == len(toks) - 1
    votes = {"libsvm": 0, "tsv": 0, "csv": 0}
    for line in lines:
        if is_libsvm(line):
            votes["libsvm"] += 1
        elif "\t" in line:
            votes["tsv"] += 1
        elif "," in line:
            votes["csv"] += 1
        elif len(line.split()) > 1:
            votes["tsv"] += 1      # space-separated parses like tsv
    return max(votes, key=votes.get)


def parse_libsvm(lines, num_features: Optional[int] = None):
    labels, rows, cols, vals = [], [], [], []
    for line in lines:
        toks = line.split()
        if not toks:
            continue
        labels.append(float(toks[0]))
        for t in toks[1:]:
            c, v = t.split(":", 1)
            rows.append(len(labels) - 1)
            cols.append(int(c))
            vals.append(float(v))
    nf = (max(cols) + 1 if cols else 0) if num_features is None \
        else num_features
    x = np.zeros((len(labels), nf), np.float64)
    if cols:
        x[rows, cols] = vals
    return x, np.asarray(labels, np.float64)


def parse_delimited(lines, delim, label_column=0, header=False,
                    ignore_columns=()):
    names = None
    if header and lines:
        names = [c.strip() for c in lines[0].split(delim)]
        lines = lines[1:]
    rows = [[_atof(t) for t in line.rstrip("\n").split(delim)]
            for line in lines if line.strip()]
    mat = np.asarray(rows, np.float64)
    if mat.size == 0:
        return np.zeros((0, 0)), np.zeros(0), names
    label = None
    keep = [c for c in range(mat.shape[1]) if c not in set(ignore_columns)]
    if label_column is not None and 0 <= label_column < mat.shape[1]:
        label = mat[:, label_column]
        keep = [c for c in keep if c != label_column]
    x = mat[:, keep]
    if names:
        names = [names[c] for c in keep]
    return x, label, names


def _atof(tok: str) -> float:
    tok = tok.strip()
    if not tok or tok.lower() in ("na", "nan", "null", "none", "?"):
        return np.nan
    try:
        return float(tok)
    except ValueError:
        return np.nan


def load_text_file(path: str, config) -> Tuple[np.ndarray,
                                               Optional[np.ndarray],
                                               Optional[List[str]]]:
    """A text data file -> (features, label, feature names)."""
    with open_text(path) as fh:
        lines = [line for line in fh.readlines() if line.strip()]
    header = bool(getattr(config, "header", False))
    fmt = _sniff(lines[1 if header else 0:50])
    label_col = 0
    lc = str(getattr(config, "label_column", "") or "0")
    if lc.startswith("name:"):
        label_col = None
    elif lc != "":
        label_col = int(lc)
    if fmt == "libsvm":
        x, y = parse_libsvm(lines)
        log_info(f"Loaded {x.shape[0]} rows x {x.shape[1]} features "
                 f"(libsvm) from {path}")
        return x, y, None
    delim = "\t" if fmt == "tsv" else ","
    x, y, names = parse_delimited(lines, delim, label_col, header)
    log_info(f"Loaded {x.shape[0]} rows x {x.shape[1]} features "
             f"({fmt}) from {path}")
    return x, y, names


def _load_side(path: str, dtype) -> Optional[np.ndarray]:
    if not exists(path):
        return None
    with open_text(path) as fh:
        return np.loadtxt(fh).astype(dtype)


def load_query_file(path: str) -> Optional[np.ndarray]:
    """``<data>.query``: per-query row counts (reference Metadata)."""
    q = _load_side(path, np.int64)
    return None if q is None else q.reshape(-1)


def load_weight_file(path: str) -> Optional[np.ndarray]:
    w = _load_side(path, np.float32)
    return None if w is None else w.reshape(-1)


def load_init_score_file(path: str) -> Optional[np.ndarray]:
    return _load_side(path, np.float64)
