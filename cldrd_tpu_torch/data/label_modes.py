"""Curriculum label modes: graded relevance targets per (relT, neg) layout.

Copy of ``cldrd_tpu/data/label_modes.py``: the reference's 10 label
modes (``dataset/nway_dataset.py:41-72``) as a table. Each mode fixes
the expected number of teacher-relevant passages (``relT``) and
negatives (``neg``) and assigns a graded label vector of length
``relT + neg``:

  mode  relT  neg   labels
  1     1     5     [1] + [0]*5
  2     10    20    [1]*10 + [1/2]*10 + [0]*10
  3     10    20    1/rank over relT + [0]*20
  4     10    20    [1] + [0.9]*9 + [1/2]*10 + [0]*10
  5     20    10    1/rank + [0]*10
  6     30    0     1/rank
  7     5     25    1/rank + [0]*25
  8     5     25    1/rank + [-0.25]*12 + [-0.5]*13     (curriculum iter 1)
  9     10    20    1/rank + [-0.25]*10 + [-0.5]*10     (curriculum iter 2)
  10    20    10    1/rank + [-0.25]*5  + [-0.5]*5      (curriculum iter 3)
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


def _inv_rank(n: int) -> List[float]:
    return list(1.0 / np.arange(1, n + 1))


def _make_labels(mode: str, n_relT: int, n_neg: int) -> List[float]:
    if mode == "1":
        return [1.0] + [0.0] * n_neg
    if mode == "2":
        return [1.0] * n_relT + [0.5] * 10 + [0.0] * 10
    if mode in ("3", "5", "6", "7"):
        return _inv_rank(n_relT) + [0.0] * n_neg
    if mode == "4":
        return [1.0] + [0.9] * 9 + [0.5] * 10 + [0.0] * 10
    if mode == "8":
        return _inv_rank(n_relT) + [-0.25] * 12 + [-0.5] * 13
    if mode == "9":
        return _inv_rank(n_relT) + [-0.25] * 10 + [-0.5] * 10
    if mode == "10":
        return _inv_rank(n_relT) + [-0.25] * 5 + [-0.5] * 5
    raise ValueError(f"label mode {mode!r} not defined")


# mode -> (expected n_relT, expected n_neg); None = any count accepted
EXPECTED_COUNTS: Dict[str, Tuple[int, int]] = {
    "1": (1, 5),
    "2": (10, 20),
    "3": (10, 20),
    "4": (10, 20),
    "5": (20, 10),
    "6": (30, 0),
    "7": (5, 25),
    "8": (5, 25),
    "9": (10, 20),
    "10": (20, 10),
}

LABEL_MODES = tuple(EXPECTED_COUNTS)

# which curriculum iteration uses which mode (reference trainer defaults:
# nway_listwise_{1,2,3}.py -> label_mode 8, 9, 10)
CURRICULUM_MODES = ("8", "9", "10")


def labels_for(mode: str, n_relT: int, n_neg: int) -> np.ndarray:
    """Graded label vector for one example; validates the (relT, neg) layout
    exactly like the reference's per-mode asserts."""
    if mode not in EXPECTED_COUNTS:
        raise ValueError(f"label mode {mode!r} not defined")
    exp_rel, exp_neg = EXPECTED_COUNTS[mode]
    if (n_relT, n_neg) != (exp_rel, exp_neg):
        raise ValueError(
            f"label mode {mode}: expected {exp_rel} relT + {exp_neg} neg, "
            f"got {n_relT} + {n_neg}"
        )
    return np.asarray(_make_labels(mode, n_relT, n_neg), dtype=np.float32)


def nway_for(mode: str) -> int:
    """Total list length (relT + neg) for a mode — the static nway axis."""
    r, n = EXPECTED_COUNTS[mode]
    return r + n
