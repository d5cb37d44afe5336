"""Sequence packing: the n-way passage tower at token-proportional cost
(copy of ``cldrd_tpu/data/packing.py``).

Several short passages share one ``max_passage_len`` row. Isolation comes
from segment ids (attention masked to ``seg_q == seg_k``, plus the key
mask) and from a position reset (each packed passage's position ids start
at 0), so every passage's CLS embedding equals its unpacked value.

Packing is per example: each example's ``nway`` passages pack into that
example's own ``rows`` bins, giving ``[bz, rows, L]`` arrays, so the
unpack gather stays local to the batch row. ``rows`` rounds up a small
ladder (multiples of ``row_multiple``) and only grows within a run.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

__all__ = ["PackedBatch", "pack_nway_batch", "rows_ladder"]


@dataclass
class PackedBatch:
    """Per-example packed passages (host numpy, static shapes).

    ``input_ids``/``attention_mask``/``position_ids``/``segment_ids`` are
    ``[bz, rows, L]``; ``gather_pos`` is ``[bz, nway]`` flat positions into
    each example's flattened ``rows * L`` token axis such that
    ``hidden.reshape(bz, rows*L, D)[b, gather_pos[b, i]]`` is passage
    ``(b, i)``'s CLS vector. Segment id 0 marks padding; passages are
    segments ``1..nway`` (in original n-way order).
    """

    input_ids: np.ndarray
    attention_mask: np.ndarray
    position_ids: np.ndarray
    segment_ids: np.ndarray
    gather_pos: np.ndarray

    def as_dict(self) -> Dict[str, np.ndarray]:
        return {
            "input_ids": self.input_ids,
            "attention_mask": self.attention_mask,
            "position_ids": self.position_ids,
            "segment_ids": self.segment_ids,
            "gather_pos": self.gather_pos,
        }


def rows_ladder(nway: int, row_multiple: int = 2) -> List[int]:
    """Allowed static row counts: multiples of ``row_multiple`` up to
    ``nway`` (the worst case: every passage in its own bin)."""
    ladder = list(range(row_multiple, nway, row_multiple))
    ladder.append(nway)
    return ladder


def _ffd(lengths: np.ndarray, capacity: int) -> List[List[int]]:
    """First-fit-decreasing bin packing; returns bins of item indices."""
    order = np.argsort(-lengths, kind="stable")
    bins: List[List[int]] = []
    space: List[int] = []
    for i in order:
        need = int(lengths[i])
        for b, free in enumerate(space):
            if free >= need:
                bins[b].append(int(i))
                space[b] -= need
                break
        else:
            bins.append([int(i)])
            space.append(capacity - need)
    return bins


def pack_nway_batch(
    input_ids: np.ndarray,
    attention_mask: np.ndarray,
    row_multiple: int = 2,
    min_rows: Optional[int] = None,
) -> PackedBatch:
    """Pack ``[bz, nway, L]`` n-way passages into ``[bz, rows, L]``.

    Every valid token of every passage survives; ``rows`` is the max
    per-example FFD bin count across the batch, rounded up to
    ``row_multiple`` (pass ``min_rows`` to pin a floor, e.g. to keep the
    run's row count). Passages whose mask is empty still get one slot (their
    CLS token row) — the reference tokenizer always emits [CLS]/[SEP], so
    empty masks only appear in synthetic tests.
    """
    bz, nway, L = input_ids.shape
    # valid length = 1 + last attended position (robust to interior zeros)
    positions = np.arange(L)[None, None, :]
    lengths = ((attention_mask != 0) * (positions + 1)).max(axis=2)
    lengths = np.maximum(lengths, 1)  # empty rows still occupy their CLS slot
    if lengths.max() > L:  # pragma: no cover - defensive
        raise ValueError("passage longer than row capacity")

    per_ex_bins = [_ffd(lengths[b], L) for b in range(bz)]
    rows_needed = max(len(bins) for bins in per_ex_bins)
    ladder = rows_ladder(nway, row_multiple)
    if min_rows is not None:
        rows_needed = max(rows_needed, int(min_rows))
    rows = next(r for r in ladder if r >= rows_needed)

    out_ids = np.zeros((bz, rows, L), input_ids.dtype)
    out_mask = np.zeros((bz, rows, L), attention_mask.dtype)
    out_pos = np.zeros((bz, rows, L), np.int32)
    out_seg = np.zeros((bz, rows, L), np.int32)
    gather = np.zeros((bz, nway), np.int32)
    for b in range(bz):
        for r, bin_items in enumerate(per_ex_bins[b]):
            cursor = 0
            for i in bin_items:
                n = int(lengths[b, i])
                sl = slice(cursor, cursor + n)
                out_ids[b, r, sl] = input_ids[b, i, :n]
                out_mask[b, r, sl] = attention_mask[b, i, :n]
                out_pos[b, r, sl] = np.arange(n)
                out_seg[b, r, sl] = i + 1  # 0 is the padding segment
                gather[b, i] = r * L + cursor
                cursor += n
    return PackedBatch(out_ids, out_mask, out_pos, out_seg, gather)
