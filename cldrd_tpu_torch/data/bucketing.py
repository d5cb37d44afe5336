"""Length-bucketed batching (copy of ``cldrd_tpu/data/bucketing.py``):
stop paying max-length work for short rows.

Rows regroup into a small fixed ladder of bucket lengths (default
32/64/128/.../max_length) and each batch pads only to its bucket. The
per-bucket batch size scales inversely with length, so every dispatch
carries about the same number of tokens. Numerics are unchanged: padded
positions are masked out of attention (a masked key's weight is exactly
0) and touch nothing else, so in fp32 a row's CLS embedding is the same
at any padded length >= its valid length.

Row order changes (rows are grouped by length), which is immaterial for
index builds: identity travels with ``SequenceBatch.ids`` and search
returns external ids. Do NOT bucket query encoding for retrieval, where
callers zip results with the input order (queries are 30 tokens anyway).

Two strategies:

- ``bucketize(batches, specs)``: streaming/greedy; wraps any
  ``SequenceBatch`` iterator and buffers at most one batch per bucket.
  Works for raw-tokenizer datasets without knowing lengths up front.
- ``TokenCacheDataset.batches_bucketed`` (``token_cache.py``):
  sort-based; the cache knows every length, so it emits each bucket
  contiguously with at most one partial batch per bucket.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .sequence_dataset import SequenceBatch

__all__ = [
    "BucketSpec",
    "bucket_specs",
    "bucketize",
    "required_lengths",
    "max_emitted_rows",
    "default_bucket_lengths",
]


@dataclass(frozen=True)
class BucketSpec:
    """One bucket: rows needing <= ``length`` tokens, batched ``batch_size``
    at a time (tokens shape [batch_size, length])."""

    length: int
    batch_size: int


def default_bucket_lengths(max_length: int, min_bucket: int = 32) -> Tuple[int, ...]:
    """Power-of-two ladder ``min_bucket, 2*min_bucket, ..., max_length``."""
    out: List[int] = []
    b = min_bucket
    while b < max_length:
        out.append(b)
        b *= 2
    out.append(max_length)
    return tuple(out)


def bucket_specs(
    max_length: int,
    batch_size: int,
    bucket_lengths: Optional[Sequence[int]] = None,
    batch_multiple: int = 1,
) -> List[BucketSpec]:
    """Build the bucket ladder with token-balanced batch sizes.

    ``batch_size`` is the batch at ``max_length``; shorter buckets grow
    inversely (``batch_size * max_length // L``) so each dispatch carries
    ~the same token count (constant device work per step). Batch sizes are
    rounded down to ``batch_multiple`` (pass the device count so sharded
    batches stay evenly shardable).
    """
    if bucket_lengths is None:
        bucket_lengths = default_bucket_lengths(max_length)
    lengths = sorted(set(int(b) for b in bucket_lengths))
    if not lengths:
        raise ValueError("no bucket lengths")
    if lengths[-1] < max_length:
        lengths.append(max_length)
    if lengths[0] < 1:
        raise ValueError(f"bucket lengths must be >= 1: {lengths}")
    specs = []
    for L in lengths:
        bz = max(batch_size * lengths[-1] // L, batch_multiple)
        bz -= bz % batch_multiple
        specs.append(BucketSpec(length=L, batch_size=bz))
    return specs


def required_lengths(mask: np.ndarray) -> np.ndarray:
    """Per-row minimum padded length that keeps every attended position:
    1 + the last position with mask == 1 (0 for all-pad rows). Robust to
    non-contiguous masks, unlike ``mask.sum``."""
    positions = np.arange(mask.shape[1])[None, :]
    return ((mask != 0) * (positions + 1)).max(axis=1)


def max_emitted_rows(n_rows: int, specs: Sequence[BucketSpec]) -> int:
    """Upper bound on total rows emitted across all bucketed batches
    (valid rows + the pad tails of at most one partial batch per bucket).
    Used by device-resident builders to size append buffers."""
    return n_rows + sum(s.batch_size for s in specs)


def _emit(
    spec: BucketSpec,
    ids: np.ndarray,
    tokens: np.ndarray,
    mask: np.ndarray,
) -> SequenceBatch:
    n = len(ids)
    bz, L = spec.batch_size, spec.length
    out_ids = np.full((bz,), -1, np.int64)
    out_ids[:n] = ids
    out_tokens = np.zeros((bz, L), np.int32)
    out_tokens[:n] = tokens[:, :L]
    out_mask = np.zeros((bz, L), np.int32)
    out_mask[:n] = mask[:, :L]
    return SequenceBatch(
        tokens={"input_ids": out_tokens, "attention_mask": out_mask},
        ids=out_ids,
        n_valid=n,
    )


def bucketize(
    batches: Iterable[SequenceBatch],
    specs: Sequence[BucketSpec],
) -> Iterator[SequenceBatch]:
    """Regroup a ``SequenceBatch`` stream into length-homogeneous batches.

    Every *valid* row of the input appears in exactly one output batch,
    sliced to its bucket length (which loses only masked padding). Buffers
    at most ``batch_size`` rows per bucket; partial buckets flush at end of
    stream, padded with ``ids == -1`` rows like any ragged tail.
    """
    specs = sorted(specs, key=lambda s: s.length)
    cut_lengths = np.asarray([s.length for s in specs])
    pend_ids: List[List[np.ndarray]] = [[] for _ in specs]
    pend_tok: List[List[np.ndarray]] = [[] for _ in specs]
    pend_mask: List[List[np.ndarray]] = [[] for _ in specs]
    counts = [0] * len(specs)

    def drain(b: int, final: bool) -> Iterator[SequenceBatch]:
        spec = specs[b]
        while counts[b] >= spec.batch_size or (final and counts[b] > 0):
            ids = np.concatenate(pend_ids[b])
            tok = np.concatenate(pend_tok[b])
            msk = np.concatenate(pend_mask[b])
            take = min(spec.batch_size, len(ids))
            yield _emit(spec, ids[:take], tok[:take], msk[:take])
            pend_ids[b] = [ids[take:]] if take < len(ids) else []
            pend_tok[b] = [tok[take:]] if take < len(ids) else []
            pend_mask[b] = [msk[take:]] if take < len(ids) else []
            counts[b] -= take

    for batch in batches:
        nv = batch.n_valid
        if nv == 0:
            continue
        tok = np.asarray(batch.tokens["input_ids"][:nv])
        msk = np.asarray(batch.tokens["attention_mask"][:nv])
        ids = np.asarray(batch.ids[:nv])
        lens = required_lengths(msk)
        if lens.max(initial=0) > cut_lengths[-1]:
            raise ValueError(
                f"row length {lens.max()} exceeds largest bucket "
                f"{cut_lengths[-1]}"
            )
        bidx = np.searchsorted(cut_lengths, lens)
        for b in range(len(specs)):
            rows = np.nonzero(bidx == b)[0]
            if rows.size == 0:
                continue
            pend_ids[b].append(ids[rows])
            pend_tok[b].append(tok[rows])
            pend_mask[b].append(msk[rows])
            counts[b] += rows.size
            yield from drain(b, final=False)
    for b in range(len(specs)):
        yield from drain(b, final=True)
