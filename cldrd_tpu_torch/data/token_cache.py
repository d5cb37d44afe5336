"""Pre-tokenized corpus cache: tokenize once, stream forever (copy of
``cldrd_tpu/data/token_cache.py``, same on-disk format, so either package
reads a cache the other wrote).

The CL-DRD curriculum re-encodes the SAME collection after every
iteration, and host tokenization sets the encode rate. This module pays
the host work once:

- ``write_token_cache`` tokenizes the corpus once (prefetch-overlapped)
  and stores fixed-shape ``input_ids`` as uint16 (WordPiece vocab 30522 <
  2^16) plus per-row valid lengths and external ids.
- ``TokenCacheDataset`` streams ``SequenceBatch``es straight from the
  memmap (no tokenizer on the hot path; each batch reads only its own
  rows) and is a drop-in for ``SequenceDataset`` in ``encode_dataset`` /
  ``build_index_on_device``.

Attention masks are rebuilt from the stored lengths (WordPiece emits
contiguous masks: CLS + pieces + SEP, then padding).
"""
from __future__ import annotations

import json
import os
from typing import Iterator

import numpy as np

from .sequence_dataset import SequenceBatch, SequenceDataset

META_NAME = "token_cache_meta.json"
IDS_NAME = "cache_ids.npy"
TOKENS_NAME = "cache_tokens.npy"
LENGTHS_NAME = "cache_lengths.npy"


def write_token_cache(
    dataset: SequenceDataset,
    out_dir: str,
    batch_size: int = 2048,
) -> None:
    """Tokenize every sequence in ``dataset`` once and persist the cache."""
    from .prefetch import prefetch

    os.makedirs(out_dir, exist_ok=True)
    n = len(dataset)
    max_len = dataset.max_length
    tokens = np.lib.format.open_memmap(
        os.path.join(out_dir, TOKENS_NAME),
        mode="w+", dtype=np.uint16, shape=(n, max_len),
    )
    lengths = np.empty((n,), np.int32)
    ids = np.empty((n,), np.int64)

    row = 0
    for batch in prefetch(dataset.batches(batch_size), depth=4):
        nv = batch.n_valid
        batch_ids = batch.tokens["input_ids"][:nv]
        if batch_ids.max(initial=0) >= np.iinfo(np.uint16).max:
            raise ValueError("token id exceeds uint16 cache range")
        tokens[row : row + nv] = batch_ids.astype(np.uint16)
        mask = batch.tokens["attention_mask"][:nv]
        # contiguity invariant: mask must be 1...10...0 per row
        lens = mask.sum(axis=1)
        nonzero = lens > 0
        probe = mask.cumsum(axis=1)[np.arange(nv), np.maximum(lens - 1, 0)]
        if not (probe[nonzero] == lens[nonzero]).all():
            raise ValueError("non-contiguous attention mask; cache unsupported")
        lengths[row : row + nv] = lens
        ids[row : row + nv] = batch.ids[:nv]
        row += nv
    assert row == n, (row, n)
    tokens.flush()
    np.save(os.path.join(out_dir, LENGTHS_NAME), lengths)
    np.save(os.path.join(out_dir, IDS_NAME), ids)
    with open(os.path.join(out_dir, META_NAME), "w") as f:
        json.dump(
            {"n": int(n), "max_length": int(max_len), "format_version": 1}, f
        )


def token_cache_exists(out_dir: str) -> bool:
    return os.path.isfile(os.path.join(out_dir, META_NAME))


class TokenCacheDataset:
    """Drop-in for ``SequenceDataset`` streaming from a token cache."""

    def __init__(self, cache_dir: str):
        with open(os.path.join(cache_dir, META_NAME)) as f:
            meta = json.load(f)
        self.n = meta["n"]
        self.max_length = meta["max_length"]
        self.tokens = np.load(
            os.path.join(cache_dir, TOKENS_NAME), mmap_mode="r"
        )
        self.lengths = np.load(os.path.join(cache_dir, LENGTHS_NAME))
        self.ids = np.load(os.path.join(cache_dir, IDS_NAME))
        assert self.tokens.shape == (self.n, self.max_length)

    def __len__(self) -> int:
        return self.n

    def batches(self, batch_size: int) -> Iterator[SequenceBatch]:
        arange = np.arange(self.max_length)[None, :]
        for start in range(0, self.n, batch_size):
            end = min(start + batch_size, self.n)
            nv = end - start
            ids_out = np.full((batch_size,), -1, np.int64)
            ids_out[:nv] = self.ids[start:end]
            input_ids = np.zeros((batch_size, self.max_length), np.int32)
            input_ids[:nv] = self.tokens[start:end]
            mask = np.zeros((batch_size, self.max_length), np.int32)
            mask[:nv] = arange < self.lengths[start:end, None]
            yield SequenceBatch(
                tokens={"input_ids": input_ids, "attention_mask": mask},
                ids=ids_out,
                n_valid=nv,
            )

    def batches_bucketed(self, specs) -> Iterator[SequenceBatch]:
        """Length-bucketed batches (see ``data/bucketing.py``): the cache
        knows every row's length up front, so each bucket's rows stream
        contiguously with at most ONE partial batch per bucket — the
        minimum possible padding for the ladder. Row order changes
        (grouped by bucket); identity rides on ``ids`` as always."""
        specs = sorted(specs, key=lambda s: s.length)
        cut = np.asarray([s.length for s in specs])
        if self.n and int(self.lengths.max()) > cut[-1]:
            raise ValueError(
                f"row length {int(self.lengths.max())} exceeds largest "
                f"bucket {cut[-1]}"
            )
        bidx = np.searchsorted(cut, self.lengths)
        for b, spec in enumerate(specs):
            rows = np.nonzero(bidx == b)[0]
            L, bz = spec.length, spec.batch_size
            arange = np.arange(L)[None, :]
            for start in range(0, len(rows), bz):
                sel = rows[start : start + bz]
                nv = len(sel)
                ids_out = np.full((bz,), -1, np.int64)
                ids_out[:nv] = self.ids[sel]
                input_ids = np.zeros((bz, L), np.int32)
                input_ids[:nv] = self.tokens[sel, :L]
                mask = np.zeros((bz, L), np.int32)
                mask[:nv] = arange < self.lengths[sel, None]
                yield SequenceBatch(
                    tokens={"input_ids": input_ids, "attention_mask": mask},
                    ids=ids_out,
                    n_valid=nv,
                )
