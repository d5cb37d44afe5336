"""Corpus / query sequence dataset for encoding (copy of
``cldrd_tpu/data/sequence_dataset.py``).

Batches are padded to the full batch size with a validity count, so every
encode call sees one shape; layout ``{"input_ids", "attention_mask"}
[bz, L] + ids [bz] + n_valid``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, List, Tuple

import numpy as np

from .loaders import load_passages, load_queries, passage_text


@dataclass
class SequenceBatch:
    tokens: Dict[str, np.ndarray]  # [bz, L] int32, padded rows after n_valid
    ids: np.ndarray                # [bz] int64, padded entries are -1
    n_valid: int


class SequenceDataset:
    """(id, text) pairs from a TSV, tokenized to fixed shapes."""

    def __init__(self, id_to_seq: Dict[int, object], tokenizer, max_length: int, is_query: bool):
        sep = getattr(tokenizer, "sep_token", "[SEP]")
        self.pairs: List[Tuple[int, str]] = [
            (sid, passage_text(seq, sep)) for sid, seq in id_to_seq.items()
        ]
        self.tokenizer = tokenizer
        self.max_length = max_length
        self.is_query = is_query

    def __len__(self) -> int:
        return len(self.pairs)

    @classmethod
    def create_from_seqs_file(cls, seqs_file: str, tokenizer, max_length: int, is_query: bool):
        load = load_queries if is_query else load_passages
        return cls(load(seqs_file), tokenizer, max_length, is_query)

    def collate(self, items: List[Tuple[int, str]], pad_to: int) -> SequenceBatch:
        n = len(items)
        texts = [t for _, t in items]
        tokens = self.tokenizer(texts, self.max_length)
        if n < pad_to:
            pad = pad_to - n
            tokens = {
                k: np.concatenate([v, np.zeros((pad, v.shape[1]), v.dtype)])
                for k, v in tokens.items()
            }
        ids = np.full((pad_to,), -1, np.int64)
        ids[:n] = [i for i, _ in items]
        return SequenceBatch(tokens=tokens, ids=ids, n_valid=n)

    def batches(self, batch_size: int) -> Iterator[SequenceBatch]:
        for start in range(0, len(self.pairs), batch_size):
            chunk = self.pairs[start : start + batch_size]
            yield self.collate(chunk, batch_size)
