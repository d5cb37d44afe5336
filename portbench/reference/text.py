"""Tokens and batches, worked out again from the benchmark's texts.

``hash_tokenize`` is the hermetic hash tokenizer's contract: ids 0 = PAD,
1 = CLS, 2 = SEP, 3.. = the first four bytes of a lower-cased word's MD5
(little endian) modulo ``vocab - 3``, plus 3; ``[CLS] a [SEP] (b [SEP])``,
cut to ``max_length - 1`` tokens and closed with ``[SEP]`` when longer;
token types 1 from the second segment on. ``nway_labels`` is the
curriculum's label mode 8 (5 teacher positives graded 1/rank, then 12
negatives at -0.25 and 13 at -0.5). ``batch_order`` is the training
order: one permutation of the examples per epoch from
``numpy.random.default_rng(seed + epoch)``, cut into full batches.
"""
from __future__ import annotations

import hashlib
from typing import Dict, List, Optional, Sequence

import numpy as np

PAD, CLS, SEP = 0, 1, 2


def _token_id(word: str, vocab: int) -> int:
    h = int.from_bytes(hashlib.md5(word.encode()).digest()[:4], "little")
    return 3 + h % (vocab - 3)


def hash_tokenize(texts: Sequence[str], max_length: int, vocab: int,
                  pairs: Optional[Sequence[str]] = None
                  ) -> Dict[str, np.ndarray]:
    n = len(texts)
    ids = np.zeros((n, max_length), np.int64)
    mask = np.zeros((n, max_length), np.int64)
    types = np.zeros((n, max_length), np.int64)
    for row, text in enumerate(texts):
        toks = [CLS] + [_token_id(w, vocab) for w in text.lower().split()]
        toks.append(SEP)
        first = len(toks)
        if pairs is not None:
            toks += [_token_id(w, vocab) for w in pairs[row].lower().split()]
            toks.append(SEP)
        if len(toks) > max_length:
            toks = toks[:max_length - 1] + [SEP]
        ids[row, :len(toks)] = toks
        mask[row, :len(toks)] = 1
        types[row, min(first, len(toks)):len(toks)] = 1
    return {"input_ids": ids, "attention_mask": mask,
            "token_type_ids": types}


def nway_labels(n_rel: int = 5, n_most: int = 12, n_semi: int = 13
                ) -> np.ndarray:
    """Label mode 8 over ``relT + most_hard + semi_hard``."""
    rel = list(1.0 / np.arange(1, n_rel + 1))
    return np.asarray(rel + [-0.25] * n_most + [-0.5] * n_semi, np.float32)


def batch_order(n_examples: int, batch_size: int, seed: int,
                epoch: int = 0) -> List[np.ndarray]:
    order = np.arange(n_examples)
    np.random.default_rng(seed + epoch).shuffle(order)
    end = n_examples - n_examples % batch_size
    return [order[s:s + batch_size] for s in range(0, end, batch_size)]
