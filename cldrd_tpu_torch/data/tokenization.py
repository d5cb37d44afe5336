"""Fixed-shape tokenization (copy of ``cldrd_tpu/data/tokenization.py``).

Every batch is padded to the static ``max_length``; the attention mask
keeps padded positions out of every CLS embedding. ``HashTokenizer`` is
the dependency-free deterministic tokenizer used by tests and benches
(hash-bucket whitespace tokens with CLS/SEP/PAD), id for id the same as
the reference's. ``HFTokenizerAdapter`` wraps an HF (fast) tokenizer;
``tokenizers``/``transformers`` are only imported when one is used.
"""
from __future__ import annotations

import hashlib
from typing import Dict, Optional, Sequence

import numpy as np

TokenBatch = Dict[str, np.ndarray]  # {"input_ids", "attention_mask"} [B, L] int32


class HFTokenizerAdapter:
    """Wrap an HF (fast) tokenizer into the fixed-shape numpy contract.

    Fast path: when the tokenizer exposes a Rust ``backend_tokenizer``, we
    call ``encode_batch`` on it directly (padding/truncation configured
    in-Rust per ``max_length``) — ~25% faster per core than going through
    ``PreTrainedTokenizerFast.__call__``'s Python plumbing, and the batch
    parallelizes across host cores inside Rust."""

    def __init__(self, tokenizer):
        self.tokenizer = tokenizer
        self.sep_token = tokenizer.sep_token or "[SEP]"
        # Work on a CLONE of the Rust backend: enable_padding/enable_truncation
        # persist on the tokenizer object, and mutating the shared instance
        # would silently change behavior for every other user of it.
        shared = getattr(tokenizer, "backend_tokenizer", None)
        self._backend = None
        if shared is not None:
            try:
                import tokenizers as _tk
                self._backend = _tk.Tokenizer.from_str(shared.to_str())
            except Exception:  # clone unavailable: fall back to slow path
                self._backend = None
        self._backend_len = None

    def _encode_backend(
        self, texts, max_length: int, pairs=None,
        return_token_type_ids: bool = False,
    ) -> TokenBatch:
        if self._backend_len != max_length:
            pad_id = self.tokenizer.pad_token_id
            if pad_id is None:
                raise ValueError(
                    "tokenizer has no pad_token_id; set one before using "
                    "the fixed-shape fast path"
                )
            self._backend.enable_padding(
                length=max_length, pad_id=pad_id,
                pad_token=self.tokenizer.pad_token or "[PAD]",
            )
            self._backend.enable_truncation(max_length)
            self._backend_len = max_length
        if pairs is not None:
            encs = self._backend.encode_batch(list(zip(texts, pairs)))
        else:
            encs = self._backend.encode_batch(list(texts))
        bz = len(encs)
        ids = np.empty((bz, max_length), np.int32)
        mask = np.empty((bz, max_length), np.int32)
        types = np.empty((bz, max_length), np.int32) if return_token_type_ids else None
        for row, e in enumerate(encs):
            ids[row] = e.ids
            mask[row] = e.attention_mask
            if types is not None:
                types[row] = e.type_ids
        out = {"input_ids": ids, "attention_mask": mask}
        if types is not None:
            out["token_type_ids"] = types
        return out

    def __call__(
        self,
        texts: Sequence[str],
        max_length: int,
        pairs: Optional[Sequence[str]] = None,
        return_token_type_ids: bool = False,
    ) -> TokenBatch:
        """``return_token_type_ids``: additionally emit HF segment ids
        (0 = first sequence incl. its [SEP], 1 = pair segment) — needed by
        BERT-family models (the MiniLM teacher); DistilBERT ignores them."""
        if self._backend is not None:
            return self._encode_backend(
                texts, max_length, pairs,
                return_token_type_ids=return_token_type_ids,
            )
        enc = self.tokenizer(
            list(texts),
            list(pairs) if pairs is not None else None,
            padding="max_length",
            truncation="longest_first",
            max_length=max_length,
            return_tensors="np",
            return_token_type_ids=return_token_type_ids,
        )
        out = {
            "input_ids": enc["input_ids"].astype(np.int32),
            "attention_mask": enc["attention_mask"].astype(np.int32),
        }
        if return_token_type_ids:
            out["token_type_ids"] = enc["token_type_ids"].astype(np.int32)
        return out


class HashTokenizer:
    """Deterministic hash-bucket tokenizer (no vocab files, no deps).

    ids: 0=PAD, 1=CLS, 2=SEP, 3..vocab-1 = hash buckets. Produces the same
    fixed-shape contract as the HF adapter, so the full pipeline (collators,
    encoder, index, search) can be exercised hermetically in tests/benches.
    """

    def __init__(self, vocab_size: int = 30522):
        assert vocab_size > 8
        self.vocab_size = vocab_size
        self.sep_token = "[SEP]"
        self.pad_id, self.cls_id, self.sep_id = 0, 1, 2

    def _token_id(self, token: str) -> int:
        h = int.from_bytes(hashlib.md5(token.encode()).digest()[:4], "little")
        return 3 + h % (self.vocab_size - 3)

    def __call__(
        self,
        texts: Sequence[str],
        max_length: int,
        pairs: Optional[Sequence[str]] = None,
        return_token_type_ids: bool = False,
    ) -> TokenBatch:
        bz = len(texts)
        ids = np.zeros((bz, max_length), np.int32)
        mask = np.zeros((bz, max_length), np.int32)
        types = np.zeros((bz, max_length), np.int32)
        for row, text in enumerate(texts):
            toks = [self.cls_id]
            toks += [self._token_id(t) for t in text.lower().split()]
            toks.append(self.sep_id)
            seg0 = len(toks)  # first segment incl. its [SEP] -> type 0
            if pairs is not None:
                toks += [self._token_id(t) for t in pairs[row].lower().split()]
                toks.append(self.sep_id)
            toks = toks[: max_length - 1] + [self.sep_id] if len(toks) > max_length else toks
            n = len(toks)
            ids[row, :n] = toks
            mask[row, :n] = 1
            types[row, min(seg0, n):n] = 1
        out = {"input_ids": ids, "attention_mask": mask}
        if return_token_type_ids:
            out["token_type_ids"] = types
        return out
