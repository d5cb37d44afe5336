"""BERT encoder (port of ``cldrd_tpu/models/bert.py``).

The reference teacher ``cross-encoder/ms-marco-MiniLM-L-6-v2`` is a BERT:
DistilBERT's blocks plus token-type (segment) embeddings and a tanh
pooler, which lives in the consumer (``CrossEncoder``). ``BertConfig``
is a ``DistilBertConfig`` with ``type_vocab_size``; ``BertEncoder`` is
the DistilBERT encoder over that config, so it reuses
``TransformerBlock`` (the same attention routes and ``cls_only`` final
block) and its ``Embeddings`` grow the token-type table.

Its state_dict keeps the port's DistilBERT names plus
``embeddings.token_type_embeddings.weight``; ``models/convert.py`` maps
it to and from HF ``BertModel`` names.
"""
from __future__ import annotations

import dataclasses

import torch

from .distilbert import DistilBertConfig, DistilBertEncoder


@dataclasses.dataclass(frozen=True)
class BertConfig(DistilBertConfig):
    """HF ``BertConfig`` in the port's field names (``dim`` =
    ``hidden_size``, ``hidden_dim`` = ``intermediate_size``)."""

    type_vocab_size: int = 2

    @classmethod
    def minilm_l6(cls, **overrides) -> "BertConfig":
        """``cross-encoder/ms-marco-MiniLM-L-6-v2``: 6 layers, hidden 384,
        12 heads, FFN 1536, BERT vocab."""
        base = dict(vocab_size=30522, max_position_embeddings=512, dim=384,
                    n_layers=6, n_heads=12, hidden_dim=1536)
        base.update(overrides)
        return cls(**base)

    @classmethod
    def tiny(cls, **overrides) -> "BertConfig":
        base = dict(vocab_size=512, max_position_embeddings=64, dim=32,
                    n_layers=2, n_heads=4, hidden_dim=64)
        base.update(overrides)
        return cls(**base)


def as_bert_config(cfg: DistilBertConfig) -> BertConfig:
    """``cfg`` as a ``BertConfig`` (its fields kept, two token types)."""
    if isinstance(cfg, BertConfig):
        return cfg
    return BertConfig(**{f.name: getattr(cfg, f.name)
                         for f in dataclasses.fields(cfg)})


class BertEncoder(DistilBertEncoder):
    """Token ids + mask (+ token types) -> hidden states [B, L, D]."""

    def __init__(self, config: BertConfig, dtype=torch.float32):
        super().__init__(as_bert_config(config), dtype)


def encoder_class(config: DistilBertConfig):
    """The config type is the architecture: BERT towers for a
    ``BertConfig``, DistilBERT's otherwise."""
    return BertEncoder if isinstance(config, BertConfig) else \
        DistilBertEncoder
