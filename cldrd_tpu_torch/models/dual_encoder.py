"""Dual encoder: query and passage towers (port of the encode surface of
``cldrd_tpu/models/dual_encoder.py``).

``share_weights=True`` uses one tower for both sides; its state_dict still
carries both ``query_encoder.*`` and ``passage_encoder.*`` keys, as the
reference torch model's aliased tower does. ``apply_cosine_similarity``
L2-normalizes every embedding at the embedding boundary, so an
inner-product index over the outputs ranks by cosine.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from .distilbert import DistilBertConfig, DistilBertEncoder, cls_pool

Batch = Dict[str, torch.Tensor]


def _l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=eps)


class NwayDualEncoder(nn.Module):
    """Query/passage towers; ``query_embs``/``passage_embs`` CLS-pool the
    final block computed for position 0 only."""

    def __init__(self, config: DistilBertConfig, share_weights: bool = False,
                 apply_cosine_similarity: bool = False,
                 dtype=torch.float32):
        super().__init__()
        self.config = config
        self.share_weights = share_weights
        self.apply_cosine_similarity = apply_cosine_similarity
        self.dtype = dtype
        self.query_encoder = DistilBertEncoder(config, dtype)
        self.passage_encoder = (self.query_encoder if share_weights
                                else DistilBertEncoder(config, dtype))

    def _embs(self, encoder: DistilBertEncoder, batch: Batch) -> torch.Tensor:
        hidden = encoder(batch["input_ids"], batch["attention_mask"],
                         cls_only=True)
        reps = cls_pool(hidden)
        return _l2_normalize(reps) if self.apply_cosine_similarity else reps

    def query_embs(self, queries: Batch) -> torch.Tensor:
        return self._embs(self.query_encoder, queries)

    def passage_embs(self, passages: Batch) -> torch.Tensor:
        return self._embs(self.passage_encoder, passages)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None,
                         seed: int = 0) -> "NwayDualEncoder":
        """Random init from an explicit generator (query tower first)."""
        if generator is None:
            generator = torch.Generator().manual_seed(seed)
        self.query_encoder.reset_parameters(generator)
        if not self.share_weights:
            self.passage_encoder.reset_parameters(generator)
        return self
