"""Dual encoder: query and passage towers and their n-way logits (port of
``cldrd_tpu/models/dual_encoder.py``).

``share_weights=True`` uses one tower for both sides; its state_dict still
carries both ``query_encoder.*`` and ``passage_encoder.*`` keys, as the
reference torch model's aliased tower does. ``apply_cosine_similarity``
L2-normalizes every embedding at the embedding boundary, so an
inner-product index over the outputs ranks by cosine. A ``DropoutRNG``
passed as ``rng`` is training mode.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from .bert import encoder_class
from .distilbert import (
    DistilBertConfig,
    DistilBertEncoder,
    DropoutRNG,
    cls_pool,
)

Batch = Dict[str, torch.Tensor]


def _l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=eps)


def _in_batch_neg_indices(bz: int, nway: int,
                          all_in_batch_neg: bool) -> np.ndarray:
    """Negative-passage index matrix over the flat ``[bz * nway]``
    passages: every passage not in row b ([bz, (bz-1)*nway]), or with
    ``all_in_batch_neg=False`` the next example's nway passages ([bz,
    nway])."""
    full = np.asarray(
        [list(range(b * nway)) + list(range((b + 1) * nway, bz * nway))
         for b in range(bz)], dtype=np.int32)
    if all_in_batch_neg:
        return full
    ys = np.concatenate([np.arange(0, (bz - 1) * nway).reshape(bz - 1, nway),
                         np.arange(0, nway).reshape(1, nway)], axis=0)
    xs = np.repeat(np.arange(bz).reshape(-1, 1), nway, axis=1)
    return full[xs, ys]


class NwayDualEncoder(nn.Module):
    """Query/passage towers; ``query_embs``/``passage_embs`` CLS-pool the
    final block computed for position 0 only; ``forward`` scores each
    query against its n-way passages (plus in-batch negatives)."""

    def __init__(self, config: DistilBertConfig, share_weights: bool = False,
                 apply_cosine_similarity: bool = False,
                 dtype=torch.float32, in_batch_loss: bool = False,
                 all_in_batch_neg: bool = True):
        super().__init__()
        self.config = config
        self.share_weights = share_weights
        self.apply_cosine_similarity = apply_cosine_similarity
        self.in_batch_loss = in_batch_loss
        self.all_in_batch_neg = all_in_batch_neg
        self.dtype = dtype
        # a BertConfig stands up BERT towers, as in the reference
        enc_cls = encoder_class(config)
        self.query_encoder = enc_cls(config, dtype)
        self.passage_encoder = (self.query_encoder if share_weights
                                else enc_cls(config, dtype))

    def _norm(self, reps: torch.Tensor) -> torch.Tensor:
        return _l2_normalize(reps) if self.apply_cosine_similarity else reps

    def _embs(self, encoder: DistilBertEncoder, batch: Batch,
              rng: Optional[DropoutRNG]) -> torch.Tensor:
        hidden = encoder(batch["input_ids"], batch["attention_mask"],
                         cls_only=True, rng=rng)
        return self._norm(cls_pool(hidden))

    def query_embs(self, queries: Batch,
                   rng: Optional[DropoutRNG] = None) -> torch.Tensor:
        return self._embs(self.query_encoder, queries, rng)

    def passage_embs(self, passages: Batch,
                     rng: Optional[DropoutRNG] = None) -> torch.Tensor:
        return self._embs(self.passage_encoder, passages, rng)

    def nway_passage_embs(self, nway_passages: Batch,
                          rng: Optional[DropoutRNG] = None) -> torch.Tensor:
        """[bz, nway, L] passages through one flat encoder batch ->
        [bz, nway, D]."""
        ids = nway_passages["input_ids"]
        bz, nway, seq_len = ids.shape
        reps = self.passage_embs(
            {"input_ids": ids.reshape(bz * nway, seq_len),
             "attention_mask": nway_passages["attention_mask"].reshape(
                 bz * nway, seq_len)}, rng)
        return reps.reshape(bz, nway, -1)

    def packed_nway_passage_embs(self, packed: Batch,
                                 rng: Optional[DropoutRNG] = None
                                 ) -> torch.Tensor:
        """Packed passages (``data/packing.py``): ``{input_ids,
        attention_mask, position_ids, segment_ids} [bz, R, L]`` and
        ``gather_pos [bz, nway]`` -> [bz, nway, D], each passage's CLS
        vector gathered at its packed start within its example."""
        ids = packed["input_ids"]
        bz, rows, seq_len = ids.shape
        flat = lambda x: x.reshape(bz * rows, seq_len)  # noqa: E731
        hidden = self.passage_encoder(
            flat(ids), flat(packed["attention_mask"]),
            position_ids=flat(packed["position_ids"]),
            segment_ids=flat(packed["segment_ids"]), rng=rng)
        per_example = hidden.reshape(bz, rows * seq_len, hidden.shape[-1])
        gather = packed["gather_pos"].long()[..., None].expand(
            -1, -1, hidden.shape[-1])
        return self._norm(torch.gather(per_example, 1, gather))

    def forward(self, queries: Batch, nway_passages: Optional[Batch] = None,
                packed_passages: Optional[Batch] = None,
                rng: Optional[DropoutRNG] = None) -> torch.Tensor:
        """Logits [bz, nway'] in fp32: nway, or with ``in_batch_loss``
        nway plus the in-batch negatives."""
        query_reps = self.query_embs(queries, rng)
        if packed_passages is not None:
            nway_reps = self.packed_nway_passage_embs(packed_passages, rng)
        else:
            nway_reps = self.nway_passage_embs(nway_passages, rng)
        bz, nway, dim = nway_reps.shape
        if self.in_batch_loss:
            neg_idx = torch.from_numpy(_in_batch_neg_indices(
                bz, nway, self.all_in_batch_neg)).to(nway_reps.device).long()
            neg = nway_reps.reshape(bz * nway, dim)[neg_idx]
            nway_reps = torch.cat([nway_reps, neg], dim=1)
        return torch.einsum("bd,bnd->bn", query_reps.float(),
                            nway_reps.float())

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


class DualEncoder(NwayDualEncoder):
    """Plain dual encoder: one (query, passage) pair per row, logits [bz]."""

    def forward(self, queries: Batch,  # type: ignore[override]
                passages: Batch,
                rng: Optional[DropoutRNG] = None) -> torch.Tensor:
        q = self.query_embs(queries, rng)
        p = self.passage_embs(passages, rng)
        return torch.einsum("bd,bd->b", q.float(), p.float())
