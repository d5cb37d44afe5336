"""Cross-encoder reranker (port of ``cldrd_tpu/models/cross_encoder.py``).

One encoder over ``[CLS] query [SEP] passage [SEP]`` and a head on the
CLS position, with the HF ``*ForSequenceClassification`` head shapes:

- ``arch='distilbert'``: pre_classifier -> ReLU -> dropout -> classifier
  (HF ``DistilBertForSequenceClassification``). Flat rows, or packed rows
  (``gather_pos`` present: several pairs a row, segment-masked attention
  on the einsum path, each pair's CLS gathered from the flat token axis).
- ``arch='bert'``: tanh pooler -> dropout -> classifier (HF
  ``BertForSequenceClassification``, the MiniLM teacher) over a
  ``BertEncoder`` reading ``token_type_ids`` when the batch carries them.
  Flat rows only.

Every dense layer runs in the compute dtype with its fp32 weights cast
(flax ``Dense(dtype=..., param_dtype=float32)``). The output is [bz]
when ``num_labels == 1``, else [bz, num_labels]; the model is
deterministic (the reference scores with ``deterministic=True``).

State_dict: ``encoder.*`` (the tower's names), ``pooler.*`` or
``pre_classifier.*``, ``classifier.*``.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from .bert import BertEncoder, as_bert_config
from .distilbert import DistilBertConfig, DistilBertEncoder, _linear, cls_pool

Batch = Dict[str, torch.Tensor]

ARCHS = ("distilbert", "bert")


class CrossEncoder(nn.Module):
    """(query ++ passage) -> relevance score [bz]."""

    def __init__(self, config: DistilBertConfig, num_labels: int = 1,
                 dtype=torch.float32, arch: str = "distilbert"):
        super().__init__()
        if arch not in ARCHS:
            raise ValueError(f"arch {arch!r} (distilbert | bert)")
        self.arch = arch
        self.num_labels = num_labels
        self.dtype = dtype
        if arch == "bert":
            self.config = as_bert_config(config)
            self.encoder = BertEncoder(self.config, dtype)
            self.pooler = nn.Linear(config.dim, config.dim)
        else:
            self.config = config
            self.encoder = DistilBertEncoder(config, dtype)
            self.pre_classifier = nn.Linear(config.dim, config.dim)
        self.classifier = nn.Linear(config.dim, num_labels)

    def forward(self, pairs: Batch) -> torch.Tensor:
        """``pairs``: flat ``{input_ids, attention_mask[, token_type_ids]}
        [bz, L]``, or packed ``{input_ids, attention_mask, position_ids,
        segment_ids} [R, L]`` with ``gather_pos [n]``."""
        packed = "gather_pos" in pairs
        if self.arch == "bert":
            if packed:
                raise ValueError(
                    "packed mode is not supported for arch='bert' (packing "
                    "would need per-segment token-type resets; use "
                    "batches()/batches_bucketed(), which are faster for "
                    "reranking anyway — see batches_packed docstring)")
            hidden = self.encoder(pairs["input_ids"], pairs["attention_mask"],
                                  cls_only=True,
                                  token_type_ids=pairs.get("token_type_ids"))
            pooled = torch.tanh(_linear(cls_pool(hidden), self.pooler,
                                        self.dtype))
        else:
            hidden = self.encoder(
                pairs["input_ids"], pairs["attention_mask"],
                # flat rows need position 0 only; packed rows need every
                # segment's start
                cls_only=not packed,
                position_ids=pairs.get("position_ids"),
                segment_ids=pairs.get("segment_ids"))
            if packed:
                flat = hidden.reshape(-1, hidden.shape[-1])
                pooled = flat[pairs["gather_pos"].long()]
            else:
                pooled = cls_pool(hidden)
            pooled = F.relu(_linear(pooled, self.pre_classifier, self.dtype))
        logits = _linear(pooled, self.classifier, self.dtype)
        return logits.squeeze(-1) if self.num_labels == 1 else logits

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator = None,
                         seed: int = 0) -> "CrossEncoder":
        """Random init from an explicit generator: the encoder's, then
        normal(initializer_range) head weights and zero biases."""
        if generator is None:
            generator = torch.Generator().manual_seed(seed)
        self.encoder.reset_parameters(generator)
        std = self.config.initializer_range
        for lin in (getattr(self, "pooler", None),
                    getattr(self, "pre_classifier", None), self.classifier):
            if lin is None:
                continue
            w = torch.empty(lin.weight.shape, dtype=torch.float32)
            w.normal_(0.0, std, generator=generator)
            lin.weight.copy_(w)
            lin.bias.zero_()
        return self
