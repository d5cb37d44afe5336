"""DistilBERT encoder in PyTorch (port of ``cldrd_tpu/models/distilbert.py``).

Architecture and parameter names follow HF ``DistilBertModel``
(``embeddings.word_embeddings.weight``,
``transformer.layer.{i}.attention.q_lin.weight``, ...), so reference
``.pth.tar`` checkpoints load with no converter. Numerics follow the JAX
encoder:

- params are fp32; in bf16 compute every weight is cast to bf16 right
  before its matmul (flax ``Dense(dtype=bf16)``);
- attention scales Q (not the logits) in the compute dtype, takes fp32
  scores, masks with -1e9, runs softmax in fp32, then casts the probs;
- GELU is the exact (erf) form;
- LayerNorm has eps 1e-12 and takes its statistics in fp32;
- ``cls_only`` on the last block computes position 0 only: a one-row
  query, residual and FFN.

Attention is the einsum form, which is what the reference's ``'auto'``
picks for encoding.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

# masked attention logit; softmax subtracts the row max, so this fully
# suppresses masked positions without inf - inf
NEG_INF = -1e9


@dataclasses.dataclass(frozen=True)
class DistilBertConfig:
    """Static architecture hyperparameters (HF ``DistilBertConfig``)."""

    vocab_size: int = 30522
    max_position_embeddings: int = 512
    dim: int = 768
    n_layers: int = 6
    n_heads: int = 12
    hidden_dim: int = 3072
    dropout: float = 0.1
    attention_dropout: float = 0.1
    layer_norm_eps: float = 1e-12
    initializer_range: float = 0.02

    @classmethod
    def tiny(cls, **overrides) -> "DistilBertConfig":
        """A small config for tests."""
        base = dict(vocab_size=512, max_position_embeddings=64, dim=32,
                    n_layers=2, n_heads=4, hidden_dim=64)
        base.update(overrides)
        return cls(**base)


def _linear(x: torch.Tensor, lin: nn.Linear, dtype) -> torch.Tensor:
    """flax ``Dense(dtype=...)``: input, kernel and bias in the compute
    dtype."""
    return F.linear(x.to(dtype), lin.weight.to(dtype), lin.bias.to(dtype))


class LayerNorm(nn.LayerNorm):
    """LayerNorm with fp32 statistics, output in the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        mean = x32.mean(-1, keepdim=True)
        var = (x32 - mean).square().mean(-1, keepdim=True)
        y = (x32 - mean) * torch.rsqrt(var + self.eps)
        return (y * self.weight + self.bias).to(x.dtype)


class Embeddings(nn.Module):
    """word + position embeddings -> LayerNorm."""

    def __init__(self, config: DistilBertConfig, dtype=torch.float32):
        super().__init__()
        self.config = config
        self.dtype = dtype
        self.word_embeddings = nn.Embedding(config.vocab_size, config.dim)
        self.position_embeddings = nn.Embedding(
            config.max_position_embeddings, config.dim)
        self.LayerNorm = LayerNorm(config.dim, eps=config.layer_norm_eps)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        seq_len = input_ids.shape[-1]
        if seq_len > self.config.max_position_embeddings:
            raise ValueError(
                f"sequence length {seq_len} exceeds the model's "
                f"max_position_embeddings="
                f"{self.config.max_position_embeddings}; lower --max-length "
                "(the 'tiny' config supports 64)")
        word = self.word_embeddings.weight.to(self.dtype)[input_ids]
        pos = self.position_embeddings.weight[:seq_len].to(self.dtype)
        return self.LayerNorm(word + pos[None])


class MultiHeadSelfAttention(nn.Module):
    def __init__(self, config: DistilBertConfig, dtype=torch.float32):
        super().__init__()
        self.config = config
        self.dtype = dtype
        self.q_lin = nn.Linear(config.dim, config.dim)
        self.k_lin = nn.Linear(config.dim, config.dim)
        self.v_lin = nn.Linear(config.dim, config.dim)
        self.out_lin = nn.Linear(config.dim, config.dim)

    def forward(self, hidden: torch.Tensor, attention_mask: torch.Tensor,
                cls_only: bool = False) -> torch.Tensor:
        cfg, dt = self.config, self.dtype
        bsz, seq_len, _ = hidden.shape
        head_dim = cfg.dim // cfg.n_heads
        q_in = hidden[:, :1] if cls_only else hidden
        q_len = q_in.shape[1]
        q = _linear(q_in, self.q_lin, dt).view(bsz, q_len, cfg.n_heads,
                                               head_dim)
        k = _linear(hidden, self.k_lin, dt).view(bsz, seq_len, cfg.n_heads,
                                                 head_dim)
        v = _linear(hidden, self.v_lin, dt).view(bsz, seq_len, cfg.n_heads,
                                                 head_dim)
        # HF parity: scale Q (not the logits), in the compute dtype
        q = q / torch.sqrt(torch.tensor(head_dim, dtype=dt,
                                        device=hidden.device))
        scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
        mask = attention_mask[:, None, None, :].bool()
        scores = torch.where(mask, scores, torch.tensor(
            NEG_INF, dtype=scores.dtype, device=scores.device))
        probs = torch.softmax(scores, dim=-1).to(dt)
        context = torch.einsum("bhqk,bkhd->bqhd", probs, v)
        return _linear(context.reshape(bsz, q_len, cfg.dim), self.out_lin, dt)


class FFN(nn.Module):
    def __init__(self, config: DistilBertConfig, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.lin1 = nn.Linear(config.dim, config.hidden_dim)
        self.lin2 = nn.Linear(config.hidden_dim, config.dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.gelu(_linear(x, self.lin1, self.dtype))  # exact (erf) GELU
        return _linear(h, self.lin2, self.dtype)


class TransformerBlock(nn.Module):
    def __init__(self, config: DistilBertConfig, dtype=torch.float32):
        super().__init__()
        self.attention = MultiHeadSelfAttention(config, dtype)
        self.sa_layer_norm = LayerNorm(config.dim, eps=config.layer_norm_eps)
        self.ffn = FFN(config, dtype)
        self.output_layer_norm = LayerNorm(config.dim,
                                           eps=config.layer_norm_eps)

    def forward(self, hidden: torch.Tensor, attention_mask: torch.Tensor,
                cls_only: bool = False) -> torch.Tensor:
        sa_out = self.attention(hidden, attention_mask, cls_only)
        residual = hidden[:, :1] if cls_only else hidden
        hidden = self.sa_layer_norm(sa_out + residual)
        return self.output_layer_norm(self.ffn(hidden) + hidden)


class Transformer(nn.Module):
    def __init__(self, config: DistilBertConfig, dtype=torch.float32):
        super().__init__()
        self.layer = nn.ModuleList(
            TransformerBlock(config, dtype) for _ in range(config.n_layers))


class DistilBertEncoder(nn.Module):
    """token ids + mask -> hidden states [B, L, D] ([B, 1, D] with
    ``cls_only``), in the compute dtype."""

    def __init__(self, config: DistilBertConfig, dtype=torch.float32):
        super().__init__()
        self.config = config
        self.dtype = dtype
        self.embeddings = Embeddings(config, dtype)
        self.transformer = Transformer(config, dtype)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                cls_only: bool = False) -> torch.Tensor:
        hidden = self.embeddings(input_ids)
        n = len(self.transformer.layer)
        for i, block in enumerate(self.transformer.layer):
            hidden = block(hidden, attention_mask, cls_only and i == n - 1)
        return hidden

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """The reference's init: normal(initializer_range) embeddings and
        weights, zero biases, unit LayerNorm scales, from ``generator``."""
        std = self.config.initializer_range
        for mod in self.modules():
            if isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
            elif isinstance(mod, (nn.Linear, nn.Embedding)):
                w = torch.empty(mod.weight.shape, dtype=torch.float32)
                w.normal_(0.0, std, generator=generator)
                mod.weight.copy_(w)
                if isinstance(mod, nn.Linear):
                    mod.bias.zero_()


def cls_pool(hidden: torch.Tensor) -> torch.Tensor:
    """CLS pooling: ``hidden[:, 0, :]``."""
    return hidden[:, 0, :]
