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
  query, residual and FFN;
- packed rows (``data/packing.py``) take ``position_ids`` (per-segment
  position reset) and ``segment_ids`` (attention within a segment only).

Training mode is a ``DropoutRNG`` passed to ``forward``: hidden and
attention-probs dropout draw from its explicit generator, never from the
global RNG. ``attention_impl`` takes the reference's values: 'xla' is
the einsum form, 'pallas' the port's CUDA kernels (``ops/attention.py``:
K3/K4 in training with attention dropout, K5 otherwise), 'auto' the
kernels when training with attention dropout on the card and the einsum
form everywhere else (``resolve_attention_impl``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cldrd_tpu_torch.ops.attention import (
    flash_attention,
    flash_attention_train,
)

# masked attention logit; softmax subtracts the row max, so this fully
# suppresses masked positions without inf - inf
NEG_INF = -1e9


def resolve_attention_impl(impl: str, train_mode: bool,
                           device: torch.device) -> str:
    """'auto' -> 'pallas' (the CUDA kernels) when training with attention
    dropout on a CUDA device, else 'xla' (the einsum form), as the
    reference resolves it for the TPU. 'xla' and 'pallas' stand."""
    if impl not in ("auto", "xla", "pallas"):
        raise ValueError(f"attention_impl {impl!r} (auto | xla | pallas)")
    if impl != "auto":
        return impl
    return "pallas" if train_mode and device.type == "cuda" else "xla"


class DropoutRNG:
    """The dropout randomness of one training step, from ``(seed, step)``
    as the reference's ``fold_in(PRNGKey(seed), step)``: a generator on
    ``device`` for hidden and attention-probs masks, and a host stream of
    int32 seeds for the attention kernels' hash (drawn without a device
    sync). A resumed run replays the same masks."""

    def __init__(self, seed: int, step: int, device):
        mixed = np.random.SeedSequence([int(seed) & 0xFFFFFFFF,
                                        int(step) & 0xFFFFFFFF])
        words = mixed.generate_state(3)
        self.generator = torch.Generator(device=device)
        self.generator.manual_seed(int(words[0]) << 32 | int(words[1]))
        self._host = np.random.default_rng(int(words[2]))

    def next_seed(self) -> int:
        return int(self._host.integers(-2**31, 2**31, dtype=np.int64))

    def dropout(self, x: torch.Tensor, p: float) -> torch.Tensor:
        """flax ``Dropout``: keep with probability 1-p, scale by 1/(1-p)."""
        if p == 0.0:
            return x
        keep = torch.rand(x.shape, generator=self.generator,
                          device=x.device) >= p
        return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


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
    # 'auto' | 'xla' | 'pallas', as in the reference (resolve_attention_impl)
    attention_impl: str = "auto"

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
    """word + position (+ token-type) embeddings -> LayerNorm. A config
    with a nonzero ``type_vocab_size`` (``BertConfig``) adds the segment
    table, as the reference's shared module does."""

    def __init__(self, config: DistilBertConfig, dtype=torch.float32):
        super().__init__()
        self.config = config
        self.dtype = dtype
        self.word_embeddings = nn.Embedding(config.vocab_size, config.dim)
        self.position_embeddings = nn.Embedding(
            config.max_position_embeddings, config.dim)
        types = getattr(config, "type_vocab_size", 0)
        if types:
            self.token_type_embeddings = nn.Embedding(types, config.dim)
        self.LayerNorm = LayerNorm(config.dim, eps=config.layer_norm_eps)

    def forward(self, input_ids: torch.Tensor,
                position_ids: Optional[torch.Tensor] = None,
                rng: Optional[DropoutRNG] = None,
                token_type_ids: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        seq_len = input_ids.shape[-1]
        if seq_len > self.config.max_position_embeddings:
            raise ValueError(
                f"sequence length {seq_len} exceeds the model's "
                f"max_position_embeddings="
                f"{self.config.max_position_embeddings}; lower --max-length "
                "(the 'tiny' config supports 64)")
        # gather from the fp32 tables, then cast: the values of the
        # reference's cast-then-gather, and a backward that accumulates
        # the sparse table gradient in fp32 (embedding_dense_backward)
        word = F.embedding(input_ids, self.word_embeddings.weight)
        table = self.position_embeddings.weight
        pos = table[:seq_len][None] if position_ids is None else \
            F.embedding(position_ids, table)
        hidden = word.to(self.dtype) + pos.to(self.dtype)
        if hasattr(self, "token_type_embeddings"):
            # no token types: segment 0's row, broadcast
            table = self.token_type_embeddings.weight
            types = table[:1][None] if token_type_ids is None else \
                F.embedding(token_type_ids, table)
            hidden = hidden + types.to(self.dtype)
        hidden = self.LayerNorm(hidden)
        return hidden if rng is None else rng.dropout(hidden,
                                                      self.config.dropout)


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
                segment_ids: Optional[torch.Tensor] = None,
                rng: Optional[DropoutRNG] = None,
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
        # the kernels take every block but a cls_only final one (its q is
        # one row), as in the reference
        train_mode = rng is not None and cfg.attention_dropout != 0.0
        impl = resolve_attention_impl(cfg.attention_impl, train_mode,
                                      hidden.device)
        use_kernel = impl == "pallas" and not cls_only
        if use_kernel and train_mode:
            context = flash_attention_train(
                q, k, v, attention_mask, rng.next_seed(),
                cfg.attention_dropout, segment_ids)
        elif use_kernel and segment_ids is None:
            context = flash_attention(q, k, v, attention_mask)
        else:
            # HF parity: scale Q (not the logits), in the compute dtype
            q = q / torch.sqrt(torch.tensor(head_dim, dtype=dt,
                                            device=hidden.device))
            scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
            mask = attention_mask[:, None, None, :].bool()
            if segment_ids is not None:
                seg_q = segment_ids[:, :1] if cls_only else segment_ids
                mask = mask & (seg_q[:, None, :, None]
                               == segment_ids[:, None, None, :])
            scores = torch.where(mask, scores, torch.tensor(
                NEG_INF, dtype=scores.dtype, device=scores.device))
            probs = torch.softmax(scores, dim=-1).to(dt)
            if rng is not None:
                probs = rng.dropout(probs, cfg.attention_dropout)
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
        self.p = config.dropout
        self.attention = MultiHeadSelfAttention(config, dtype)
        self.sa_layer_norm = LayerNorm(config.dim, eps=config.layer_norm_eps)
        self.ffn = FFN(config, dtype)
        self.output_layer_norm = LayerNorm(config.dim,
                                           eps=config.layer_norm_eps)

    def forward(self, hidden: torch.Tensor, attention_mask: torch.Tensor,
                segment_ids: Optional[torch.Tensor] = None,
                rng: Optional[DropoutRNG] = None,
                cls_only: bool = False) -> torch.Tensor:
        sa_out = self.attention(hidden, attention_mask, segment_ids, rng,
                                cls_only)
        if rng is not None:
            sa_out = rng.dropout(sa_out, self.p)
        residual = hidden[:, :1] if cls_only else hidden
        hidden = self.sa_layer_norm(sa_out + residual)
        ffn = self.ffn(hidden)
        if rng is not None:
            ffn = rng.dropout(ffn, self.p)
        return self.output_layer_norm(ffn + hidden)


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
                cls_only: bool = False,
                position_ids: Optional[torch.Tensor] = None,
                segment_ids: Optional[torch.Tensor] = None,
                rng: Optional[DropoutRNG] = None,
                token_type_ids: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """``rng`` set = training mode (dropout on); ``position_ids`` /
        ``segment_ids`` [B, L]: packed rows; ``token_type_ids`` [B, L]
        read only by a config with a token-type table (BERT)."""
        hidden = self.embeddings(input_ids, position_ids, rng,
                                 token_type_ids)
        n = len(self.transformer.layer)
        for i, block in enumerate(self.transformer.layer):
            hidden = block(hidden, attention_mask, segment_ids, rng,
                           cls_only and i == n - 1)
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
