"""DistilBERT and BERT in plain float32 PyTorch.

The published architecture (HF ``DistilBertModel`` / ``BertModel``, post
LayerNorm blocks): word + position (+ token type) embeddings and a
LayerNorm (eps 1e-12); per block q, k and v projections, scaled dot
products with masked keys at -1e9, softmax, the output projection, a
residual LayerNorm, an FFN of two products around the exact (erf) GELU
and a second residual LayerNorm. A CLS embedding needs position 0 of
the last block only, so that block computes one query row (``cls_only``);
the dropout masks of a training step are drawn on the shapes the port
draws them on. The BERT cross-encoder adds the tanh pooler and the
one-logit classifier.

Parameter names are HF's as the port's state dicts hold them
(``param_specs``); the benchmark makes the weights under these names and
hands the same tensors to the port and to this module.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

NEG_INF = -1e9
Params = Dict[str, torch.Tensor]
Quant = Optional[Callable[[torch.Tensor], torch.Tensor]]


def param_specs(cfg: dict, prefix: str = "") -> List[Tuple[str, tuple, str]]:
    """(name, shape, kind) of an encoder's parameters; kind is 'w' (a
    product's weight or an embedding table), 'b' (a bias), 'ln_w' or
    'ln_b'."""
    d, f, v = cfg["dim"], cfg["hidden_dim"], cfg["vocab_size"]
    e = prefix + "embeddings."
    out = [(e + "word_embeddings.weight", (v, d), "w"),
           (e + "position_embeddings.weight",
            (cfg["max_position_embeddings"], d), "w")]
    if cfg.get("type_vocab_size"):
        out.append((e + "token_type_embeddings.weight",
                    (cfg["type_vocab_size"], d), "w"))
    out += [(e + "LayerNorm.weight", (d,), "ln_w"),
            (e + "LayerNorm.bias", (d,), "ln_b")]
    for i in range(cfg["n_layers"]):
        blk = f"{prefix}transformer.layer.{i}."
        for lin in ("q_lin", "k_lin", "v_lin", "out_lin"):
            out += [(f"{blk}attention.{lin}.weight", (d, d), "w"),
                    (f"{blk}attention.{lin}.bias", (d,), "b")]
        out += [(blk + "sa_layer_norm.weight", (d,), "ln_w"),
                (blk + "sa_layer_norm.bias", (d,), "ln_b"),
                (blk + "ffn.lin1.weight", (f, d), "w"),
                (blk + "ffn.lin1.bias", (f,), "b"),
                (blk + "ffn.lin2.weight", (d, f), "w"),
                (blk + "ffn.lin2.bias", (d,), "b"),
                (blk + "output_layer_norm.weight", (d,), "ln_w"),
                (blk + "output_layer_norm.bias", (d,), "ln_b")]
    return out


def dual_encoder_specs(cfg: dict) -> List[Tuple[str, tuple, str]]:
    """Separate query and passage towers."""
    return (param_specs(cfg, "query_encoder.")
            + param_specs(cfg, "passage_encoder."))


def cross_encoder_specs(cfg: dict) -> List[Tuple[str, tuple, str]]:
    """A BERT tower, the pooler and the classifier."""
    d = cfg["dim"]
    return param_specs(cfg, "encoder.") + [
        ("pooler.weight", (d, d), "w"), ("pooler.bias", (d,), "b"),
        ("classifier.weight", (1, d), "w"), ("classifier.bias", (1,), "b")]


def fp8_e4m3(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to fp8 e4m3 under a per-tensor scale (its largest
    magnitude onto 448), back in float32: the control's products'
    operands and the hidden states it holds between blocks."""
    amax = x.detach().abs().amax().clamp(min=1e-30)
    scale = 448.0 / amax
    q = (x.detach() * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale
    return x + (q - x).detach()  # the backward passes straight through


def _layer_norm(x, w, b, eps=1e-12):
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).square().mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * w + b


def _held(x, quant: Quant):
    """A hidden state as the compute type holds it between blocks."""
    return x if quant is None else quant(x)


def _linear(x, w, b, quant: Quant):
    if quant is not None:
        x, w = quant(x), quant(w)
    return torch.matmul(x, w.t()) + b


def encode(p: Params, prefix: str, cfg: dict, input_ids: torch.Tensor,
           attention_mask: torch.Tensor,
           token_type_ids: Optional[torch.Tensor] = None,
           dropout=None, quant: Quant = None) -> torch.Tensor:
    """CLS embeddings [B, D] in float32. ``dropout``: a
    ``reference.dropout.StepDropout`` (training mode)."""
    e = prefix + "embeddings."
    bsz, length = input_ids.shape
    x = p[e + "word_embeddings.weight"][input_ids] \
        + p[e + "position_embeddings.weight"][:length][None]
    if e + "token_type_embeddings.weight" in p:
        types = (torch.zeros_like(input_ids) if token_type_ids is None
                 else token_type_ids)
        x = x + p[e + "token_type_embeddings.weight"][types]
    x = _held(_layer_norm(x, p[e + "LayerNorm.weight"],
                          p[e + "LayerNorm.bias"]), quant)
    if dropout is not None:
        x = dropout.hidden(x)
    heads = cfg["n_heads"]
    hd = cfg["dim"] // heads
    keep = attention_mask.bool()[:, None, None, :]
    n = cfg["n_layers"]
    for i in range(n):
        blk = f"{prefix}transformer.layer.{i}."
        last = i == n - 1
        a = blk + "attention."

        def lin(t, name):
            return _linear(t, p[a + name + ".weight"], p[a + name + ".bias"],
                           quant)

        xq = x[:, :1] if last else x
        q = lin(xq, "q_lin").view(bsz, xq.shape[1], heads, hd) / math.sqrt(hd)
        k = lin(x, "k_lin").view(bsz, length, heads, hd)
        v = lin(x, "v_lin").view(bsz, length, heads, hd)
        if quant is not None:
            q, k, v = quant(q), quant(k), quant(v)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k)
        scores = torch.where(keep, scores, torch.full_like(scores, NEG_INF))
        probs = torch.softmax(scores, dim=-1)
        if dropout is not None:
            probs = (dropout.probs_drawn(probs) if last
                     else dropout.probs_hashed(probs))
        if quant is not None:
            probs = quant(probs)
        ctx = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(
            bsz, xq.shape[1], cfg["dim"])
        sa = lin(ctx, "out_lin")
        if dropout is not None:
            sa = dropout.hidden(sa)
        x = _held(_layer_norm(sa + xq, p[blk + "sa_layer_norm.weight"],
                              p[blk + "sa_layer_norm.bias"]), quant)
        h = F.gelu(_linear(x, p[blk + "ffn.lin1.weight"],
                           p[blk + "ffn.lin1.bias"], quant))
        h = _linear(h, p[blk + "ffn.lin2.weight"], p[blk + "ffn.lin2.bias"],
                    quant)
        if dropout is not None:
            h = dropout.hidden(h)
        x = _held(_layer_norm(h + x, p[blk + "output_layer_norm.weight"],
                              p[blk + "output_layer_norm.bias"]), quant)
    return x[:, 0]


def cross_encoder_scores(p: Params, cfg: dict, tokens: Dict[str, torch.Tensor],
                         quant: Quant = None) -> torch.Tensor:
    """BERT cross-encoder scores [B]: tanh pooler, one-logit classifier."""
    cls = encode(p, "encoder.", cfg, tokens["input_ids"],
                 tokens["attention_mask"], tokens.get("token_type_ids"),
                 quant=quant)
    pooled = torch.tanh(_linear(cls, p["pooler.weight"], p["pooler.bias"],
                                quant))
    return _linear(pooled, p["classifier.weight"], p["classifier.bias"],
                   quant)[:, 0]
