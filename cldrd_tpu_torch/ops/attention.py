"""K3/K4/K5: fused attention for the DistilBERT encoder.

Replaces the TPU kernels of ``cldrd_tpu/ops/attention.py``:

- K3 ``_train_fwd_kernel_factory`` and K4 ``_train_bwd_kernel_factory``
  become ``flash_attention_train``, a ``torch.autograd.Function`` whose
  forward and backward are the CUDA kernels of ``csrc/attention.cu``,
  with attention-probs dropout computed inside them from a counter hash;
- K5 ``_attention_kernel`` becomes ``flash_attention``: its forward is
  K3's kernel with no dropout and no segments, its backward recomputes
  through the plain einsum form, as the reference's backward is XLA
  recompute.

Layout ``[B, L, H, D]`` at every public function, as in the reference.
The kernels take bf16 or fp32, ``head_dim`` 32 or 64 and any ``L`` up to
512 (ragged tiles are masked in the kernel); on the passage tower's shape
(B=240, H=12, L=256, D=64, bf16) both directions are bound by bytes (see
the note in the source).

Dropout is ``_hash_keep``: a murmur3-style finalizer over the element index
``((b*H + h)*Lq + q)*Lk + k`` (int32, wrapping) xor the seed, in 32-bit
unsigned arithmetic with logical shifts; ``hash_keep`` and
``dropout_keep_mask`` reproduce it bit for bit, here in int64 masked to
32 bits.

Each kernel has its plain PyTorch version beside it (``*_plain``), which
repeats the reference kernel's arithmetic: a wrapper takes it for CPU
tensors only, and on a CUDA tensor launches the kernel or raises.
``LAUNCHES`` counts kernel launches by name.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from . import _build

NEG_INF = -1e9
HEAD_DIMS = (32, 64)
MAX_LEN = 512
LAUNCHES = {"train_fwd": 0, "train_bwd": 0, "infer": 0}

_M32 = 0xFFFFFFFF
# the reference's int32 constants -1028477379 and -2048144789 as uint32
# (the first is 0xC2B2AE3D, not murmur3's 0xC2B2AE35 that its comment names)
_C1 = -1028477379 & _M32
_C2 = -2048144789 & _M32


# ------------------------------------------------------------ dropout hash


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c`` modulo 2**32 for int64 ``x`` in [0, 2**32): the constant
    splits in 16-bit halves so no product leaves int64's range."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def hash_keep(idx: torch.Tensor, seed: int, dropout_p: float) -> torch.Tensor:
    """``_hash_keep``: keep mask (True = keep) from element indices (any
    integer tensor; taken modulo 2**32, as int32 wraps) and an int32
    seed."""
    x = (idx.to(torch.int64) & _M32) ^ (int(seed) & _M32)
    x = _mul32(x, _C1)
    x = x ^ (x >> 16)
    x = _mul32(x, _C2)
    x = x ^ (x >> 13)
    x = _mul32(x, _C1)
    x = x ^ (x >> 16)
    u = (x >> 8).to(torch.float32) * (2.0 ** -24)
    return u >= torch.tensor(dropout_p, dtype=torch.float32)


def dropout_keep_mask(bsz: int, n_heads: int, q_len: int, k_len: int,
                      seed: int, dropout_p: float,
                      device=None) -> torch.Tensor:
    """The kernels' keep mask as a [B, H, Lq, Lk] bool tensor."""
    b, h, q, k = (torch.arange(n, dtype=torch.int64, device=device)
                  for n in (bsz, n_heads, q_len, k_len))
    idx = (((b[:, None, None, None] * n_heads + h[None, :, None, None])
            * q_len + q[None, None, :, None]) * k_len
           + k[None, None, None, :])
    return hash_keep(idx, seed, dropout_p)


def _in_dtype(x: float, dtype) -> torch.Tensor:
    """A Python float rounded to ``dtype`` (a 0-d tensor)."""
    return torch.tensor(x, dtype=torch.float64).to(dtype)


# ---------------------------------------------------------- plain versions


def _scores(q, k, mask, segment_ids):
    """fp32 scores of ``q * scale`` (scaled in the compute dtype) against
    ``k``, masked with -1e9: [B, H, Lq, Lk]."""
    scale = _in_dtype(1.0 / math.sqrt(q.shape[-1]), q.dtype).to(q.device)
    s = torch.einsum("bqhd,bkhd->bhqk", (q * scale).float(), k.float())
    allowed = mask[:, None, None, :] != 0
    if segment_ids is not None:
        allowed = allowed & (segment_ids[:, None, :, None]
                             == segment_ids[:, None, None, :])
    return torch.where(allowed, s, torch.tensor(NEG_INF, device=s.device))


def _probs(q, k, mask, segment_ids):
    s = _scores(q, k, mask, segment_ids)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    return (e / e.sum(-1, keepdim=True)).to(q.dtype)


def train_fwd_plain(q, k, v, mask, seed: int, dropout_p: float,
                    segment_ids=None) -> torch.Tensor:
    """K3's plain version: the reference kernel's forward arithmetic."""
    probs = _probs(q, k, mask, segment_ids)
    if dropout_p > 0.0:
        b, lq, h, _ = q.shape
        keep = dropout_keep_mask(b, h, lq, k.shape[1], seed, dropout_p,
                                 q.device)
        inv = _in_dtype(1.0 / (1.0 - dropout_p), q.dtype).to(q.device)
        probs = torch.where(keep, probs * inv, torch.zeros_like(probs))
    return torch.einsum("bhqk,bkhd->bqhd", probs.float(),
                        v.float()).to(q.dtype)


def train_bwd_plain(q, k, v, mask, seed: int, dropout_p: float,
                    segment_ids, g) -> Tuple[torch.Tensor, ...]:
    """K4's plain version: (dq, dk, dv) by the reference kernel's backward
    arithmetic (softmax backward on the pre-dropout probs, in fp32)."""
    dt = q.dtype
    scale = 1.0 / math.sqrt(q.shape[-1])
    probs = _probs(q, k, mask, segment_ids)
    dp = torch.einsum("bqhd,bkhd->bhqk", g.float(), v.float())
    probs_d = probs
    if dropout_p > 0.0:
        b, lq, h, _ = q.shape
        keep = dropout_keep_mask(b, h, lq, k.shape[1], seed, dropout_p,
                                 q.device)
        inv = _in_dtype(1.0 / (1.0 - dropout_p), dt).to(q.device)
        probs_d = torch.where(keep, probs * inv, torch.zeros_like(probs))
        inv32 = _in_dtype(1.0 / (1.0 - dropout_p), torch.float32).to(
            q.device)
        dp = torch.where(keep, dp * inv32, torch.zeros_like(dp))
    dv = torch.einsum("bhqk,bqhd->bkhd", probs_d.float(), g.float())
    pf = probs.float()
    ds = (pf * (dp - (dp * pf).sum(-1, keepdim=True))).to(dt).float()
    scale32 = _in_dtype(scale, torch.float32).to(q.device)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float()) * scale32
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * scale32
    return dq.to(dt), dk.to(dt), dv.to(dt)


def attention_plain(q, k, v, mask) -> torch.Tensor:
    """K5's plain version (K3's forward with no dropout, no segments)."""
    return train_fwd_plain(q, k, v, mask, 0, 0.0)


def xla_attention(q, k, v, mask) -> torch.Tensor:
    """The reference's differentiable ``_xla_attention``: q divided by
    sqrt(D) in the compute dtype, fp32 scores and softmax, probs cast,
    fp32-accumulated P.V. K5's backward differentiates this."""
    d = torch.tensor(q.shape[-1], dtype=q.dtype, device=q.device)
    s = torch.einsum("bqhd,bkhd->bhqk", (q / torch.sqrt(d)).float(),
                     k.float())
    s = torch.where(mask[:, None, None, :] != 0, s,
                    torch.tensor(NEG_INF, device=s.device))
    probs = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs.float(),
                        v.float()).to(q.dtype)


# ------------------------------------------------------------ the kernels


def _check(name, q, k, v, mask, segment_ids, g=None):
    """What the kernels take: one CUDA device; q/k/v (and g) contiguous
    [B, L, H, D] in one dtype, bf16 or fp32, D in HEAD_DIMS, L <= 512;
    mask (and segments) [B, L]."""
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: dtype {q.dtype} (bf16 or fp32)")
    if q.dim() != 4:
        raise ValueError(f"{name}: q must be [B, L, H, D]")
    b, length, h, d = q.shape
    if d not in HEAD_DIMS or not 1 <= length <= MAX_LEN:
        raise ValueError(f"{name}: head_dim {d} (takes {HEAD_DIMS}), "
                         f"L {length} (takes 1..{MAX_LEN})")
    for n, t in (("k", k), ("v", v), ("g", g)):
        if t is None:
            continue
        if t.shape != q.shape or t.dtype != q.dtype:
            raise ValueError(f"{name}: {n} {tuple(t.shape)} {t.dtype} vs q "
                             f"{tuple(q.shape)} {q.dtype}")
    for n, t in (("mask", mask), ("segment_ids", segment_ids)):
        if t is not None and tuple(t.shape) != (b, length):
            raise ValueError(f"{name}: {n} must be [B, L]")
    for t in (k, v, mask, segment_ids, g):
        if t is not None and t.device != q.device:
            raise ValueError(f"{name}: operands on {t.device} and "
                             f"{q.device}")


def _i32(t):
    return None if t is None else t.to(torch.int32).contiguous()


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch_fwd(q, k, v, mask, seed, dropout_p, segment_ids, with_stats,
                name):
    _check(name, q, k, v, mask, segment_ids)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    mask, seg = _i32(mask), _i32(segment_ids)
    b, length, h, d = q.shape
    out = torch.empty_like(q)
    stats = (torch.empty((b, h, length, 2), dtype=torch.float32,
                         device=q.device) if with_stats else None)
    inv = float(_in_dtype(1.0 / (1.0 - dropout_p), q.dtype))
    scale = float(_in_dtype(1.0 / math.sqrt(d), q.dtype))
    _build.launch(
        "attention", "attn_fwd_launch",
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
        + [ctypes.c_float] * 3,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), _ptr(seg),
        out.data_ptr(), _ptr(stats), _build.dtype_code(q.dtype), b, length,
        h, d, _seed32(seed), float(dropout_p), inv, scale, device=q.device)
    LAUNCHES[name] += 1
    return out, stats


def _launch_bwd(q, k, v, mask, seed, dropout_p, segment_ids, stats, g):
    _check("train_bwd", q, k, v, mask, segment_ids, g)
    q, k, v, g = (t.contiguous() for t in (q, k, v, g))
    mask, seg = _i32(mask), _i32(segment_ids)
    b, length, h, d = q.shape
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    dsum = torch.empty((b, h, length), dtype=torch.float32, device=q.device)
    inv = float(_in_dtype(1.0 / (1.0 - dropout_p), q.dtype))
    inv32 = float(_in_dtype(1.0 / (1.0 - dropout_p), torch.float32))
    scale = float(_in_dtype(1.0 / math.sqrt(d), q.dtype))
    scale32 = float(_in_dtype(1.0 / math.sqrt(d), torch.float32))
    _build.launch(
        "attention", "attn_bwd_launch",
        [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6
        + [ctypes.c_float] * 5,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), _ptr(seg),
        g.data_ptr(), stats.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), dsum.data_ptr(), _build.dtype_code(q.dtype), b,
        length, h, d, _seed32(seed), float(dropout_p), inv, inv32, scale,
        scale32, device=q.device)
    LAUNCHES["train_bwd"] += 1
    return dq, dk, dv


def _seed32(seed: int) -> int:
    """An int32 seed as the C entry point's signed int."""
    s = int(seed) & _M32
    return s - (1 << 32) if s >= 1 << 31 else s


def _route(q) -> str:
    if q.device.type == "cpu":
        return "plain"
    if q.device.type != "cuda":
        raise ValueError(f"attention: no route for {q.device}")
    return "kernel"


class _TrainAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, mask, seed, dropout_p, segment_ids):
        if _route(q) == "plain":
            out, stats = train_fwd_plain(q, k, v, mask, seed, dropout_p,
                                         segment_ids), None
        else:
            out, stats = _launch_fwd(q, k, v, mask, seed, dropout_p,
                                     segment_ids, True, "train_fwd")
        ctx.save_for_backward(q, k, v, mask, segment_ids, stats)
        ctx.seed, ctx.dropout_p = seed, dropout_p
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, mask, segment_ids, stats = ctx.saved_tensors
        if stats is None:
            grads = train_bwd_plain(q, k, v, mask, ctx.seed, ctx.dropout_p,
                                    segment_ids, g)
        else:
            grads = _launch_bwd(q, k, v, mask, ctx.seed, ctx.dropout_p,
                                segment_ids, stats, g)
        return (*grads, None, None, None, None)


def flash_attention_train(q, k, v, mask, seed: int, dropout_p: float = 0.0,
                          segment_ids: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Fused attention for training: q/k/v [B, L, H, D], mask [B, L],
    ``seed`` an int32 (the dropout stream), ``dropout_p`` static,
    optional ``segment_ids`` [B, L] (packed rows attend only within their
    segment). Forward K3, backward K4 on CUDA tensors."""
    return _TrainAttention.apply(q, k, v, mask, int(seed), float(dropout_p),
                                 segment_ids)


class _InferAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, mask):
        ctx.save_for_backward(q, k, v, mask)
        if _route(q) == "plain":
            return attention_plain(q, k, v, mask)
        return _launch_fwd(q, k, v, mask, 0, 0.0, None, False, "infer")[0]

    @staticmethod
    def backward(ctx, g):
        q, k, v, mask = ctx.saved_tensors
        with torch.enable_grad():
            qkv = [t.detach().requires_grad_(True) for t in (q, k, v)]
            out = xla_attention(*qkv, mask)
            grads = torch.autograd.grad(out, qkv, g)
        return (*grads, None)


def flash_attention(q, k, v, mask) -> torch.Tensor:
    """Fused attention (K5): q/k/v [B, L, H, D], mask [B, L]; returns
    [B, L, H, D] in q's dtype. The backward recomputes through
    ``xla_attention``."""
    return _InferAttention.apply(q, k, v, mask)
