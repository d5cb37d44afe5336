"""K3/K4/K5: fused attention for the DistilBERT encoder.

Replaces the TPU kernels of ``cldrd_tpu/ops/attention.py``:

- K3 ``_train_fwd_kernel_factory`` and K4 ``_train_bwd_kernel_factory``
  become ``flash_attention_train``, a ``torch.autograd.Function`` whose
  forward and backward are CUDA kernels, with attention-probs dropout
  computed inside them from a counter hash. ``_kernel_route`` picks the
  kernels by dtype and shape alone: bf16 with ``head_dim`` 64 and
  ``L <= 256`` (every train-attention launch of the main path) takes the
  Hopper kernels of ``csrc/attention_sm90.cu`` (one pass, rows held in
  shared memory, ``cp.async``, ``wgmma``); fp32, ``head_dim`` 32 and
  ``256 < L <= 512`` take the tiled kernels of ``csrc/attention.cu``;
- K5 ``_attention_kernel`` becomes ``flash_attention``, routed by the
  same function: bf16 with ``head_dim`` 64 and ``L <= 64`` (the query
  encode's L=30) takes ``csrc/attention_infer.cu`` (a warp per (b, h)
  row, rows padded to 32 or 64, ``mma.sync`` with the row in registers);
  ``64 < L <= 256`` (the passage encode) takes
  ``csrc/attention_infer_d64.cu``; bf16 with ``head_dim`` 32 and
  ``L <= 256`` (the MiniLM-L6 teacher's B=128, L=256) takes
  ``csrc/attention_infer_d32.cu``. Both of those hold a block per
  (b, h), skip key tiles with no real key and keep the row in registers
  (``mma.sync``). The rest takes the tiled forward of
  ``csrc/attention.cu``. Its backward recomputes through the plain
  einsum form, as the reference's backward is XLA recompute.

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
``LAUNCHES`` counts kernel launches by name, ``ENTRY_LAUNCHES`` by the C
entry point they went through, ``ROUTE_LAUNCHES`` by (name, entry point):
K3 and K5 share the tiled forward, and the sm90 forward where a caller
forces K5 onto it (its old route). ``SHAPE_LAUNCHES`` counts
the forwards by (name, entry point, B, L): the length buckets' shapes.
"""
from __future__ import annotations

import ctypes
import math
from collections import Counter
from typing import Optional, Tuple

import torch

from . import _build

NEG_INF = -1e9
HEAD_DIMS = (32, 64)
MAX_LEN = 512
LAUNCHES = {"train_fwd": 0, "train_bwd": 0, "infer": 0}
# the Hopper route's reach: bf16, head_dim 64, rows up to 256
SM90_HEAD_DIM, SM90_MAX_LEN = 64, 256
SHORT_MAX_LEN = 64  # K5's short-row kernel: bf16, head_dim 64, L <= 64
# K5's head_dim-32 kernel: bf16, L <= 256 (the MiniLM-L6 teacher); its
# head_dim-64 kernel takes 64 < L <= SM90_MAX_LEN
D32_HEAD_DIM, D32_MAX_LEN = 32, 256
# K5's own kernels by route: (source stem, C entry point)
_INFER_KERNELS = {"short": ("attention_infer", "attn_infer_short_launch"),
                  "d64": ("attention_infer_d64", "attn_infer_d64_launch"),
                  "d32": ("attention_infer_d32", "attn_infer_d32_launch")}
ENTRY_LAUNCHES = {"attn_fwd_launch": 0, "attn_bwd_launch": 0,
                  "attn_fwd_sm90_launch": 0, "attn_bwd_sm90_launch": 0,
                  "attn_infer_short_launch": 0, "attn_infer_d64_launch": 0,
                  "attn_infer_d32_launch": 0}
# the sm90 forward keeps an ("infer", ...) count: a K5 launch takes it
# only when a caller forces the route (chip_smoke's old-route timings)
ROUTE_LAUNCHES = {(name, entry): 0 for name, entries in (
    ("train_fwd", ("attn_fwd_launch", "attn_fwd_sm90_launch")),
    ("train_bwd", ("attn_bwd_launch", "attn_bwd_sm90_launch")),
    ("infer", ("attn_fwd_launch", "attn_fwd_sm90_launch",
               "attn_infer_short_launch", "attn_infer_d64_launch",
               "attn_infer_d32_launch")))
    for entry in entries}
SHAPE_LAUNCHES: Counter = Counter()

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


def _scalars(dropout_p: float, head_dim: int, dtype) -> Tuple[float, ...]:
    """The launchers' (inv, inv32, scale, scale32): 1/(1-p) and
    1/sqrt(head_dim) rounded to the compute dtype and to fp32."""
    inv, scale = 1.0 / (1.0 - dropout_p), 1.0 / math.sqrt(head_dim)
    return (float(_in_dtype(inv, dtype)),
            float(_in_dtype(inv, torch.float32)),
            float(_in_dtype(scale, dtype)),
            float(_in_dtype(scale, torch.float32)))


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


def residual_ov_plain(q, k, v, mask, seed: int, dropout_p: float,
                      segment_ids=None) -> torch.Tensor:
    """The sm90 forward's second output, ov = sum_k keep * probs * v in
    fp32 [B, L, H, D] (probs in the compute dtype, unscaled): inv32 *
    (g . ov) is the softmax backward's row sum, rowsum(dp * probs), in
    another order."""
    probs = _probs(q, k, mask, segment_ids)
    if dropout_p > 0.0:
        b, lq, h, _ = q.shape
        keep = dropout_keep_mask(b, h, lq, k.shape[1], seed, dropout_p,
                                 q.device)
        probs = torch.where(keep, probs, torch.zeros_like(probs))
    return torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float())


def _ds_plain(q, k, v, mask, seed: int, dropout_p: float, segment_ids,
              g) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4's plain (dS, probs_d), both fp32 [B, H, Lq, Lk]: the softmax
    backward on the pre-dropout probs, dS rounded to the compute dtype."""
    dt = q.dtype
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
    pf = probs.float()
    ds = (pf * (dp - (dp * pf).sum(-1, keepdim=True))).to(dt).float()
    return ds, probs_d.float()


def sm90_bwd_bound(q, k, v, mask, seed: int, dropout_p: float,
                   segment_ids, g, dq, dk) -> Tuple[torch.Tensor, ...]:
    """How far, element by element, the sm90 backward's dq and dk may lie
    from the plain versions ``dq``, ``dk`` (fp32 bounds, their shapes).
    Each dS element may move by one bf16 ulp of itself (2^-7, doubled)
    and by what fp32 dots of 64 terms in another order give its
    (dp - rowsum) (2^-16 of the absolute terms, 4x the 64 * 2^-24 worst
    case), and each output by one ulp: |err| <= scale * (E . |k|) +
    2^-7 * |dq| with E = 2^-6 * |dS| + 2^-16 * probs * (|g| . |v|^T *
    inv32 + inv32 * (|g| . |ov|)), and the same with E^T and |q| for
    dk."""
    ds, _ = _ds_plain(q, k, v, mask, seed, dropout_p, segment_ids, g)
    probs = _probs(q, k, mask, segment_ids).float()
    inv32 = _in_dtype(1.0 / (1.0 - dropout_p), torch.float32).to(q.device)
    ga, va = g.float().abs(), v.float().abs()
    ov = residual_ov_plain(q, k, v, mask, seed, dropout_p, segment_ids)
    terms = (torch.einsum("bqhd,bkhd->bhqk", ga, va)
             + torch.einsum("bqhd,bqhd->bhq", ga, ov.abs())[..., None]
             ) * inv32
    e = 2.0 ** -6 * ds.abs() + 2.0 ** -16 * probs * terms
    scale = 1.0 / math.sqrt(q.shape[-1])
    bq = (scale * torch.einsum("bhqk,bkhd->bqhd", e, k.float().abs())
          + 2.0 ** -7 * dq.float().abs())
    bk = (scale * torch.einsum("bhqk,bqhd->bkhd", e, q.float().abs())
          + 2.0 ** -7 * dk.float().abs())
    return bq, bk


def train_bwd_plain(q, k, v, mask, seed: int, dropout_p: float,
                    segment_ids, g) -> Tuple[torch.Tensor, ...]:
    """K4's plain version: (dq, dk, dv) by the reference kernel's backward
    arithmetic (softmax backward on the pre-dropout probs, in fp32)."""
    dt = q.dtype
    ds, probs_d = _ds_plain(q, k, v, mask, seed, dropout_p, segment_ids, g)
    scale32 = _in_dtype(1.0 / math.sqrt(q.shape[-1]), torch.float32).to(
        q.device)
    dv = torch.einsum("bhqk,bqhd->bkhd", probs_d, g.float())
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


def _kernel_route(dtype, length: int, head_dim: int, name: str) -> str:
    """The CUDA kernels a launch takes, by dtype and shape alone, for bf16
    with head_dim 64: for K5 (``name == "infer"``) "short"
    (``csrc/attention_infer.cu``) with L <= 64 and "d64"
    (``csrc/attention_infer_d64.cu``) with 64 < L <= 256; for K3/K4
    "sm90" (``csrc/attention_sm90.cu``) with L <= 256. For bf16 K5 with
    head_dim 32 and L <= 256: "d32" (``csrc/attention_infer_d32.cu``).
    "tiled" (``csrc/attention.cu``) for everything else: fp32, K3/K4 at
    head_dim 32, 256 < L <= 512."""
    if dtype == torch.bfloat16 and head_dim == SM90_HEAD_DIM:
        if name == "infer" and length <= SHORT_MAX_LEN:
            return "short"
        if length <= SM90_MAX_LEN:
            return "d64" if name == "infer" else "sm90"
    if (dtype == torch.bfloat16 and head_dim == D32_HEAD_DIM
            and name == "infer" and length <= D32_MAX_LEN):
        return "d32"
    return "tiled"


def _aligned(name, *tensors):
    """The Hopper kernels copy 16-byte vectors: every operand starts on a
    16-byte boundary."""
    for t in tensors:
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{name}: operands must be 16-byte aligned")


def _launch_fwd(q, k, v, mask, seed, dropout_p, segment_ids, with_stats,
                name):
    """K3 (K5 as ``name="infer"``): returns (out, res), with res the
    backward's residual (stats, ov) when ``with_stats`` (see
    ``_launch_bwd``), else None."""
    _check(name, q, k, v, mask, segment_ids)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    mask, seg = _i32(mask), _i32(segment_ids)
    b, length, h, d = q.shape
    out = torch.empty_like(q)
    stats = (torch.empty((b, h, length, 2), dtype=torch.float32,
                         device=q.device) if with_stats else None)
    ov = None
    inv, _, scale, _ = _scalars(float(dropout_p), d, q.dtype)
    route = _kernel_route(q.dtype, length, d, name)
    if route in _INFER_KERNELS:  # K5 only: p=0, no segments, no residual
        _aligned(name, q, k, v, out)
        stem, entry = _INFER_KERNELS[route]
        _build.launch(
            stem, entry,
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_float],
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
            out.data_ptr(), b, length, h, scale, device=q.device)
    elif route == "sm90":
        if with_stats:
            ov = torch.empty(q.shape, dtype=torch.float32, device=q.device)
        _aligned(name, q, k, v, out, ov)
        entry = "attn_fwd_sm90_launch"
        _build.launch(
            "attention_sm90", entry,
            [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
            + [ctypes.c_float] * 3,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
            _ptr(seg), out.data_ptr(), _ptr(stats), _ptr(ov), b, length, h,
            _seed32(seed), float(dropout_p), inv, scale, device=q.device)
    else:
        entry = "attn_fwd_launch"
        _build.launch(
            "attention", entry,
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
            + [ctypes.c_float] * 3,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
            _ptr(seg), out.data_ptr(), _ptr(stats),
            _build.dtype_code(q.dtype), b, length, h, d, _seed32(seed),
            float(dropout_p), inv, scale, device=q.device)
    LAUNCHES[name] += 1
    ENTRY_LAUNCHES[entry] += 1
    ROUTE_LAUNCHES[(name, entry)] += 1
    SHAPE_LAUNCHES[(name, entry, b, length)] += 1
    return out, (None if stats is None else (stats, ov))


def _launch_bwd(q, k, v, mask, seed, dropout_p, segment_ids, res, g):
    """K4: (dq, dk, dv) from the forward's residual ``res`` = (stats, ov):
    the rows' (max, sum) [B, H, L, 2] and, from the sm90 forward,
    ov = sum_k keep * probs * v [B, L, H, D] fp32, whose dot with g is
    the softmax backward's row sum (None from the tiled forward)."""
    stats, ov = res
    _check("train_bwd", q, k, v, mask, segment_ids, g)
    q, k, v, g = (t.contiguous() for t in (q, k, v, g))
    mask, seg = _i32(mask), _i32(segment_ids)
    b, length, h, d = q.shape
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    inv, inv32, scale, scale32 = _scalars(float(dropout_p), d, q.dtype)
    if _kernel_route(q.dtype, length, d, "train_bwd") == "sm90":
        if (ov is None or ov.shape != q.shape or ov.dtype != torch.float32
                or not ov.is_contiguous()):
            raise ValueError("train_bwd: the sm90 kernels need the sm90 "
                             "forward's residual")
        _aligned("train_bwd", q, k, v, g, ov, dq, dk, dv)
        entry = "attn_bwd_sm90_launch"
        _build.launch(
            "attention_sm90", entry,
            [ctypes.c_void_p] * 11 + [ctypes.c_int] * 4
            + [ctypes.c_float] * 5,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
            _ptr(seg), g.data_ptr(), ov.data_ptr(), stats.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, length, h,
            _seed32(seed), float(dropout_p), inv, inv32, scale, scale32,
            device=q.device)
    else:
        dsum = torch.empty((b, h, length), dtype=torch.float32,
                           device=q.device)
        entry = "attn_bwd_launch"
        _build.launch(
            "attention", entry,
            [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6
            + [ctypes.c_float] * 5,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
            _ptr(seg), g.data_ptr(), stats.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), dsum.data_ptr(),
            _build.dtype_code(q.dtype), b, length, h, d, _seed32(seed),
            float(dropout_p), inv, inv32, scale, scale32, device=q.device)
    LAUNCHES["train_bwd"] += 1
    ENTRY_LAUNCHES[entry] += 1
    ROUTE_LAUNCHES[("train_bwd", entry)] += 1
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
            out, res = train_fwd_plain(q, k, v, mask, seed, dropout_p,
                                       segment_ids), (None, None)
        else:
            out, res = _launch_fwd(q, k, v, mask, seed, dropout_p,
                                   segment_ids, True, "train_fwd")
        ctx.save_for_backward(q, k, v, mask, segment_ids, *res)
        ctx.seed, ctx.dropout_p = seed, dropout_p
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, mask, segment_ids, stats, ov = ctx.saved_tensors
        if stats is None:
            grads = train_bwd_plain(q, k, v, mask, ctx.seed, ctx.dropout_p,
                                    segment_ids, g)
        else:
            grads = _launch_bwd(q, k, v, mask, ctx.seed, ctx.dropout_p,
                                segment_ids, (stats, ov), g)
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
