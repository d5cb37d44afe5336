"""The yardstick's arithmetic: the card's peaks, the least time a kernel
could take, the bytes and operations of the port's kernels at a shape,
and the FLOPs of an encoder call and of a training step.

Copied, not imported, so that a change to the program cannot move the
yardstick:

- ``PEAK_BYTES``, ``PEAK_OPS``, ``bound_ms``, ``k1_bytes_ops``: from
  ``chip_smoke.py:279-280``, ``:416-434``;
- ``attn_bytes_ops``: ``chip_smoke.py:1118-1134`` (``_attn_bytes_ops``);
- ``kernel_class``: ``chip_smoke.py:2196-2208`` (``_kernel_class``);
- ``super_rounds``: ``cldrd_tpu_torch/search/mips.py:189-201``
  (``_super_rounds``, with ``_SUPER_ROWS`` and ``_SUPER_ROUNDS`` of
  ``:150-151``), which sets how many level-2 candidates K1 writes;
- ``train_step_flops_dense``: ``bench_train.py:39-63``
  (``train_step_flops``), kept as it was; ``encoder_fwd_flops`` counts the
  same terms but gives the ``cls_only`` final block (one query row, one
  FFN row) what it computes, and ``seq_fwd_flops`` counts them at each
  text's real length, the model FLOPs the MFU metrics read.

Peaks: one NVIDIA H100 SXM5 80GB, NVIDIA's H100 Tensor Core GPU data
sheet, dense rates without sparsity, at its 700 W limit: 989 TFLOP/s
bf16, 1,979 TOP/s int8, 67 TFLOP/s fp32 outside the tensor cores,
3.35 TB/s of HBM3.
"""
from __future__ import annotations

import math
from typing import Tuple

PEAK_BYTES = 3.35e12
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "fp32": 67e12}

ITEM_BYTES = {"int8": 1, "bf16": 2, "fp16": 2, "fp32": 4}

SUPER_ROWS = 2048
SUPER_ROUNDS = 16


def bound_ms(nbytes: float, ops: float, op_type: str) -> Tuple[float, str]:
    """The least milliseconds a kernel can take: the larger of its bytes at
    the HBM rate and its operations at the type's peak, and which one."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = ops / PEAK_OPS[op_type] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def super_rounds(n: int, nsup: int, bz: int, k: int) -> int:
    """Level-2 rounds K1 emits for an n-row store (a multiple of 8)."""
    lam = k * SUPER_ROWS / n
    for r2 in range(8, SUPER_ROUNDS, 8):
        if r2 * nsup < k:
            continue
        tail = 1.0 - math.exp(-lam) * sum(
            lam ** i / math.factorial(i) for i in range(r2))
        if tail * nsup * bz <= 5e-4:
            return r2
    return SUPER_ROUNDS


def k1_bytes_ops(bz: int, n: int, d: int, c_dtype: str, q_dtype: str,
                 rounds2: int, scaled: bool) -> Tuple[float, float]:
    """K1 (``extract_topk``): the store, its ids and scales, the queries
    read once; the level-2 candidates (value and position) and the bin
    bounds written once."""
    nsup = n // SUPER_ROWS
    nbytes = (n * d * ITEM_BYTES[c_dtype] + 4 * n + (4 * n if scaled else 0)
              + bz * d * ITEM_BYTES[q_dtype]
              + 2 * bz * nsup * rounds2 * 4 + bz * nsup * 4)
    return nbytes, 2.0 * bz * n * d


def attn_bytes_ops(b: int, length: int, dtype: str, n_tensors: int,
                   n_dots: int, n_int: int = 1, heads: int = 12,
                   head_dim: int = 64, keys=None) -> Tuple[float, float]:
    """One attention launch: each [B, L, H, D] operand and each int32
    [B, L] mask row read or written once, and ``n_dots`` products of
    2*B*H*L*L*D. Given ``keys``, the unmasked keys over the batch (K5: a
    masked key's weight is exactly 0), K and V count those rows only and
    each product 2*H*L*keys*D. K3: 4 tensors, 2 products; K4: 7 and 5."""
    row = heads * head_dim * ITEM_BYTES[dtype]
    if keys is None:
        keys, n_kv = b * length, 0
    else:
        n_kv = 2
    nbytes = ((n_tensors - n_kv) * b * length * row + n_kv * keys * row
              + 4 * n_int * b * length)
    return nbytes, n_dots * 2.0 * heads * length * keys * head_dim


def kernel_class(name: str) -> str:
    """A device operation's class, by its kernel name."""
    if "attn_fwd" in name or "attn_infer" in name:
        return "attention forward (K3/K5)"
    if "attn_bwd" in name:
        return "attention backward (K4)"
    low = name.lower()
    if "memcpy" in low or "memset" in low:
        return "copies to and from the host, memsets"
    if any(k in low for k in ("gemm", "xmma", "cutlass", "nvjet", "wgmma")):
        return "matmul (cuBLAS)"
    if any(k in low for k in ("adam", "multi_tensor", "foreach")):
        return "optimizer"
    if "nccl" in low:
        return "collectives (NCCL)"
    if "extract_topk" in low or "binmax" in low or "ivf_probe" in low:
        return "search kernels (K1/K2/K6)"
    return ELEMENTWISE


ELEMENTWISE = "other (elementwise, norms, reductions, copies)"


# ---------------------------------------------------------------- FLOPs


def train_step_flops_dense(dim: int, hidden_dim: int, n_layers: int,
                           bz: int, nway: int, lq: int, lp: int) -> float:
    """``bench_train.py::train_step_flops`` (remat off), every position of
    every block counted: forward + backward (2x forward)."""

    def encoder_flops(n_seq, length):
        tokens = n_seq * length
        matmul = 2.0 * tokens * (4 * dim * dim + 2 * dim * hidden_dim) \
            * n_layers
        attn = 2.0 * 2 * tokens * length * dim * n_layers
        return (matmul + attn) * 3.0

    return encoder_flops(bz, lq) + encoder_flops(bz * nway, lp)


def encoder_fwd_flops(n_seq: int, length: int, dim: int, hidden_dim: int,
                      n_layers: int, cls_only: bool = True) -> float:
    """Forward FLOPs of ``n_seq`` rows of ``length`` tokens (padding
    included, as the dense products compute it): q, k, v, out and the two
    FFN products, and the scores and weighted sum of attention. With
    ``cls_only`` the last block computes q, out, the FFN and attention for
    position 0 only, as the port's encoder does for a CLS embedding."""
    full = 2.0 * length * (4 * dim * dim + 2 * dim * hidden_dim) \
        + 2.0 * 2 * length * length * dim
    if not cls_only:
        return n_seq * full * n_layers
    last = (2.0 * length * 2 * dim * dim          # k and v over every row
            + 2.0 * (2 * dim * dim + 2 * dim * hidden_dim)  # q, out, FFN
            + 2.0 * 2 * length * dim)             # one query row's attention
    return n_seq * (full * (n_layers - 1) + last)


def seq_fwd_flops(lengths, dim: int, hidden_dim: int, n_layers: int
                  ) -> float:
    """Forward FLOPs of sequences of the given real token counts, each
    computed at its own length (the model's work, padding left out), the
    last block for position 0 only."""
    import numpy as np

    n = np.asarray(lengths, dtype=np.float64)
    full = 2.0 * n * (4 * dim * dim + 2 * dim * hidden_dim) \
        + 4.0 * n * n * dim
    last = (4.0 * n * dim * dim + 2.0 * (2 * dim * dim + 2 * dim * hidden_dim)
            + 4.0 * n * dim)
    return float((full * (n_layers - 1) + last).sum())


def pct(part: float, whole: float):
    """100 * part / whole, or None where there is nothing to divide."""
    if not whole or part is None:
        return None
    return 100.0 * part / whole
