"""K6: IVF probe-and-score.

Replaces the TPU kernels ``cldrd_tpu/ops/ivf_probe.py::_kernel_plain`` and
``::_kernel_scaled`` (launched by ``probe_scores``). For every (query b,
probe p) the fp32 scores of the ``slot`` rows of bucket ``probe[b, p]`` of
a row-layout store ``[nb * slot, D]`` against ``q[b]``, times the per-row
scale of an int8 store. The CUDA kernel is ``csrc/ivf_probe.cu``; its
bound on an H100 is the probed rows, read once (see the note there).
``probe_scores_plain`` is the plain PyTorch version of the same function:
the CPU path, and what the kernel is held to on the card.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

LAUNCHES = 0  # kernel launches through probe_scores()

# the plain version widens at most this many gathered elements at once
_PLAIN_CHUNK_ELEMS = 1 << 28


def _check(q, buckets_rows, probe, bucket_scales, slot: int):
    """The operands both versions take: bf16/fp32 queries, a bf16 or int8
    store of whole buckets, int32 probes and fp32 ``[nb, slot]`` scales
    (``None`` or ``[nb, 0]`` for none). Returns the scales to use."""
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"probe_scores: query dtype {q.dtype}")
    if buckets_rows.dtype not in (torch.bfloat16, torch.int8):
        raise TypeError(f"probe_scores: store dtype {buckets_rows.dtype} "
                        "(the kernel takes bf16 rows or int8 codes)")
    if probe.dtype != torch.int32 or probe.dim() != 2 \
            or probe.shape[0] != q.shape[0]:
        raise ValueError("probe_scores: probe must be int32 [B, P]")
    n, d = buckets_rows.shape
    if slot <= 0 or n % slot or q.shape[1] != d:
        raise ValueError(f"probe_scores: store [{n}, {d}] is not whole "
                         f"buckets of {slot} rows of the queries' width "
                         f"{q.shape[1]}")
    if bucket_scales is not None and bucket_scales.shape[1] == 0:
        bucket_scales = None
    if bucket_scales is not None and (
            bucket_scales.dtype != torch.float32
            or tuple(bucket_scales.shape) != (n // slot, slot)):
        raise ValueError("probe_scores: scales must be float32 [nb, slot]")
    return bucket_scales


def gather_scores(q: torch.Tensor, buckets_rows: torch.Tensor,
                  probe: torch.Tensor,
                  bucket_scales: Optional[torch.Tensor], slot: int
                  ) -> torch.Tensor:
    """``[B, P * slot]`` fp32 by row gather: both operands widened to fp32,
    one fp32 matmul per query, the scale (``[nb, slot]`` or ``None``)
    multiplied after the dot. Any store dtype; the query is taken as it
    is. Widening is exact: bf16 values, int8 codes and bf16 x bf16
    products are all exact in fp32. Gathers a bounded number of rows at a
    time."""
    b, d = q.shape
    p = probe.shape[1]
    qf = q.float()
    pr = probe.long()
    lane = torch.arange(slot, device=q.device)
    out = torch.empty((b, p * slot), dtype=torch.float32, device=q.device)
    step = max(1, _PLAIN_CHUNK_ELEMS // max(1, p * slot * d))
    for b0 in range(0, b, step):
        b1 = min(b, b0 + step)
        rowix = (pr[b0:b1, :, None] * slot + lane).reshape(b1 - b0, p * slot)
        cand = buckets_rows[rowix].float()              # [b, P*slot, D]
        s = torch.bmm(cand, qf[b0:b1, :, None])[..., 0]
        if bucket_scales is not None:
            s = s * bucket_scales[pr[b0:b1]].reshape(b1 - b0, p * slot)
        out[b0:b1] = s
    return out


def probe_scores_plain(q: torch.Tensor, buckets_rows: torch.Tensor,
                       probe: torch.Tensor,
                       bucket_scales: Optional[torch.Tensor] = None, *,
                       slot: int) -> torch.Tensor:
    """The plain version of ``probe_scores`` (``probe_scores_reference``):
    ``gather_scores`` of the query rounded to bf16, as the kernels take it
    (for a bf16 query that changes nothing)."""
    bucket_scales = _check(q, buckets_rows, probe, bucket_scales, slot)
    return gather_scores(q.to(torch.bfloat16), buckets_rows, probe,
                         bucket_scales, slot)


def probe_scores(q: torch.Tensor, buckets_rows: torch.Tensor,
                 probe: torch.Tensor,
                 bucket_scales: Optional[torch.Tensor] = None, *,
                 slot: int) -> torch.Tensor:
    """Scores ``[B, P * slot]`` fp32 of every row of the probed buckets.

    q ``[B, D]`` (bf16 or fp32; taken in bf16), buckets_rows ``[nb * slot,
    D]`` (bucket j = rows ``j*slot:(j+1)*slot``; bf16 or int8), probe
    ``[B, P]`` int32 bucket indices (repeats allowed), bucket_scales
    ``[nb, slot]`` fp32 or ``None``. CPU tensors take
    ``probe_scores_plain``; CUDA tensors launch the kernel, or raise on an
    operand it does not take."""
    if q.device.type == "cpu":
        return probe_scores_plain(q, buckets_rows, probe, bucket_scales,
                                  slot=slot)
    if q.device.type != "cuda":
        raise ValueError(f"probe_scores: no route for {q.device}")
    bucket_scales = _check(q, buckets_rows, probe, bucket_scales, slot)
    operands = [("q", q), ("buckets_rows", buckets_rows), ("probe", probe)]
    if bucket_scales is not None:
        operands.append(("bucket_scales", bucket_scales))
    for name, t in operands:
        if t.device != q.device:
            raise ValueError(f"probe_scores: {name} on {t.device}, queries "
                             f"on {q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"probe_scores: {name} must be contiguous and "
                             "16-byte aligned")
    b, d = q.shape
    p = probe.shape[1]
    if d % 16 or d > 1024:
        raise ValueError(f"probe_scores: D={d} (the kernel takes a multiple "
                         "of 16 up to 1024)")
    out = torch.empty((b, p * slot), dtype=torch.float32, device=q.device)
    if b == 0 or p == 0:
        return out
    _build.launch(
        "ivf_probe", "ivf_probe_launch",
        [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int],
        q.data_ptr(), _build.dtype_code(q.dtype),
        buckets_rows.data_ptr(), _build.dtype_code(buckets_rows.dtype),
        probe.data_ptr(),
        None if bucket_scales is None else bucket_scales.data_ptr(),
        out.data_ptr(), b, p, buckets_rows.shape[0] // slot, slot, d,
        device=q.device)
    global LAUNCHES
    LAUNCHES += 1
    return out
