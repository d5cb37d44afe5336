"""K2: masked fp32 scores plus per-bin maxima in one pass.

Replaces the TPU kernel ``cldrd_tpu/search/mips.py::_fused_kernel_factory``
(launched by ``_scores_and_binmax``). The CUDA kernel is
``csrc/fused_binmax.cu``; its bound on an H100 is the ``[B, N]`` fp32 score
write (see the note there). ``fused_binmax_plain`` is the plain PyTorch
version of the same function: the CPU path, and what the kernel is held
to on the card.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build

LAUNCHES = 0  # kernel launches through fused_binmax()

NEG_INF = float("-inf")
# plain versions score at most this many rows at once (bounds the fp32
# widening of a large store)
_PLAIN_CHUNK_ROWS = 262_144


def block_scores(queries: torch.Tensor, corpus_blk: torch.Tensor,
                 blk_scales: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B, D] x [n, D] -> [B, n] fp32 scores with fp32 accumulation.

    Both operands widen to fp32 before one fp32 matmul: bf16 values and
    int8 codes are exact in fp32, and bf16 x bf16 products are exact in
    fp32, so this is the reference's bf16 dot with fp32 accumulation
    (``preferred_element_type=float32``). The per-row scale of an int8
    store multiplies after the dot."""
    s = queries.float() @ corpus_blk.float().T
    if blk_scales is not None:
        s = s * blk_scales[None, :]
    return s


def fused_binmax_plain(queries, corpus, row_ids, bin_rows: int,
                       scales=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scores [B, N] fp32 masked, bin maxima [B, N // bin_rows] fp32),
    scored ``_PLAIN_CHUNK_ROWS`` rows at a time."""
    bz, n = queries.shape[0], corpus.shape[0]
    scores = torch.empty((bz, n), dtype=torch.float32, device=queries.device)
    for r0 in range(0, n, _PLAIN_CHUNK_ROWS):
        r1 = min(n, r0 + _PLAIN_CHUNK_ROWS)
        s = block_scores(queries, corpus[r0:r1],
                         None if scales is None else scales[r0:r1])
        scores[:, r0:r1] = torch.where(row_ids[None, r0:r1] >= 0, s, NEG_INF)
    return scores, scores.view(bz, n // bin_rows, bin_rows).amax(-1)


def fused_binmax(queries: torch.Tensor, corpus: torch.Tensor,
                 row_ids: torch.Tensor, bin_rows: int,
                 scales: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scores [B, N] fp32 masked, bin maxima [B, N // bin_rows] fp32).

    CPU tensors take ``fused_binmax_plain``; CUDA tensors launch the
    kernel, or raise on a shape or dtype it does not take."""
    if queries.device.type == "cpu":
        return fused_binmax_plain(queries, corpus, row_ids, bin_rows, scales)
    if queries.device.type != "cuda":
        raise ValueError(f"fused_binmax: no route for {queries.device}")
    _build.check_search_operands("fused_binmax", queries, corpus, row_ids,
                                 scales)
    bz, d = queries.shape
    n = corpus.shape[0]
    if bin_rows not in (8, 16, 32, 64, 128) or n % bin_rows:
        raise ValueError(f"fused_binmax: bin_rows={bin_rows} must be a "
                         f"power of two in [8, 128] dividing N={n}")
    dev = queries.device
    out_s = torch.empty((bz, n), dtype=torch.float32, device=dev)
    out_b = torch.empty((bz, n // bin_rows), dtype=torch.float32, device=dev)
    _build.launch(
        "fused_binmax", "fused_binmax_launch",
        [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int],
        queries.data_ptr(), _build.dtype_code(queries.dtype),
        corpus.data_ptr(), _build.dtype_code(corpus.dtype),
        row_ids.data_ptr(), None if scales is None else scales.data_ptr(),
        out_s.data_ptr(), out_b.data_ptr(), bz, n, d, bin_rows, device=dev)
    global LAUNCHES
    LAUNCHES += 1
    return out_s, out_b
