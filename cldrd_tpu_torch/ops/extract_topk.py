"""K1: fused scores plus two-level in-block top-m extraction.

Replaces the TPU kernel ``cldrd_tpu/search/mips.py::_extract_kernel_factory``
(launched by ``_binmax_segment_extract``), the production path of exact
search. The CUDA kernel is ``csrc/extract_topk.cu``; on an H100 it is bound
by its tensor-core operations (2*B*N*D), about 7.0 ms at B=512 over the
8,847,360-row int8 store, and its design keeps the ``[B, N]`` scores out of
device memory (see the note there). ``extract_topk_plain`` is the plain
PyTorch version: the CPU path, and what the kernel is held to on the card.

For each 2048-row super-block and query, with R level-1 rounds and R2
level-2 rounds:

- level 1: each bin of ``bin_rows`` rows (a power of two from 8 to 256,
  as the extract route admits) gives R-1 (value, position) candidates by
  rounds of max, lowest-row argmax among equal values, and mask; the R-th
  round's max is the bin's remainder bound, max-reduced over the
  super-block (``rem1``);
- level 2: the super-block's candidates give their top-R2 by rounds of
  max, lowest-position argmax among equal values, and mask of every
  candidate at that position.

Outputs are B-major: ``sup_v``/``sup_p`` ``[B, nsup, R2]`` and ``rem1``
``[B, nsup]`` (the TPU kernel's ``[nsup, R2, B]`` and ``[nsup, 8, B]``
transposed, without the 8-row pad). Positions are segment-local rows.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build
from .fused_binmax import block_scores

LAUNCHES = 0  # kernel launches through extract_topk()

SUPER_ROWS = 2048
NEG_INF = float("-inf")
_BIG = 2147483647
_PLAIN_CHUNK_SUPERS = 128  # super-blocks scored at once by the plain version


def extract_topk_plain(queries, corpus, row_ids, rounds: int, rounds2: int,
                       bin_rows: int = 128, scales=None):
    """The plain PyTorch version of ``extract_topk`` (same outputs), scoring
    ``_PLAIN_CHUNK_SUPERS`` super-blocks at a time."""
    bz = queries.shape[0]
    n = corpus.shape[0]
    nsup = n // SUPER_ROWS
    bins = SUPER_ROWS // bin_rows
    m = rounds - 1
    dev = queries.device
    out_v = torch.empty((bz, nsup, rounds2), dtype=torch.float32, device=dev)
    out_p = torch.empty((bz, nsup, rounds2), dtype=torch.int32, device=dev)
    out_r = torch.empty((bz, nsup), dtype=torch.float32, device=dev)
    lane = torch.arange(bin_rows, dtype=torch.int32, device=dev)
    for s0 in range(0, nsup, _PLAIN_CHUNK_SUPERS):
        s1 = min(nsup, s0 + _PLAIN_CHUNK_SUPERS)
        ns = s1 - s0
        r0, r1 = s0 * SUPER_ROWS, s1 * SUPER_ROWS
        s = block_scores(queries, corpus[r0:r1],
                         None if scales is None else scales[r0:r1])
        s = torch.where(row_ids[None, r0:r1] >= 0, s, NEG_INF)
        s = s.view(bz, ns * bins, bin_rows)
        base = (r0 + torch.arange(ns * bins, device=dev, dtype=torch.int32)
                * bin_rows)
        vs, ps = [], []
        for r in range(rounds):
            mx = s.amax(-1)  # [B, nb]
            if r == m:
                rem = mx
                break
            am = torch.where(s == mx[..., None], lane, bin_rows).amin(-1)
            vs.append(mx)
            ps.append(base + am)
            s = torch.where(lane == am[..., None], NEG_INF, s)
        cv = torch.stack(vs, -1).reshape(bz, ns, bins * m)
        cp = torch.stack(ps, -1).reshape(bz, ns, bins * m)
        for r in range(rounds2):
            mx = cv.amax(-1)  # [B, ns]
            px = torch.where(cv == mx[..., None], cp, _BIG).amin(-1)
            out_v[:, s0:s1, r] = mx
            out_p[:, s0:s1, r] = px
            cv = torch.where(cp == px[..., None], NEG_INF, cv)
        out_r[:, s0:s1] = rem.view(bz, ns, bins).amax(-1)
    return out_v, out_p, out_r


def extract_topk(queries: torch.Tensor, corpus: torch.Tensor,
                 row_ids: torch.Tensor, rounds: int, rounds2: int,
                 bin_rows: int = 128, scales: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(sup_v [B, nsup, rounds2] f32, sup_p [B, nsup, rounds2] i32,
    rem1 [B, nsup] f32) for a corpus of nsup*2048 rows.

    CPU tensors take ``extract_topk_plain``; CUDA tensors launch the
    kernel, or raise on a shape or dtype it does not take."""
    if queries.device.type == "cpu":
        return extract_topk_plain(queries, corpus, row_ids, rounds, rounds2,
                                  bin_rows, scales)
    if queries.device.type != "cuda":
        raise ValueError(f"extract_topk: no route for {queries.device}")
    _build.check_search_operands("extract_topk", queries, corpus, row_ids,
                                 scales)
    bz, d = queries.shape
    n = corpus.shape[0]
    if n % SUPER_ROWS or n == 0:
        raise ValueError(f"extract_topk: N={n} must be a positive multiple "
                         f"of {SUPER_ROWS}")
    if bz % 64 or bz == 0:
        raise ValueError(f"extract_topk: batch {bz} must be a multiple of 64")
    if bin_rows not in (8, 16, 32, 64, 128, 256) or (bz > 512
                                                     and bin_rows > 128):
        raise ValueError(f"extract_topk: bin_rows={bin_rows} (powers of two "
                         "8..256, 8..128 above batch 512)")
    if not 2 <= rounds <= 7 or not 1 <= rounds2 <= 16:
        raise ValueError(f"extract_topk: rounds={rounds} (2..7), "
                         f"rounds2={rounds2} (1..16)")
    nsup = n // SUPER_ROWS
    dev = queries.device
    out_v = torch.empty((bz, nsup, rounds2), dtype=torch.float32, device=dev)
    out_p = torch.empty((bz, nsup, rounds2), dtype=torch.int32, device=dev)
    out_r = torch.empty((bz, nsup), dtype=torch.float32, device=dev)
    _build.launch(
        "extract_topk", "extract_topk_launch",
        [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, ctypes.c_int],
        queries.data_ptr(), _build.dtype_code(queries.dtype),
        corpus.data_ptr(), _build.dtype_code(corpus.dtype),
        row_ids.data_ptr(), None if scales is None else scales.data_ptr(),
        out_v.data_ptr(), out_p.data_ptr(), out_r.data_ptr(), bz, nsup, d,
        rounds, rounds2, bin_rows, device=dev)
    global LAUNCHES
    LAUNCHES += 1
    return out_v, out_p, out_r
