"""K7: the maximum score of every store tile for every query.

Replaces the TPU kernel ``examples/bench_int8_dot.py::make_kernel``
(``:37``, launched by ``bench`` at ``:86``): the A/B that asks whether the
int8 store's score product runs at the int8 matrix rate. ``out[i, b]`` is
the maximum over the rows ``r`` of tile ``i`` (``tile_rows`` rows) of
``dot(corpus[r], queries[b])``, fp32 ``[N // tile_rows, B]``; no ids, mask
or row scale, as the TPU kernel has none. Three variants, picked by
``kernel_route`` from the dtypes alone:

- ``bf16``: bf16 queries x bf16 store, fp32 accumulation;
- ``int8_cast``: bf16 queries x int8 store, widened to bf16 in the kernel;
- ``int8_native``: int8 x int8, int32 accumulation, cast to fp32.

All three run ``csrc/int8_dot_sm90.cu`` (wgmma fed by TMA: m64n128k16 in
bf16, m64n128k32 s8 x s8 for the native variant). On an H100 each is bound
by its products at the A/B's shape (N = 1,114,112, D = 768, B = 512):
0.886 ms at the bf16 rate, 0.443 ms at the int8 rate for the native one.
``tile_max_scores_plain`` is the plain PyTorch version: the CPU path, and
what the kernel is held to on the card. No path of the port launches K7;
``chip_smoke.py`` runs it in its kernels phase.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

LAUNCHES = 0  # kernel launches through tile_max_scores()
# launches by C entry point
ENTRY_LAUNCHES = {"int8_dot_sm90_launch": 0}
# the CUDA function each variant launches once a call, as a trace names it
KERNEL_NAMES = {"bf16": "int8_dot_sm90_kernel<0>",
                "int8_cast": "int8_dot_sm90_kernel<1>",
                "int8_native": "int8_dot_sm90_kernel<2>"}
ROUTES = {(torch.bfloat16, torch.bfloat16): "bf16",
          (torch.bfloat16, torch.int8): "int8_cast",
          (torch.int8, torch.int8): "int8_native"}
MIN_DIM, MAX_DIM = 128, 768
QUERY_BLOCK = 128  # B and tile_rows are multiples of it
# the plain version scores at most this many rows at once (bounds the
# fp32 widening of a large store)
_PLAIN_CHUNK_ROWS = 262_144


def kernel_route(q_dtype, c_dtype) -> str:
    """The variant a launch takes, by the operand dtypes alone: "bf16"
    (bf16 x bf16), "int8_cast" (bf16 queries x int8 store) or
    "int8_native" (int8 x int8). Raises on any other pair."""
    route = ROUTES.get((q_dtype, c_dtype))
    if route is None:
        raise TypeError(f"tile_max_scores: no variant for {q_dtype} queries "
                        f"x {c_dtype} store")
    return route


def tile_max_scores_plain(queries: torch.Tensor, corpus: torch.Tensor,
                          tile_rows: int) -> torch.Tensor:
    """[B, D] x [N, D] -> [N // tile_rows, B] fp32: each tile's maximum
    score, with both operands widened to fp32 and one fp32 matmul per
    chunk of whole tiles, at most ``_PLAIN_CHUNK_ROWS`` rows (or one tile,
    if a tile is larger).

    Exact for every variant's operands: bf16 values and int8 codes are
    exact in fp32, a bf16 x bf16 or int8 x int8 product is exact in fp32,
    and the native variant's sums are integers of at most 128 * 128 * 768
    = 12,582,912 < 2^24 in magnitude, so fp32 holds every partial sum
    exactly whatever the order. On other bf16 data only the order of the
    fp32 sums differs from the kernel's."""
    bz, n = queries.shape[0], corpus.shape[0]
    chunk = max(tile_rows, _PLAIN_CHUNK_ROWS // tile_rows * tile_rows)
    qf = queries.float()
    out = torch.empty((n // tile_rows, bz), dtype=torch.float32,
                      device=queries.device)
    for r0 in range(0, n, chunk):
        r1 = min(n, r0 + chunk)
        s = corpus[r0:r1].float() @ qf.T
        out[r0 // tile_rows:r1 // tile_rows] = s.view(
            -1, tile_rows, bz).amax(1)
    return out


def check_operands(queries, corpus, tile_rows):
    """What the kernel takes, checked before any pointer reaches it."""
    kernel_route(queries.dtype, corpus.dtype)
    if corpus.device != queries.device:
        raise ValueError(f"tile_max_scores: corpus on {corpus.device}, "
                         f"queries on {queries.device}")
    for name, t in (("queries", queries), ("corpus", corpus)):
        if t.dim() != 2 or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"tile_max_scores: {name} must be a contiguous,"
                             " 16-byte aligned 2-D tensor")
    (bz, d), (n, d2) = queries.shape, corpus.shape
    if d != d2 or d % 64 or not MIN_DIM <= d <= MAX_DIM:
        raise ValueError(f"tile_max_scores: dims {d} vs {d2} (must match and "
                         f"be a multiple of 64 from {MIN_DIM} to {MAX_DIM})")
    if bz == 0 or bz % QUERY_BLOCK:
        raise ValueError(f"tile_max_scores: B={bz} (a positive multiple of "
                         f"{QUERY_BLOCK})")
    if tile_rows <= 0 or tile_rows % QUERY_BLOCK or n % tile_rows:
        raise ValueError(f"tile_max_scores: tile_rows={tile_rows} must be a "
                         f"multiple of {QUERY_BLOCK} dividing N={n}")
    if n >= 2**31:
        raise ValueError(f"tile_max_scores: N={n} rows (the tensor maps "
                         "take fewer than 2^31)")


def tile_max_scores(queries: torch.Tensor, corpus: torch.Tensor,
                    tile_rows: int) -> torch.Tensor:
    """[N // tile_rows, B] fp32: ``out[i, b]`` is the maximum over tile
    ``i``'s rows of ``dot(corpus[r], queries[b])``.

    CPU tensors take ``tile_max_scores_plain``; CUDA tensors launch the
    variant ``kernel_route`` names, or raise on what it does not take:
    another dtype pair, B not a multiple of 128, D not a multiple of 64 in
    128-768, ``tile_rows`` not a multiple of 128 dividing N, N >= 2^31."""
    if queries.device.type == "cpu":
        return tile_max_scores_plain(queries, corpus, tile_rows)
    if queries.device.type != "cuda":
        raise ValueError(f"tile_max_scores: no route for {queries.device}")
    check_operands(queries, corpus, tile_rows)
    bz, d = queries.shape
    n = corpus.shape[0]
    out = torch.empty((n // tile_rows, bz), dtype=torch.float32,
                      device=queries.device)
    entry = "int8_dot_sm90_launch"
    _build.launch(
        "int8_dot_sm90", entry,
        [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
         ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
         ctypes.c_int],
        queries.data_ptr(), _build.dtype_code(queries.dtype),
        corpus.data_ptr(), _build.dtype_code(corpus.dtype), out.data_ptr(),
        bz, n, d, tile_rows, device=queries.device)
    ENTRY_LAUNCHES[entry] += 1
    global LAUNCHES
    LAUNCHES += 1
    return out
