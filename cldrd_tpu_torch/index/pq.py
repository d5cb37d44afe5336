"""Product quantization, the storage layer of the IVFPQ tier (port of
``cldrd_tpu/index/pq.py``).

PQ splits each vector into ``m`` sub-vectors and stores one codebook index
per sub-vector: ``m * bits / 8`` bytes a row. Codes quantize RESIDUALS
(x - coarse centroid), FAISS ``IndexIVFPQ`` semantics: the coarse matmul
already gives ``q . centroid`` for every probed bucket, so the search adds
it back and the codebooks carry only within-cell structure. Training runs
one ``kmeans`` per sub-space; search scores codes through per-query lookup
tables (``pq_lut``), gathered per sub-space (``pq_scores_from_codes``).
Search scores equal ``q . (centroid + decode(codes))`` up to fp32 sum
order.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from cldrd_tpu_torch.device import DeviceLike, resolve_device

from .kmeans import kmeans


def train_pq(x: np.ndarray, m: int, n_codes: int = 16, iters: int = 15,
             seed: int = 0, device: DeviceLike = None) -> np.ndarray:
    """Train ``m`` independent sub-quantizers -> codebooks [m, n_codes,
    D/m] fp32 (one Lloyd's per sub-space). ``n_codes`` is 2**bits."""
    x = np.asarray(x, np.float32)
    n, d = x.shape
    if d % m:
        raise ValueError(f"dim {d} is not divisible by pq_m={m}")
    if n < n_codes:
        raise ValueError(f"need >= n_codes ({n_codes}) training rows, got {n}")
    dsub = d // m
    out = np.empty((m, n_codes, dsub), np.float32)
    for j in range(m):
        out[j] = kmeans(x[:, j * dsub:(j + 1) * dsub], n_codes, iters=iters,
                        seed=seed * 131 + j, device=device)
    return out


def encode_pq(x: np.ndarray, codebooks: np.ndarray, block: int = 16384,
              chunk_rows: int = 1_048_576,
              device: DeviceLike = None) -> np.ndarray:
    """Nearest-codeword codes for every row -> uint8 [N, m]. Rows go to the
    device ``chunk_rows`` at a time and are coded in ``block``-row blocks
    over all sub-spaces at once (the L2 -> dot identity per sub-space)."""
    dev = resolve_device(device)
    x = np.asarray(x, np.float32)
    n, d = x.shape
    m, kq, dsub = codebooks.shape
    if d != m * dsub:
        raise ValueError(f"dim {d} != pq_m*dsub ({m}*{dsub})")
    if kq > 256:
        raise ValueError("codes are stored as uint8: at most 256 codewords")
    cb = torch.as_tensor(np.asarray(codebooks, np.float32)).to(dev)
    half_c2 = 0.5 * (cb * cb).sum(2)                       # [m, kq]
    out = np.empty((n, m), np.uint8)
    for s0 in range(0, n, chunk_rows):
        xs = torch.from_numpy(x[s0:s0 + chunk_rows]).to(dev)
        parts = []
        for r0 in range(0, xs.shape[0], block):
            rows = xs[r0:r0 + block].reshape(-1, m, dsub)
            s = torch.einsum("bmd,mkd->bmk", rows, cb) - half_c2[None]
            parts.append(s.argmax(2).to(torch.uint8))
        if parts:
            out[s0:s0 + xs.shape[0]] = torch.cat(parts).cpu().numpy()
    return out


def decode_pq(codes: np.ndarray, codebooks: np.ndarray) -> np.ndarray:
    """Reconstruct vectors from codes -> fp32 [N, D] (host-side tooling;
    the search never decodes)."""
    codes = np.asarray(codes)
    m, kq, dsub = np.asarray(codebooks).shape
    n = codes.shape[0]
    assert codes.shape == (n, m), codes.shape
    return (np.asarray(codebooks, np.float32)[np.arange(m)[None, :], codes]
            .reshape(n, m * dsub))


def train_opq(x: np.ndarray, m: int, n_codes: int = 16, iters: int = 8,
              pq_iters: int = 8, seed: int = 0,
              device: DeviceLike = None) -> Tuple[np.ndarray, np.ndarray]:
    """OPQ (FAISS ``OPQMatrix``): learn an orthogonal rotation R that
    decorrelates the sub-spaces before PQ, alternating a codebook refresh
    on ``y = x @ R`` with the orthogonal-Procrustes solve ``R = U V^T`` of
    ``svd(x^T decode(encode(y)))``. Returns ``(R [D, D] fp32, codebooks
    [m, n_codes, D/m] fp32)``; ``q . x == (q @ R) . (x @ R)``."""
    x = np.asarray(x, np.float32)
    n, d = x.shape
    rng = np.random.default_rng(seed)
    q0, _ = np.linalg.qr(rng.standard_normal((d, d)))
    rot = q0.astype(np.float32)
    for it in range(iters):
        y = x @ rot
        cb = train_pq(y, m, n_codes, iters=pq_iters, seed=seed * 7 + it,
                      device=device)
        rec = decode_pq(encode_pq(y, cb, device=device), cb)
        u, _, vt = np.linalg.svd(x.T @ rec, full_matrices=False)
        rot = (u @ vt).astype(np.float32)
    cb = train_pq(x @ rot, m, n_codes, iters=pq_iters,
                  seed=seed * 7 + iters, device=device)
    return rot, cb


def pack_codes4(codes: np.ndarray) -> np.ndarray:
    """Pack 4-bit codes two per byte: [N, m] (values < 16) -> [N, m//2]
    with byte j = codes[2j] | codes[2j+1] << 4."""
    codes = np.asarray(codes)
    n, m = codes.shape
    if m % 2:
        raise ValueError(f"4-bit packing needs even pq_m (got {m})")
    if codes.max(initial=0) >= 16:
        raise ValueError("pack_codes4 is for 4-bit codes")
    c = codes.astype(np.uint8).reshape(n, m // 2, 2)
    return (c[:, :, 0] | (c[:, :, 1] << 4)).astype(np.uint8)


def unpack_codes4(packed):
    """Inverse of :func:`pack_codes4`, on numpy or torch: [..., m//2]
    uint8 -> [..., m] int32."""
    if isinstance(packed, torch.Tensor):
        lo = (packed & 0xF).to(torch.int32)
        hi = (packed >> 4).to(torch.int32)
        return torch.stack([lo, hi], -1).reshape(*packed.shape[:-1], -1)
    lo = (packed & 0xF).astype(np.int32)
    hi = (packed >> 4).astype(np.int32)
    return np.stack([lo, hi], axis=-1).reshape(*packed.shape[:-1], -1)


def pq_lut(q: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """Per-query score lookup tables: q [B, D] -> [B, m, n_codes] fp32,
    ``lut[b, j, c] = q_subspace_j . codeword_c``."""
    b = q.shape[0]
    m, kq, dsub = codebooks.shape
    return torch.einsum("bmd,mkd->bmk",
                        q.float().reshape(b, m, dsub), codebooks.float())


def pq_scores_from_codes(codes: torch.Tensor, lut: torch.Tensor
                         ) -> torch.Tensor:
    """codes [B, R, m] int -> scores [B, R] fp32, ``sum_j lut[b, j,
    codes[b, r, j]]``: one gather of the LUT per sub-space (the reference's
    one-hot einsum computes the same sum)."""
    b, r, m = codes.shape
    scores = torch.zeros((b, r), dtype=torch.float32, device=lut.device)
    for j in range(m):
        scores += lut[:, j, :].gather(1, codes[:, :, j].long())
    return scores
