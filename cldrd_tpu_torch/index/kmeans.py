"""k-means for the IVF coarse quantizer (port of
``cldrd_tpu/index/kmeans.py``).

Lloyd's algorithm with the L2 -> dot identity ``argmin ||x - c||^2 ==
argmax (x.c - ||c||^2 / 2)``: assignment is one fp32 matmul + argmax per
row block on the device, and the centroid update is a second matmul
(``one_hot(assign).T @ x``, a segment sum with a fixed summation order).
Seeding is greedy farthest-first over a capped random pool; the seed pool
and the training subsample come from ``np.random.default_rng(seed)``
exactly as in the reference, so they agree bit for bit.

Empty clusters re-seed to a jittered copy of the largest cluster's
centroid. The reference draws that jitter from ``jax.random.normal``,
which torch cannot reproduce; here it comes from a ``torch.Generator``
seeded with ``seed * 1000003 + it`` (a known, deliberate difference: runs
that empty a cluster differ from the reference's from that iteration on).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from cldrd_tpu_torch.device import DeviceLike, resolve_device


def _pad_blocks(x: np.ndarray, block: int) -> Tuple[np.ndarray, np.ndarray]:
    """Pad rows up to a multiple of ``block``; returns (x_pad, weight)."""
    n, d = x.shape
    n_pad = -(-n // block) * block
    w = np.zeros((n_pad,), np.float32)
    w[:n] = 1.0
    if n_pad != n:
        x = np.concatenate([x, np.zeros((n_pad - n, d), x.dtype)])
    return x, w


def _block_assign_scores(rows: torch.Tensor, centroids: torch.Tensor,
                         half_c2: torch.Tensor) -> torch.Tensor:
    return rows @ centroids.T - half_c2[None, :]


def _lloyd_iter(x: torch.Tensor, w: torch.Tensor, centroids: torch.Tensor,
                gen: torch.Generator, block: int):
    """One Lloyd iteration. x [N_pad, D] fp32, w [N_pad] {0,1} weights,
    centroids [K, D] fp32 -> (new_centroids, counts, inertia_proxy), the
    proxy being the sum of per-row best (x.c - ||c||^2/2) scores."""
    n_pad, d = x.shape
    k = centroids.shape[0]
    half_c2 = 0.5 * (centroids * centroids).sum(1)
    sums = torch.zeros((k, d), dtype=torch.float32, device=x.device)
    counts = torch.zeros((k,), dtype=torch.float32, device=x.device)
    inertia = torch.zeros((), dtype=torch.float32, device=x.device)
    for r0 in range(0, n_pad, block):
        rows, rw = x[r0:r0 + block], w[r0:r0 + block]
        s = _block_assign_scores(rows, centroids, half_c2)   # [block, K]
        best, assign = s.max(1)
        oh = torch.nn.functional.one_hot(assign, k).float() * rw[:, None]
        sums = sums + oh.T @ rows                             # [K, D]
        counts = counts + oh.sum(0)
        inertia = inertia + (best * rw).sum()
    new_c = sums / counts.clamp(min=1.0)[:, None]
    empty = counts == 0
    if bool(empty.any()):
        # FAISS split_clusters policy: re-seed to the largest cluster's
        # centroid plus a tiny jitter so the pair separates next iteration
        biggest = int(counts.argmax())
        jitter = 1e-3 * torch.randn((k, d), generator=gen,
                                    dtype=torch.float32).to(x.device)
        reseed = new_c[biggest][None, :] * (1.0 + jitter) + jitter
        new_c = torch.where(empty[:, None], reseed, new_c)
    return new_c, counts, inertia


def _farthest_first(x: torch.Tensor, k: int, start: int) -> torch.Tensor:
    """Greedy farthest-first traversal seeding: k times, pick the point
    with the largest distance to the chosen seed set (first maximum on
    ties, as ``jnp.argmax``)."""
    seeds = torch.zeros((k, x.shape[1]), dtype=x.dtype, device=x.device)
    seeds[0] = x[start]
    mind = ((x - x[start][None, :]) ** 2).sum(1)
    for i in range(1, k):
        nxt = x[mind.argmax()]
        seeds[i] = nxt
        mind = torch.minimum(mind, ((x - nxt[None, :]) ** 2).sum(1))
    return seeds


def assign_clusters(x: np.ndarray, centroids: np.ndarray, block: int = 16384,
                    chunk_rows: int = 1_048_576,
                    device: DeviceLike = None) -> np.ndarray:
    """Nearest-centroid (L2) assignment for every row of ``x`` -> int32 [N].
    Rows go to the device ``chunk_rows`` at a time and are scored in
    ``block``-row blocks."""
    dev = resolve_device(device)
    x = np.asarray(x, np.float32)
    n = x.shape[0]
    c = torch.as_tensor(np.asarray(centroids, np.float32)).to(dev)
    half_c2 = 0.5 * (c * c).sum(1)
    out = np.empty((n,), np.int32)
    for s0 in range(0, n, chunk_rows):
        xs = torch.from_numpy(x[s0:s0 + chunk_rows]).to(dev)
        parts = [_block_assign_scores(xs[r0:r0 + block], c, half_c2)
                 .argmax(1) for r0 in range(0, xs.shape[0], block)]
        out[s0:s0 + xs.shape[0]] = torch.cat(parts).to(torch.int32).cpu() \
            .numpy()
    return out


def kmeans(x: np.ndarray, k: int, iters: int = 15, seed: int = 0,
           block: int = 16384,
           max_points_per_centroid: Optional[int] = 256, tol: float = 1e-5,
           device: DeviceLike = None) -> np.ndarray:
    """Lloyd's k-means; returns centroids fp32 [k, D].

    ``max_points_per_centroid`` subsamples the training set the way FAISS
    does (256 per centroid). Stops early when the inertia surrogate
    improves by < ``tol`` relative."""
    dev = resolve_device(device)
    x = np.asarray(x, np.float32)
    n, d = x.shape
    if k <= 0 or k > n:
        raise ValueError(f"k must be in [1, n_rows]: k={k}, n={n}")
    rng = np.random.default_rng(seed)
    if max_points_per_centroid is not None and n > k * max_points_per_centroid:
        sub = rng.choice(n, size=k * max_points_per_centroid, replace=False)
        x = x[np.sort(sub)]
        n = x.shape[0]
    pool_n = min(n, max(4 * k, 2048))
    pool = (x if pool_n == n
            else x[np.sort(rng.choice(n, size=pool_n, replace=False))])
    centroids = _farthest_first(torch.from_numpy(pool).to(dev), k,
                                int(rng.integers(pool_n)))

    block = min(block, max(256, -(-n // 8)))
    x_pad, w = _pad_blocks(x, block)
    x_dev = torch.from_numpy(x_pad).to(dev)
    w_dev = torch.from_numpy(w).to(dev)

    prev = -np.inf
    for it in range(iters):
        gen = torch.Generator().manual_seed(seed * 1000003 + it)
        centroids, counts, inertia = _lloyd_iter(x_dev, w_dev, centroids,
                                                 gen, block)
        cur = float(inertia)
        if np.isfinite(prev) and abs(cur - prev) <= tol * max(abs(prev), 1.0):
            break
        prev = cur
    return centroids.cpu().numpy()
