"""Refine tier: exact re-scoring of approximate candidates (copy of
``cldrd_tpu/index/refine.py``).

FAISS equivalence: ``IndexRefineFlat`` / the refinement stage of
``IndexIVFPQR``: a compressed first tier proposes candidates, an exact
store re-scores them. The exact store stays on disk (the ``persistence``
store the index build already wrote), memmapped through the page cache;
the rescore is a host-side gather + fp32 dot batch, so the compressed
tier keeps its device-memory saving.

Score semantics: a candidate found in the store gets the exact fp32
``q . stored_row`` (int8 stores dequantize the gathered rows); a candidate
the store has never seen (documents live-added to the serving index)
keeps its first-tier score. Refinement never drops a result.
"""
from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import numpy as np
import torch

from .persistence import IDS_NAME, META_NAME, SCALES_NAME


class DiskRefiner:
    """Random-row exact scorer over a persisted embedding store."""

    def __init__(self, store_dir: str):
        with open(os.path.join(store_dir, META_NAME)) as f:
            self.meta = json.load(f)
        self.dim = int(self.meta["dim"])
        self._dt = np.dtype(self.meta["dtype"])
        self._rps = int(self.meta["rows_per_shard"])
        self._mmaps = []
        for shard in self.meta["shards"]:
            path = os.path.join(store_dir, shard["file"])
            self._mmaps.append(np.memmap(
                path, dtype=self._dt, mode="r",
                shape=(shard["rows"], self.dim)))
        self._scales = (np.load(os.path.join(store_dir, SCALES_NAME))
                        if self._dt == np.int8 else None)
        ids = np.load(os.path.join(store_dir, IDS_NAME))
        # id -> global row, via one sorted permutation (8.8M ids = 70 MB
        # of int64; a dict would be 10x that and 100x slower to build)
        self._order = np.argsort(ids).astype(np.int64)
        self._sorted_ids = ids[self._order]

    def lookup_rows(self, cand_ids: np.ndarray) -> np.ndarray:
        """External ids -> global store rows; -1 where the store has no
        such id (padding, tombstones, live-added documents)."""
        flat = np.asarray(cand_ids, np.int64).ravel()
        pos = np.searchsorted(self._sorted_ids, flat)
        pos_c = np.minimum(pos, len(self._sorted_ids) - 1)
        valid = (flat >= 0) & (self._sorted_ids[pos_c] == flat)
        rows = np.where(valid, self._order[pos_c], -1)
        return rows.reshape(np.shape(cand_ids))

    def gather(self, rows: np.ndarray) -> np.ndarray:
        """Global rows [M] -> fp32 vectors [M, D] (int8 stores
        dequantize). Rows are grouped per shard so each memmap sees one
        sorted fancy-index (sequential-ish page access)."""
        rows = np.asarray(rows, np.int64)
        out = np.empty((len(rows), self.dim), np.float32)
        shard_of = rows // self._rps
        for s in np.unique(shard_of):
            sel = np.flatnonzero(shard_of == s)
            within = rows[sel] - int(s) * self._rps
            order = np.argsort(within)
            block = self._mmaps[int(s)][within[order]].astype(np.float32)
            if self._scales is not None:
                block *= self._scales[rows[sel][order], None]
            out[sel[order]] = block
        return out

    def rescore(self, q: np.ndarray, cand_ids: np.ndarray) -> np.ndarray:
        """q [B, D] fp32, cand_ids [B, R] -> exact scores [B, R] fp32,
        NaN where the store has no row for the id."""
        q = np.asarray(q, np.float32)
        b, r = cand_ids.shape
        rows = self.lookup_rows(cand_ids)
        out = np.full((b, r), np.nan, np.float32)
        flat_rows = rows.ravel()
        hit = np.flatnonzero(flat_rows >= 0)
        if hit.size:
            vecs = self.gather(flat_rows[hit])        # [M, D]
            q_rep = q[hit // r]                        # [M, D]
            out.ravel()[hit] = np.einsum(
                "md,md->m", q_rep, vecs, dtype=np.float32)
        return out


class RefinedIndex:
    """IVF/IVFPQ candidate generation + DiskRefiner exact re-scoring.

    Drop-in for the serving index surface: ``search`` widens the first
    tier to ``k * factor`` candidates, re-scores them exactly, and
    returns the top-k by refined score. Everything else (add/remove/
    save/n_vectors/nprobe/...) rides the wrapped index; add/remove
    re-wrap so the refiner follows the live index through swaps.
    """

    def __init__(self, coarse, refiner: DiskRefiner, factor: int = 4):
        if factor < 1:
            raise ValueError(f"refine factor must be >= 1 (got {factor})")
        self.coarse = coarse
        self.refiner = refiner
        self.factor = int(factor)

    def __getattr__(self, name):
        return getattr(self.coarse, name)

    def search(
        self, queries, k: int, nprobe: Optional[int] = None
    ) -> Tuple[np.ndarray, np.ndarray]:
        if isinstance(queries, torch.Tensor):  # e.g. on the device
            queries = queries.detach().float().cpu().numpy()
        q = np.asarray(queries, np.float32)
        p = self.coarse.nprobe if nprobe is None else int(nprobe)
        p = max(1, min(p, self.coarse.n_buckets))
        # first tier fetches k*factor, capped at the probed row count
        r = max(k, min(k * self.factor, p * self.coarse.slot))
        v, ids = self.coarse.search(q, r, nprobe=nprobe)
        exact = self.refiner.rescore(q, ids)
        scores = np.where(np.isnan(exact), v, exact)
        scores = np.where(ids >= 0, scores, -np.inf)
        take = np.argsort(-scores, axis=1, kind="stable")[:, :k]
        out_s = np.take_along_axis(scores, take, axis=1).astype(np.float32)
        out_i = np.take_along_axis(ids, take, axis=1)
        out_i = np.where(np.isfinite(out_s), out_i, -1)
        return out_s, out_i

    def add(self, embeddings, ids) -> "RefinedIndex":
        return RefinedIndex(self.coarse.add(embeddings, ids),
                            self.refiner, self.factor)

    def remove(self, ids) -> "RefinedIndex":
        return RefinedIndex(self.coarse.remove(ids),
                            self.refiner, self.factor)
