"""Exact inner-product index on one device (port of
``cldrd_tpu/index/flat_index.py``, single-device paths).

The corpus embedding matrix lives in device memory (bf16 by default,
fp32, or int8 codes with per-row fp32 scales); external ids are an int32
array aligned row for row, -1 marking padding. Search is the exact bin-max
top-k of ``cldrd_tpu_torch.search.mips``, run in positions mode: the device
returns row positions and the id map is a host-side ``np.take``.
Certificate misses recover per query through an exact streaming re-scan.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from cldrd_tpu_torch.device import resolve_device, to_host_async
from cldrd_tpu_torch.search.mips import topk_binmax, topk_streaming


def _pad_rows(n: int, multiple: int) -> int:
    return int(math.ceil(n / multiple) * multiple)


def _check_ids(ids: np.ndarray) -> None:
    """External ids live in an int32 array with -1 reserved for padding."""
    ids = np.asarray(ids)
    if ids.size and (int(ids.min()) < 0 or int(ids.max()) >= 2**31):
        raise ValueError(
            "external ids must be in [0, 2**31): the id map is int32 with "
            f"-1 reserved for padding (got min={ids.min()}, max={ids.max()})")


def quantize_rows(c):
    """Per-row symmetric int8 quantization: ``s[j] = max|c[j]| / 127``
    (zero rows get scale 1), ``c8[j] = rint(c[j] / s[j])`` (round half to
    even). Takes numpy or torch rows and answers in kind; byte-identical
    to the reference's. Returns ``(codes int8 [N, D], scales fp32 [N])``."""
    if isinstance(c, torch.Tensor):
        s = c.abs().amax(1).to(torch.float32) / 127.0
        s = torch.where(s == 0.0, torch.ones_like(s), s)
        codes = torch.round(c.to(torch.float32) / s[:, None]).to(torch.int8)
        return codes, s
    s = np.abs(c).max(axis=1).astype(np.float32) / np.float32(127.0)
    s = np.where(s == 0.0, np.float32(1.0), s)
    codes = np.rint(c.astype(np.float32) / s[:, None]).astype(np.int8)
    return codes, s


def query_dtype_for(store_dtype, precision: str):
    """int8 stores score bf16 queries against bf16-widened codes (fp32
    queries under a non-default precision); float stores score in their
    own dtype."""
    if store_dtype == torch.int8:
        return torch.float32 if precision != "default" else torch.bfloat16
    return store_dtype


@dataclass
class FlatIPIndex:
    """Exact MIPS index: embeddings [N_pad, D] + row ids [N_pad] on one
    device (``row_scales`` [N_pad] fp32 for an int8 store)."""

    embeddings: torch.Tensor
    row_ids: torch.Tensor
    block_rows: int = 8192
    method: str = "binmax"  # 'binmax' (fast exact) | 'stream' (lean exact)
    precision: str = "default"
    row_scales: Optional[torch.Tensor] = None

    def __post_init__(self):
        self.rescued_queries = 0  # certificate misses re-scanned so far

    @property
    def device(self) -> torch.device:
        return self.embeddings.device

    @property
    def dim(self) -> int:
        return self.embeddings.shape[1]

    @property
    def _query_dtype(self):
        return query_dtype_for(self.embeddings.dtype, self.precision)

    def _host_ids(self) -> np.ndarray:
        ids = getattr(self, "_host_ids_cache", None)
        if ids is None:
            ids = self.row_ids.cpu().numpy()
            self._host_ids_cache = ids
        return ids

    @property
    def n_vectors(self) -> int:
        return int((self._host_ids() >= 0).sum())

    @classmethod
    def build(cls, embeddings: np.ndarray, ids: np.ndarray,
              dtype=torch.bfloat16, block_rows: int = 8192,
              method: str = "binmax", precision: str = "default",
              device=None) -> "FlatIPIndex":
        """Pad rows to a multiple of ``block_rows`` (id -1) and place the
        store on ``device`` in ``dtype``; ``torch.int8`` quantizes per row
        on the host first."""
        n, d = embeddings.shape
        assert ids.shape == (n,)
        _check_ids(ids)
        if dtype == torch.int8:
            codes, s = quantize_rows(np.asarray(embeddings))
            return cls.build_quantized(codes, s, ids, block_rows, method,
                                       precision, device)
        dev = resolve_device(device)
        n_pad = _pad_rows(max(n, 1), block_rows)
        row_ids = np.full((n_pad,), -1, np.int32)
        row_ids[:n] = ids.astype(np.int32)
        embs = np.zeros((n_pad, d), np.float32)
        embs[:n] = embeddings
        return cls(torch.from_numpy(embs).to(dev).to(dtype),
                   torch.from_numpy(row_ids).to(dev), block_rows, method,
                   precision)

    @classmethod
    def build_quantized(cls, codes: np.ndarray, scales: np.ndarray,
                        ids: np.ndarray, block_rows: int = 8192,
                        method: str = "binmax", precision: str = "default",
                        device=None) -> "FlatIPIndex":
        """The int8 index from pre-quantized per-row codes + scales;
        padding rows get scale 1 and id -1."""
        n, d = codes.shape
        assert codes.dtype == np.int8 and ids.shape == (n,)
        assert scales.shape == (n,)
        _check_ids(ids)
        dev = resolve_device(device)
        n_pad = _pad_rows(max(n, 1), block_rows)
        embs = np.zeros((n_pad, d), np.int8)
        embs[:n] = codes
        sc = np.ones((n_pad,), np.float32)
        sc[:n] = scales
        row_ids = np.full((n_pad,), -1, np.int32)
        row_ids[:n] = ids.astype(np.int32)
        return cls(torch.from_numpy(embs).to(dev),
                   torch.from_numpy(row_ids).to(dev), block_rows, method,
                   precision, torch.from_numpy(sc).to(dev))

    @classmethod
    def from_tensors(cls, embeddings: torch.Tensor, row_ids: torch.Tensor,
                     row_scales: Optional[torch.Tensor] = None,
                     block_rows: int = 8192, method: str = "binmax",
                     precision: str = "default") -> "FlatIPIndex":
        """Adopt tensors already on the device (no host round trip). Rows
        must already be padded to a multiple of ``block_rows`` with id -1;
        int8 embeddings need ``row_scales``."""
        n = embeddings.shape[0]
        if n % block_rows or row_ids.shape != (n,):
            raise ValueError(f"{n} rows: pad to a multiple of {block_rows} "
                             "with one id per row")
        if (embeddings.dtype == torch.int8) != (row_scales is not None):
            raise ValueError("row_scales go with (and only with) an int8 "
                             "store")
        return cls(embeddings.contiguous(),
                   row_ids.to(torch.int32).contiguous(), block_rows, method,
                   precision,
                   None if row_scales is None
                   else row_scales.to(torch.float32).contiguous())

    # ------------------------------------------------------------ search

    def _to_queries(self, queries) -> torch.Tensor:
        q = torch.as_tensor(queries)
        return q.to(self.device).to(self._query_dtype)

    def search(self, queries, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """queries [B, D] (host or device) -> (scores [B, k], ids [B, k]).

        Exact top-k; -1 fills ranks beyond the corpus size. Query batches
        pad to a multiple of 128 by REPEATING the first query (a zero query
        scores 0.0 everywhere and could never pass the strict certificate),
        so the extract route's shape rule always holds."""
        q = self._to_queries(queries)
        b = q.shape[0]
        b_pad = -(-b // 128) * 128
        if b_pad != b:
            q = torch.cat([q, q[:1].expand(b_pad - b, q.shape[1])])
        s, i = self._recover_resolve(q, k, b, *self._search_device(q, k))
        return s[:b], i[:b]

    def _device_pos_ids(self) -> torch.Tensor:
        pos = getattr(self, "_device_pos_ids_cache", None)
        if pos is None:
            ar = torch.arange(self.row_ids.shape[0], dtype=torch.int32,
                              device=self.device)
            pos = torch.where(self.row_ids >= 0, ar, torch.full_like(ar, -1))
            self._device_pos_ids_cache = pos
        return pos

    def _search_device(self, q: torch.Tensor, k: int):
        """Dispatch one device search without waiting for it; returns
        (scores, positions, is_positions=True, ok_or_None)."""
        if self.method == "binmax":
            s, i, ok = topk_binmax(q, self.embeddings, self.row_ids, k,
                                   precision=self.precision,
                                   return_positions=True, on_miss="flag",
                                   row_scales=self.row_scales)
            return s, i, True, ok
        s, i = topk_streaming(q, self.embeddings, self._device_pos_ids(), k,
                              self.block_rows, self.precision,
                              row_scales=self.row_scales)
        return s, i, True, None

    # fixed re-scan batch, small enough that one adversarial query costs a
    # fraction of a fast-path batch
    _RESCAN_BATCH = 128

    def _rescan_exact(self, q: torch.Tensor, k: int):
        """Exact streaming re-scan (positions mode) of queries whose
        certificate failed, in fixed batches with replicated padding."""
        fb = self._RESCAN_BATCH
        out_s, out_p = [], []
        for s0 in range(0, len(q), fb):
            chunk = q[s0: s0 + fb]
            n = len(chunk)
            if n < fb:
                chunk = torch.cat([chunk,
                                   chunk[:1].expand(fb - n, q.shape[1])])
            v, p = topk_streaming(chunk, self.embeddings,
                                  self._device_pos_ids(), k, self.block_rows,
                                  self.precision, row_scales=self.row_scales)
            out_s.append(v[:n].cpu().numpy())
            out_p.append(p[:n].cpu().numpy())
        return np.concatenate(out_s), np.concatenate(out_p)

    def _recover_resolve(self, q: torch.Tensor, k: int, n_valid: int, s, i,
                         positions, ok) -> Tuple[np.ndarray, np.ndarray]:
        """Fetch device results, re-run certificate-miss queries exactly
        (first ``n_valid`` rows only: pad rows are sliced off anyway) and
        map positions to external ids on the host."""
        s, i = s.cpu().numpy(), i.cpu().numpy()
        if ok is not None:
            bad = np.nonzero(~ok.cpu().numpy()[:n_valid])[0]
            if bad.size:
                self.rescued_queries += int(bad.size)
                rs, rp = self._rescan_exact(
                    q[torch.from_numpy(bad).to(q.device)], k)
                s = s.copy()
                i = i.copy()
                s[bad] = rs
                i[bad] = rp
        if positions:
            ids = self._host_ids()
            i = np.where(i >= 0, ids[np.maximum(i, 0)], -1)
        return s, i

    def search_batched(self, queries, k: int, batch_size: int = 128,
                       max_in_flight: int = 4
                       ) -> Tuple[np.ndarray, np.ndarray]:
        """Fixed-shape batched search over many queries; the final ragged
        batch pads to ``batch_size`` by repeating its first query.

        All queries go to the device in one copy; up to ``max_in_flight``
        batch searches stay queued on the device stream while earlier
        results are fetched (each batch's own copies, fenced by an event)
        and id-mapped on the host."""
        nq, d = queries.shape
        batch_size = -(-batch_size // 128) * 128  # extract-route shape rule
        out_s = np.empty((nq, k), np.float32)
        out_i = np.empty((nq, k), np.int64)
        q_all = self._to_queries(queries)
        pending: list = []  # (start, n, q_dev, (s, i[, ok]) on host, done)

        def drain_one():
            start, n, q_dev, fetched, done = pending.pop(0)
            if done is not None:
                done.synchronize()
            s, i = self._recover_resolve(
                q_dev, k, n, fetched[0], fetched[1], True,
                fetched[2] if len(fetched) > 2 else None)
            out_s[start: start + n] = s[:n]
            out_i[start: start + n] = i[:n]

        for start in range(0, nq, batch_size):
            q = q_all[start: start + batch_size]
            n = q.shape[0]
            if n < batch_size:
                q = torch.cat([q, q[:1].expand(batch_size - n, d)])
            s, i, _, ok = self._search_device(q, k)
            pending.append((start, n, q) + to_host_async(
                s, i, *(() if ok is None else (ok,))))
            if len(pending) >= max_in_flight:
                drain_one()
        while pending:
            drain_one()
        return out_s, out_i
