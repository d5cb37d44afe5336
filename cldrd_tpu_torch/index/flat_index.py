"""Exact inner-product index (port of ``cldrd_tpu/index/flat_index.py``).

The corpus embedding matrix lives in device memory (bf16 by default,
fp32, or int8 codes with per-row fp32 scales); external ids are an int32
array aligned row for row, -1 marking padding. Search is the exact bin-max
top-k of ``cldrd_tpu_torch.search.mips``, run in positions mode: the device
returns row positions and the id map is a host-side ``np.take``.
Certificate misses recover per query through an exact streaming re-scan.

With ``mesh`` the store is row-sharded over the mesh's devices
(``parallel.Sharded``; rows pad to ``ndev * block_rows``, each shard a
multiple of ``block_rows``) and searches run ``sharded_topk``: the
search kernels launch once per shard and the candidates merge on the
first device. Saved files hold the global row order, as the reference's.
A sharded index is rebuilt, not updated: ``add``/``remove`` raise.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from cldrd_tpu_torch.device import resolve_device, to_host_async
from cldrd_tpu_torch.parallel.mesh import Mesh, Sharded, shard_rows
from cldrd_tpu_torch.search.mips import (
    sharded_topk,
    topk_binmax,
    topk_streaming,
)
from cldrd_tpu_torch.utils.profiling import annotate


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
        # divide by a tensor: on CUDA a Python-scalar divisor is applied
        # as a product with its reciprocal, which rounds some scales (and
        # so codes) away from the reference's quotient
        amax = c.abs().amax(1).to(torch.float32)
        s = amax / torch.full_like(amax, 127.0)
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


class HostIdCacheMixin:
    """Host-cached external-id map shared by the resident index classes.

    ``_ids_field`` names the device id array (-1 = padding/tombstone).
    ``/healthz`` and every add/remove response read ``n_vectors``; the
    cache keeps them from fetching the whole id array each time."""

    _ids_field = "row_ids"

    def _host_ids(self) -> np.ndarray:
        ids = getattr(self, "_host_ids_cache", None)
        if ids is None:
            ids = getattr(self, self._ids_field).cpu().numpy()
            self._host_ids_cache = ids
        return ids

    @property
    def n_vectors(self) -> int:
        return int((self._host_ids() >= 0).sum())


@dataclass
class FlatIPIndex(HostIdCacheMixin):
    """Exact MIPS index: embeddings [N_pad, D] + row ids [N_pad] on one
    device (``row_scales`` [N_pad] fp32 for an int8 store), or each of
    them a ``Sharded`` over ``mesh``."""

    embeddings: torch.Tensor
    row_ids: torch.Tensor
    block_rows: int = 8192
    method: str = "binmax"  # 'binmax' (fast exact) | 'stream' (lean exact)
    precision: str = "default"
    row_scales: Optional[torch.Tensor] = None
    mesh: Optional[Mesh] = None

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

    @classmethod
    def build(cls, embeddings: np.ndarray, ids: np.ndarray,
              dtype=torch.bfloat16, block_rows: int = 8192,
              method: str = "binmax", precision: str = "default",
              device=None, mesh: Optional[Mesh] = None) -> "FlatIPIndex":
        """Pad rows to a multiple of ``block_rows`` (id -1) and place the
        store on ``device`` in ``dtype``; ``torch.int8`` quantizes per row
        on the host first. ``mesh`` row-shards it instead: rows pad to
        ``ndev * block_rows``."""
        n, d = embeddings.shape
        assert ids.shape == (n,)
        _check_ids(ids)
        if dtype == torch.int8:
            codes, s = quantize_rows(np.asarray(embeddings))
            return cls.build_quantized(codes, s, ids, block_rows, method,
                                       precision, device, mesh)
        ndev = 1 if mesh is None else mesh.size
        n_pad = _pad_rows(max(n, 1), block_rows * ndev)
        row_ids = np.full((n_pad,), -1, np.int32)
        row_ids[:n] = ids.astype(np.int32)
        embs = np.zeros((n_pad, d), np.float32)
        embs[:n] = embeddings
        if mesh is not None:
            return cls(shard_rows(embs, mesh, dtype),
                       shard_rows(row_ids, mesh), block_rows, method,
                       precision, mesh=mesh)
        dev = resolve_device(device)
        return cls(torch.from_numpy(embs).to(dev).to(dtype),
                   torch.from_numpy(row_ids).to(dev), block_rows, method,
                   precision)

    @classmethod
    def build_quantized(cls, codes: np.ndarray, scales: np.ndarray,
                        ids: np.ndarray, block_rows: int = 8192,
                        method: str = "binmax", precision: str = "default",
                        device=None, mesh: Optional[Mesh] = None
                        ) -> "FlatIPIndex":
        """The int8 index from pre-quantized per-row codes + scales;
        padding rows get scale 1 and id -1."""
        n, d = codes.shape
        assert codes.dtype == np.int8 and ids.shape == (n,)
        assert scales.shape == (n,)
        _check_ids(ids)
        ndev = 1 if mesh is None else mesh.size
        n_pad = _pad_rows(max(n, 1), block_rows * ndev)
        embs = np.zeros((n_pad, d), np.int8)
        embs[:n] = codes
        sc = np.ones((n_pad,), np.float32)
        sc[:n] = scales
        row_ids = np.full((n_pad,), -1, np.int32)
        row_ids[:n] = ids.astype(np.int32)
        if mesh is not None:
            return cls(shard_rows(embs, mesh), shard_rows(row_ids, mesh),
                       block_rows, method, precision, shard_rows(sc, mesh),
                       mesh=mesh)
        dev = resolve_device(device)
        return cls(torch.from_numpy(embs).to(dev),
                   torch.from_numpy(row_ids).to(dev), block_rows, method,
                   precision, torch.from_numpy(sc).to(dev))

    @classmethod
    def from_tensors(cls, embeddings: torch.Tensor, row_ids: torch.Tensor,
                     row_scales: Optional[torch.Tensor] = None,
                     block_rows: int = 8192, method: str = "binmax",
                     precision: str = "default", mesh: Optional[Mesh] = None
                     ) -> "FlatIPIndex":
        """Adopt tensors already on the device (no host round trip). Rows
        must already be padded to a multiple of ``block_rows`` with id -1;
        int8 embeddings need ``row_scales``. With ``mesh`` they are
        ``Sharded`` parts (or tensors, split here), each part a multiple
        of ``block_rows`` rows."""
        n = embeddings.shape[0]
        ndev = 1 if mesh is None else mesh.size
        if n % (block_rows * ndev) or tuple(row_ids.shape) != (n,):
            raise ValueError(f"{n} rows: pad to a multiple of "
                             f"{block_rows * ndev} with one id per row")
        if (embeddings.dtype == torch.int8) != (row_scales is not None):
            raise ValueError("row_scales go with (and only with) an int8 "
                             "store")
        if mesh is not None:
            def as_sharded(x, dtype=None):
                if isinstance(x, Sharded):
                    return Sharded([p.to(dtype or p.dtype).contiguous()
                                    for p in x.parts])
                return shard_rows(x.contiguous(), mesh, dtype)

            return cls(as_sharded(embeddings),
                       as_sharded(row_ids, torch.int32), block_rows, method,
                       precision,
                       None if row_scales is None
                       else as_sharded(row_scales, torch.float32),
                       mesh=mesh)
        return cls(embeddings.contiguous(),
                   row_ids.to(torch.int32).contiguous(), block_rows, method,
                   precision,
                   None if row_scales is None
                   else row_scales.to(torch.float32).contiguous())

    # ------------------------------------------------------- live updates

    def _free_tail(self) -> int:
        """Rows of contiguous id == -1 padding at the END of the id array:
        spare capacity that add() fills in place."""
        host = self._host_ids()
        valid = np.flatnonzero(host >= 0)
        used = int(valid[-1]) + 1 if valid.size else 0
        return len(host) - used

    def _derived(self, embeddings, row_ids_host: np.ndarray, row_scales):
        """A new index over these arrays with this one's settings."""
        out = FlatIPIndex(embeddings,
                          torch.from_numpy(row_ids_host).to(self.device),
                          self.block_rows, self.method, self.precision,
                          row_scales)
        out._host_ids_cache = row_ids_host
        return out

    def add(self, embeddings: np.ndarray, ids: np.ndarray) -> "FlatIPIndex":
        """Append documents (FAISS ``add_with_ids``); returns a NEW index.
        New rows first fill the padding tail IN PLACE (this index's
        tensors are written, so do not search the old object afterwards;
        no second corpus materializes); only when that capacity runs out
        does a ``block_rows``-aligned slab concatenate on. int8 stores
        quantize new rows with the shared quantizer. Row positions, and so
        tie order, are the reference's. Unsharded indexes only."""
        if self.mesh is not None:
            raise NotImplementedError(
                "add() on a sharded index would redistribute shards; "
                "rebuild with FlatIPIndex.build(mesh=...)")
        embeddings = np.asarray(embeddings)
        ids = np.asarray(ids)
        n, d = embeddings.shape
        assert ids.shape == (n,) and d == self.dim
        _check_ids(ids)
        int8 = self.embeddings.dtype == torch.int8
        free = self._free_tail()
        n_total = len(self._host_ids())
        if int8:
            rows, scales_new = quantize_rows(embeddings)
        else:
            rows, scales_new = embeddings.astype(np.float32), None
        fill = min(n, free)   # rows that reuse the existing padding tail
        over = n - fill       # rows that need a new block-aligned slab

        # the fallible slab allocation comes first: nothing of this index
        # is written until every allocation has succeeded
        embs, row_scales = self.embeddings, self.row_scales
        host = self._host_ids().copy()
        if over > 0:
            n_pad = _pad_rows(over, self.block_rows)
            new_ids = np.full((n_pad,), -1, np.int32)
            new_ids[:over] = ids[fill:].astype(np.int32)
            slab = np.zeros((n_pad, d), np.int8 if int8 else np.float32)
            slab[:over] = rows[fill:]
            embs = torch.cat([embs, torch.from_numpy(slab).to(
                self.device, embs.dtype)])
            if int8:
                sc = np.ones((n_pad,), np.float32)
                sc[:over] = scales_new[fill:]
                row_scales = torch.cat([row_scales,
                                        torch.from_numpy(sc).to(self.device)])
            host = np.concatenate([host, new_ids])
        if fill > 0:
            offset = n_total - free
            embs[offset:offset + fill] = torch.from_numpy(
                np.ascontiguousarray(rows[:fill])).to(self.device, embs.dtype)
            host[offset:offset + fill] = ids[:fill].astype(np.int32)
            if int8:
                row_scales[offset:offset + fill] = torch.from_numpy(
                    scales_new[:fill]).to(self.device)
        return self._derived(embs, host, row_scales)

    def remove(self, ids) -> "FlatIPIndex":
        """Tombstone documents (FAISS ``remove_ids``): matching rows get id
        -1 and drop out of every search. Capacity is not reclaimed; the
        new index shares the embedding tensor."""
        if self.mesh is not None:
            raise NotImplementedError("remove() on a sharded index: "
                                      "rebuild instead")
        drop_list = sorted(set(int(i) for i in ids))
        _check_ids(np.asarray(drop_list, np.int64))
        host = self._host_ids()
        new_ids = np.where(np.isin(host, np.asarray(drop_list, np.int32)),
                           -1, host).astype(np.int32)
        return self._derived(self.embeddings, new_ids, self.row_scales)

    def save(self, out_dir: str, rows_per_shard: int = 500_000) -> None:
        """Persist the resident index, padding rows dropped: an fp32 store
        for float stores, int8 codes + scales for quantized ones (written
        as they are, no dequantize round trip)."""
        from .persistence import write_embeddings, write_quantized

        host_ids = self._host_ids()
        valid = np.flatnonzero(host_ids >= 0)
        ids = host_ids[valid].astype(np.int64)

        def rows(x):
            if isinstance(x, Sharded):   # global row order, from the host
                return x.cpu()[torch.from_numpy(valid)]
            return x[torch.from_numpy(valid).to(x.device)].cpu()

        if self.embeddings.dtype == torch.int8:
            write_quantized(out_dir, rows(self.embeddings).numpy(),
                            rows(self.row_scales).numpy(), ids,
                            rows_per_shard=rows_per_shard)
        else:
            write_embeddings(out_dir, rows(self.embeddings).float().numpy(),
                             ids, rows_per_shard=rows_per_shard)

    # ------------------------------------------------- FAISS read surface

    def _id_to_row(self, ids: np.ndarray) -> np.ndarray:
        """External ids -> row positions via a cached sorted-id map
        (binary search; a dict at 8.8M ids would cost ~600 MB). Raises
        ``KeyError`` on unknown or removed ids."""
        maps = getattr(self, "_id_row_map_cache", None)
        if maps is None:
            host = self._host_ids()
            rows = np.flatnonzero(host >= 0).astype(np.int64)
            order = np.argsort(host[rows], kind="stable")
            maps = (host[rows][order], rows[order])  # (sorted ids, rows)
            self._id_row_map_cache = maps
        sorted_ids, sorted_rows = maps
        pos = np.searchsorted(sorted_ids, ids)
        bad = (pos >= len(sorted_ids)) | (sorted_ids[np.minimum(
            pos, len(sorted_ids) - 1)] != ids)
        if bad.any():
            raise KeyError(
                f"ids not in index: {np.asarray(ids)[bad][:10].tolist()}")
        return sorted_rows[pos]

    def reconstruct(self, ids) -> np.ndarray:
        """The STORED vectors of external ``ids`` as fp32 [len(ids), D]
        (FAISS ``reconstruct``/``reconstruct_batch``; a scalar id returns
        [D]). int8 stores dequantize ``codes * scale``: the vectors search
        scores against, not the originals before quantization. Raises
        ``KeyError`` for unknown or removed ids."""
        scalar = np.ndim(ids) == 0
        idv = np.atleast_1d(np.asarray(ids, np.int64))
        rows_host = self._id_to_row(idv)
        if self.mesh is not None:
            out = self.embeddings.take(rows_host).float()
            if self.embeddings.dtype == torch.int8:
                out = out * self.row_scales.take(rows_host)[:, None]
            out = out.cpu().numpy()
            return out[0] if scalar else out
        rows = torch.from_numpy(rows_host).to(self.device)
        out = self.embeddings[rows].float()
        if self.embeddings.dtype == torch.int8:
            out = out * self.row_scales[rows][:, None]
        out = out.cpu().numpy()
        return out[0] if scalar else out

    def range_search(self, queries, radius: float, k_start: int = 1024,
                     max_passes: Optional[int] = 8
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """All hits with inner product STRICTLY above ``radius`` (FAISS
        ``range_search`` IP semantics), exact, in FAISS's CSR convention:
        ``(lims [B+1], scores, ids)`` with query q's hits at
        ``[lims[q]:lims[q+1]]``, sorted by score descending (FAISS leaves
        them unsorted).

        Exact top-k runs at doubling depths (``k_start``, 2*k_start, ...)
        until every query's k-th score has fallen to ``radius`` or the
        corpus is exhausted, then the hits are filtered on the host; a
        query with at most ``k_start`` hits pays one search. After
        ``max_passes`` searches (default 8: depth 128 * k_start) it
        RAISES rather than truncate, naming the radius; ``max_passes=None``
        searches as deep as the corpus."""
        q = np.asarray(queries)
        n_rows = len(self._host_ids())  # padded size; -inf beyond corpus
        k = min(max(int(k_start), 1), n_rows)
        passes = 0
        while True:
            scores, ids = self.search(q, k)
            passes += 1
            valid = ids >= 0
            # deeper hits are possible only if some query's k-th kept slot
            # is a real row still scoring above radius
            if k >= n_rows or not np.any(valid[:, -1]
                                         & (scores[:, -1] > radius)):
                break
            if max_passes is not None and passes >= max_passes:
                raise RuntimeError(
                    f"range_search(radius={radius!r}) still unsaturated "
                    f"after {passes} passes (depth {k} of {n_rows} rows): "
                    "the radius matches a large fraction of the corpus. "
                    "Raise k_start, raise max_passes, or pass "
                    "max_passes=None to search exhaustively.")
            k = min(k * 2, n_rows)
        keep = valid & (scores > radius)
        lims = np.zeros(len(q) + 1, np.int64)
        np.cumsum(keep.sum(axis=1), out=lims[1:])
        # rows are already score-descending from search()
        return (lims, scores[keep].astype(np.float32),
                ids[keep].astype(np.int64))

    # ------------------------------------------------------------ search

    def warmup_batch_sizes(self, max_batch: int) -> list:
        """One batch size per padded shape ``search()`` can dispatch for
        b <= max_batch (it pads b up to a multiple of 128)."""
        sizes, m = [], 128
        while True:
            sizes.append(min(max_batch, m))
            if m >= max_batch:
                return sizes
            m += 128

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
        with annotate("cldrd.search.dispatch"):
            found = self._search_device(q, k)
        s, i = self._recover_resolve(q, k, b, *found)
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
        if self.mesh is not None:
            res = sharded_topk(
                q, self.embeddings, self.row_ids, k, self.mesh,
                self.mesh.axis_name, self.block_rows, method=self.method,
                precision=self.precision, return_positions=True,
                on_miss="flag", row_scales=self.row_scales)
            if self.method == "binmax":
                return res[0], res[1], True, res[2]
            return res[0], res[1], True, None
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
            if self.mesh is not None:
                v, p = sharded_topk(
                    chunk, self.embeddings, self.row_ids, k, self.mesh,
                    self.mesh.axis_name, self.block_rows, method="stream",
                    precision=self.precision, return_positions=True,
                    row_scales=self.row_scales)
            else:
                v, p = topk_streaming(chunk, self.embeddings,
                                      self._device_pos_ids(), k,
                                      self.block_rows, self.precision,
                                      row_scales=self.row_scales)
            out_s.append(v[:n].cpu().numpy())
            out_p.append(p[:n].cpu().numpy())
        return np.concatenate(out_s), np.concatenate(out_p)

    def _recover_resolve(self, q: torch.Tensor, k: int, n_valid: int, s, i,
                         positions, ok) -> Tuple[np.ndarray, np.ndarray]:
        """Fetch device results, re-run certificate-miss queries exactly
        (first ``n_valid`` rows only: pad rows are sliced off anyway) and
        map positions to external ids on the host."""
        with annotate("cldrd.search.resolve"):
            s, i = s.cpu().numpy(), i.cpu().numpy()
            if ok is not None:
                bad = np.nonzero(~ok.cpu().numpy()[:n_valid])[0]
                if bad.size:
                    self.rescued_queries += int(bad.size)
                    with annotate("cldrd.search.rescue"):
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
                with annotate("cldrd.search.fetch"):
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
            with annotate("cldrd.search.dispatch"):
                s, i, _, ok = self._search_device(q, k)
                pending.append((start, n, q) + to_host_async(
                    s, i, *(() if ok is None else (ok,))))
            if len(pending) >= max_in_flight:
                drain_one()
        while pending:
            drain_one()
        return out_s, out_i
