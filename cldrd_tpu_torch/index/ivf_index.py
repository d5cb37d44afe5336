"""IVF (inverted-file) approximate MIPS index (port of
``cldrd_tpu/index/ivf_index.py``).

Probe ``nprobe`` of the index's cells per query instead of scanning the
corpus: the low-latency tier for small serving batches.

- **Fixed-size buckets.** Every cluster is padded into one or more
  ``slot``-row buckets (zero rows, id -1, scale 1); a cluster larger than
  ``slot`` spans several buckets, each carrying a copy of its centroid, so
  it takes several probe slots.
- **Row-layout device store.** Non-PQ buckets live on the device as
  ``[n_buckets * slot, D]`` rows (bucket j = rows ``j*slot:(j+1)*slot``);
  PQ code stores stay ``[n_buckets, slot * row_bytes]``. The disk format
  is the reference's ``format_version 1`` (``[nb, slot * D]``, bf16
  written as fp32), so a directory written by either package loads in
  the other.
- **Search**: coarse scores ``q @ centroids.T`` (``block_scores``) ->
  top-``nprobe`` buckets -> scores of the probed rows -> exact chunked
  payload top-k (ties toward the smaller id). A CUDA store at
  ``precision='default'`` with 1- or 2-byte rows (bf16, int8) is scored
  by the probe kernel K6 (``ops.ivf_probe``); every other case (fp32
  stores, 'high'/'highest', CPU tensors) by the row gather + fp32 matmul,
  the reference's own second route.
- **Exactness**: with ``nprobe == n_buckets`` every row is visited, and
  the result equals ``FlatIPIndex`` / the exact oracle.
- **Sharded** (``mesh``): buckets, ids and scales row-shard over the
  mesh's devices (``parallel.Sharded``), the bucket count padded to a
  multiple of the shard count with empty buckets that never win a probe
  (``n_real_buckets``) and never persist. Centroids, codebooks and the
  OPQ rotation stay whole on the first device, where the global probe
  set (exactly ``nprobe`` buckets, as on one device) and the PQ tables
  are computed once and copied to every shard. Each shard masks the
  probes it does not own, scores its own buckets (K6 per shard where
  eligible) and takes a local top-k; the candidates merge on the first
  device. At ``nprobe == n_real`` it is exact too. ``add``/``remove``
  raise: a sharded store is rebuilt.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from cldrd_tpu_torch.device import DeviceLike, resolve_device
from cldrd_tpu_torch.ops.fused_binmax import block_scores
from cldrd_tpu_torch.ops.ivf_probe import gather_scores, probe_scores
from cldrd_tpu_torch.parallel.mesh import Mesh, shard_rows
from cldrd_tpu_torch.search.mips import (
    NEG_INF,
    _top_k,
    _topk_with_payload,
    topk_with_payload_chunked,
)

from .flat_index import (
    HostIdCacheMixin,
    _check_ids,
    quantize_rows,
    query_dtype_for,
)
from .kmeans import assign_clusters, kmeans
from .pq import (
    encode_pq,
    pack_codes4,
    pq_lut,
    pq_scores_from_codes,
    train_opq,
    train_pq,
    unpack_codes4,
)

IVF_META_NAME = "ivf_meta.json"


def _chunk_into_buckets(row_idx, values, ids, slot: int, scales=None):
    """Chunk the given rows (indices into ``values``/``ids``[/``scales``])
    into padded ``slot``-row buckets; the ONE bucket-padding convention
    (zero rows, id -1, scale 1) shared by build() and add()-overflow.
    Yields (blk [slot, d], bid [slot] int32, sc [slot] fp32 | None)."""
    d = values.shape[1]
    for s0 in range(0, len(row_idx), slot):
        chunk = row_idx[s0: s0 + slot]
        blk = np.zeros((slot, d), values.dtype)
        blk[: len(chunk)] = values[chunk]
        bid = np.full((slot,), -1, np.int32)
        bid[: len(chunk)] = ids[chunk].astype(np.int32)
        sc = None
        if scales is not None:
            sc = np.ones((slot,), np.float32)
            sc[: len(chunk)] = scales[chunk]
        yield blk, bid, sc


def _probe_kernel_eligible(store: torch.Tensor, precision: str) -> bool:
    """K6 scores a CUDA store at 'default' precision whose rows are 1 or 2
    bytes an element (bf16, int8): its dot is bf16 x bf16 with fp32
    accumulation. fp32 stores and 'high'/'highest' keep the gather route,
    as in the reference."""
    return (store.device.type == "cuda" and precision == "default"
            and store.element_size() <= 2)


def _probe_and_score(q, buckets_rows, bucket_scales, probe, slot: int,
                     precision: str):
    """Scores [B, p*slot] fp32 of every row in the probed buckets of the
    row-layout store [nb*slot, D]: K6 where eligible, else the row gather
    + fp32 matmul."""
    if _probe_kernel_eligible(buckets_rows, precision):
        return probe_scores(q, buckets_rows,
                            probe.to(torch.int32).contiguous(),
                            bucket_scales, slot=slot)
    return gather_scores(q, buckets_rows, probe, bucket_scales, slot)


def _pad_topk(v, ids, k: int):
    """Pad (scores, ids) [B, k_eff] to k with (-inf, -1); ids of non-finite
    scores become -1."""
    b, k_eff = v.shape
    if k_eff < k:
        v = torch.cat([v, v.new_full((b, k - k_eff), NEG_INF)], -1)
        ids = torch.cat([ids, ids.new_full((b, k - k_eff), -1)], -1)
    return v, torch.where(torch.isfinite(v), ids, torch.full_like(ids, -1))


def _ivf_search(q, centroids, buckets_rows, bucket_ids, bucket_scales,
                k: int, nprobe: int, slot: int, precision: str):
    """IVF search. q [B, D] (query dtype), centroids [nb, D] fp32,
    buckets_rows [nb*slot, D], bucket_ids [nb, slot] int32 (-1 padding),
    bucket_scales [nb, slot] fp32 or None. Returns (scores [B, k] fp32
    desc, external ids [B, k] int32, -1 pad)."""
    b = q.shape[0]
    cs = block_scores(q.float(), centroids)                   # [B, nb]
    _, probe = _top_k(cs, nprobe)                             # [B, nprobe]
    cand_ids = bucket_ids[probe].reshape(b, nprobe * slot)
    scores = _probe_and_score(q, buckets_rows, bucket_scales, probe, slot,
                              precision)
    scores = torch.where(cand_ids >= 0, scores, NEG_INF)
    v, ids = topk_with_payload_chunked(scores, cand_ids,
                                       min(k, nprobe * slot))
    return _pad_topk(v, ids, k)


def _ivf_pq_search(q, q_lut, centroids, buckets_flat, bucket_ids, codebooks,
                   k: int, nprobe: int, slot: int):
    """IVFPQ search (FAISS ``IndexIVFPQ`` semantics). q [B, D] fp32,
    buckets_flat [nb, slot*mb] uint8 residual codes (mb = m for 8-bit,
    m/2 for nibble-packed 4-bit), codebooks [m, n_codes, D/m] fp32. A row
    of bucket j scores ``q . centroid_j`` (from the coarse matmul) plus the
    LUT sum of ``q_lut . residual``; ``q_lut`` is ``q`` or the
    OPQ-rotated query."""
    b = q.shape[0]
    m = codebooks.shape[0]
    row_bytes = buckets_flat.shape[1] // slot
    q = q.float()
    cs = block_scores(q, centroids)                           # [B, nb]
    base, probe = _top_k(cs, nprobe)                          # [B, p] x2
    cand = buckets_flat[probe].reshape(b, nprobe * slot, row_bytes)
    cand_codes = (cand.to(torch.int32) if row_bytes == m
                  else unpack_codes4(cand))
    cand_ids = bucket_ids[probe].reshape(b, nprobe * slot)
    lut = pq_lut(q_lut.float(), codebooks)                    # [B, m, n_codes]
    scores = pq_scores_from_codes(cand_codes, lut)            # [B, p*slot]
    scores = scores + base.repeat_interleave(slot, dim=1)
    scores = torch.where(cand_ids >= 0, scores, NEG_INF)
    v, ids = topk_with_payload_chunked(scores, cand_ids,
                                       min(k, nprobe * slot))
    return _pad_topk(v, ids, k)


# ---------------------------------------------------------------------------
# Sharded search: see the module docstring. Shard j owns the contiguous
# bucket range [j*nb_local, (j+1)*nb_local).


def _local_probe(probe, shard: int, nb_local: int):
    """Global probe bucket indices -> (clamped local indices, owned mask)
    for one shard."""
    local = probe - shard * nb_local
    valid = (local >= 0) & (local < nb_local)
    return torch.where(valid, local, torch.zeros_like(local)), valid


def _merge_topk_over_mesh(scores_parts, ids_parts, k: int, home):
    """Each shard's masked scores -> its local top-k -> candidates on
    ``home`` -> one payload-sort merge, padded to k with (-inf, -1)."""
    vs, ids = [], []
    for scores, cand in zip(scores_parts, ids_parts):
        v, i = topk_with_payload_chunked(scores, cand,
                                         min(k, scores.shape[1]))
        vs.append(v.to(home))
        ids.append(i.to(home))
    b = vs[0].shape[0]
    cand_v = torch.stack(vs, 1).reshape(b, -1)   # shard-major per query
    cand_i = torch.stack(ids, 1).reshape(b, -1)
    v, i = _topk_with_payload(cand_v, cand_i, min(k, cand_v.shape[1]))
    return _pad_topk(v, i, k)


def _ivf_search_sharded(q, centroids, buckets, bucket_ids, bucket_scales,
                        k: int, nprobe: int, slot: int, precision: str,
                        n_real: int):
    """Sharded flat/int8 IVF search; ``buckets``/``bucket_ids``/
    ``bucket_scales`` are ``Sharded``, the rest on the first device."""
    b = q.shape[0]
    cs = block_scores(q.float(), centroids[:n_real])
    _, probe = _top_k(cs, nprobe)                             # global
    nb_local = bucket_ids.part_rows
    scores_parts, ids_parts = [], []
    for j, (bk, bid) in enumerate(zip(buckets.parts, bucket_ids.parts)):
        lidx, valid = _local_probe(probe.to(bk.device), j, nb_local)
        cand_ids = torch.where(valid[:, :, None], bid[lidx],
                               torch.full_like(bid[lidx], -1)
                               ).reshape(b, nprobe * slot)
        sc = None if bucket_scales is None else bucket_scales.parts[j]
        scores = _probe_and_score(q.to(bk.device), bk, sc, lidx, slot,
                                  precision)
        scores_parts.append(torch.where(cand_ids >= 0, scores, NEG_INF))
        ids_parts.append(cand_ids)
    return _merge_topk_over_mesh(scores_parts, ids_parts, k, q.device)


def _ivf_pq_search_sharded(q, q_lut, centroids, buckets, bucket_ids,
                           codebooks, k: int, nprobe: int, slot: int,
                           n_real: int):
    """Sharded IVFPQ search: the coarse scores and the LUT are computed
    once; only the code gather and the LUT scoring run per shard."""
    b = q.shape[0]
    m = codebooks.shape[0]
    row_bytes = buckets.shape[1] // slot
    q = q.float()
    cs = block_scores(q, centroids[:n_real])
    base, probe = _top_k(cs, nprobe)                          # [B, p] x2
    lut = pq_lut(q_lut.float(), codebooks)                    # [B, m, n_codes]
    nb_local = bucket_ids.part_rows
    scores_parts, ids_parts = [], []
    for j, (bk, bid) in enumerate(zip(buckets.parts, bucket_ids.parts)):
        dev = bk.device
        lidx, valid = _local_probe(probe.to(dev), j, nb_local)
        cand = bk[lidx].reshape(b, nprobe * slot, row_bytes)
        cand_codes = (cand.to(torch.int32) if row_bytes == m
                      else unpack_codes4(cand))
        cand_ids = torch.where(valid[:, :, None], bid[lidx],
                               torch.full_like(bid[lidx], -1)
                               ).reshape(b, nprobe * slot)
        scores = pq_scores_from_codes(cand_codes, lut.to(dev))
        scores = scores + base.to(dev).repeat_interleave(slot, dim=1)
        scores_parts.append(torch.where(cand_ids >= 0, scores, NEG_INF))
        ids_parts.append(cand_ids)
    return _merge_topk_over_mesh(scores_parts, ids_parts, k, q.device)


def _place_bucket_store(mat_flat: np.ndarray, bids: np.ndarray, scs,
                        cents: np.ndarray, bcl, store_dtype, slot: int,
                        device: torch.device, mesh: Optional[Mesh] = None):
    """Put the host bucket store on ``device``: non-PQ stores in row
    layout [nb*slot, D] (a free host reshape), PQ code stores as
    [nb, slot*mb]. With ``mesh`` the bucket count pads to a multiple of
    the mesh size (zero rows, ids -1, scales 1, zero centroids, cluster
    -1) and buckets/ids/scales row-shard over it; centroids go to its
    first device. Returns (buckets, bucket_ids, scales, centroids,
    bucket_cluster, n_real)."""
    pq = store_dtype == torch.uint8
    nb = mat_flat.shape[0]

    def layout(m):
        return m if pq else m.reshape(m.shape[0] * slot, -1)

    if mesh is None:
        buckets = torch.from_numpy(np.ascontiguousarray(
            layout(mat_flat))).to(device)
        if buckets.dtype != store_dtype:
            buckets = buckets.to(store_dtype)   # float stores stage fp32
        return (buckets, torch.from_numpy(bids).to(device),
                None if scs is None else torch.from_numpy(scs).to(device),
                torch.from_numpy(np.asarray(cents, np.float32)).to(device),
                bcl, nb)
    ndev = mesh.size
    pad = -(-max(nb, 1) // ndev) * ndev - nb
    if pad:
        mat_flat = np.concatenate(
            [mat_flat, np.zeros((pad, mat_flat.shape[1]), mat_flat.dtype)])
        bids = np.concatenate([bids, np.full((pad, slot), -1, np.int32)])
        if scs is not None:
            scs = np.concatenate([scs, np.ones((pad, slot), np.float32)])
        cents = np.concatenate(
            [cents, np.zeros((pad, cents.shape[1]), cents.dtype)])
        if bcl is not None:
            bcl = np.concatenate([bcl, np.full((pad,), -1, np.int32)])
    return (shard_rows(np.ascontiguousarray(layout(mat_flat)), mesh,
                       store_dtype),
            shard_rows(bids, mesh),
            None if scs is None else shard_rows(scs, mesh),
            torch.from_numpy(np.asarray(cents, np.float32)).to(
                mesh.devices[0]),
            bcl, nb)


def _to_device_f32(x, device):
    return None if x is None else torch.from_numpy(
        np.asarray(x, np.float32)).to(device)


@dataclass
class IVFIndex(HostIdCacheMixin):
    """Approximate MIPS index: bucketed corpus + per-bucket centroids."""

    _ids_field = "bucket_ids"

    centroids: torch.Tensor     # [n_buckets, D] fp32 (clusters spanning
                                # several buckets duplicate their centroid)
    buckets: torch.Tensor       # [n_buckets*slot, D] store dtype, or PQ
                                # codes [n_buckets, slot*row_bytes] uint8
    bucket_ids: torch.Tensor    # [n_buckets, slot] int32, -1 = padding
    slot: int
    nprobe: int = 8             # default probes (override per search)
    precision: str = "default"
    bucket_scales: Optional[torch.Tensor] = None  # [n_buckets, slot] (int8)
    bucket_cluster: Optional[np.ndarray] = None   # [n_buckets] int32 host
                                # map bucket -> training cluster (add())
    codebooks: Optional[torch.Tensor] = None      # [pq_m, 2**bits, D/pq_m]
    opq_rotation: Optional[torch.Tensor] = None   # [D, D] orthogonal (OPQ)
    mesh: Optional[Mesh] = None                   # row-shards the buckets
    n_real_buckets: Optional[int] = None          # non-pad buckets of a
                                # sharded store; None = all are real

    @property
    def device(self) -> torch.device:
        return self.centroids.device

    @property
    def dim(self) -> int:
        return self.centroids.shape[1]

    @property
    def n_buckets(self) -> int:
        return self.centroids.shape[0]

    @property
    def n_real(self) -> int:
        """Buckets that hold (or held) data: the mesh pads excluded."""
        return (self.n_buckets if self.n_real_buckets is None
                else self.n_real_buckets)

    @property
    def is_pq(self) -> bool:
        return self.codebooks is not None

    @property
    def _pq_packed(self) -> bool:
        """4-bit stores hold two codes per byte: row width < pq_m."""
        return (self.is_pq and self.buckets.shape[1] // self.slot
                < self.codebooks.shape[0])

    @property
    def _query_dtype(self):
        if self.is_pq:  # LUTs are fp32; codes are not a scoring dtype
            return torch.float32
        return query_dtype_for(self.buckets.dtype, self.precision)

    # ------------------------------------------------------------- build

    @classmethod
    def build(cls, embeddings: np.ndarray, ids: np.ndarray, nlist: int,
              slot: Optional[int] = None, nprobe: int = 8,
              dtype=torch.bfloat16, precision: str = "default",
              kmeans_iters: int = 15, seed: int = 0,
              centroids: Optional[np.ndarray] = None,
              pq_m: Optional[int] = None, pq_bits: int = 4,
              opq: bool = False, device: DeviceLike = None,
              mesh: Optional[Mesh] = None) -> "IVFIndex":
        """Train (or accept) ``nlist`` centroids, group rows into
        fixed-``slot`` buckets, and place everything on ``device``.

        ``slot`` defaults to the mean cluster size rounded up to 128.
        ``dtype`` bf16 (default) / float32 / int8. ``pq_m`` switches the
        store to product-quantized residual codes (``pq_m`` sub-quantizers
        of ``2**pq_bits`` codewords; ``dtype`` is then ignored); ``opq``
        also learns an orthogonal pre-rotation. ``mesh`` row-shards the
        bucket store over the mesh's devices (training runs on its first
        device)."""
        dev = resolve_device(device) if mesh is None else mesh.devices[0]
        embeddings = np.asarray(embeddings, np.float32)
        n, d = embeddings.shape
        ids = np.asarray(ids)
        assert ids.shape == (n,)
        _check_ids(ids)
        if centroids is None:
            centroids = kmeans(embeddings, nlist, iters=kmeans_iters,
                               seed=seed, device=dev)
        else:
            centroids = np.asarray(centroids, np.float32)
            assert centroids.shape == (nlist, d), centroids.shape
        assign = assign_clusters(embeddings, centroids, device=dev)
        if slot is None:
            mean = max(1, n // max(1, nlist))
            slot = max(128, -(-mean // 128) * 128)

        # quantize first (per row, order-independent), then group rows by
        # cluster and chunk each cluster into slot-row buckets
        int8 = dtype == torch.int8 and pq_m is None
        codebooks = rotation = None
        if pq_m is not None:
            if pq_bits not in (4, 8):
                raise ValueError(f"pq_bits must be 4 or 8 (got {pq_bits})")
            if pq_bits == 4 and pq_m % 2:
                raise ValueError(
                    f"pq_m must be even for 4-bit codes (got {pq_m}): "
                    "they pack two per byte")
            # codes quantize the residual to the assigned coarse centroid;
            # search adds q.centroid back from the coarse matmul
            residuals = embeddings - centroids[assign]
            if opq:
                rotation, codebooks = train_opq(
                    residuals, pq_m, 1 << pq_bits, seed=seed, device=dev)
                residuals = residuals @ rotation
            else:
                codebooks = train_pq(residuals, pq_m, 1 << pq_bits,
                                     seed=seed, device=dev)
            values = encode_pq(residuals, codebooks, device=dev)
            if pq_bits == 4:
                values = pack_codes4(values)
            row_scales = None
        elif int8:
            values, row_scales = quantize_rows(embeddings)
        else:
            values, row_scales = embeddings, None
        row_w = values.shape[1]  # D, or the code bytes of a row
        order = np.argsort(assign, kind="stable")
        sizes = np.bincount(assign, minlength=nlist)
        nb = int(sum(-(-int(s) // slot) for s in sizes if s))
        mat = np.zeros((nb, slot, row_w),
                       np.uint8 if pq_m is not None
                       else (np.int8 if int8 else np.float32))
        bids = np.full((nb, slot), -1, np.int32)
        scs = np.ones((nb, slot), np.float32) if int8 else None
        cents = np.empty((nb, d), np.float32)
        bcl = np.empty((nb,), np.int32)
        bi = 0
        start = 0
        for c in range(nlist):
            rows = order[start: start + sizes[c]]
            start += sizes[c]
            if sizes[c] == 0:
                continue
            for blk, bid, sc in _chunk_into_buckets(rows, values, ids, slot,
                                                    row_scales):
                mat[bi], bids[bi], cents[bi], bcl[bi] = blk, bid, \
                    centroids[c], c
                if int8:
                    scs[bi] = sc
                bi += 1
        assert bi == nb, (bi, nb)

        store_dtype = (torch.uint8 if pq_m is not None
                       else (torch.int8 if int8 else dtype))
        buckets, dev_ids, scales, dev_cents, bcl, n_real = \
            _place_bucket_store(mat.reshape(nb, slot * row_w), bids, scs,
                                cents, bcl, store_dtype, slot, dev, mesh)
        return cls(centroids=dev_cents, buckets=buckets, bucket_ids=dev_ids,
                   slot=slot, nprobe=nprobe, precision=precision,
                   bucket_scales=scales, bucket_cluster=bcl,
                   codebooks=_to_device_f32(codebooks, dev),
                   opq_rotation=_to_device_f32(rotation, dev), mesh=mesh,
                   n_real_buckets=n_real)

    # ------------------------------------------------------------ search

    def warmup_batch_sizes(self, max_batch: int) -> list:
        """One representative b per padded shape ``search()`` can dispatch
        for b <= max_batch (it pads to a power of two >= 8)."""
        sizes, b = [], 8
        while True:
            sizes.append(min(max_batch, b))
            if b >= max_batch:
                return sizes
            b *= 2

    def search(self, queries, k: int, nprobe: Optional[int] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        """queries [B, D] (host or device) -> (scores [B, k] fp32, external
        ids [B, k] int32; -1 fills ranks beyond the probed rows).

        ``nprobe`` clamps to ``n_real``, where the search is exact. The
        batch pads to the next power of two >= 8 by repeating the first
        row, so a micro-batcher's arbitrary group sizes reuse a few
        shapes."""
        q = torch.as_tensor(queries).to(self.device).to(
            self._query_dtype).contiguous()
        b = q.shape[0]
        p = self.nprobe if nprobe is None else int(nprobe)
        if p < 1:
            raise ValueError(f"nprobe must be >= 1 (got {p})")
        p = min(p, self.n_real)
        if p * self.slot < k and p < self.n_real:
            raise ValueError(
                f"nprobe*slot ({p}*{self.slot}) < k ({k}): raise nprobe "
                "or build with a larger slot")
        if b == 0:
            return (np.zeros((0, k), np.float32),
                    np.full((0, k), -1, np.int32))
        b_pad = max(8, 1 << (b - 1).bit_length())
        if b_pad != b:
            q = torch.cat([q, q[:1].expand(b_pad - b, q.shape[1])])
        if self.is_pq:
            # OPQ moves into the LUT input: q . x == (q R) . (x R); the
            # coarse term keeps plain q
            q_lut = q if self.opq_rotation is None else q @ self.opq_rotation
            if self.mesh is not None:
                v, ids = _ivf_pq_search_sharded(
                    q, q_lut, self.centroids, self.buckets, self.bucket_ids,
                    self.codebooks, k, p, self.slot, self.n_real)
            else:
                v, ids = _ivf_pq_search(q, q_lut, self.centroids,
                                        self.buckets, self.bucket_ids,
                                        self.codebooks, k, p, self.slot)
        elif self.mesh is not None:
            v, ids = _ivf_search_sharded(
                q, self.centroids, self.buckets, self.bucket_ids,
                self.bucket_scales, k, p, self.slot, self.precision,
                self.n_real)
        else:
            v, ids = _ivf_search(q, self.centroids, self.buckets,
                                 self.bucket_ids, self.bucket_scales, k, p,
                                 self.slot, self.precision)
        return v[:b].cpu().numpy(), ids[:b].cpu().numpy()

    # ------------------------------------------------------- live updates

    def _derived(self, **changes) -> "IVFIndex":
        fields = dict(centroids=self.centroids, buckets=self.buckets,
                      bucket_ids=self.bucket_ids, slot=self.slot,
                      nprobe=self.nprobe, precision=self.precision,
                      bucket_scales=self.bucket_scales,
                      bucket_cluster=self.bucket_cluster,
                      codebooks=self.codebooks,
                      opq_rotation=self.opq_rotation)
        host_ids = changes.pop("host_ids")
        fields.update(changes)
        fields["bucket_ids"] = torch.from_numpy(host_ids).to(self.device)
        out = IVFIndex(**fields)
        out._host_ids_cache = host_ids
        return out

    def add(self, embeddings: np.ndarray, ids) -> "IVFIndex":
        """Append documents (FAISS IVF ``add_with_ids``: assign to the
        nearest trained centroid, no retraining); returns a NEW index.

        New rows first fill free slots (padding or tombstones) of their
        cluster's buckets, written IN PLACE into this index's tensors (do
        not search the old object afterwards); only cluster overflow
        appends new buckets. Placement, and so tie order, is the
        reference's. Unsharded stores only."""
        if self.mesh is not None:
            raise NotImplementedError(
                "add() on a sharded IVF index would redistribute shards; "
                "rebuild with IVFIndex.build(mesh=...)")
        embeddings = np.asarray(embeddings, np.float32)
        n, d = embeddings.shape
        ids = np.asarray(ids)
        assert ids.shape == (n,) and d == self.dim
        _check_ids(ids)
        if self.bucket_cluster is None:
            raise ValueError("this IVFIndex carries no bucket->cluster map "
                             "(pre-add-format store); rebuild to add()")
        cent_host = self.centroids.cpu().numpy()
        # nearest bucket centroid == nearest cluster centroid (a
        # multi-bucket cluster duplicates its centroid; route through the
        # cluster map)
        nearest_bucket = assign_clusters(embeddings, cent_host,
                                         device=self.device)
        clusters = self.bucket_cluster[nearest_bucket]

        cluster_buckets: dict = {}
        for b, c in enumerate(self.bucket_cluster):
            cluster_buckets.setdefault(int(c), []).append(b)
        host_ids = self._host_ids().copy()
        free: dict = {}
        cursor: dict = {}           # cluster -> first bucket with free slots
        placements: dict = {}       # bucket -> [(slot_pos, new_row_idx)]
        overflow: dict = {}         # cluster -> [new_row_idx]
        int8 = self.buckets.dtype == torch.int8
        if self.is_pq:
            # the residual to the ASSIGNED cluster's centroid
            resid_new = embeddings - cent_host[nearest_bucket]
            if self.opq_rotation is not None:
                resid_new = resid_new @ self.opq_rotation.cpu().numpy()
            codes_new = encode_pq(resid_new, self.codebooks.cpu().numpy(),
                                  device=self.device)
            if self._pq_packed:
                codes_new = pack_codes4(codes_new)
            scales_new = None
        elif int8:
            codes_new, scales_new = quantize_rows(embeddings)
        else:
            codes_new, scales_new = embeddings, None
        row_w = (self.buckets.shape[1] // self.slot if self.is_pq
                 else self.buckets.shape[1])
        for i in range(n):
            c = int(clusters[i])
            blist = cluster_buckets[c]
            # per-cluster cursor: a bucket whose free list emptied is never
            # re-visited in this call
            j = cursor.get(c, 0)
            while j < len(blist):
                b = blist[j]
                fl = free.setdefault(
                    b, list(np.flatnonzero(host_ids[b] == -1)))
                if fl:
                    s = int(fl.pop(0))
                    placements.setdefault(b, []).append((s, i))
                    host_ids[b, s] = np.int32(ids[i])
                    break
                j += 1
            cursor[c] = j
            if j == len(blist):
                overflow.setdefault(c, []).append(i)

        # overflow first: the concatenations allocate, and nothing of this
        # index is written until they have succeeded
        buckets, scales = self.buckets, self.bucket_scales
        centroids, bcl = self.centroids, self.bucket_cluster
        dev = self.device
        if overflow:
            nbk_rows, nbk_ids, nbk_cents, nbk_cl, nbk_sc = [], [], [], [], []
            for c, idxs in sorted(overflow.items()):
                ccent = cent_host[cluster_buckets[c][0]]
                for blk, bid, sc in _chunk_into_buckets(
                        np.asarray(idxs), codes_new, ids, self.slot,
                        scales_new):
                    nbk_rows.append(blk)
                    nbk_ids.append(bid)
                    nbk_cents.append(ccent)
                    nbk_cl.append(c)
                    nbk_sc.append(sc)
            slab = np.stack(nbk_rows)                 # [n_new, slot, row_w]
            slab = (slab.reshape(len(nbk_rows), self.slot * row_w)
                    if self.is_pq
                    else slab.reshape(len(nbk_rows) * self.slot, row_w))
            buckets = torch.cat([buckets, torch.from_numpy(slab).to(
                dev, buckets.dtype)])
            host_ids = np.concatenate([host_ids, np.stack(nbk_ids)])
            centroids = torch.cat([centroids, torch.from_numpy(
                np.stack(nbk_cents)).to(dev)])
            bcl = np.concatenate([bcl, np.asarray(nbk_cl, np.int32)])
            if int8:
                scales = torch.cat([scales, torch.from_numpy(
                    np.stack(nbk_sc)).to(dev)])

        if placements:
            pos_b, pos_s, rows_i = [], [], []
            for b in sorted(placements):
                for s, i in placements[b]:
                    pos_b.append(b)
                    pos_s.append(s)
                    rows_i.append(i)
            pb = torch.as_tensor(pos_b, device=dev)
            ps = torch.as_tensor(pos_s, device=dev)
            vals = torch.from_numpy(np.ascontiguousarray(
                codes_new[rows_i])).to(dev, buckets.dtype)
            if self.is_pq:   # bucket layout [nb, slot*row_w]
                buckets.view(-1, self.slot, row_w)[pb, ps] = vals
            else:            # row layout: row bucket*slot + pos
                buckets[pb * self.slot + ps] = vals
            if int8:
                scales[pb, ps] = torch.from_numpy(
                    scales_new[rows_i]).to(dev)

        return self._derived(host_ids=host_ids, centroids=centroids,
                             buckets=buckets, bucket_scales=scales,
                             bucket_cluster=bcl)

    def remove(self, ids) -> "IVFIndex":
        """Tombstone matching rows (id -> -1); FAISS ``remove_ids``.
        Their slots are reusable by add()."""
        if self.mesh is not None:
            raise NotImplementedError(
                "remove() on a sharded IVF index: rebuild instead")
        drop = np.asarray(sorted(set(int(i) for i in ids)), np.int64)
        _check_ids(drop)
        host = self._host_ids()
        new_ids = np.where(np.isin(host, drop.astype(np.int32)), -1, host)
        return self._derived(host_ids=new_ids.astype(np.int32))

    # -------------------------------------------------------- persistence

    def save(self, out_dir: str) -> None:
        """Write the reference's ``format_version 1`` directory: the store
        as [nb, slot*row_w] (int8 and PQ codes verbatim, float stores as
        fp32), ids, scales, cluster map, codebooks, rotation, meta. A
        sharded store's pad buckets do not persist, so the directory
        reloads onto any shard count."""
        os.makedirs(out_dir, exist_ok=True)
        nb = self.n_real
        np.save(os.path.join(out_dir, "centroids.npy"),
                self.centroids[:nb].cpu().numpy())
        store = (self.buckets.cpu().numpy()
                 if self.buckets.dtype in (torch.int8, torch.uint8)
                 else self.buckets.float().cpu().numpy())
        if not self.is_pq:          # rows [nb*slot, D] -> disk [nb, slot*D]
            store = store[:nb * self.slot].reshape(nb, -1)
        np.save(os.path.join(out_dir, "buckets.npy"), store[:nb])
        np.save(os.path.join(out_dir, "bucket_ids.npy"),
                self._host_ids()[:nb])
        if self.bucket_scales is not None:
            np.save(os.path.join(out_dir, "bucket_scales.npy"),
                    self.bucket_scales.cpu().numpy()[:nb])
        if self.bucket_cluster is not None:
            np.save(os.path.join(out_dir, "bucket_cluster.npy"),
                    self.bucket_cluster.astype(np.int32)[:nb])
        if self.is_pq:
            np.save(os.path.join(out_dir, "pq_codebooks.npy"),
                    self.codebooks.cpu().numpy())
            if self.opq_rotation is not None:
                np.save(os.path.join(out_dir, "opq_rotation.npy"),
                        self.opq_rotation.cpu().numpy())
        meta = {
            "slot": int(self.slot),
            "nprobe": int(self.nprobe),
            "precision": self.precision,
            "dim": int(self.dim),
            "n_buckets": int(nb),
            "dtype": ("pq" if self.is_pq
                      else "int8" if store.dtype == np.int8
                      else "float32"),
            "format_version": 1,
        }
        if self.is_pq:
            meta["pq_m"] = int(self.codebooks.shape[0])
            meta["pq_codes"] = int(self.codebooks.shape[1])
            meta["pq_packed"] = self._pq_packed
            meta["opq"] = self.opq_rotation is not None
        with open(os.path.join(out_dir, IVF_META_NAME), "w") as f:
            json.dump(meta, f, indent=2)

    @classmethod
    def load(cls, out_dir: str, dtype=None, precision=None,
             device: DeviceLike = None, mesh: Optional[Mesh] = None
             ) -> "IVFIndex":
        """Load a ``save()`` directory (either package's) onto ``device``.

        ``dtype`` is the device store's: an int8 store keeps its codes
        only when int8 is asked for; any float request (or the bf16
        default) dequantizes codes x scales. A PQ store has one device
        form (uint8 codes, fp32 LUT scoring), so a dtype request raises.
        ``mesh`` loads the buckets straight into shards."""
        dev = resolve_device(device) if mesh is None else mesh.devices[0]
        with open(os.path.join(out_dir, IVF_META_NAME)) as f:
            meta = json.load(f)
        cents = np.load(os.path.join(out_dir, "centroids.npy"))
        buckets = np.load(os.path.join(out_dir, "buckets.npy"))
        bids = np.load(os.path.join(out_dir, "bucket_ids.npy"))
        codebooks = rotation = None
        host_scales = None
        if meta["dtype"] == "pq":
            if dtype is not None:
                raise ValueError(
                    "this IVF store holds PQ codes; the device dtype is "
                    "fixed (uint8 codes, fp32 LUT scoring): drop the dtype "
                    "request or rebuild without --pq-m")
            codebooks = np.load(os.path.join(out_dir, "pq_codebooks.npy"))
            rot_path = os.path.join(out_dir, "opq_rotation.npy")
            if os.path.isfile(rot_path):
                rotation = np.load(rot_path)
            store_dtype = torch.uint8
        elif meta["dtype"] == "int8":
            sc = np.load(os.path.join(out_dir, "bucket_scales.npy"))
            if (dtype or torch.bfloat16) == torch.int8:
                host_scales = sc
                store_dtype = torch.int8
            else:
                nb_, slot_ = sc.shape
                buckets = (buckets.reshape(nb_, slot_, meta["dim"])
                           .astype(np.float32) * sc[:, :, None]
                           ).reshape(nb_, slot_ * meta["dim"])
                store_dtype = dtype or torch.bfloat16
        else:
            if dtype == torch.int8:
                raise ValueError(
                    "int8 device store requested but this IVF store is "
                    "float (a raw cast would destroy the rows); rebuild "
                    "with cli.index --store-dtype int8 --ivf-nlist N")
            store_dtype = dtype or torch.bfloat16
        bcl_path = os.path.join(out_dir, "bucket_cluster.npy")
        bcl = np.load(bcl_path) if os.path.isfile(bcl_path) else None
        slot = int(meta["slot"])
        dev_buckets, dev_ids, scales, dev_cents, bcl, n_real = \
            _place_bucket_store(buckets, bids, host_scales, cents, bcl,
                                store_dtype, slot, dev, mesh)
        return cls(centroids=dev_cents, buckets=dev_buckets,
                   bucket_ids=dev_ids, slot=slot, nprobe=int(meta["nprobe"]),
                   precision=precision or meta.get("precision", "default"),
                   bucket_scales=scales, bucket_cluster=bcl,
                   codebooks=_to_device_f32(codebooks, dev),
                   opq_rotation=_to_device_f32(rotation, dev), mesh=mesh,
                   n_real_buckets=n_real)


def ivf_exists(out_dir: str) -> bool:
    return os.path.isfile(os.path.join(out_dir, IVF_META_NAME))
