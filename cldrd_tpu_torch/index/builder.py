"""Corpus/query encoding: text -> CLS embeddings, and index builds (port
of ``cldrd_tpu/index/builder.py``).

Batches have a fixed shape (the ragged tail is padded; ``n_valid`` says
how many rows are real), or, with ``bucket_lengths``, one shape per
length bucket (``data/bucketing.py``). Tokenization runs on a background
thread ``prefetch_depth`` batches ahead; tokens cross to the device
packed in 3 bytes a token (uint16 ids, uint8 mask) through pinned
staging and are widened there. ``encode_dataset`` copies each batch's
embeddings to the host behind an event and waits for a batch only a few
batches later; ``build_index_on_device`` writes them into a
preallocated device store instead, so they never leave the card.

Data parallel (``mesh``): ``make_encode_fn(..., mesh=)`` holds a replica
of the model on each device of the mesh and encodes rows
``[j*bz/ndev, (j+1)*bz/ndev)`` of a batch on device j, returning the
parts as a ``parallel.Sharded``. ``encode_dataset`` concatenates them in
row order; the sharded ``build_index_on_device`` writes each device's
part into its own shard of the store at the same local offset.
"""
from __future__ import annotations

import copy
import logging
import time
from collections import deque
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from cldrd_tpu_torch.data.prefetch import prefetch
from cldrd_tpu_torch.data.sequence_dataset import SequenceDataset
from cldrd_tpu_torch.device import resolve_device, to_host_async
from cldrd_tpu_torch.parallel.mesh import Mesh, Sharded
from cldrd_tpu_torch.utils.profiling import annotate, spanned

logger = logging.getLogger(__name__)

EncodeFn = Callable[[Dict[str, np.ndarray]], torch.Tensor]

_IN_FLIGHT = 4  # batches left on the device before their results are fetched



def _batch_stream(dataset, batch_size: int, bucket_lengths,
                  batch_multiple: int = 1):
    """Resolve the batch iterator: flat fixed-shape batches, or
    length-bucketed ones (rows regrouped by valid length so short
    passages stop paying max_length work; the same embeddings).

    Returns ``(iterator, max_batch_rows, emitted_rows_bound)``; the latter
    two size device append buffers (bucketed batches vary in row count and
    pad at most one partial batch per bucket)."""
    if bucket_lengths is None:
        n_batches = -(-max(len(dataset), 1) // batch_size)
        return (spanned(dataset.batches(batch_size), "cldrd.data.batch"),
                batch_size, n_batches * batch_size)
    from cldrd_tpu_torch.data.bucketing import (
        bucket_specs,
        bucketize,
        max_emitted_rows,
    )

    # () / [] selects the default power-of-two ladder; None (handled
    # above) means no bucketing at all
    specs = bucket_specs(dataset.max_length, batch_size,
                         list(bucket_lengths) or None, batch_multiple)
    if hasattr(dataset, "batches_bucketed"):
        it = dataset.batches_bucketed(specs)  # sorted: minimal padding
    else:
        it = bucketize(dataset.batches(batch_size), specs)
    max_bz = max(s.batch_size for s in specs)
    return (spanned(it, "cldrd.data.batch"), max_bz,
            max_emitted_rows(len(dataset), specs))


def compact_tokens(tokens: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Host-side payload compaction (the reference's ``_compact_tokens``):
    WordPiece ids fit uint16 and the mask is 0/1, so a token travels in 3
    bytes instead of 8; ids out of uint16's range stay as they are."""
    ids = tokens["input_ids"]
    if ids.dtype != np.uint16 and ids.size and ids.max() < (1 << 16) \
            and ids.min() >= 0:
        ids = ids.astype(np.uint16)
    return {"input_ids": ids,
            "attention_mask": tokens["attention_mask"].astype(np.uint8)}


def _to_device(x: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A compacted token array on ``dev`` as int64. uint16 ids travel as
    the same two bytes typed int16 (torch's uint16 has few operators) and
    are widened with ``& 0xFFFF``, which restores ids >= 32,768. On the
    card the copy is staged through pinned memory and does not block."""
    wide16 = x.dtype == np.uint16
    host = torch.from_numpy(np.ascontiguousarray(
        x.view(np.int16) if wide16 else x))
    if dev.type == "cuda":
        pinned = torch.empty(host.shape, dtype=host.dtype, pin_memory=True)
        pinned.copy_(host)
        host = pinned.to(dev, non_blocking=True)
    out = host.to(torch.int64)
    return out & 0xFFFF if wide16 else out


def make_encode_fn(model, method: str, mesh: Optional[Mesh] = None
                   ) -> EncodeFn:
    """An encode closure over ``model`` (a ``NwayDualEncoder`` on its
    device) in eval mode: tokens ``{input_ids, attention_mask}`` (host
    arrays) -> fp32 embeddings [B, D] on the model's device.

    ``method``: 'query_embs' or 'passage_embs'. ``mesh``: data-parallel
    encode over its devices (one replica of the model each, the model's
    own device reusing the model); a batch's rows must divide evenly and
    the result is a ``Sharded`` [B, D]."""
    model.eval()
    dev = next(model.parameters()).device
    if mesh is None:
        fn = getattr(model, method)

        def encode(tokens):
            with torch.inference_mode():
                batch = {k: _to_device(v, dev)
                         for k, v in compact_tokens(tokens).items()}
                return fn(batch).float()

        return encode
    replicas = {dev: model}
    for d in mesh.devices:
        if d not in replicas:
            replicas[d] = copy.deepcopy(model).to(d).eval()
    fns = [getattr(replicas[d], method) for d in mesh.devices]
    ndev = mesh.size

    def encode_sharded(tokens):
        tokens = compact_tokens(tokens)
        bz = tokens["input_ids"].shape[0]
        if bz % ndev:
            raise ValueError(f"a batch of {bz} rows does not split over "
                             f"{ndev} devices")
        per = bz // ndev
        parts = []
        with torch.inference_mode():
            for j, (fn, d) in enumerate(zip(fns, mesh.devices)):
                batch = {k: _to_device(v[j * per:(j + 1) * per], d)
                         for k, v in tokens.items()}
                parts.append(fn(batch).float())
        return Sharded(parts)

    encode_sharded.mesh = mesh
    return encode_sharded


def encode_dataset(encode_fn: EncodeFn, dataset: SequenceDataset,
                   batch_size: int, log_every: int = 200,
                   prefetch_depth: int = 4, bucket_lengths=None,
                   batch_multiple: int = 1
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Encode every sequence; returns (embeddings fp32 [N, D], ids int64
    [N]). Raises ``FloatingPointError`` if any embedding is NaN.

    ``bucket_lengths``: length-bucketed encoding (a sequence of bucket
    lengths, or ``()`` for the default power-of-two ladder). Rows come
    back GROUPED BY LENGTH, not in dataset order: pair embeddings with
    the returned ``ids``, never with the input row order.

    An encode over a mesh (``make_encode_fn(..., mesh=)``) needs every
    batch's rows to split over its devices: ``batch_multiple`` becomes
    its device count, and ``batch_size`` must be a multiple of it."""
    mesh = getattr(encode_fn, "mesh", None)
    if mesh is not None:
        if batch_size % mesh.size:
            raise ValueError(f"batch size {batch_size} is not a multiple "
                             f"of the {mesh.size} devices")
        batch_multiple = mesh.size
    batches, _, _ = _batch_stream(dataset, batch_size, bucket_lengths,
                                  batch_multiple)
    emb_chunks, id_chunks = [], []
    pending: deque = deque()
    t0 = time.perf_counter()
    n_batches = n_done = 0

    def fetch():
        copies, n, ids = pending.popleft()
        host = []
        with annotate("cldrd.index.fetch"):
            for (part,), done in copies:
                if done is not None:
                    done.synchronize()  # this batch's copy only
                host.append(part.numpy())
        emb_chunks.append(np.concatenate(host)[:n])
        id_chunks.append(ids)

    for batch in prefetch(batches, depth=prefetch_depth):
        n = batch.n_valid
        with annotate("cldrd.index.encode"):
            embs = encode_fn(batch.tokens)
            parts = embs.parts if isinstance(embs, Sharded) else [embs[:n]]
            pending.append(([to_host_async(p) for p in parts], n,
                            batch.ids[:n]))
        if len(pending) > _IN_FLIGHT:
            fetch()
        n_batches += 1
        n_done += n
        if log_every and n_batches % log_every == 0:
            logger.info("encoded %d seqs (%.0f seq/s)", n_done,
                        n_done / (time.perf_counter() - t0))
    while pending:
        fetch()
    embeddings = (np.concatenate(emb_chunks) if emb_chunks
                  else np.zeros((0, 0), np.float32))
    ids = (np.concatenate(id_chunks) if id_chunks
           else np.zeros((0,), np.int64))
    n_nan = int(np.isnan(embeddings).sum())
    if n_nan:
        raise FloatingPointError(f"{n_nan} NaNs in encoded embeddings")
    elapsed = time.perf_counter() - t0
    logger.info("encoded %d sequences in %.1fs (%.0f seq/s)", len(ids),
                elapsed, len(ids) / max(elapsed, 1e-9))
    return embeddings, ids


def build_index_from_dataset(encode_fn: EncodeFn, dataset: SequenceDataset,
                             batch_size: int, out_dir: Optional[str] = None,
                             dtype=torch.bfloat16, block_rows: int = 8192,
                             device=None):
    """Encode the corpus, optionally persist the embedding store, and
    stand up the resident ``FlatIPIndex`` on ``device``."""
    from .flat_index import FlatIPIndex
    from .persistence import write_embeddings

    embeddings, ids = encode_dataset(encode_fn, dataset, batch_size)
    if out_dir is not None:
        write_embeddings(out_dir, embeddings, ids)
    return FlatIPIndex.build(embeddings, ids, dtype=dtype,
                             block_rows=block_rows, device=device)


def build_index_on_device(encode_fn: EncodeFn, dataset: SequenceDataset,
                          batch_size: int, dim: int, dtype=torch.bfloat16,
                          block_rows: int = 8192, prefetch_depth: int = 4,
                          mesh=None, bucket_lengths=None, device=None):
    """Encode straight into the resident index: no host round trip.

    The store is preallocated on ``device`` (``encode_fn``'s device) at
    ``n + max_batch_rows`` rows rounded up to ``block_rows``, and each
    encoded batch is copied in place at ``offset``, its padded tail rows
    included; the next batch's write at ``offset + n_valid`` covers them,
    except after the final batch, where they stay as rows with id -1
    (masked out of every search). ``torch.int8`` quantizes each batch on
    the device (``quantize_rows``); rows never written keep code 0 and
    scale 1.0. Row order is the stream's: length-grouped with
    ``bucket_lengths``, identity on the id map.

    ``mesh`` builds a row-sharded index: ``encode_fn`` must encode over
    the same mesh (``make_encode_fn(..., mesh=mesh)``)."""
    from .flat_index import FlatIPIndex, _pad_rows, quantize_rows

    if mesh is not None:
        return _build_index_on_device_sharded(
            encode_fn, dataset, batch_size, dim, dtype, block_rows,
            prefetch_depth, mesh, bucket_lengths)
    dev = resolve_device(device)
    n = len(dataset)
    batches, max_bz, _ = _batch_stream(dataset, batch_size, bucket_lengths)
    # every batch writes its full (possibly bucket-specific) row count, of
    # which the tail is padding: the store covers the largest write at the
    # largest offset (<= n)
    n_pad = _pad_rows(max(n, 1) + max_bz, block_rows)
    int8 = dtype == torch.int8
    buf = torch.zeros((n_pad, dim), dtype=dtype, device=dev)
    scales = (torch.ones((n_pad,), dtype=torch.float32, device=dev)
              if int8 else None)
    ids_buf = np.full((n_pad,), -1, np.int64)
    offset = 0
    for batch in prefetch(batches, depth=prefetch_depth):
        embs = encode_fn(batch.tokens)  # [bz, dim] on the device
        bz = embs.shape[0]
        with torch.inference_mode():
            if int8:
                codes, s = quantize_rows(embs)
                buf[offset:offset + bz] = codes
                scales[offset:offset + bz] = s
            else:
                buf[offset:offset + bz] = embs
        ids_buf[offset:offset + batch.n_valid] = batch.ids[:batch.n_valid]
        offset += batch.n_valid
    if offset != n:
        raise AssertionError(f"{offset} rows encoded of {n}")
    return FlatIPIndex.from_tensors(
        buf, torch.from_numpy(ids_buf.astype(np.int32)).to(dev), scales,
        block_rows=block_rows)


def _build_index_on_device_sharded(encode_fn: EncodeFn,
                                   dataset: SequenceDataset, batch_size: int,
                                   dim: int, dtype, block_rows: int,
                                   prefetch_depth: int, mesh: Mesh,
                                   bucket_lengths=None):
    """Every device writes its part of each encoded batch into its own
    shard at the same local offset; shard j holds global rows
    ``[j*local_rows, (j+1)*local_rows)``, as in the reference."""
    from .flat_index import FlatIPIndex, _pad_rows, quantize_rows

    ndev = mesh.size
    if getattr(encode_fn, "mesh", None) != mesh:
        raise ValueError("a sharded build needs an encode over the same "
                         "mesh: make_encode_fn(model, method, mesh=mesh)")
    if batch_size % ndev:
        raise ValueError(f"batch size {batch_size} is not a multiple of "
                         f"the {ndev} devices")
    # bucketed batch sizes are multiples of ndev, so every batch splits;
    # emitted_bound covers the valid rows and the pad tails
    batches, _, emitted_bound = _batch_stream(dataset, batch_size,
                                              bucket_lengths,
                                              batch_multiple=ndev)
    local_rows = _pad_rows(-(-max(emitted_bound, 1) // ndev), block_rows)
    int8 = dtype == torch.int8
    bufs = [torch.zeros((local_rows, dim), dtype=dtype, device=d)
            for d in mesh.devices]
    scales = ([torch.ones((local_rows,), dtype=torch.float32, device=d)
               for d in mesh.devices] if int8 else None)
    ids_buf = np.full((local_rows * ndev,), -1, np.int64)
    local_offset = 0
    for batch in prefetch(batches, depth=prefetch_depth):
        parts = encode_fn(batch.tokens).parts   # [per_dev, dim] each
        per_dev = parts[0].shape[0]
        with torch.inference_mode():
            for j, part in enumerate(parts):
                rows = slice(local_offset, local_offset + per_dev)
                if int8:
                    codes, s = quantize_rows(part)
                    bufs[j][rows] = codes
                    scales[j][rows] = s
                else:
                    bufs[j][rows] = part
        # device j's shard covers global rows [j*local_rows, ...); batch
        # rows [j*per_dev, (j+1)*per_dev) land at its local offset
        batch_ids = np.full((per_dev * ndev,), -1, np.int64)
        batch_ids[:batch.n_valid] = batch.ids[:batch.n_valid]
        for j in range(ndev):
            dst = j * local_rows + local_offset
            ids_buf[dst:dst + per_dev] = batch_ids[j * per_dev:
                                                   (j + 1) * per_dev]
        local_offset += per_dev
    ids32 = ids_buf.astype(np.int32)
    row_ids = Sharded([
        torch.from_numpy(ids32[j * local_rows:(j + 1) * local_rows]).to(d)
        for j, d in enumerate(mesh.devices)])
    return FlatIPIndex.from_tensors(
        Sharded(bufs), row_ids,
        None if scales is None else Sharded(scales),
        block_rows=block_rows, mesh=mesh)
