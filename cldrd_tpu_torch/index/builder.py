"""Corpus/query encoding: text -> CLS embeddings (port of ``make_encode_fn``
and ``encode_dataset`` from ``cldrd_tpu/index/builder.py``).

Batches have a fixed shape (the ragged tail is padded; ``n_valid`` says
how many rows are real). Tokenization runs on the host while the device
encodes earlier batches: each batch's embeddings copy to the host behind
an event, and the host waits for a batch only a few batches later.
"""
from __future__ import annotations

import logging
import time
from collections import deque
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from cldrd_tpu_torch.data.sequence_dataset import SequenceDataset
from cldrd_tpu_torch.device import to_host_async

logger = logging.getLogger(__name__)

EncodeFn = Callable[[Dict[str, np.ndarray]], torch.Tensor]

_IN_FLIGHT = 4  # batches left on the device before their results are fetched


def make_encode_fn(model, method: str) -> EncodeFn:
    """An encode closure over ``model`` (a ``NwayDualEncoder`` on its
    device) in eval mode: tokens ``{input_ids, attention_mask}`` (host
    arrays) -> fp32 embeddings [B, D] on the model's device.

    ``method``: 'query_embs' or 'passage_embs'."""
    model.eval()
    fn = getattr(model, method)
    dev = next(model.parameters()).device

    def encode(tokens):
        with torch.inference_mode():
            batch = {k: torch.as_tensor(tokens[k]).to(dev, torch.int64)
                     for k in ("input_ids", "attention_mask")}
            return fn(batch).float()

    return encode


def encode_dataset(encode_fn: EncodeFn, dataset: SequenceDataset,
                   batch_size: int, log_every: int = 200
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Encode every sequence; returns (embeddings fp32 [N, D], ids int64
    [N]). Raises ``FloatingPointError`` if any embedding is NaN."""
    emb_chunks, id_chunks = [], []
    pending: deque = deque()
    t0 = time.perf_counter()
    n_batches = 0

    def fetch():
        (embs,), done, ids = pending.popleft()
        if done is not None:
            done.synchronize()  # this batch's copy only
        emb_chunks.append(embs.numpy())
        id_chunks.append(ids)

    for batch in dataset.batches(batch_size):
        n = batch.n_valid
        pending.append((*to_host_async(encode_fn(batch.tokens)[:n]),
                        batch.ids[:n]))
        if len(pending) > _IN_FLIGHT:
            fetch()
        n_batches += 1
        if log_every and n_batches % log_every == 0:
            n_done = n_batches * batch_size
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
