"""Serve the index: a resident query daemon over HTTP (port of
``cldrd_tpu/cli/serve.py``).

Load the query tower and the corpus index onto the device once, warm up
every search shape, then answer queries until stopped.

    python -m cldrd_tpu_torch.cli.serve --index index_dir \\
        --checkpoint model.pth.tar [--ivf --nprobe 32 --hbm-dtype int8]

API (stdlib ``http.server``, JSON over POST):

- ``POST /search``  {"queries": ["text", ...], "k": 10,
  "exclude_ids": [int, ...]?, "rerank_k": 50?} -> {"results": [[{"id":
  int, "score": float}, ...], ...], "elapsed_ms": float}. ``exclude_ids``
  drops ids by over-fetch and needs k + len(exclude_ids) <= --topk.
  ``rerank_k``: two-stage mode: retrieve the top rerank_k, rescore them
  with the resident cross-encoder (``--reranker``) against texts from
  the ``--passages`` docstore (or added by ``/add``), return the top k
  by its score; hits carry "score" (cross-encoder) and
  "retrieval_score" (dot).
- ``POST /rerank``  {"query": "text", "passages": ["doc", ...], "k": 5?}
  -> {"results": [{"index": int, "score": float}, ...]}: the second
  stage over explicit texts, sorted by score descending.
- ``POST /add``     {"ids": [int, ...], "texts": ["doc", ...]} -> {"ok":
  true, "n_vectors": N}  (passage-tower encode -> ``index.add``)
- ``POST /remove``  {"ids": [int, ...]} -> {"ok": true, "n_vectors": N}
- ``POST /save``    {"dir": "/path"} -> the LIVE index persisted there
- ``POST /reload``  {"dir": "/path"} -> blue/green swap to a store loaded
  in the startup mode; the new index warms up outside the lock
- ``GET /healthz``  -> {"ok": true, "n_vectors", "dim", request/query/
  device-batch counters, latency p50/p99/mean; nprobe/n_buckets in IVF
  mode, refine_factor with --refine-factor}

Flat mode searches ``FlatIPIndex`` (exact, kernels K1/K2); ``--ivf``
serves the IVF companion store (``cli.index --ivf-nlist``) through the
probe kernel K6, ``--refine-factor`` re-scores its candidates exactly
against the flat disk store.

Dynamic micro-batching (on by default): request threads enqueue; one
device worker drains the queue for up to ``--max-batch-wait-ms`` or until
the encode batch fills, runs ONE encode + search over the union and hands
each request its slice. Every pass computes top-``--topk`` and slices
each request's ``k`` (requests with a larger k are refused up front).
``--max-pending`` bounds the queue: beyond it requests get 503 +
Retry-After.

The cross-encoder stage collates through
``RerankingDataset.from_pairs`` and ``batches(--rerank-batch-size)``,
the offline rerank path's contract, so its scores equal
``cli.rerank_eval --mode cross``'s on the same pairs at that batch
shape. Not in this port yet: ``--shards`` other than 1 (ROADMAP A6);
the flag parses and raises.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import json
import logging
import os
import queue
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional

import numpy as np
import torch

from cldrd_tpu_torch.data.docstore import TsvDocStore
from cldrd_tpu_torch.data.reranking_dataset import RerankingDataset
from cldrd_tpu_torch.device import dtype_from_name
from cldrd_tpu_torch.evaluation.reranking_evaluator import (
    make_cross_encoder_score_fn,
)
from cldrd_tpu_torch.index import (
    DiskRefiner,
    IVFIndex,
    RefinedIndex,
    index_exists,
    ivf_exists,
    load_index,
    make_encode_fn,
)
from cldrd_tpu_torch.index.ivf_index import IVF_META_NAME

from .common import (
    add_model_args,
    build_tokenizer,
    cross_encoder_config,
    load_cross_encoder,
    load_dual_encoder,
    model_config_from_args,
    setup_logging,
)

logger = logging.getLogger("cldrd_tpu_torch.cli.serve")


class ServiceOverloaded(RuntimeError):
    """The micro-batcher's pending queue is full: the caller should back
    off and retry (HTTP 503 + Retry-After)."""

    def __init__(self, depth: int, retry_after_s: int = 1):
        super().__init__(
            f"service overloaded: {depth} requests already pending "
            f"(--max-pending); retry after {retry_after_s}s")
        self.retry_after_s = retry_after_s


class _Pending:
    """One enqueued request awaiting the batching worker."""

    __slots__ = ("texts", "k", "exclude", "event", "results", "error")

    def __init__(self, texts: List[str], k: int, exclude=frozenset()):
        self.texts = texts
        self.k = k
        self.exclude = exclude
        self.event = threading.Event()
        self.results = None
        self.error: Optional[Exception] = None


_SHUTDOWN = object()


def _filter_ranked(ranked, exclude, k):
    """Top-k after dropping excluded ids (search() validated that every
    pass computes default_k >= k + |exclude| hits)."""
    if not exclude:
        return ranked[:k]
    return [h for h in ranked if h["id"] not in exclude][:k]


def _on_device(dev: torch.device):
    """Make ``dev`` the calling thread's current CUDA device (the batching
    worker and /reload's request thread start on device 0)."""
    return (torch.cuda.device(dev) if dev.type == "cuda"
            else contextlib.nullcontext())


class Reranker:
    """The cross-encoder second stage, resident beside the index. Pairs
    collate through ``RerankingDataset.from_pairs`` and ``batches()``,
    padded to the fixed ``batch_size``."""

    def __init__(self, score_fn, tokenizer, max_len: int, batch_size: int,
                 with_token_type_ids: bool, arch: str):
        self.score_fn = score_fn
        self.tokenizer = tokenizer
        self.max_len = max_len
        self.batch_size = batch_size
        self.with_token_type_ids = with_token_type_ids
        self.arch = arch

    def score_texts(self, query: str, passages: List[object]) -> np.ndarray:
        """Cross-encoder scores of (query, passage) pairs in input order;
        ``passages`` are plain texts or titled dicts (the docstore's
        values). The caller holds the device lock."""
        ds = RerankingDataset.from_pairs(
            [(0, i) for i in range(len(passages))], {0: query},
            dict(enumerate(passages)), self.tokenizer, is_cross_encoder=True,
            max_len=self.max_len,
            with_token_type_ids=self.with_token_type_ids)
        out = np.zeros(len(passages), np.float32)
        for batch in ds.batches(self.batch_size):
            scores = self.score_fn(batch)
            for i in range(batch.n_valid):
                out[int(batch.pids[i])] = float(scores[i])
        return out


class SearchService:
    """Tokenize -> encode -> top-k, behind one device lock."""

    def __init__(self, tokenizer, encode_fn, index, max_length: int,
                 encode_batch: int, default_k: int,
                 dynamic_batching: bool = True,
                 max_batch_wait_ms: float = 2.0,
                 passage_encode_fn=None, passage_max_length: int = 256,
                 index_loader=None, reranker: Optional[Reranker] = None,
                 docstore=None, max_pending: int = 256):
        self.tokenizer = tokenizer
        self.encode_fn = encode_fn
        self.index = index
        # two-stage serving: the cross-encoder and id -> text for it
        self.reranker = reranker
        self.docstore = docstore
        # texts of documents added by /add stay rerankable (the docstore
        # TSV predates them)
        self._live_texts: dict = {}
        # blue/green reloads (POST /reload) load a directory in the mode
        # the daemon started with (flat/IVF, device dtype, precision)
        self._index_loader = index_loader
        self.max_length = max_length
        self.encode_batch = encode_batch
        self.default_k = default_k
        self.passage_encode_fn = passage_encode_fn
        self.passage_max_length = passage_max_length
        self.dynamic_batching = dynamic_batching
        self.max_batch_wait_ms = max_batch_wait_ms
        self.max_pending = int(max_pending)
        self._lock = threading.Lock()   # device passes and index swaps
        self.stats = {"requests": 0, "queries": 0, "device_batches": 0,
                      "reranked_queries": 0, "rejected_overload": 0}
        # guards the stats, the latency ring and the enqueue-vs-close
        # order: close() clears _worker under it BEFORE posting the
        # shutdown sentinel, so the sentinel is the queue's last item and
        # the FIFO worker answers every real request before it exits
        self._state_lock = threading.Lock()
        self._latencies = collections.deque(maxlen=2048)  # seconds
        self._queue: "queue.Queue" = queue.Queue()
        self._worker: Optional[threading.Thread] = None
        if dynamic_batching:
            self._worker = threading.Thread(
                target=self._worker_loop, name="cldrd-serve-batcher",
                daemon=True)
            self._worker.start()

    @property
    def device(self) -> torch.device:
        return self.index.device

    def close(self) -> None:
        with self._state_lock:
            worker, self._worker = self._worker, None
            if worker is None:
                return
            self._queue.put(_SHUTDOWN)
        worker.join(timeout=60)

    # ------------------------------------------------- batching worker
    def _worker_loop(self) -> None:
        while True:
            first = self._queue.get()
            if first is _SHUTDOWN:
                return
            group = [first]
            total = len(first.texts)
            deadline = time.perf_counter() + self.max_batch_wait_ms / 1e3
            while total < self.encode_batch:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    nxt = self._queue.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is _SHUTDOWN:
                    self._finish_group(group)
                    return
                group.append(nxt)
                total += len(nxt.texts)
            self._finish_group(group)

    def _finish_group(self, group: List[_Pending]) -> None:
        texts: List[str] = []
        for p in group:
            texts.extend(p.texts)
        try:
            all_results = self._search_device(texts, self.default_k)
        except Exception as e:  # the worker keeps serving: every waiter
            logger.exception("device pass failed")  # gets the failure
            for p in group:
                p.error = e
                p.event.set()
            return
        off = 0
        for p in group:
            span = all_results[off: off + len(p.texts)]
            p.results = [_filter_ranked(ranked, p.exclude, p.k)
                         for ranked in span]
            off += len(p.texts)
            p.event.set()

    def warmup(self) -> None:
        """Run every search shape the micro-batcher can produce (each index
        class names its padded batch sizes) and the passage tower once,
        before serving traffic."""
        with self._lock:
            self._warm_searches(self.index)
            if self.passage_encode_fn is not None:
                with _on_device(self.device):
                    tokens = self.tokenizer(["warmup"],
                                            self.passage_max_length)
                    self.passage_encode_fn(self._pad(tokens,
                                                     self.encode_batch))
            if self.reranker is not None:
                # one padded rerank batch
                with _on_device(self.device):
                    self.reranker.score_texts("warmup", ["warmup"])

    def _pad(self, tokens, to: int):
        n = tokens["input_ids"].shape[0]
        if n >= to:
            return tokens
        return {k: np.concatenate([v, np.zeros((to - n, v.shape[1]),
                                               v.dtype)])
                for k, v in tokens.items()}

    def search(self, texts: List[str], k: Optional[int], exclude_ids=None,
               rerank_k=None):
        """Top-k hits per text. ``exclude_ids`` drops ids by over-fetch:
        every pass computes top-``default_k``, and k + |exclude| must fit
        under it. ``rerank_k``: the first stage fetches the top rerank_k
        (after exclusion), the cross-encoder rescores them against their
        texts, and the top k by its score come back with both scores; the
        first stage still coalesces through the micro-batcher."""
        k = int(k or self.default_k)
        exclude = frozenset(int(i) for i in (exclude_ids or ()))
        if rerank_k is not None:
            if self.reranker is None:
                raise ValueError(
                    "this service carries no cross-encoder; restart with "
                    "--reranker to use rerank_k")
            rerank_k = int(rerank_k)
            if not 1 <= k <= rerank_k:
                raise ValueError(
                    f"k must be in [1, rerank_k] ({k} vs rerank_k="
                    f"{rerank_k}): the second stage returns the top k of "
                    "the rerank_k retrieved candidates")
        fetch_k = rerank_k if rerank_k is not None else k
        if not 1 <= fetch_k <= self.default_k:
            # checked in the request thread: a bad k answers 400 and never
            # joins a group
            raise ValueError(
                f"k must be in [1, {self.default_k}] (--topk sets the "
                f"serving ceiling; every pass computes top-{self.default_k} "
                f"and slices)")
        if fetch_k + len(exclude) > self.default_k:
            raise ValueError(
                f"k + len(exclude_ids) ({fetch_k} + {len(exclude)}) exceeds "
                f"the serving ceiling {self.default_k} (--topk): the "
                "exclusion filter over-fetches from the same per-pass top-k")
        if not texts:
            return []
        t0 = time.perf_counter()
        with self._state_lock:
            worker = self._worker
            if worker is not None and self._queue.qsize() >= self.max_pending:
                self.stats["rejected_overload"] += 1
                raise ServiceOverloaded(self._queue.qsize())
            self.stats["requests"] += 1
            self.stats["queries"] += len(texts)
            if worker is not None:
                pending = _Pending(texts, fetch_k, exclude)
                self._queue.put(pending)
        if worker is None:
            out = [_filter_ranked(r, exclude, fetch_k)
                   for r in self._search_device(texts, self.default_k)]
        else:
            # the worker always answers; the timeout is a safety valve
            if not pending.event.wait(timeout=600):
                raise RuntimeError(
                    "search timed out waiting for the device worker")
            if pending.error is not None:
                raise pending.error
            out = pending.results
        if rerank_k is not None:
            out = [self._rerank_ranked(q, ranked, k)
                   for q, ranked in zip(texts, out)]
        with self._state_lock:
            self._latencies.append(time.perf_counter() - t0)
        return out

    # --------------------------------------------------- second stage

    def _passages_for_ids(self, ids: List[int]) -> List[object]:
        """Retrieved ids -> passage texts: texts added by /add first, then
        the --passages docstore."""
        out = [self._live_texts.get(i) for i in ids]
        missing = [(j, i) for j, (i, t) in enumerate(zip(ids, out))
                   if t is None]
        if missing:
            if self.docstore is None:
                raise ValueError(
                    "retrieved ids cannot be resolved to text: restart "
                    "with --passages <collection.tsv>, or score explicit "
                    "texts via POST /rerank")
            try:
                fetched = self.docstore.get_many([i for _, i in missing])
            except KeyError as e:
                raise ValueError(str(e))
            for (j, _), text in zip(missing, fetched):
                out[j] = text
        return out

    def _rerank_ranked(self, query: str, ranked, k: int):
        """One query's retrieved hits rescored by the cross-encoder: the
        top k by its score (stable: retrieval order breaks ties)."""
        if not ranked:
            return ranked
        passages = self._passages_for_ids([h["id"] for h in ranked])
        with self._lock, _on_device(self.device):
            scores = self.reranker.score_texts(query, passages)
        with self._state_lock:
            self.stats["reranked_queries"] += 1
        order = np.argsort(-scores, kind="stable")[:k]
        return [{"id": ranked[i]["id"], "score": float(scores[i]),
                 "retrieval_score": ranked[i]["score"]} for i in order]

    def rerank(self, query: str, passages: List[str], k=None):
        """POST /rerank: cross-encoder scores of explicit texts, sorted
        descending, as (index, score)."""
        if self.reranker is None:
            raise ValueError("this service carries no cross-encoder; "
                             "restart with --reranker to use /rerank")
        if not isinstance(query, str):
            raise ValueError("'query' must be a string")
        if (not isinstance(passages, list) or not passages
                or not all(isinstance(t, str) for t in passages)):
            raise ValueError("'passages' must be a non-empty list of strings")
        k = len(passages) if k is None else int(k)
        if not 1 <= k <= len(passages):
            raise ValueError(
                f"k must be in [1, len(passages)] (got {k} for "
                f"{len(passages)} passages)")
        with self._lock, _on_device(self.device):
            scores = self.reranker.score_texts(query, passages)
        with self._state_lock:
            self.stats["reranked_queries"] += 1
        order = np.argsort(-scores, kind="stable")[:k]
        return [{"index": int(i), "score": float(scores[i])} for i in order]

    # ------------------------------------------------------- live updates

    def add_documents(self, ids: List[int], texts: List[str]) -> int:
        """Encode with the passage tower and append to the resident index;
        the next device pass sees the new index."""
        if self.passage_encode_fn is None:
            raise ValueError("this service was built without a passage "
                             "tower; restart with one to use /add")
        if (not isinstance(texts, list)
                or not all(isinstance(t, str) for t in texts)):
            raise ValueError("'texts' must be a list of strings")
        if len(ids) != len(texts) or not texts:
            raise ValueError("'ids' and 'texts' must be equal-length, "
                             "non-empty lists")
        embs = []
        with self._lock, _on_device(self.device):
            for s in range(0, len(texts), self.encode_batch):
                chunk = texts[s: s + self.encode_batch]
                tokens = self._pad(self.tokenizer(chunk,
                                                  self.passage_max_length),
                                   self.encode_batch)
                embs.append(self.passage_encode_fn(tokens)[: len(chunk)]
                            .cpu().numpy())
            new = self.index.add(np.concatenate(embs),
                                 np.asarray(ids, np.int64))
            self.index = new
        if self.reranker is not None:
            for i, t in zip(ids, texts):
                self._live_texts[int(i)] = t
        return new.n_vectors

    def remove_documents(self, ids: List[int]) -> int:
        """Tombstone documents (``index.remove``)."""
        if not ids:
            raise ValueError("'ids' must be a non-empty list")
        with self._lock:
            self.index = self.index.remove([int(i) for i in ids])
            n = self.index.n_vectors
        for i in ids:
            self._live_texts.pop(int(i), None)
        return n

    def reload_index(self, index_dir: str) -> int:
        """Blue/green swap: load a NEW store in the startup mode and warm
        its searches OUTSIDE the device lock (passes keep answering from
        the old index), then swap."""
        if self._index_loader is None:
            raise ValueError("this service carries no index loader; "
                             "restart to change the index")
        if not isinstance(index_dir, str) or not index_dir:
            raise ValueError("'dir' must be a non-empty path string")
        try:
            new = self._index_loader(index_dir)
        except OSError as e:
            raise ValueError(f"cannot load index from {index_dir}: {e}")
        self._warm_searches(new)
        with self._lock:
            self.index = new
            return new.n_vectors

    def _warm_searches(self, index) -> None:
        """Search ``index`` once per batch size it can dispatch."""
        with _on_device(index.device):
            tokens = self._pad(self.tokenizer(["warmup"], self.max_length),
                               self.encode_batch)
            embs = self.encode_fn(tokens)
            for b in index.warmup_batch_sizes(self.encode_batch):
                index.search(embs[:b], self.default_k)

    def save_index(self, out_dir: str) -> int:
        """Persist the LIVE index (adds and tombstones included), under the
        device lock for a consistent snapshot."""
        if not isinstance(out_dir, str) or not out_dir:
            raise ValueError("'dir' must be a non-empty path string")
        with self._lock:
            self.index.save(out_dir)
            return self.index.n_vectors

    def latency_ms(self) -> dict:
        """p50/p99/mean over the most recent requests (ring of 2048)."""
        with self._state_lock:
            lat = sorted(self._latencies)
        if not lat:
            return {}
        n = len(lat)
        return {
            "latency_p50_ms": round(lat[n // 2] * 1e3, 2),
            "latency_p99_ms": round(lat[min(n - 1, int(n * 0.99))] * 1e3, 2),
            "latency_mean_ms": round(sum(lat) / n * 1e3, 2),
        }

    def _search_device(self, texts: List[str], k: int):
        """One locked encode + search pass over ``texts`` (chunked to the
        fixed encode batch shape); the embeddings stay on the device."""
        with self._lock, _on_device(self.device):
            self.stats["device_batches"] += 1
            out = []
            for s in range(0, len(texts), self.encode_batch):
                chunk = texts[s: s + self.encode_batch]
                tokens = self._pad(self.tokenizer(chunk, self.max_length),
                                   self.encode_batch)
                embs = self.encode_fn(tokens)[: len(chunk)]
                scores, ids = self.index.search(embs, k)
                for r in range(len(chunk)):
                    valid = ids[r] >= 0
                    out.append([
                        {"id": int(i), "score": float(v)}
                        for i, v in zip(ids[r][valid], scores[r][valid])])
            return out


class _Handler(BaseHTTPRequestHandler):
    service: SearchService = None  # set by serve()

    def _reply(self, code: int, payload: dict,
               headers: Optional[dict] = None) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for name, value in (headers or {}).items():
            self.send_header(name, value)
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802 (http.server API)
        if self.path != "/healthz":
            self._reply(404, {"error": f"unknown path {self.path}"})
            return
        idx = self.service.index
        payload = {"ok": True, "n_vectors": idx.n_vectors, "dim": idx.dim,
                   **self.service.stats, **self.service.latency_ms()}
        if hasattr(idx, "nprobe"):  # IVF mode: the probe configuration
            payload["nprobe"] = idx.nprobe
            payload["n_buckets"] = idx.n_buckets
        if hasattr(idx, "factor"):  # refine tier on top
            payload["refine_factor"] = idx.factor
        if self.service.reranker is not None:
            payload["reranker"] = self.service.reranker.arch
        self._reply(200, payload)

    def do_POST(self):  # noqa: N802
        if self.path not in ("/search", "/add", "/remove", "/save",
                             "/reload", "/rerank"):
            self._reply(404, {"error": f"unknown path {self.path}"})
            return
        try:
            length = int(self.headers.get("Content-Length", 0))
            req = json.loads(self.rfile.read(length) or b"{}")
            t0 = time.perf_counter()
            if self.path == "/search":
                queries = req["queries"]
                if not isinstance(queries, list) or not all(
                        isinstance(q, str) for q in queries):
                    raise ValueError("'queries' must be a list of strings")
                payload = {"results": self.service.search(
                    queries, req.get("k"),
                    exclude_ids=req.get("exclude_ids"),
                    rerank_k=req.get("rerank_k"))}
            elif self.path == "/rerank":
                payload = {"results": self.service.rerank(
                    req["query"], req["passages"], req.get("k"))}
            elif self.path == "/add":
                n = self.service.add_documents(
                    [int(i) for i in req["ids"]], req["texts"])
                payload = {"ok": True, "n_vectors": n}
            elif self.path == "/save":
                n = self.service.save_index(req["dir"])
                payload = {"ok": True, "n_vectors": n, "dir": req["dir"]}
            elif self.path == "/reload":
                n = self.service.reload_index(req["dir"])
                payload = {"ok": True, "n_vectors": n, "dir": req["dir"]}
            else:
                n = self.service.remove_documents(
                    [int(i) for i in req["ids"]])
                payload = {"ok": True, "n_vectors": n}
            payload["elapsed_ms"] = round((time.perf_counter() - t0) * 1e3, 2)
            self._reply(200, payload)
        except (KeyError, TypeError, ValueError, OverflowError,
                NotImplementedError) as e:
            # OverflowError: numpy raises it for out-of-range int casts
            self._reply(400, {"error": str(e)})
        except ServiceOverloaded as e:
            self._reply(503, {"error": str(e)},
                        headers={"Retry-After": str(e.retry_after_s)})
        except RuntimeError as e:
            # e.g. the device-worker wait timed out
            self._reply(503, {"error": str(e)})

    def log_message(self, fmt, *args):
        logger.info("%s " + fmt, self.address_string(), *args)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--index", required=True,
                   help="index directory (from cli.index)")
    p.add_argument("--checkpoint", default=None,
                   help="reference .pth.tar weights (random init if absent)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--topk", type=int, default=1000,
                   help="default k, and the ceiling of a request's k")
    p.add_argument("--max-length", type=int, default=30)
    p.add_argument("--passage-max-length", type=int, default=256,
                   help="tokenized length of documents added via POST /add")
    p.add_argument("--encode-batch-size", type=int, default=128)
    p.add_argument("--hbm-dtype", default="bfloat16",
                   choices=("bfloat16", "float32", "int8"),
                   help="device store dtype (int8 = per-row-scaled codes)")
    p.add_argument("--shards", type=int, default=1,
                   help="shard the corpus over this many devices (only 1: "
                        "multi-GPU is ROADMAP A6)")
    p.add_argument("--ivf", action="store_true",
                   help="serve the IVF index at <index>/ivf (cli.index "
                        "--ivf-nlist): probe --nprobe cells per query "
                        "instead of scanning the whole corpus")
    p.add_argument("--nprobe", type=int, default=None,
                   help="IVF cells probed per query (default: the build's "
                        "value); nprobe=n_buckets is exact")
    p.add_argument("--refine-factor", type=int, default=None,
                   help="with --ivf: re-score the top k*FACTOR first-tier "
                        "candidates exactly against the flat disk store at "
                        "<index> (memmapped; FAISS IndexRefineFlat) and "
                        "return the refined top-k")
    p.add_argument("--reranker", choices=("distilbert", "bert"), default=None,
                   help="keep a cross-encoder second stage resident: "
                        "enables POST /rerank and 'rerank_k' on /search "
                        "('bert' = the MiniLM teacher's family)")
    p.add_argument("--reranker-checkpoint", default=None,
                   help="cross-encoder weights (HF .pth.tar/.bin/.pt or a "
                        "JAX .msgpack); omitted = random init")
    p.add_argument("--reranker-size", choices=("full", "tiny"),
                   default="full",
                   help="'full' = MiniLM-L6 for --reranker bert, "
                        "distilbert-base otherwise")
    p.add_argument("--reranker-config", default=None,
                   help="cross-encoder config overrides as a JSON file "
                        "path or inline JSON (over --reranker-size)")
    p.add_argument("--reranker-tokenizer", default=None,
                   help="tokenizer of the cross-encoder (default: "
                        "--tokenizer)")
    p.add_argument("--rerank-max-length", type=int, default=256,
                   help="joined [CLS] q [SEP] p [SEP] length")
    p.add_argument("--rerank-batch-size", type=int, default=32,
                   help="fixed pair-batch shape of the cross-encoder")
    p.add_argument("--passages", default=None,
                   help="collection TSV (pid\\ttext or pid\\ttitle\\tpara) "
                        "mmap'd as a docstore so rerank_k can resolve "
                        "retrieved ids to texts")
    p.add_argument("--max-batch-wait-ms", type=float, default=2.0,
                   help="dynamic micro-batching window: how long the device "
                        "worker waits for more concurrent requests")
    p.add_argument("--no-dynamic-batching", action="store_true",
                   help="process each request in its own device pass")
    p.add_argument("--max-pending", type=int, default=256,
                   help="reject requests with 503 + Retry-After once this "
                        "many are queued for the device worker")
    p.add_argument("--precision", default="default",
                   choices=("default", "high", "highest"),
                   help="'default' runs the kernels (bf16 operands, fp32 "
                        "accumulation; fp32 stores in fp32); 'high' and "
                        "'highest' score with a plain fp32 matmul")
    add_model_args(p)
    return p


def _build_reranker(args) -> Optional[Reranker]:
    """The resident cross-encoder of ``--reranker`` (bf16 compute)."""
    if not args.reranker:
        return None
    # --attention-impl applies to every model the daemon holds
    rcfg = cross_encoder_config(args.reranker, args.reranker_size,
                                args.reranker_config, args.attention_impl)
    if args.rerank_max_length > rcfg.max_position_embeddings:
        raise SystemExit(
            f"--rerank-max-length {args.rerank_max_length} exceeds the "
            "cross-encoder's max_position_embeddings="
            f"{rcfg.max_position_embeddings}")
    if not args.reranker_checkpoint:
        logger.warning("--reranker without --reranker-checkpoint: the "
                       "second stage scores with RANDOM weights")
    model = load_cross_encoder(args.reranker_checkpoint, rcfg, args.reranker,
                               torch.bfloat16, args.device)
    tokenizer = build_tokenizer(args.reranker_tokenizer or args.tokenizer,
                                vocab_size=rcfg.vocab_size)
    logger.info("reranker: %s cross-encoder resident (pair batch %d x %d)",
                args.reranker, args.rerank_batch_size,
                args.rerank_max_length)
    return Reranker(make_cross_encoder_score_fn(model), tokenizer,
                    args.rerank_max_length, args.rerank_batch_size,
                    with_token_type_ids=args.reranker == "bert",
                    arch=args.reranker)


def make_service(args) -> SearchService:
    if args.shards != 1:
        raise SystemExit(f"--shards {args.shards}: multi-GPU serving is "
                         "ROADMAP A6, not yet ported")
    cfg = model_config_from_args(args)
    for flag, val in (("--max-length", args.max_length),
                      ("--passage-max-length", args.passage_max_length)):
        if val > cfg.max_position_embeddings:
            raise SystemExit(
                f"{flag} {val} exceeds the model's max_position_embeddings"
                f"={cfg.max_position_embeddings}")
    use_ivf = args.ivf
    if use_ivf and args.nprobe is not None and args.nprobe < 1:
        raise SystemExit(f"--nprobe must be >= 1 (got {args.nprobe})")
    if args.refine_factor is not None:
        if not use_ivf:
            raise SystemExit("--refine-factor requires --ivf (the flat "
                             "index is already exact)")
        if args.refine_factor < 1:
            raise SystemExit(
                f"--refine-factor must be >= 1 (got {args.refine_factor})")
    tokenizer = build_tokenizer(args.tokenizer, vocab_size=cfg.vocab_size)
    model = load_dual_encoder(args.checkpoint, cfg, args.share_weights,
                              args.cosine, torch.bfloat16, args.device)
    hbm_dtype = dtype_from_name(args.hbm_dtype)

    def index_loader(index_dir: str):
        """Load ``index_dir`` in the daemon's startup mode: at startup and
        for POST /reload (flat/IVF, device dtype, precision, nprobe)."""
        if not use_ivf:
            return load_index(index_dir, dtype=hbm_dtype,
                              precision=args.precision, device=args.device)
        # the parent store dir or the ivf dir itself
        ivf_dir = (index_dir if ivf_exists(index_dir)
                   else os.path.join(index_dir, "ivf"))
        if not ivf_exists(ivf_dir):
            raise ValueError(f"no IVF index at {ivf_dir}: build one with "
                             "cli.index --ivf-nlist N (or drop --ivf)")
        with open(os.path.join(ivf_dir, IVF_META_NAME)) as f:
            is_pq = json.load(f)["dtype"] == "pq"
        # a PQ store has one device form: --hbm-dtype does not apply
        idx = IVFIndex.load(ivf_dir, dtype=None if is_pq else hbm_dtype,
                            precision=args.precision, device=args.device)
        if args.nprobe is not None:
            idx.nprobe = min(args.nprobe, idx.n_buckets)
        logger.info("IVF%s serving: %d buckets x %d slot, nprobe=%d",
                    "PQ" if is_pq else "", idx.n_buckets, idx.slot,
                    idx.nprobe)
        if args.refine_factor:
            if not index_exists(index_dir):
                raise ValueError(
                    f"--refine-factor needs the flat embedding store at "
                    f"{index_dir} (point --index at the parent store dir, "
                    "not the ivf subdir)")
            idx = RefinedIndex(idx, DiskRefiner(index_dir),
                               factor=args.refine_factor)
        return idx

    try:
        index = index_loader(args.index)
    except ValueError as e:
        raise SystemExit(str(e))
    docstore = None
    if args.passages:
        if not os.path.exists(args.passages):
            raise SystemExit(f"--passages {args.passages}: no such file")
        docstore = TsvDocStore(args.passages)
        logger.info("docstore: %d passages mmap'd from %s", len(docstore),
                    args.passages)
    return SearchService(
        tokenizer, make_encode_fn(model, "query_embs"), index,
        args.max_length, args.encode_batch_size, args.topk,
        dynamic_batching=not args.no_dynamic_batching,
        max_batch_wait_ms=args.max_batch_wait_ms,
        passage_encode_fn=make_encode_fn(model, "passage_embs"),
        passage_max_length=args.passage_max_length,
        index_loader=index_loader, reranker=_build_reranker(args),
        docstore=docstore, max_pending=args.max_pending)


def serve(args, ready_event: Optional[threading.Event] = None):
    """Build the service, warm it up and bind the socket; returns the
    server (call ``serve_forever``). ``ready_event`` is set once bound."""
    service = make_service(args)
    service.warmup()
    handler = type("BoundHandler", (_Handler,), {"service": service})
    httpd = ThreadingHTTPServer((args.host, args.port), handler)
    logger.info("serving %d vectors on http://%s:%d (k=%d)",
                service.index.n_vectors, args.host, httpd.server_address[1],
                args.topk)
    if ready_event is not None:
        ready_event.set()
    return httpd


def main(argv: Optional[List[str]] = None) -> int:
    setup_logging()
    args = build_parser().parse_args(argv)
    httpd = serve(args)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.RequestHandlerClass.service.close()
        httpd.server_close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
