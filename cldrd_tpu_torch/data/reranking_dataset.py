"""Reranking dataset: (qid, pid) pairs scored by a dual or cross encoder
(port of ``cldrd_tpu/data/reranking_dataset.py``).

Run-file parsing, the title-[SEP]-para join and dual- vs cross-encoder
collation, padded to a fixed batch shape. ``batches``,
``batches_packed`` and ``batches_bucketed`` (length buckets,
``data/bucketing.py``) give the reference's numpy arrays element for
element.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from cldrd_tpu_torch.utils.profiling import annotate

from .loaders import load_passages, load_queries, passage_text


@dataclass
class RerankBatch:
    qids: np.ndarray  # [bz] int64, -1 padded
    pids: np.ndarray  # [bz] int64, -1 padded
    n_valid: int
    # cross-encoder mode:
    query_passage: Optional[Dict[str, np.ndarray]] = None  # [bz, L]
    # dual-encoder mode:
    query: Optional[Dict[str, np.ndarray]] = None    # [bz, Lq]
    passage: Optional[Dict[str, np.ndarray]] = None  # [bz, Lp]


class RerankingDataset:
    def __init__(
        self,
        ranking_path: str,
        queries_path: str,
        passages_path: str,
        tokenizer,
        is_cross_encoder: bool,
        query_first: bool = True,
        max_len: Optional[int] = None,
        query_max_len: Optional[int] = None,
        passage_max_len: Optional[int] = None,
        with_token_type_ids: bool = False,
    ):
        pairs: List[Tuple[int, int]] = []
        with open(ranking_path, "r", encoding="utf-8") as f:
            for line in f:
                a = line.rstrip("\n").split("\t")
                qid, pid = (int(a[0]), int(a[1])) if query_first else (int(a[1]), int(a[0]))
                pairs.append((qid, pid))
        self._init_core(
            pairs, load_queries(queries_path), load_passages(passages_path),
            tokenizer, is_cross_encoder, max_len, query_max_len, passage_max_len,
            with_token_type_ids,
        )

    @classmethod
    def from_pairs(
        cls,
        pairs: List[Tuple[int, int]],
        qid_to_query: Dict[int, str],
        pid_to_passage: Dict[int, object],
        tokenizer,
        is_cross_encoder: bool,
        max_len: Optional[int] = None,
        query_max_len: Optional[int] = None,
        passage_max_len: Optional[int] = None,
        with_token_type_ids: bool = False,
    ) -> "RerankingDataset":
        """In-memory (qid, pid) pairs with preloaded text lookups — shares
        the exact collation contract with the file-based constructor (used
        by teacher-data creation so the two paths cannot drift)."""
        obj = cls.__new__(cls)
        obj._init_core(
            list(pairs), qid_to_query, pid_to_passage,
            tokenizer, is_cross_encoder, max_len, query_max_len, passage_max_len,
            with_token_type_ids,
        )
        return obj

    def _init_core(
        self, pairs, qid_to_query, pid_to_passage, tokenizer,
        is_cross_encoder, max_len, query_max_len, passage_max_len,
        with_token_type_ids=False,
    ) -> None:
        self.pairs = pairs
        self.qid_to_query = qid_to_query
        self.pid_to_passage = pid_to_passage
        self.tokenizer = tokenizer
        self.is_cross_encoder = is_cross_encoder
        # BERT-family cross encoders (the MiniLM teacher) need segment ids;
        # emitted alongside input_ids/attention_mask in cross-mode batches.
        self.with_token_type_ids = with_token_type_ids
        if with_token_type_ids and not is_cross_encoder:
            raise ValueError("token_type_ids only apply to cross-encoder mode")
        if is_cross_encoder:
            assert max_len is not None
            self.max_len = max_len
        else:
            assert query_max_len is not None and passage_max_len is not None
            self.query_max_len = query_max_len
            self.passage_max_len = passage_max_len
        self._sep = getattr(tokenizer, "sep_token", "[SEP]")

    def __len__(self) -> int:
        return len(self.pairs)

    def _pad_tokens(self, tokens: Dict[str, np.ndarray], pad_to: int) -> Dict[str, np.ndarray]:
        n = next(iter(tokens.values())).shape[0]
        if n == pad_to:
            return tokens
        return {
            k: np.concatenate([v, np.zeros((pad_to - n, v.shape[1]), v.dtype)])
            for k, v in tokens.items()
        }

    def batches(self, batch_size: int) -> Iterator[RerankBatch]:
        for start in range(0, len(self.pairs), batch_size):
            with annotate("cldrd.data.batch"):
                batch = self._batch(self.pairs[start : start + batch_size],
                                    batch_size)
            yield batch

    def _batch(self, chunk, batch_size: int) -> RerankBatch:
        """Tokenize and collate ``chunk``'s pairs, padded to ``batch_size``."""
        n = len(chunk)
        queries = [self.qid_to_query[q] for q, _ in chunk]
        passages = [
            passage_text(self.pid_to_passage[p], self._sep) for _, p in chunk
        ]
        qids = np.full((batch_size,), -1, np.int64)
        pids = np.full((batch_size,), -1, np.int64)
        qids[:n] = [q for q, _ in chunk]
        pids[:n] = [p for _, p in chunk]
        if self.is_cross_encoder:
            qp = self.tokenizer(
                queries, self.max_len, pairs=passages,
                **({"return_token_type_ids": True}
                   if self.with_token_type_ids else {}),
            )
            return RerankBatch(
                qids=qids, pids=pids, n_valid=n,
                query_passage=self._pad_tokens(qp, batch_size),
            )
        q = self.tokenizer(queries, self.query_max_len)
        p = self.tokenizer(passages, self.passage_max_len)
        return RerankBatch(
            qids=qids, pids=pids, n_valid=n,
            query=self._pad_tokens(q, batch_size),
            passage=self._pad_tokens(p, batch_size),
        )

    def batches_packed(
        self,
        batch_size: int,
        row_multiple: int = 8,
    ) -> Iterator[RerankBatch]:
        """Packed cross-encoder batches: several (q ++ p) pairs per
        ``max_len`` row (``data/packing.py``: segment-masked attention and
        per-segment position reset). Packed rows lose the cls-only final
        block (every segment start is needed); the BERT cross-encoder
        refuses them (token types would need per-segment resets).

        Each batch packs ``batch_size`` pairs into ``R`` rows;
        ``query_passage`` carries ``[R, L]`` arrays plus ``gather_pos
        [batch_size]`` (each pair's CLS position in the flattened ``R*L``
        axis), ``CrossEncoder``'s packed contract. ``R`` rounds up a
        ladder and only ever grows."""
        if not self.is_cross_encoder:
            raise ValueError("batches_packed is for cross-encoder mode "
                             "(dual mode: use batches_bucketed)")
        from .packing import pack_nway_batch

        min_rows = 0
        L = self.max_len
        for start in range(0, len(self.pairs), batch_size):
            chunk = self.pairs[start : start + batch_size]
            n = len(chunk)
            queries = [self.qid_to_query[q] for q, _ in chunk]
            passages = [
                passage_text(self.pid_to_passage[p], self._sep) for _, p in chunk
            ]
            toks = self.tokenizer(queries, L, pairs=passages)
            ids = np.zeros((batch_size, L), np.int32)
            mask = np.zeros((batch_size, L), np.int32)
            ids[:n] = toks["input_ids"]
            mask[:n] = toks["attention_mask"]
            pb = pack_nway_batch(
                ids[None], mask[None], row_multiple=row_multiple,
                min_rows=min_rows or None,
            )
            min_rows = max(min_rows, pb.input_ids.shape[1])
            qids = np.full((batch_size,), -1, np.int64)
            pids = np.full((batch_size,), -1, np.int64)
            qids[:n] = [q for q, _ in chunk]
            pids[:n] = [p for _, p in chunk]
            yield RerankBatch(
                qids=qids, pids=pids, n_valid=n,
                query_passage={
                    "input_ids": pb.input_ids[0],
                    "attention_mask": pb.attention_mask[0],
                    "position_ids": pb.position_ids[0],
                    "segment_ids": pb.segment_ids[0],
                    "gather_pos": pb.gather_pos[0],
                },
            )

    def batches_bucketed(
        self,
        batch_size: int,
        bucket_lengths: Optional[List[int]] = None,
        batch_multiple: int = 1,
    ) -> Iterator[RerankBatch]:
        """Length-bucketed batches: scoring at ~token-proportional FLOPs.

        Pair order is free for every consumer — ``score_pairs`` and the
        teacher reranker regroup scores by qid — so rows regroup into the
        ``data/bucketing.py`` ladder: cross-encoder mode buckets the joined
        ``q ++ [SEP] ++ p`` rows; dual mode buckets the passage tower and
        keeps queries at ``query_max_len`` (they are ~30 tokens already).
        Padding is attention-masked, so every score is identical to the
        flat layout's in fp32; under bfloat16 compute, kernels and
        reductions differ per shape, so scores can move in the last bits,
        the same variation any batch-size change causes. Per-bucket
        batch sizes scale inversely with length (constant tokens per
        dispatch, no wasted rows)."""
        from .bucketing import bucket_specs, required_lengths

        max_len = self.max_len if self.is_cross_encoder else self.passage_max_len
        specs = bucket_specs(
            max_len, batch_size, bucket_lengths, batch_multiple
        )
        cuts = np.asarray([s.length for s in specs])
        # pending rows per bucket: (qid, pid, main ids, main mask[, q ids,
        # q mask]) — tokenized ONCE at full width; emission slices to the
        # bucket length, which is lossless because a row in bucket L has
        # required length <= L (so neither width truncates it differently)
        pend: List[List[tuple]] = [[] for _ in specs]

        def emit(b: int) -> RerankBatch:
            spec, rows = specs[b], pend[b]
            pend[b] = []
            n = len(rows)
            bz, L = spec.batch_size, spec.length
            qids = np.full((bz,), -1, np.int64)
            pids = np.full((bz,), -1, np.int64)
            main_ids = np.zeros((bz, L), np.int32)
            main_mask = np.zeros((bz, L), np.int32)
            main_types = (np.zeros((bz, L), np.int32)
                          if self.with_token_type_ids else None)
            for r, row in enumerate(rows):
                qids[r], pids[r] = row[0], row[1]
                main_ids[r] = row[2][:L]
                main_mask[r] = row[3][:L]
                if main_types is not None:
                    main_types[r] = row[-1][:L]
            if self.is_cross_encoder:
                qp = {"input_ids": main_ids, "attention_mask": main_mask}
                if main_types is not None:
                    qp["token_type_ids"] = main_types
                return RerankBatch(
                    qids=qids, pids=pids, n_valid=n, query_passage=qp,
                )
            lq = self.query_max_len
            q_ids = np.zeros((bz, lq), np.int32)
            q_mask = np.zeros((bz, lq), np.int32)
            for r, row in enumerate(rows):
                q_ids[r] = row[4]
                q_mask[r] = row[5]
            return RerankBatch(
                qids=qids, pids=pids, n_valid=n,
                query={"input_ids": q_ids, "attention_mask": q_mask},
                passage={"input_ids": main_ids, "attention_mask": main_mask},
            )

        chunk = 1024
        for start in range(0, len(self.pairs), chunk):
            idxs = range(start, min(start + chunk, len(self.pairs)))
            queries = [self.qid_to_query[self.pairs[i][0]] for i in idxs]
            passages = [
                passage_text(self.pid_to_passage[self.pairs[i][1]], self._sep)
                for i in idxs
            ]
            if self.is_cross_encoder:
                toks = self.tokenizer(
                    queries, max_len, pairs=passages,
                    **({"return_token_type_ids": True}
                       if self.with_token_type_ids else {}),
                )
                q_toks = None
            else:
                toks = self.tokenizer(passages, max_len)
                q_toks = self.tokenizer(queries, self.query_max_len)
            ids = np.asarray(toks["input_ids"])
            mask = np.asarray(toks["attention_mask"])
            lens = required_lengths(mask)
            for j, (i, b) in enumerate(zip(idxs, np.searchsorted(cuts, lens))):
                row = (self.pairs[i][0], self.pairs[i][1], ids[j], mask[j])
                if q_toks is not None:
                    row += (np.asarray(q_toks["input_ids"][j]),
                            np.asarray(q_toks["attention_mask"][j]))
                if self.with_token_type_ids:
                    # always the LAST element; emit() slices row[-1]
                    row += (np.asarray(toks["token_type_ids"][j]),)
                pend[int(b)].append(row)
                if len(pend[int(b)]) == specs[int(b)].batch_size:
                    yield emit(int(b))
        for b in range(len(specs)):
            if pend[b]:
                yield emit(b)


# The reference's missing ``dataset::MsMacroRerankingDataset``
# (``reranking_evaluator.py:284``, SURVEY §2.4) is the same capability with
# MS MARCO file layouts; this alias keeps reference-oriented call sites
# working (sic: the reference spells it "MsMacro").
MsMarcoRerankingDataset = RerankingDataset
MsMacroRerankingDataset = RerankingDataset
