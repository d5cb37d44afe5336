"""N-way training dataset with fixed-shape collation (copy of
``cldrd_tpu/data/nway_dataset.py``).

- one constructor over ``cldrd_tpu_torch.data.loaders`` covers the
  reference's seven ``create_from_*`` file layouts; ``rank/nranks``
  slices the training file;
- the collator emits static shapes: ``[bz, Lq]`` queries,
  ``[bz, nway, Lp]`` passages (or their packed layout), ``[bz, nway]``
  labels;
- outputs are host numpy; the trainer moves them to the device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from .label_modes import labels_for, nway_for
from .loaders import load_passages, load_queries, load_train_examples, passage_text


@dataclass
class NwayBatch:
    """One collated training batch (host numpy, static shapes)."""

    qid: np.ndarray            # [bz] int64
    relT_pids: np.ndarray      # [bz, n_relT] int64
    neg_pids: np.ndarray       # [bz, n_neg] int64
    nway_pids: np.ndarray      # [bz, nway] int64
    query: Dict[str, np.ndarray]          # [bz, Lq]
    nway_passages: Dict[str, np.ndarray]  # [bz, nway, Lp]
    labels: np.ndarray         # [bz, nway] float32
    # teacher scores for KD losses (margin-MSE / KL-div); equals ``labels``
    # when the training file carries no scores, so the train step has one
    # static signature either way
    teacher_scores: Optional[np.ndarray] = None  # [bz, nway] float32
    # packed passage tower inputs (``data/packing.py``; set when the
    # dataset was built with ``pack_passages=True``): the device-facing
    # replacement for ``nway_passages`` at ~token-proportional FLOPs
    packed_passages: Optional[Dict[str, np.ndarray]] = None


class NwayDataset:
    """Map-style dataset over teacher-ranking examples
    ``{qid, relT_pids, neg_pids}`` with graded labels per ``label_mode``."""

    def __init__(
        self,
        qid_to_query: Dict[int, str],
        pid_to_passage: Dict[int, object],
        train_examples: List[dict],
        tokenizer,
        max_query_len: int,
        max_passage_len: int,
        label_mode: str = "3",
        neg_score_mode: str = "original",
        pack_passages: bool = False,
    ):
        self.qid_to_query = qid_to_query
        self.pid_to_passage = pid_to_passage
        self.train_examples = train_examples
        self.tokenizer = tokenizer
        self.max_query_len = max_query_len
        self.max_passage_len = max_passage_len
        self.label_mode = str(label_mode)
        # sequence packing (data/packing.py): collate emits packed_passages
        # alongside the flat layout; row count only ever grows (monotone
        # min_rows) so a run sees a couple of shapes
        self.pack_passages = pack_passages
        self._pack_min_rows = 0
        # teacher-score handling for negatives without scores (the missing
        # kd trainers' --neg_score_mode={mean,original} flag, SURVEY §2.4):
        # 'original' keeps given scores (0.0 where absent); 'mean' fills
        # absent negative scores with the mean relT score minus a margin
        self.neg_score_mode = neg_score_mode
        self.nway = nway_for(self.label_mode)
        sep = getattr(tokenizer, "sep_token", "[SEP]")
        self._sep = sep

    def __len__(self) -> int:
        return len(self.train_examples)

    def __getitem__(self, idx: int) -> dict:
        ex = self.train_examples[idx]
        qid, relT_pids, neg_pids = ex["qid"], ex["relT_pids"], ex["neg_pids"]
        labels = labels_for(self.label_mode, len(relT_pids), len(neg_pids))
        item = {
            "qid": qid,
            "relT_pids": relT_pids,
            "neg_pids": neg_pids,
            "query": self.qid_to_query[qid],
            "passages": [
                passage_text(self.pid_to_passage[pid], self._sep)
                for pid in list(relT_pids) + list(neg_pids)
            ],
            "labels": labels,
        }
        if "relT_scores" in ex:
            rel_s = list(ex["relT_scores"])
            neg_s = list(ex.get("neg_scores") or [])
            if len(neg_s) < len(neg_pids):
                if self.neg_score_mode == "mean":
                    fill = float(np.mean(rel_s)) - 1.0 if rel_s else 0.0
                else:
                    fill = 0.0
                neg_s = neg_s + [fill] * (len(neg_pids) - len(neg_s))
            item["teacher_scores"] = np.asarray(rel_s + neg_s, np.float32)
        return item

    def collate(self, items: Sequence[dict]) -> NwayBatch:
        bz = len(items)
        nway = self.nway
        flat_passages: List[str] = []
        for it in items:
            assert len(it["passages"]) == nway
            flat_passages.extend(it["passages"])
        queries = self.tokenizer([it["query"] for it in items], self.max_query_len)
        passages = self.tokenizer(flat_passages, self.max_passage_len)
        passages = {k: v.reshape(bz, nway, -1) for k, v in passages.items()}
        relT = np.asarray([it["relT_pids"] for it in items], np.int64)
        neg = (
            np.asarray([it["neg_pids"] for it in items], np.int64)
            if len(items[0]["neg_pids"])
            else np.zeros((bz, 0), np.int64)
        )
        labels = np.stack([it["labels"] for it in items]).astype(np.float32)
        if all("teacher_scores" in it for it in items):
            teacher = np.stack([it["teacher_scores"] for it in items]).astype(np.float32)
        else:
            teacher = labels
        packed = None
        if self.pack_passages:
            from .packing import pack_nway_batch

            pb = pack_nway_batch(
                passages["input_ids"], passages["attention_mask"],
                min_rows=self._pack_min_rows or None,
            )
            self._pack_min_rows = max(self._pack_min_rows, pb.input_ids.shape[1])
            packed = pb.as_dict()
        return NwayBatch(
            qid=np.asarray([it["qid"] for it in items], np.int64),
            relT_pids=relT,
            neg_pids=neg,
            nway_pids=np.concatenate([relT, neg], axis=-1),
            query=queries,
            nway_passages=passages,
            labels=labels,
            teacher_scores=teacher,
            packed_passages=packed,
        )

    # ------------------------------------------------------------ factories

    @classmethod
    def create_from_files(
        cls,
        queries_path: str,
        passages_path: str,
        training_path: str,
        tokenizer,
        max_query_len: int,
        max_passage_len: int,
        label_mode: str,
        fmt: str = "relT_most_semi_hard",
        rank: int = -1,
        nranks: Optional[int] = None,
        neg_score_mode: str = "original",
        pack_passages: bool = False,
    ) -> "NwayDataset":
        """One factory covering the reference's seven ``create_from_*``
        constructors (select the file layout via ``fmt``; shard by
        ``rank/nranks`` for multi-host input pipelines)."""
        return cls(
            load_queries(queries_path),
            load_passages(passages_path),
            load_train_examples(training_path, fmt=fmt, rank=rank, nranks=nranks),
            tokenizer,
            max_query_len,
            max_passage_len,
            label_mode,
            neg_score_mode=neg_score_mode,
            pack_passages=pack_passages,
        )

    # epoch iteration ----------------------------------------------------

    def batches(
        self,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = True,
    ) -> Iterator[NwayBatch]:
        order = np.arange(len(self))
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        end = len(order) - (len(order) % batch_size) if drop_last else len(order)
        for start in range(0, end, batch_size):
            idxs = order[start : start + batch_size]
            if len(idxs) < batch_size and drop_last:
                break
            yield self.collate([self[i] for i in idxs])
