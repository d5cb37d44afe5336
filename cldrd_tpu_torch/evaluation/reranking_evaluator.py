"""Model-in-the-loop reranking evaluation (port of
``cldrd_tpu/evaluation/reranking_evaluator.py``).

``RerankingEvaluator`` scores (qid, pid) candidate pairs with a dual or
cross encoder and runs the shared metric core (``RankingEvaluator``);
``ContinueRerankEvaluator`` evaluates every checkpoint of a training run
folder (the port's ``.pth.tar`` and the JAX trainer's ``.msgpack``);
``write_rankdata`` writes scored ranklists as a run TSV.

Scoring runs under ``torch.inference_mode`` on the model's device, one
fixed-shape batch at a time; grouping and the metric arithmetic stay on
the host in numpy, as in the reference.
"""
from __future__ import annotations

import glob
import os
import re
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from cldrd_tpu_torch.data.reranking_dataset import RerankBatch, RerankingDataset

from .ranking_evaluator import RankingEvaluator

ScoreFn = Callable[[RerankBatch], np.ndarray]  # batch -> [bz] float scores


def _on(model, tokens: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    dev = next(model.parameters()).device
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev, torch.int64)
            for k, v in tokens.items()}


def make_dual_encoder_score_fn(model) -> ScoreFn:
    """Score (q, p) pairs with a dual encoder: dot(CLS_q, CLS_p) in fp32
    (the reference's dual path)."""

    def fn(batch: RerankBatch) -> np.ndarray:
        assert batch.query is not None and batch.passage is not None
        with torch.inference_mode():
            q = model.query_embs(_on(model, batch.query))
            p = model.passage_embs(_on(model, batch.passage))
            return torch.einsum("bd,bd->b", q.float(),
                                p.float()).cpu().numpy()

    return fn


def make_cross_encoder_score_fn(model) -> ScoreFn:
    """Score concatenated (q ++ p) sequences with a cross encoder (the
    reference's cross path), flat or packed."""

    def fn(batch: RerankBatch) -> np.ndarray:
        assert batch.query_passage is not None
        with torch.inference_mode():
            return model(_on(model, batch.query_passage)).float() \
                .cpu().numpy()

    return fn


def write_rankdata(
    qid_to_ranklist: Dict[int, Sequence[Tuple[int, float]]], path: str
) -> None:
    """Write scored ranklists as a ``qid\\tpid\\trank\\tscore`` run TSV."""
    with open(path, "w", encoding="utf-8") as f:
        for qid, ranked in qid_to_ranklist.items():
            for rank, (pid, score) in enumerate(ranked, start=1):
                f.write(f"{qid}\t{pid}\t{rank}\t{score:.6f}\n")


class RerankingEvaluator(RankingEvaluator):
    """Evaluate a scoring model over (qid, pid) candidate pairs."""

    def score_pairs(
        self,
        score_fn: ScoreFn,
        dataset: RerankingDataset,
        batch_size: int = 128,
        bucket_lengths: Optional[List[int]] = None,
        pack_pairs: bool = False,
    ) -> Dict[int, List[Tuple[int, float]]]:
        """Score every pair and group into per-query ranklists sorted by
        score descending (stable, so run-file order breaks ties).

        ``bucket_lengths`` (a list, possibly empty for the default ladder)
        switches to length-bucketed batches: identical scores at
        ~token-proportional device cost (``RerankingDataset.batches_bucketed``;
        one executable per bucket). ``pack_pairs`` (cross-encoder mode
        only) packs several pairs per row instead — even fewer padding
        FLOPs (``RerankingDataset.batches_packed``)."""
        if pack_pairs:
            batches = dataset.batches_packed(batch_size)
        elif bucket_lengths is not None:
            batches = dataset.batches_bucketed(
                batch_size, list(bucket_lengths) or None
            )
        else:
            batches = dataset.batches(batch_size)
        qid_to_scored: Dict[int, List[Tuple[int, float]]] = {}
        for batch in batches:
            scores = score_fn(batch)
            for i in range(batch.n_valid):
                qid_to_scored.setdefault(int(batch.qids[i]), []).append(
                    (int(batch.pids[i]), float(scores[i]))
                )
        return {
            qid: sorted(pairs, key=lambda x: -x[1])
            for qid, pairs in qid_to_scored.items()
        }

    def compute_metrics(  # type: ignore[override]
        self,
        score_fn: ScoreFn,
        dataset: RerankingDataset,
        batch_size: int = 128,
        rankdata_path: Optional[str] = None,
        bucket_lengths: Optional[List[int]] = None,
    ) -> Dict[int, object]:
        """Rerank with the model, then run the shared metric core."""
        qid_to_scored = self.score_pairs(
            score_fn, dataset, batch_size, bucket_lengths=bucket_lengths
        )
        if rankdata_path is not None:
            write_rankdata(qid_to_scored, rankdata_path)
        ranklists = {
            qid: [pid for pid, _ in scored] for qid, scored in qid_to_scored.items()
        }
        return self.compute_metrics_from_ranklists(ranklists)

    def direct_compute_metric(
        self, qid_to_ranklist: Dict[int, Sequence[int]]
    ) -> Dict[str, float]:
        """Metrics from precomputed ranklists (reference ``:107-119``)."""
        return self.compute_metrics_from_ranklists(dict(qid_to_ranklist))


class ContinueRerankEvaluator:
    """Evaluate every checkpoint in a training run folder — the missing
    ``continue_rerank_evaluator`` capability (SURVEY §2.4).

    ``params_loader(path) -> model`` reads a checkpoint (either format);
    ``score_fn_factory(model)`` makes its score function; results
    accumulate in a step-keyed table.
    """

    def __init__(
        self,
        evaluator: RerankingEvaluator,
        dataset: RerankingDataset,
        score_fn_factory: Callable[[object], ScoreFn],
        params_loader: Callable[[str], object],
        batch_size: int = 128,
        bucket_lengths: Optional[List[int]] = None,
    ):
        self.evaluator = evaluator
        self.dataset = dataset
        self.score_fn_factory = score_fn_factory
        self.params_loader = params_loader
        self.batch_size = batch_size
        self.bucket_lengths = bucket_lengths

    def checkpoints(self, folder: str, prefix: str = "checkpoint"
                    ) -> List[Tuple[int, str]]:
        """(step, path) of every ``<prefix>_<step>.pth.tar`` (the port's)
        and ``.msgpack`` (the JAX trainer's) in ``folder``, by step."""
        out = []
        for ext in (".pth.tar", ".msgpack"):
            for path in glob.glob(os.path.join(folder, f"{prefix}_*{ext}")):
                m = re.search(rf"{prefix}_(\d+){re.escape(ext)}$", path)
                if m:
                    out.append((int(m.group(1)), path))
        return sorted(out)

    def evaluate_folder(
        self, folder: str, results_path: Optional[str] = None
    ) -> Dict[int, Dict[str, float]]:
        from cldrd_tpu_torch.utils import MetricMonitor

        monitor = MetricMonitor()
        results: Dict[int, Dict[str, float]] = {}
        for step, path in self.checkpoints(folder):
            params = self.params_loader(path)
            metrics = self.evaluator.compute_metrics(
                self.score_fn_factory(params), self.dataset, self.batch_size,
                bucket_lengths=self.bucket_lengths,
            )
            results[step] = metrics
            monitor.update(step, **{k: float(v) for k, v in metrics.items()})
        if results_path is not None:
            monitor.write(results_path)
        return results
