"""Run-file retrieval metrics: MRR@k, Recall@k, nDCG@k, MAP@k.

Reproduces the metric semantics of the reference evaluator
(CL-DRD's ``evaluation/retrieval_evaluator.py:14-246``) exactly — same
qrels filtering (grade <= 1e-5 dropped), same binarization points (2.0 for
TREC-style graded qrels, 1.0 for MS MARCO), same per-query definitions:

- MRR@k: reciprocal rank of the *first* binary-relevant hit, 0 if it falls
  beyond k.
- Recall@k: #(binary-relevant hits at rank <= k) / #(binary-relevant in qrels).
- MAP@k: precision-sum over binary-relevant hits at rank <= k divided by the
  total number of binary-relevant qrels entries.
- nDCG@k: graded gains grade/log2(1+rank) over hits at rank <= k, normalized
  by the ideal DCG of the top-min(#relevant, k) grades.

Aggregation divides by the number of ranked queries that appear in the qrels
(``evaluated_queries``); queries in the run but absent from qrels are ignored.

This is host-side numpy code by design: the metric computation is a trivial
fraction of end-to-end cost and must be bit-for-bit comparable with the
reference's published numbers (reference README.md:35).
"""
from __future__ import annotations

import csv
from typing import Dict, List, Sequence

import numpy as np


def load_qrels(qrel_path: str, is_trec: bool = False) -> Dict[int, Dict[int, float]]:
    """Parse a qrels file into {qid: {pid: grade}}, dropping grades <= 1e-5.

    TREC qrels are space-separated, MS MARCO qrels tab-separated
    (reference retrieval_evaluator.py:20-27).
    """
    sep = " " if is_trec else "\t"
    qid_to_relevant: Dict[int, Dict[int, float]] = {}
    with open(qrel_path, "r") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            qid_s, _, pid_s, grade_s = line.split(sep)
            grade = float(grade_s)
            if grade <= 0.00001:
                continue
            qid_to_relevant.setdefault(int(qid_s), {})[int(pid_s)] = grade
    return qid_to_relevant


def load_run_ranklists(ranking_path: str) -> Dict[int, List[int]]:
    """Parse a run file (2/3/4 tab-separated columns; qid, pid first) into
    {qid: [pid, ...]} preserving file order (assumed rank order)."""
    qid_to_ranklist: Dict[int, List[int]] = {}
    with open(ranking_path, "r") as fin:
        for line in fin:
            array = line.strip().split("\t")
            if len(array) not in (2, 3, 4):
                raise ValueError(f"run line has {len(array)} columns, expected 2-4")
            qid, pid = int(array[0]), int(array[1])
            qid_to_ranklist.setdefault(qid, []).append(pid)
    return qid_to_ranklist


class RankingEvaluator:
    """File-based retrieval evaluator with reference-identical semantics."""

    def __init__(
        self,
        qrel_path: str,
        mrr_at_k: Sequence[int] = (10, 1000),
        ndcg_at_k: Sequence[int] = (10, 100),
        recall_at_k: Sequence[int] = (50, 1000),
        map_at_k: int = 1000,
        is_trec: bool = False,
    ):
        self.qid_to_relevant_data = load_qrels(qrel_path, is_trec=is_trec)
        self.mrr_at_k = list(mrr_at_k)
        self.ndcg_at_k = list(ndcg_at_k)
        self.recall_at_k = list(recall_at_k)
        self.map_at_k = map_at_k
        self.is_trec = is_trec

    # ------------------------------------------------------------------ API

    def compute_metrics(
        self,
        ranking_path: str,
        return_per_query: bool = False,
        per_query_metrics_path: str | None = None,
    ):
        """Evaluate a run file. Binarization point is 2.0 for TREC qrels, 1.0
        otherwise (reference retrieval_evaluator.py:68,75)."""
        qid_to_ranklist = load_run_ranklists(ranking_path)
        return self.compute_metrics_from_ranklists(
            qid_to_ranklist,
            return_per_query=return_per_query,
            per_query_metrics_path=per_query_metrics_path,
        )

    def compute_metrics_from_ranklists(
        self,
        qid_to_ranklist: Dict[int, Sequence[int]],
        return_per_query: bool = False,
        per_query_metrics_path: str | None = None,
    ):
        bp = 2.0 if self.is_trec else 1.0
        out = self._calculate_metrics_plain(
            qid_to_ranklist,
            self.qid_to_relevant_data,
            binarization_point=bp,
            return_per_query=return_per_query,
        )
        if return_per_query:
            local_dict, rr, recall, ndcg, qidx_to_qid, qrels = out
            if per_query_metrics_path is not None:
                self._output_per_query_metrics(
                    qidx_to_qid, qrels, per_query_metrics_path, rr, recall, ndcg
                )
            return local_dict, (rr, recall, ndcg)
        return out

    # ------------------------------------------------------------- internals

    def _calculate_metrics_plain(
        self,
        ranking: Dict[int, Sequence[int]],
        qrels: Dict[int, Dict[int, float]],
        binarization_point: float = 1.0,
        return_per_query: bool = False,
    ):
        ranked_queries = len(ranking)
        qidx_to_qid = {idx: qid for idx, qid in enumerate(ranking)}

        n_mrr, n_rec, n_ndcg = len(self.mrr_at_k), len(self.recall_at_k), len(self.ndcg_at_k)
        rr_pq = np.zeros((n_mrr, ranked_queries))
        recall_pq = np.zeros((n_rec, ranked_queries))
        ndcg_pq = np.zeros((n_ndcg, ranked_queries))
        ap_pq = np.zeros(ranked_queries)
        evaluated_queries = 0

        for query_index, (query_id, ranked_doc_ids) in enumerate(ranking.items()):
            if query_id not in qrels:
                continue
            evaluated_queries += 1

            relevant_ids = np.array(list(qrels[query_id].keys()))
            relevant_grades = np.array(list(qrels[query_id].values()))
            sorted_relevant_grades = np.sort(relevant_grades)[::-1]
            num_relevant = relevant_ids.shape[0]

            np_rank = np.asarray(ranked_doc_ids)
            # grade index of each ranked doc in qrels (or -1 if not relevant)
            relevant_mask = np.isin(np_rank, relevant_ids)

            binary_relevant = relevant_ids[relevant_grades >= binarization_point]
            binary_num_relevant = binary_relevant.shape[0]
            binary_relevant_mask = np.isin(np_rank, binary_relevant)

            if np.any(binary_relevant_mask):
                ranks = np.arange(1, binary_relevant_mask.shape[0] + 1)[binary_relevant_mask]

                # MAP@k over binary-relevant hits
                map_ranks = ranks[ranks <= self.map_at_k]
                ap = np.sum(np.arange(1, map_ranks.shape[0] + 1) / map_ranks)
                ap_pq[query_index] = ap / binary_num_relevant

                # MRR@k: first binary-relevant hit only
                first_rank = ranks[0]
                for ci, cutoff in enumerate(self.mrr_at_k):
                    if first_rank <= cutoff:
                        rr_pq[ci, query_index] = 1.0 / first_rank

                # Recall@k
                for ci, cutoff in enumerate(self.recall_at_k):
                    recall_pq[ci, query_index] = (ranks <= cutoff).sum() / binary_num_relevant

            if np.any(relevant_mask):
                ranks = np.arange(1, relevant_mask.shape[0] + 1)[relevant_mask]
                # graded gain of each relevant hit, in rank order
                hit_ids = np_rank[relevant_mask]
                grade_idx = np.array(
                    [np.flatnonzero(relevant_ids == hid)[0] for hid in hit_ids]
                )
                grades_per_rank = relevant_grades[grade_idx]

                for ci, cutoff in enumerate(self.ndcg_at_k):
                    depth = min(num_relevant, cutoff)
                    idcg = (
                        sorted_relevant_grades[:cutoff]
                        / np.log2(1 + np.arange(1, depth + 1))
                    ).sum()
                    in_cut = ranks <= cutoff
                    dcg = (grades_per_rank[in_cut] / np.log2(1 + ranks[in_cut])).sum()
                    ndcg_pq[ci, query_index] = dcg / idcg

        mrr = rr_pq.sum(axis=-1) / evaluated_queries
        relevant_counts = (rr_pq > 0).sum(axis=-1)
        map_score = ap_pq.sum(axis=-1) / evaluated_queries
        recall = recall_pq.sum(axis=-1) / evaluated_queries
        ndcg = ndcg_pq.sum(axis=-1) / evaluated_queries

        local_dict: Dict[str, float] = {}
        for ci, cutoff in enumerate(self.mrr_at_k):
            local_dict[f"MRR@{cutoff}"] = mrr[ci]
            local_dict[f"QueriesWithRelevant@{cutoff}"] = relevant_counts[ci]
        for ci, cutoff in enumerate(self.recall_at_k):
            local_dict[f"Recall@{cutoff}"] = recall[ci]
        for ci, cutoff in enumerate(self.ndcg_at_k):
            local_dict[f"nDCG@{cutoff}"] = ndcg[ci]
        local_dict[f"MAP@{self.map_at_k}"] = map_score
        local_dict["QueriesRanked"] = evaluated_queries

        if return_per_query:
            return local_dict, rr_pq, recall_pq, ndcg_pq, qidx_to_qid, qrels
        return local_dict

    def _output_per_query_metrics(
        self, qidx_to_qid, qrels, output_path, rr_pq, recall_pq, ndcg_pq
    ):
        with open(output_path, "w") as fout:
            writer = csv.writer(fout)
            header = (
                ["query"]
                + [f"mrr@{k}" for k in self.mrr_at_k]
                + [f"recall@{k}" for k in self.recall_at_k]
                + [f"ndcg@{k}" for k in self.ndcg_at_k]
            )
            writer.writerow(header)
            for qidx, qid in qidx_to_qid.items():
                if qid not in qrels:
                    continue
                row = [qid]
                row += [f"{rr_pq[d][qidx]:.3f}" for d in range(rr_pq.shape[0])]
                row += [f"{recall_pq[d][qidx]:.3f}" for d in range(recall_pq.shape[0])]
                row += [f"{ndcg_pq[d][qidx]:.3f}" for d in range(ndcg_pq.shape[0])]
                writer.writerow(row)
