"""Official-style MS MARCO passage-ranking evaluation (MRR@10).

Clean reimplementation of the capability provided by the vendored Microsoft
script in the reference (``evaluation/ms_marco_eval.py`` of CL-DRD):
MRR@10 from a qrels file plus a candidate file, with the same
duplicate-passage quality check (a query's candidate list must not contain
more than ``MAX_DUP_FRACTION`` duplicate pids).
"""
from __future__ import annotations

from typing import Dict, List, Set, Tuple

MAX_MRR_RANK = 10
MAX_DUP_FRACTION = 0.75  # quality check threshold, as in the official script


def load_reference(path_to_reference: str) -> Dict[int, Set[int]]:
    """qrels file ``qid\\t0\\tpid\\tgrade`` (or ``qid\\tpid``) → {qid: {pid}}."""
    qids_to_relevant: Dict[int, Set[int]] = {}
    with open(path_to_reference, "r") as f:
        for line in f:
            parts = line.strip().split("\t")
            if len(parts) >= 3:
                qid, pid = int(parts[0]), int(parts[2])
            else:
                qid, pid = int(parts[0]), int(parts[1])
            qids_to_relevant.setdefault(qid, set()).add(pid)
    return qids_to_relevant


def load_candidate(path_to_candidate: str) -> Dict[int, List[int]]:
    """Run file ``qid\\tpid\\trank[...]`` → {qid: [pid in rank order]}."""
    qid_to_ranked: Dict[int, List[Tuple[int, int]]] = {}
    with open(path_to_candidate, "r") as f:
        for line in f:
            parts = line.strip().split("\t")
            qid, pid = int(parts[0]), int(parts[1])
            rank = int(parts[2]) if len(parts) > 2 else len(qid_to_ranked.get(qid, [])) + 1
            qid_to_ranked.setdefault(qid, []).append((rank, pid))
    return {
        qid: [pid for _, pid in sorted(pairs)] for qid, pairs in qid_to_ranked.items()
    }


def quality_checks_qids(
    qids_to_relevant: Dict[int, Set[int]],
    qids_to_ranked: Dict[int, List[int]],
) -> Tuple[bool, str]:
    """Check candidate lists: every scored qid must be in qrels' domain is NOT
    required, but no candidate list may be dominated by duplicate pids."""
    message = ""
    allowed = True
    for qid, pids in qids_to_ranked.items():
        if len(pids) == 0:
            continue
        duplicate_fraction = 1.0 - len(set(pids)) / len(pids)
        if duplicate_fraction > MAX_DUP_FRACTION:
            message = (
                f"Query {qid} candidate list has duplicate fraction "
                f"{duplicate_fraction:.3f} > {MAX_DUP_FRACTION}"
            )
            allowed = False
    return allowed, message


def compute_metrics(
    qids_to_relevant: Dict[int, Set[int]],
    qids_to_ranked: Dict[int, List[int]],
) -> Dict[str, float]:
    """MRR@10 over all qrels queries (missing queries count as 0)."""
    mrr_sum = 0.0
    ranked = 0
    for qid in qids_to_relevant:
        if qid not in qids_to_ranked:
            continue
        ranked += 1
        relevant = qids_to_relevant[qid]
        for i, pid in enumerate(qids_to_ranked[qid][:MAX_MRR_RANK]):
            if pid in relevant:
                mrr_sum += 1.0 / (i + 1)
                break
    mrr = mrr_sum / len(qids_to_relevant) if qids_to_relevant else 0.0
    return {"MRR @10": mrr, "QueriesRanked": ranked}


def compute_metrics_from_files(
    path_to_reference: str,
    path_to_candidate: str,
    perform_checks: bool = True,
) -> Dict[str, float]:
    qids_to_relevant = load_reference(path_to_reference)
    qids_to_ranked = load_candidate(path_to_candidate)
    if perform_checks:
        allowed, message = quality_checks_qids(qids_to_relevant, qids_to_ranked)
        if not allowed:
            raise ValueError(message)
    return compute_metrics(qids_to_relevant, qids_to_ranked)
