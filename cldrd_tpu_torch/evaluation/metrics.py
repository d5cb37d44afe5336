"""Simple set-based recall utilities.

Covers (and fixes) the reference's broken ``evaluation/metrics.py`` (its line
35 has a syntax error making the module unimportable — SURVEY.md §2.5). Recall
here is set-intersection recall at a cutoff between a run file and a qrels
file, matching the reference's intent.
"""
from __future__ import annotations

from typing import Dict, List, Set


def recall_at(
    qid_to_ranklist: Dict[int, List[int]],
    qid_to_relevant: Dict[int, Set[int]],
    cutoff: int,
) -> float:
    """Mean over qrels queries of |top-cutoff ∩ relevant| / |relevant|."""
    total, n = 0.0, 0
    for qid, relevant in qid_to_relevant.items():
        if not relevant:
            continue
        n += 1
        retrieved = set(qid_to_ranklist.get(qid, [])[:cutoff])
        total += len(retrieved & relevant) / len(relevant)
    return total / n if n else 0.0


def recall_from_files(run_path: str, qrels_path: str, cutoff: int = 1000) -> float:
    qid_to_ranklist: Dict[int, List[int]] = {}
    with open(run_path, "r") as f:
        for line in f:
            parts = line.strip().split("\t")
            qid, pid = int(parts[0]), int(parts[1])
            qid_to_ranklist.setdefault(qid, []).append(pid)

    qid_to_relevant: Dict[int, Set[int]] = {}
    with open(qrels_path, "r") as f:
        for line in f:
            parts = line.strip().replace(" ", "\t").split("\t")
            qid, pid, grade = int(parts[0]), int(parts[2]), float(parts[3])
            if grade <= 0.00001:
                continue
            qid_to_relevant.setdefault(qid, set()).add(pid)

    return recall_at(qid_to_ranklist, qid_to_relevant, cutoff)
