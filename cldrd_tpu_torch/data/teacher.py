"""Teacher-data creation: retrieve -> rerank -> bucket into curriculum
files (port of ``cldrd_tpu/data/teacher.py``).

1. retrieve top-k candidates per training query (any ``{qid: [pid, ...]}``
   ranklists or a run file),
2. score (query, candidate) pairs with a teacher (a cross-encoder
   score_fn, ``evaluation.make_cross_encoder_score_fn``),
3. bucket the teacher ranking into curriculum examples: the top ``n_relT``
   become graded positives, the next ``n_most_hard`` the hardest
   negatives, and ``n_semi_hard`` more are drawn (seeded numpy, the
   reference's draws) from the tail.

Output rows are the ``relT_most_semi_hard`` JSONL that
``data.loaders.load_train_examples`` reads, byte for byte the
reference's files, with teacher scores for the KD losses."""
from __future__ import annotations

import json
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from cldrd_tpu_torch.utils.profiling import annotate, spanned

Scored = List[Tuple[int, float]]  # [(pid, teacher_score)] sorted desc


def bucket_example(
    qid: int,
    scored: Scored,
    n_relT: int,
    n_most_hard: int,
    n_semi_hard: int,
    rng: np.random.Generator,
) -> Optional[dict]:
    """One curriculum example from a teacher-sorted candidate list.

    Returns None when the list is too short to fill all three buckets."""
    need = n_relT + n_most_hard + n_semi_hard
    if len(scored) < need:
        return None
    relT = scored[:n_relT]
    most = scored[n_relT : n_relT + n_most_hard]
    tail = scored[n_relT + n_most_hard :]
    semi_idx = rng.choice(len(tail), size=n_semi_hard, replace=False)
    semi = [tail[i] for i in sorted(semi_idx)]
    return {
        "qid": int(qid),
        "relT_pids": [int(p) for p, _ in relT],
        "relT_scores": [float(s) for _, s in relT],
        "most_hard_pids": [int(p) for p, _ in most],
        "most_hard_scores": [float(s) for _, s in most],
        "semi_hard_pids": [int(p) for p, _ in semi],
        "semi_hard_scores": [float(s) for _, s in semi],
    }


# The paper's three curriculum stages (SURVEY §6): (n_relT, n_most, n_semi).
CURRICULUM_BUCKETS = {
    "5relT_25neg": (5, 12, 13),
    "10relT_20neg": (10, 10, 10),
    "20relT_10neg": (20, 5, 5),
    "30relT": (30, 0, 0),
}


def build_curriculum_files(
    qid_to_scored: Dict[int, Scored],
    out_prefix: str,
    buckets: Optional[Dict[str, Tuple[int, int, int]]] = None,
    seed: int = 4680,
) -> Dict[str, str]:
    """Write one JSONL per curriculum stage from teacher-scored ranklists.

    Returns {stage_name: path}. Queries without enough candidates for a
    stage are skipped in that stage's file."""
    buckets = buckets or CURRICULUM_BUCKETS
    paths: Dict[str, str] = {}
    for name, (n_rel, n_most, n_semi) in buckets.items():
        rng = np.random.default_rng(seed)
        path = f"{out_prefix}{name}.train.jsonl"
        n_written = 0
        with open(path, "w", encoding="utf-8") as f:
            for qid in sorted(qid_to_scored):
                ex = bucket_example(
                    qid, qid_to_scored[qid], n_rel, n_most, n_semi, rng
                )
                if ex is not None:
                    f.write(json.dumps(ex) + "\n")
                    n_written += 1
        paths[name] = path
    return paths


def rerank_candidates_with_teacher(
    qid_to_ranklist: Dict[int, Sequence[int]],
    score_fn: Callable,
    qid_to_query: Dict[int, str],
    pid_to_passage: Dict[int, object],
    tokenizer,
    max_len: int = 256,
    batch_size: int = 128,
    bucket_lengths: Optional[Sequence[int]] = None,
    pack_pairs: bool = False,
    with_token_type_ids: bool = False,
) -> Dict[int, Scored]:
    """Score every (query, candidate) pair with the teacher and sort.

    ``score_fn`` takes a ``RerankBatch`` (cross- or dual-encoder;
    ``evaluation.make_*_score_fn``). Collation is shared with
    ``RerankingDataset`` (via ``from_pairs``), so evaluation-time and
    data-creation-time batches are identical by construction.

    ``bucket_lengths`` (a list, possibly empty for the 32/64/../max
    ladder): length-bucketed scoring, the same scores at a device cost
    near proportional to the real tokens. ``pack_pairs`` packs several
    pairs per row (distilbert cross-encoder score_fn required)."""
    from .reranking_dataset import RerankingDataset

    pairs = [
        (qid, pid) for qid, pids in qid_to_ranklist.items() for pid in pids
    ]
    dataset = RerankingDataset.from_pairs(
        pairs, qid_to_query, pid_to_passage, tokenizer,
        is_cross_encoder=True, max_len=max_len,
        # BERT-family teachers (the reference's MiniLM) read segment ids
        with_token_type_ids=with_token_type_ids,
    )
    if pack_pairs:
        batches = dataset.batches_packed(batch_size)
    elif bucket_lengths is not None:
        batches = dataset.batches_bucketed(
            batch_size, list(bucket_lengths) or None
        )
    else:
        batches = dataset.batches(batch_size)
    out: Dict[int, List[Tuple[int, float]]] = {}
    # batches are tokenized and collated on this thread, as it waits
    for batch in spanned(batches, "cldrd.data.wait"):
        with annotate("cldrd.teacher.score"):
            scores = score_fn(batch)
        with annotate("cldrd.teacher.collect"):
            for i in range(batch.n_valid):
                out.setdefault(int(batch.qids[i]), []).append(
                    (int(batch.pids[i]), float(scores[i]))
                )
    with annotate("cldrd.teacher.collect"):
        return {
            qid: sorted(scored, key=lambda x: -x[1])
            for qid, scored in out.items()
        }
