"""Run-file writer + the batched retrieval loop (copy of
``cldrd_tpu/search/run_writer.py``).

Reference parity: ``retriever/retrieve_top_passages.py:88-109`` — batched
top-k search over encoded queries, then a ``qid\\tpid\\trank\\tscore`` TSV run
file (rank is 1-based).
"""
from __future__ import annotations

import logging
import time
from typing import Dict

import numpy as np

logger = logging.getLogger(__name__)


def write_run_file(
    path: str,
    qids: np.ndarray,
    top_ids: np.ndarray,
    top_scores: np.ndarray,
) -> None:
    """qids [Nq]; top_ids/top_scores [Nq, k]. Slots with id -1 (beyond the
    corpus) are skipped."""
    with open(path, "w", encoding="utf-8") as f:
        for qi in range(len(qids)):
            qid = int(qids[qi])
            rank = 0
            for pid, score in zip(top_ids[qi], top_scores[qi]):
                if pid < 0:
                    continue
                rank += 1
                f.write(f"{qid}\t{int(pid)}\t{rank}\t{float(score)}\n")


def retrieve_to_run_file(
    index,
    query_embeddings: np.ndarray,
    qids: np.ndarray,
    out_path: str,
    topk: int = 1000,
    batch_size: int = 128,
) -> Dict[str, float]:
    """Search + write run file; returns timing stats (the reference prints
    'Elapsed Time per query' from ``index_retrieve``,
    ``retrieval_utils.py:150-152``)."""
    t0 = time.perf_counter()
    scores, ids = index.search_batched(query_embeddings, topk, batch_size)
    elapsed = time.perf_counter() - t0
    nq = len(qids)
    stats = {
        "elapsed_s": elapsed,
        "ms_per_query": 1000.0 * elapsed / max(nq, 1),
        "qps": nq / max(elapsed, 1e-9),
    }
    logger.info(
        "searched %d queries top-%d in %.2fs (%.2f ms/query, %.0f QPS)",
        nq, topk, elapsed, stats["ms_per_query"], stats["qps"],
    )
    write_run_file(out_path, qids, ids, scores)
    return stats
