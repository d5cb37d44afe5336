"""Run-file retrieval metrics (copies of ``cldrd_tpu/evaluation``'s
ranking evaluator, set recall and MS MARCO MRR@10)."""
from .metrics import recall_at, recall_from_files
from .ms_marco_eval import compute_metrics_from_files, quality_checks_qids
from .ranking_evaluator import RankingEvaluator, load_qrels, load_run_ranklists
from .reranking_evaluator import (
    ContinueRerankEvaluator,
    RerankingEvaluator,
    make_cross_encoder_score_fn,
    make_dual_encoder_score_fn,
    write_rankdata,
)

__all__ = ["ContinueRerankEvaluator", "RankingEvaluator",
           "RerankingEvaluator", "compute_metrics_from_files", "load_qrels",
           "load_run_ranklists", "make_cross_encoder_score_fn",
           "make_dual_encoder_score_fn", "quality_checks_qids", "recall_at",
           "recall_from_files", "write_rankdata"]
