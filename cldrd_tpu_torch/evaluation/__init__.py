"""Run-file retrieval metrics (copies of ``cldrd_tpu/evaluation``'s
ranking evaluator, set recall and MS MARCO MRR@10)."""
from .metrics import recall_at, recall_from_files
from .ms_marco_eval import compute_metrics_from_files, quality_checks_qids
from .ranking_evaluator import RankingEvaluator, load_qrels, load_run_ranklists

__all__ = ["RankingEvaluator", "load_qrels", "load_run_ranklists",
           "recall_at", "recall_from_files", "compute_metrics_from_files",
           "quality_checks_qids"]
