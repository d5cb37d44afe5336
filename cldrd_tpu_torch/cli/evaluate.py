"""Evaluate a run file against qrels (copy of ``cldrd_tpu/cli/evaluate.py``;
host-only, so it takes no device flag).

    python -m cldrd_tpu_torch.cli.evaluate --qrels qrels.tsv --run dev.run.tsv
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from cldrd_tpu_torch.evaluation import RankingEvaluator

from .common import setup_logging


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--qrels", required=True)
    p.add_argument("--run", required=True)
    p.add_argument("--trec", action="store_true",
                   help="TREC qrels (space-separated, binarization at grade 2)")
    p.add_argument("--per-query", default=None,
                   help="optional per-query metrics CSV path")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    setup_logging(verbose=False)
    args = build_parser().parse_args(argv)
    evaluator = RankingEvaluator(args.qrels, is_trec=args.trec)
    if args.per_query:
        metrics, _ = evaluator.compute_metrics(
            args.run, return_per_query=True,
            per_query_metrics_path=args.per_query)
    else:
        metrics = evaluator.compute_metrics(args.run)
    print(json.dumps({k: float(v) for k, v in metrics.items()}, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
