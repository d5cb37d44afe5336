"""Model-in-the-loop reranking evaluation over checkpoints (port of
``cldrd_tpu/cli/rerank_eval.py``).

Score a candidates run file with a dual or cross encoder at one
checkpoint, or at every checkpoint of a training run folder, and report
the metric dict per step.

- ``--mode dual`` (default): dot(CLS_q, CLS_p) with the n-way dual
  encoder's towers.
- ``--mode cross``: a cross-encoder scores the joined ``[CLS] q [SEP] p
  [SEP]`` pairs; ``--teacher-arch bert`` is the MiniLM teacher's family.

    python -m cldrd_tpu_torch.cli.rerank_eval --candidates-run dev.run.tsv \\
        --queries queries.dev.tsv --passages collection.tsv \\
        --qrels qrels.dev.tsv --run-folder runs/it1 [--mode cross ...]
"""
from __future__ import annotations

import argparse
import json
import logging
import sys
from typing import List, Optional

from cldrd_tpu_torch.data.reranking_dataset import RerankingDataset
from cldrd_tpu_torch.evaluation.reranking_evaluator import (
    ContinueRerankEvaluator,
    RerankingEvaluator,
    make_cross_encoder_score_fn,
    make_dual_encoder_score_fn,
)

from .common import (
    add_model_args,
    build_tokenizer,
    compute_dtype_from_args,
    load_cross_encoder,
    load_dual_encoder,
    model_config_from_args,
    setup_logging,
)
from .create_training_data import (
    add_teacher_arch,
    reconcile_teacher_arch,
    teacher_config,
)

logger = logging.getLogger("cldrd_tpu_torch.cli.rerank_eval")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--candidates-run", required=True,
                   help="run TSV of (qid, pid) candidates to rerank")
    p.add_argument("--queries", required=True)
    p.add_argument("--passages", required=True)
    p.add_argument("--qrels", required=True)
    p.add_argument("--trec", action="store_true",
                   help="TREC graded qrels (space-separated, binarize at 2)")
    p.add_argument("--checkpoint", default=None,
                   help="evaluate ONE checkpoint (.pth.tar or .msgpack)")
    p.add_argument("--run-folder", default=None,
                   help="evaluate EVERY checkpoint_<step> (.pth.tar or "
                        ".msgpack) in this folder")
    p.add_argument("--results", default=None,
                   help="append a step-keyed metric TSV here (folder mode)")
    p.add_argument("--mode", choices=("dual", "cross"), default="dual")
    add_teacher_arch(p)
    p.add_argument("--max-length", type=int, default=256,
                   help="joined-pair length (cross mode)")
    p.add_argument("--max-query-len", type=int, default=30)
    p.add_argument("--max-passage-len", type=int, default=256)
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--bucket-lengths", type=int, nargs="*", default=None,
                   help="length-bucketed scoring (the same scores, "
                        "~token-proportional device cost)")
    p.add_argument("--compute-dtype", choices=("bfloat16", "float32"),
                   default="bfloat16")
    add_model_args(p)
    return p


def main(argv: Optional[List[str]] = None) -> int:
    setup_logging()
    args = build_parser().parse_args(argv)
    if bool(args.checkpoint) == bool(args.run_folder):
        raise SystemExit("pass exactly one of --checkpoint / --run-folder")
    dtype = compute_dtype_from_args(args)
    if args.mode == "cross":
        reconcile_teacher_arch(args)
        cfg = teacher_config(args)

        def params_loader(path):
            return load_cross_encoder(path, cfg, args.teacher_arch, dtype,
                                      args.device)

        score_fn_factory = make_cross_encoder_score_fn
    else:
        cfg = model_config_from_args(args)

        def params_loader(path):
            return load_dual_encoder(path, cfg, args.share_weights,
                                     args.cosine, dtype, args.device)

        score_fn_factory = make_dual_encoder_score_fn

    tokenizer = build_tokenizer(args.tokenizer, vocab_size=cfg.vocab_size)
    dataset = RerankingDataset(
        args.candidates_run, args.queries, args.passages, tokenizer,
        is_cross_encoder=args.mode == "cross",
        max_len=args.max_length,
        query_max_len=args.max_query_len,
        passage_max_len=args.max_passage_len,
        with_token_type_ids=(args.mode == "cross"
                             and args.teacher_arch == "bert"))
    evaluator = RerankingEvaluator(args.qrels, is_trec=args.trec)

    if args.checkpoint:
        metrics = evaluator.compute_metrics(
            score_fn_factory(params_loader(args.checkpoint)), dataset,
            args.batch_size, bucket_lengths=args.bucket_lengths)
        print(json.dumps(metrics, indent=2, default=float))
        return 0
    cre = ContinueRerankEvaluator(evaluator, dataset, score_fn_factory,
                                  params_loader, batch_size=args.batch_size,
                                  bucket_lengths=args.bucket_lengths)
    results = cre.evaluate_folder(args.run_folder, results_path=args.results)
    print(json.dumps({str(k): v for k, v in results.items()},
                     indent=2, default=float))
    return 0


if __name__ == "__main__":
    sys.exit(main())
