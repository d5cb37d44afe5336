"""Create curriculum training files: candidates -> teacher rerank ->
buckets (port of ``cldrd_tpu/cli/create_training_data.py``).

Take top-k candidates per training query (a run file from
``cli.retrieve``), score each (query, candidate) pair with a
cross-encoder teacher (or an oracle over graded qrels), and bucket the
teacher ranking into the curriculum JSONL stages (5relT_25neg /
10relT_20neg / 20relT_10neg / 30relT) with teacher scores attached.

    python -m cldrd_tpu_torch.cli.create_training_data \\
        --candidates-run train.run.tsv --queries queries.train.tsv \\
        --passages collection.tsv --teacher-arch bert \\
        --teacher-checkpoint minilm.pth.tar --out-prefix data/
"""
from __future__ import annotations

import argparse
import json
import logging
import sys
import time
from typing import List, Optional

import numpy as np

from cldrd_tpu_torch.data import (
    build_curriculum_files,
    rerank_candidates_with_teacher,
)
from cldrd_tpu_torch.data.loaders import load_passages, load_queries
from cldrd_tpu_torch.evaluation import (
    load_qrels,
    load_run_ranklists,
    make_cross_encoder_score_fn,
)

from .common import (
    add_model_args,
    build_tokenizer,
    compute_dtype_from_args,
    cross_encoder_config,
    load_cross_encoder,
    setup_logging,
)

logger = logging.getLogger("cldrd_tpu_torch.cli.create_training_data")

BUCKETS_UNPORTED = ("--bucket-lengths: length-bucketed teacher scoring is "
                    "not ported yet (ROADMAP A4); score flat or with "
                    "--pack-pairs")


def add_teacher_arch(p: argparse.ArgumentParser) -> None:
    p.add_argument("--teacher-arch", choices=("distilbert", "bert"),
                   default="distilbert",
                   help="'bert' = the reference teacher's family "
                        "(cross-encoder/ms-marco-MiniLM-L-6-v2, a "
                        "BertForSequenceClassification with token-type "
                        "embeddings + tanh pooler); --model-size full then "
                        "means the MiniLM-L6 shape")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--candidates-run", required=True,
                   help="run TSV of retrieval candidates per training query")
    p.add_argument("--queries", required=True)
    p.add_argument("--passages", required=True)
    p.add_argument("--teacher-checkpoint", default=None,
                   help="cross-encoder teacher weights (HF .pth.tar/.bin/.pt "
                        "or a JAX .msgpack); random init if absent")
    p.add_argument("--teacher-oracle-qrels", default=None,
                   help="ORACLE teacher: score candidates by graded qrels "
                        "relevance (+ --teacher-noise) instead of a "
                        "cross-encoder")
    p.add_argument("--teacher-noise", type=float, default=0.0,
                   help="stddev of Gaussian noise added to oracle grades "
                        "(0 = exact oracle)")
    add_teacher_arch(p)
    p.add_argument("--out-prefix", required=True,
                   help="output path prefix for <stage>.train.jsonl files")
    p.add_argument("--max-length", type=int, default=256)
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--bucket-lengths", type=int, nargs="*", default=None,
                   help="length-bucketed teacher scoring (not ported yet: "
                        "ROADMAP A4)")
    p.add_argument("--pack-pairs", action="store_true",
                   help="pack several (q ++ p) pairs into each max-length "
                        "row (segment-masked attention; distilbert teacher "
                        "only)")
    p.add_argument("--seed", type=int, default=4680)
    p.add_argument("--compute-dtype", choices=("bfloat16", "float32"),
                   default="bfloat16",
                   help="teacher compute dtype (float32 for bit-stable "
                        "scores across batch shapes)")
    # the teacher is a cross-encoder: no embedding space for --cosine
    add_model_args(p, cosine=False)
    return p


def reconcile_teacher_arch(args) -> None:
    """On the teacher CLIs the architecture switch is ``--teacher-arch``;
    a conflicting ``--arch`` is refused, otherwise mirrored."""
    if (getattr(args, "arch", "distilbert") != "distilbert"
            and args.arch != args.teacher_arch):
        raise SystemExit(
            f"--arch {args.arch} conflicts with --teacher-arch "
            f"{args.teacher_arch}: the teacher model's family is selected "
            "by --teacher-arch on this command")
    args.arch = args.teacher_arch


def oracle_scored(ranklists, qrels_path: str, noise: float, seed: int):
    """Teacher scores from graded qrels: grade + N(0, noise) (the
    reference's numpy draws), with a tiny retrieval-rank decrement so
    noise=0 stays deterministic (ties resolve in retrieval order)."""
    qrels = load_qrels(qrels_path)
    rng = np.random.default_rng(seed)
    out = {}
    for qid, pids in ranklists.items():
        grades = qrels.get(int(qid), {})
        scored = [
            (int(pid),
             float(grades.get(int(pid), 0.0))
             + (float(rng.normal(0.0, noise)) if noise > 0 else 0.0)
             - rank * 1e-6)
            for rank, pid in enumerate(pids)
        ]
        scored.sort(key=lambda t: -t[1])
        out[int(qid)] = scored
    return out


def teacher_config(args):
    """The teacher's config: MiniLM-L6 at full size for ``bert``,
    distilbert-base otherwise; ``--model-config`` / ``--model-size``."""
    return cross_encoder_config(args.teacher_arch, args.model_size,
                                args.model_config, args.attention_impl)


def main(argv: Optional[List[str]] = None) -> int:
    setup_logging()
    args = build_parser().parse_args(argv)
    reconcile_teacher_arch(args)
    if args.bucket_lengths is not None:
        raise NotImplementedError(BUCKETS_UNPORTED)
    if args.teacher_oracle_qrels:
        if args.teacher_checkpoint:
            raise SystemExit("--teacher-oracle-qrels and "
                             "--teacher-checkpoint are mutually exclusive")
        ranklists = load_run_ranklists(args.candidates_run)
        logger.info("oracle-scoring %d queries from %s (noise %.3g) ...",
                    len(ranklists), args.teacher_oracle_qrels,
                    args.teacher_noise)
        qid_to_scored = oracle_scored(
            ranklists, args.teacher_oracle_qrels, args.teacher_noise,
            args.seed)
        paths = build_curriculum_files(qid_to_scored, args.out_prefix,
                                       seed=args.seed)
        print(json.dumps(paths, indent=2))
        return 0
    if args.teacher_arch == "bert" and args.pack_pairs:
        raise SystemExit("--pack-pairs is not supported with "
                         "--teacher-arch bert (see CrossEncoder docs); "
                         "use --bucket-lengths")
    cfg = teacher_config(args)
    tokenizer = build_tokenizer(args.tokenizer, vocab_size=cfg.vocab_size)
    ranklists = load_run_ranklists(args.candidates_run)
    qid_to_query = load_queries(args.queries)
    pid_to_passage = load_passages(args.passages)
    model = load_cross_encoder(args.teacher_checkpoint, cfg,
                               args.teacher_arch,
                               compute_dtype_from_args(args), args.device)
    score_fn = make_cross_encoder_score_fn(model)
    n_pairs = sum(len(p) for p in ranklists.values())
    logger.info("teacher-scoring %d queries x candidates (%d pairs) ...",
                len(ranklists), n_pairs)
    t0 = time.perf_counter()
    qid_to_scored = rerank_candidates_with_teacher(
        ranklists, score_fn, qid_to_query, pid_to_passage, tokenizer,
        max_len=args.max_length, batch_size=args.batch_size,
        pack_pairs=args.pack_pairs,
        with_token_type_ids=args.teacher_arch == "bert")
    elapsed = time.perf_counter() - t0
    logger.info("scored %d pairs in %.3f s (%.1f pairs/s, tokenization "
                "included)", n_pairs, elapsed, n_pairs / max(elapsed, 1e-9))
    paths = build_curriculum_files(qid_to_scored, args.out_prefix,
                                   seed=args.seed)
    print(json.dumps(paths, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
