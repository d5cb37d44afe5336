"""Run the multi-iteration CL-DRD curriculum as one program (port of
``cldrd_tpu/cli/curriculum.py``):

  python -m cldrd_tpu_torch.cli.curriculum \\
      --queries q.tsv --passages c.tsv \\
      --training-paths it1.jsonl it2.jsonl it3.jsonl \\
      --label-modes 8 9 10 --learning-rates 7e-6 3e-6 3e-6 --epochs 4 2 2

Weights hand forward in memory between iterations; each iteration writes
resumable checkpoints under ``<run-folder>/curriculum_iterN``. With
``--eval-queries``/``--eval-qrels`` every iteration is followed by a
retrieval evaluation: the passage tower encodes the collection into a
flat index on the device, the query tower encodes the queries, the exact
top-k goes to ``curriculum_iterN.run.tsv`` and the metrics are appended
to ``<run-folder>/curriculum_eval.tsv``.
"""
from __future__ import annotations

import argparse
import logging
import os
import sys
from typing import List, Optional

from cldrd_tpu_torch.data.nway_dataset import NwayDataset
from cldrd_tpu_torch.train import TrainConfig, run_curriculum

from .common import (
    add_model_args,
    build_tokenizer,
    model_config_from_args,
    setup_logging,
)

logger = logging.getLogger("cldrd_tpu_torch.cli.curriculum")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--config", help="YAML TrainConfig base (flags override)")
    p.add_argument("--queries", required=True)
    p.add_argument("--passages", required=True)
    p.add_argument("--training-paths", nargs="+", required=True)
    p.add_argument("--label-modes", nargs="+", default=["8", "9", "10"])
    p.add_argument("--learning-rates", nargs="+", type=float,
                   default=[7e-6, 3e-6, 3e-6])
    p.add_argument("--epochs", nargs="+", type=int, default=[4, 2, 2])
    p.add_argument("--train-fmt", default="relT_most_semi_hard")
    p.add_argument("--run-folder", default="./experiments")
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--pack-passages", action="store_true", default=None,
                   help="pack short passages into shared rows (identical "
                        "logits, token-proportional passage-tower work). "
                        "Default: the flat layout")
    p.add_argument("--no-pack-passages", dest="pack_passages",
                   action="store_false", help="the flat [bz, nway, L] layout")
    p.add_argument("--model-checkpoint", default=None,
                   help="warm start for iteration 1 (.pth.tar)")
    p.add_argument("--eval-queries", default=None,
                   help="qid\\ttext TSV: index + retrieve + evaluate after "
                        "each iteration (requires --eval-qrels)")
    p.add_argument("--eval-qrels", default=None)
    p.add_argument("--eval-topk", type=int, default=1000)
    p.add_argument("--eval-trec", action="store_true")
    p.add_argument("--eval-batch-size", type=int, default=128,
                   help="encode + search batch size of the evaluation")
    add_model_args(p, train=True)
    return p


def _make_eval_hook(args, base: TrainConfig, tokenizer):
    """Per-iteration index build + retrieval + metrics."""
    import numpy as np

    from cldrd_tpu_torch.data.sequence_dataset import SequenceDataset
    from cldrd_tpu_torch.evaluation import RankingEvaluator
    from cldrd_tpu_torch.index import (
        FlatIPIndex,
        encode_dataset,
        make_encode_fn,
    )
    from cldrd_tpu_torch.search import retrieve_to_run_file
    from cldrd_tpu_torch.utils import MetricMonitor

    evaluator = RankingEvaluator(args.eval_qrels, is_trec=args.eval_trec)
    passages_ds = SequenceDataset.create_from_seqs_file(
        args.passages, tokenizer, base.max_passage_len, is_query=False)
    queries_ds = SequenceDataset.create_from_seqs_file(
        args.eval_queries, tokenizer, base.max_query_len, is_query=True)
    monitor = MetricMonitor()
    table_path = os.path.join(base.run_folder, "curriculum_eval.tsv")

    def hook(i, state, trainer):
        model = trainer.model
        p_embs, pids = encode_dataset(make_encode_fn(model, "passage_embs"),
                                      passages_ds, args.eval_batch_size)
        index = FlatIPIndex.build(p_embs, pids, device=trainer.device)
        q_embs, qids = encode_dataset(make_encode_fn(model, "query_embs"),
                                      queries_ds, args.eval_batch_size)
        run_path = os.path.join(base.run_folder,
                                f"curriculum_iter{i + 1}.run.tsv")
        retrieve_to_run_file(index, q_embs, qids, run_path,
                             topk=args.eval_topk,
                             batch_size=args.eval_batch_size)
        metrics = evaluator.compute_metrics(run_path)
        monitor.update(i + 1, **{
            k: float(v) for k, v in metrics.items()
            if isinstance(v, (int, float, np.integer, np.floating))})
        monitor.write(table_path)
        logger.info("iteration %d eval: %s", i + 1, metrics)
        model.train()

    return hook


def main(argv: Optional[List[str]] = None) -> int:
    setup_logging()
    args = build_parser().parse_args(argv)
    n_iter = len(args.training_paths)
    if not (len(args.label_modes) == len(args.learning_rates)
            == len(args.epochs) == n_iter):
        raise SystemExit("--training-paths, --label-modes, --learning-rates "
                         "and --epochs need one value per iteration")
    base = TrainConfig.from_yaml(args.config) if args.config else \
        TrainConfig()
    base = base.replace(queries_path=args.queries,
                        passages_path=args.passages,
                        train_fmt=args.train_fmt, run_folder=args.run_folder)
    for field in ("share_weights", "batch_size", "pack_passages"):
        if getattr(args, field) is not None:
            base = base.replace(**{field: getattr(args, field)})
    if args.cosine:
        base = base.replace(apply_cosine_similarity=True)
    iterations = [
        base.replace(training_path=args.training_paths[i],
                     label_mode=args.label_modes[i],
                     learning_rate=args.learning_rates[i],
                     num_train_epochs=args.epochs[i],
                     experiment_name=f"curriculum_iter{i + 1}",
                     model_checkpoint=args.model_checkpoint if i == 0
                     else None)
        for i in range(n_iter)]
    model_config = model_config_from_args(args)
    tokenizer = build_tokenizer(args.tokenizer,
                                vocab_size=model_config.vocab_size)

    def dataset_factory(cfg: TrainConfig) -> NwayDataset:
        return NwayDataset.create_from_files(
            cfg.queries_path, cfg.passages_path, cfg.training_path,
            tokenizer, cfg.max_query_len, cfg.max_passage_len,
            cfg.label_mode, fmt=cfg.train_fmt,
            pack_passages=bool(cfg.pack_passages))

    hook = None
    if args.eval_queries or args.eval_qrels:
        if not (args.eval_queries and args.eval_qrels):
            raise SystemExit("--eval-queries and --eval-qrels go together")
        os.makedirs(base.run_folder, exist_ok=True)
        hook = _make_eval_hook(args, base, tokenizer)
    run_curriculum(iterations, model_config, dataset_factory,
                   device=args.device, after_iteration=hook)
    return 0


if __name__ == "__main__":
    sys.exit(main())
