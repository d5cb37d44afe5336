"""Train one curriculum iteration (port of ``cldrd_tpu/cli/train.py``).

Every hyperparameter is a ``TrainConfig`` field: a YAML config supplies
defaults and flags override single fields. Runs on CUDA unless
``--device cpu``.

    python -m cldrd_tpu_torch.cli.train --queries-path q.tsv \\
        --passages-path c.tsv --training-path it1.jsonl --label-mode 8
"""
from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from cldrd_tpu_torch.data.nway_dataset import NwayDataset
from cldrd_tpu_torch.train import TrainConfig, Trainer

from .common import (
    add_model_args,
    build_tokenizer,
    model_config_from_args,
    setup_logging,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", help="YAML TrainConfig (flags override)")
    add_model_args(p, train=True)
    for field in (
        "queries_path", "passages_path", "training_path", "train_fmt",
        "label_mode", "model_checkpoint", "resume", "run_folder",
        "experiment_name", "loss", "weighing_scheme", "compute_dtype",
        "kd_mode", "neg_score_mode",
    ):
        p.add_argument(f"--{field.replace('_', '-')}", dest=field,
                       default=None)
    for field in (
        "max_query_len", "max_passage_len", "num_train_epochs", "batch_size",
        "warmup_steps", "seed", "logging_steps", "evaluate_steps",
        "n_devices", "grad_accum_steps",
    ):
        p.add_argument(f"--{field.replace('_', '-')}", dest=field, type=int,
                       default=None)
    for field in (
        "learning_rate", "weight_decay", "adam_epsilon", "max_grad_norm",
        "reg_lambda", "temperature", "lambda_weight",
    ):
        p.add_argument(f"--{field.replace('_', '-')}", dest=field,
                       type=float, default=None)
    p.add_argument("--in-batch-loss", action="store_true", default=None)
    p.add_argument("--apply-cosine-similarity",
                   dest="apply_cosine_similarity", action="store_true",
                   default=None)
    p.add_argument("--all-in-batch-neg", action="store_true", default=None)
    p.add_argument("--remat", action="store_true", default=None,
                   help="not ported yet: raises")
    p.add_argument("--pack-passages", action="store_true", default=None,
                   help="pack short passages into shared max-passage-len "
                        "rows (segment-masked attention + position reset): "
                        "identical logits at token-proportional "
                        "passage-tower work. Default: the flat layout")
    p.add_argument("--no-pack-passages", dest="pack_passages",
                   action="store_false", help="the flat [bz, nway, L] layout")
    p.add_argument("--tensorboard", action="store_true", default=None,
                   help="also write TensorBoard event files under "
                        "<run_dir>/tb")
    return p


def config_from_args(args: argparse.Namespace) -> TrainConfig:
    cfg = TrainConfig.from_yaml(args.config) if args.config else TrainConfig()
    return cfg.replace(**{k: v for k, v in vars(args).items()
                          if v is not None and hasattr(cfg, k)})


def main(argv: Optional[List[str]] = None) -> int:
    setup_logging()
    args = build_parser().parse_args(argv)
    if args.cosine:
        args.apply_cosine_similarity = True
    cfg = config_from_args(args)
    model_config = model_config_from_args(args)
    tokenizer = build_tokenizer(args.tokenizer,
                                vocab_size=model_config.vocab_size)
    dataset = NwayDataset.create_from_files(
        cfg.queries_path, cfg.passages_path, cfg.training_path, tokenizer,
        cfg.max_query_len, cfg.max_passage_len, cfg.label_mode,
        fmt=cfg.train_fmt, neg_score_mode=cfg.neg_score_mode,
        pack_passages=bool(cfg.pack_passages))
    Trainer(cfg, model_config, device=args.device).train(dataset)
    return 0


if __name__ == "__main__":
    sys.exit(main())
