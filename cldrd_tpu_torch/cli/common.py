"""Shared CLI plumbing: tokenizer/model construction, logging (port of
``cldrd_tpu/cli/common.py`` for the retrieval path)."""
from __future__ import annotations

import argparse
import json
import logging
import os
import sys
from typing import Optional

import torch

from cldrd_tpu_torch.device import resolve_device
from cldrd_tpu_torch.models import DistilBertConfig, NwayDualEncoder
from cldrd_tpu_torch.models.convert import (
    dual_encoder_state_dict,
    load_checkpoint,
)


def setup_logging(verbose: bool = True) -> None:
    logging.basicConfig(
        level=logging.INFO if verbose else logging.WARNING,
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
        stream=sys.stdout,
        force=True,
    )


def model_config_from_args(args: argparse.Namespace) -> DistilBertConfig:
    spec = getattr(args, "model_config", None)
    if spec:
        # JSON file path or inline JSON dict of config overrides
        if os.path.exists(spec):
            with open(spec) as f:
                overrides = json.load(f)
        else:
            overrides = json.loads(spec)
        # a reference config may name its attention route; every route
        # computes the same function, and the port has the einsum one only
        overrides.pop("attention_impl", None)
        return DistilBertConfig(**overrides)
    if getattr(args, "model_size", "full") == "tiny":
        return DistilBertConfig.tiny()
    return DistilBertConfig()


def add_model_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--model-size", choices=("full", "tiny"), default="full",
                   help="'tiny' is the hermetic test configuration")
    p.add_argument("--model-config", default=None,
                   help="config overrides as a JSON file path or inline "
                        "JSON (takes precedence over --model-size)")
    p.add_argument("--share-weights", action="store_true", default=False,
                   help="one tower for queries and passages")
    p.add_argument("--tokenizer", default="hash",
                   help="'hash' (hermetic) or an HF tokenizer name/path")
    p.add_argument("--cosine", action="store_true", default=False,
                   help="the checkpoint was trained with cosine scoring: "
                        "L2-normalize every embedding at encode time")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu'")


def build_tokenizer(name: str, vocab_size: int = 30522):
    """'hash' -> HashTokenizer (``vocab_size`` must be the model's
    embedding-table size); anything else -> an HF fast tokenizer in the
    fixed-shape adapter."""
    from cldrd_tpu_torch.data.tokenization import (
        HashTokenizer,
        HFTokenizerAdapter,
    )

    if name == "hash":
        return HashTokenizer(vocab_size=vocab_size)
    from transformers import AutoTokenizer

    return HFTokenizerAdapter(AutoTokenizer.from_pretrained(name))


def compute_dtype_from_args(args) -> torch.dtype:
    return torch.float32 if args.compute_dtype == "float32" else \
        torch.bfloat16


def load_dual_encoder(checkpoint: Optional[str], cfg: DistilBertConfig,
                      share_weights: bool, cosine: bool, dtype,
                      device, seed: int = 0) -> NwayDualEncoder:
    """The dual encoder on ``device`` in eval mode, with weights from a
    reference ``.pth.tar`` checkpoint or, without one, a random init from
    ``seed``."""
    dev = resolve_device(device)
    model = NwayDualEncoder(cfg, share_weights=share_weights,
                            apply_cosine_similarity=cosine, dtype=dtype)
    if checkpoint:
        sd = dual_encoder_state_dict(load_checkpoint(checkpoint),
                                     share_weights)
        # keys the towers do not hold (HF buffers, heads) are ignored, as
        # the reference's converter ignores them; missing ones raise
        missing = model.load_state_dict(sd, strict=False).missing_keys
        if missing:
            raise KeyError(f"{checkpoint}: missing weights {missing[:5]}")
    else:
        model.reset_parameters(seed=seed)
    return model.to(dev).eval()
