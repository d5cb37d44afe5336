"""Export a trained checkpoint to the reference's and HF's torch layouts
(port of ``cldrd_tpu/cli/export.py``).

``--checkpoint`` takes the port's ``.pth.tar``, a reference one, or a JAX
trainer's ``.msgpack``, and ``--out`` gets either

- ``--format reference``: a ``state_dict``-only ``.pth.tar`` in the
  reference's ``NwayDualEncoder`` layout (``query_encoder.* /
  passage_encoder.*``; BERT towers in HF ``BertModel`` names); or
- ``--format hf``: one HF ``pytorch_model.bin`` state_dict per tower
  (``query_encoder/`` and ``passage_encoder/``; one ``encoder/`` with
  ``--share-weights``).

    python -m cldrd_tpu_torch.cli.export --checkpoint checkpoint_9.msgpack \\
        --out model.pth.tar [--format hf]
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import sys
from typing import List, Optional

import torch

from cldrd_tpu_torch.models.convert import dual_encoder_to_reference

from .common import (
    add_model_args,
    load_dual_encoder,
    model_config_from_args,
    setup_logging,
)

logger = logging.getLogger("cldrd_tpu_torch.cli.export")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--checkpoint", required=True,
                   help="a .pth.tar (the port's or the reference's) or a "
                        "JAX .msgpack")
    p.add_argument("--out", required=True, help="output file or directory")
    p.add_argument("--format", choices=("reference", "hf"),
                   default="reference")
    # export converts weights: normalization is an encode-time behavior
    add_model_args(p, cosine=False)
    return p


def main(argv: Optional[List[str]] = None) -> int:
    setup_logging()
    args = build_parser().parse_args(argv)
    share = bool(args.share_weights)
    cfg = model_config_from_args(args)
    # the model checks the weights against the config (missing keys raise)
    model = load_dual_encoder(args.checkpoint, cfg, share, False,
                              torch.float32, args.device)
    tensors = {k: v.detach().cpu().clone() for k, v in
               dual_encoder_to_reference(model.state_dict()).items()}
    if args.format == "reference":
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        torch.save({"state_dict": tensors}, args.out)
        print(json.dumps({"format": "reference", "path": args.out,
                          "n_tensors": len(tensors)}))
        return 0
    towers = (("encoder", "query_encoder"),) if share else (
        ("query_encoder", "query_encoder"),
        ("passage_encoder", "passage_encoder"))
    written = {}
    for out_name, prefix in towers:
        tower_sd = {k[len(prefix) + 1:]: v for k, v in tensors.items()
                    if k.startswith(prefix + ".")}
        d = os.path.join(args.out, out_name)
        os.makedirs(d, exist_ok=True)
        torch.save(tower_sd, os.path.join(d, "pytorch_model.bin"))
        written[out_name] = len(tower_sd)
    print(json.dumps({"format": "hf", "path": args.out, "towers": written}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
