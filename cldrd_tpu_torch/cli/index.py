"""Build the corpus embedding store.

Port of ``cldrd_tpu/cli/index.py`` for the flat store: encode the
collection with the passage tower and write the blocked shard store
(JSON meta + binary shards + ids.npy) that both packages read.

    python -m cldrd_tpu_torch.cli.index --collection collection.tsv \\
        --checkpoint model.pth.tar --out index_dir
"""
from __future__ import annotations

import argparse
import json
import logging
import sys
import time
from typing import List, Optional

from cldrd_tpu_torch.data.sequence_dataset import SequenceDataset
from cldrd_tpu_torch.index import encode_dataset, make_encode_fn
from cldrd_tpu_torch.index.persistence import write_embeddings

from .common import (
    add_model_args,
    build_tokenizer,
    compute_dtype_from_args,
    load_dual_encoder,
    model_config_from_args,
    setup_logging,
)

logger = logging.getLogger("cldrd_tpu_torch.cli.index")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--collection", required=True, help="pid\\ttext TSV")
    p.add_argument("--checkpoint", default=None,
                   help="reference .pth.tar weights (random init if absent)")
    p.add_argument("--out", required=True, help="index output directory")
    p.add_argument("--max-length", type=int, default=256)
    p.add_argument("--batch-size", type=int, default=512)
    p.add_argument("--store-dtype", default="float32",
                   choices=("float16", "float32", "int8"),
                   help="on-disk embedding dtype (int8 = per-row-scaled "
                        "codes + scales)")
    p.add_argument("--compute-dtype", default="bfloat16",
                   choices=("bfloat16", "float32"),
                   help="encoder activation dtype")
    add_model_args(p)
    return p


def main(argv: Optional[List[str]] = None) -> int:
    setup_logging()
    args = build_parser().parse_args(argv)
    cfg = model_config_from_args(args)
    tokenizer = build_tokenizer(args.tokenizer, vocab_size=cfg.vocab_size)
    model = load_dual_encoder(args.checkpoint, cfg, args.share_weights,
                              args.cosine, compute_dtype_from_args(args),
                              args.device)
    dataset = SequenceDataset.create_from_seqs_file(
        args.collection, tokenizer, args.max_length, is_query=False)
    encode = make_encode_fn(model, "passage_embs")
    t0 = time.perf_counter()
    embeddings, ids = encode_dataset(encode, dataset, args.batch_size)
    elapsed = time.perf_counter() - t0
    logger.info("encoded %d passages in %.1fs (%.0f passages/s)", len(ids),
                elapsed, len(ids) / max(elapsed, 1e-9))
    write_embeddings(args.out, embeddings, ids, dtype=args.store_dtype)
    logger.info("index written to %s", args.out)
    print(json.dumps({"passages": len(ids), "encode_s": elapsed,
                      "passages_per_s": len(ids) / max(elapsed, 1e-9)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
