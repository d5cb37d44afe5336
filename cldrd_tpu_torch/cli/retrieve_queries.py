"""Inverse retrieval: top-k *queries* per passage, for teacher-data
creation (port of ``cldrd_tpu/cli/retrieve_queries.py``).

Encode the passages with the passage tower, search an index built over
QUERY embeddings (``cli.index --collection queries.tsv``), and write
``pid\\tqid\\trank\\tscore``.

    python -m cldrd_tpu_torch.cli.retrieve_queries --query-index qindex \\
        --passages collection.tsv --checkpoint model.pth.tar --run p2q.tsv
"""
from __future__ import annotations

import argparse
import json
import logging
import sys
from typing import List, Optional

from cldrd_tpu_torch.data.sequence_dataset import SequenceDataset
from cldrd_tpu_torch.device import dtype_from_name
from cldrd_tpu_torch.index import encode_dataset, load_index, make_encode_fn
from cldrd_tpu_torch.search import retrieve_to_run_file

from .common import (
    add_model_args,
    build_tokenizer,
    compute_dtype_from_args,
    load_dual_encoder,
    model_config_from_args,
    setup_logging,
)

logger = logging.getLogger("cldrd_tpu_torch.cli.retrieve_queries")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--query-index", required=True,
                   help="index directory built over QUERY embeddings")
    p.add_argument("--passages", required=True, help="pid\\ttext TSV")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--run", required=True,
                   help="output TSV: pid\\tqid\\trank\\tscore")
    p.add_argument("--topk", type=int, default=200)
    p.add_argument("--max-length", type=int, default=256)
    p.add_argument("--encode-batch-size", type=int, default=512)
    p.add_argument("--search-batch-size", type=int, default=128)
    p.add_argument("--compute-dtype", default="bfloat16",
                   choices=("bfloat16", "float32"),
                   help="encoder activation dtype")
    p.add_argument("--hbm-dtype", default="bfloat16",
                   choices=("bfloat16", "float32", "int8"),
                   help="device store dtype (int8 = per-row-scaled codes)")
    p.add_argument("--precision", default="default",
                   choices=("default", "high", "highest"),
                   help="'default' runs the search kernels; 'high' and "
                        "'highest' score with a plain fp32 matmul")
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
        args.passages, tokenizer, args.max_length, is_query=False)
    encode = make_encode_fn(model, "passage_embs")
    p_embs, pids = encode_dataset(encode, dataset, args.encode_batch_size)
    index = load_index(args.query_index,
                       dtype=dtype_from_name(args.hbm_dtype),
                       precision=args.precision, device=args.device)
    stats = retrieve_to_run_file(index, p_embs, pids, args.run,
                                 topk=args.topk,
                                 batch_size=args.search_batch_size)
    print(json.dumps({"passages": len(pids),
                      **{k: round(v, 3) for k, v in stats.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
