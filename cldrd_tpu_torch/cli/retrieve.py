"""Retrieve the exact top-k passages per query into a run file.

Port of ``cldrd_tpu/cli/retrieve.py``: encode the queries, load the store
into a device ``FlatIPIndex``, search exactly, and write
``qid\\tpid\\trank\\tscore``.

    python -m cldrd_tpu_torch.cli.retrieve --index index_dir \\
        --queries queries.tsv --checkpoint model.pth.tar --run dev.run.tsv
"""
from __future__ import annotations

import argparse
import contextlib
import json
import logging
import sys
from typing import List, Optional

from cldrd_tpu_torch.data.sequence_dataset import SequenceDataset
from cldrd_tpu_torch.device import dtype_from_name
from cldrd_tpu_torch.index import encode_dataset, load_index, make_encode_fn
from cldrd_tpu_torch.parallel import CORPUS_AXIS, make_mesh
from cldrd_tpu_torch.search import retrieve_to_run_file
from cldrd_tpu_torch.utils.profiling import trace

from .common import (
    add_model_args,
    build_tokenizer,
    compute_dtype_from_args,
    load_dual_encoder,
    model_config_from_args,
    setup_logging,
)

logger = logging.getLogger("cldrd_tpu_torch.cli.retrieve")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--index", required=True,
                   help="index directory (from cli.index)")
    p.add_argument("--queries", required=True, help="qid\\ttext TSV")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--run", required=True, help="output run TSV path")
    p.add_argument("--topk", type=int, default=1000)
    p.add_argument("--max-length", type=int, default=30)
    p.add_argument("--encode-batch-size", type=int, default=512)
    p.add_argument("--search-batch-size", type=int, default=128)
    p.add_argument("--compute-dtype", default="bfloat16",
                   choices=("bfloat16", "float32"),
                   help="encoder activation dtype")
    p.add_argument("--hbm-dtype", default="bfloat16",
                   choices=("bfloat16", "float32", "int8"),
                   help="device store dtype (int8 = per-row-scaled codes)")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace of the search phase "
                        "(host ops and every device's kernels; the query "
                        "encode and the index load stay outside it) into "
                        "this directory: one *.pt.trace.json that "
                        "Perfetto, chrome://tracing and TensorBoard load")
    p.add_argument("--shards", type=int, default=1,
                   help="shard the corpus over this many local devices "
                        "(per-shard exact top-k on each device, merged on "
                        "the first: FAISS's IndexShards); 0 = all local "
                        "devices")
    p.add_argument("--precision", default="default",
                   choices=("default", "high", "highest"),
                   help="'default' runs the search kernels (bf16 operands, "
                        "fp32 accumulation; fp32 stores in fp32); 'high' and "
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
        args.queries, tokenizer, args.max_length, is_query=True)
    encode = make_encode_fn(model, "query_embs")
    q_embs, qids = encode_dataset(encode, dataset, args.encode_batch_size)
    mesh = None
    if args.shards != 1:
        mesh = make_mesh(args.shards, CORPUS_AXIS, args.device)
    index = load_index(args.index, dtype=dtype_from_name(args.hbm_dtype),
                       precision=args.precision, device=args.device,
                       mesh=mesh)
    ctx = (trace(args.profile_dir) if args.profile_dir
           else contextlib.nullcontext())
    with ctx:
        stats = retrieve_to_run_file(index, q_embs, qids, args.run,
                                     topk=args.topk,
                                     batch_size=args.search_batch_size)
    stats["rescued_queries"] = index.rescued_queries
    print(json.dumps({"queries": len(qids),
                      **{k: round(v, 3) for k, v in stats.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
