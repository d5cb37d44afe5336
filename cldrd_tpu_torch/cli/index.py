"""Build the corpus embedding store, and its IVF companion.

Port of ``cldrd_tpu/cli/index.py``: encode the collection with the
passage tower and write the blocked shard store (JSON meta + binary
shards + ids.npy) that both packages read; with ``--ivf-nlist`` also the
IVF/IVFPQ store at ``<out>/ivf`` that ``cli.serve --ivf`` serves.

    python -m cldrd_tpu_torch.cli.index --collection collection.tsv \\
        --checkpoint model.pth.tar --out index_dir [--ivf-nlist 512] \\
        [--bucket-lengths] [--token-cache cache_dir]
    # the IVF companion of an existing store, without re-encoding:
    python -m cldrd_tpu_torch.cli.index --collection collection.tsv \\
        --out index_dir --ivf-only --ivf-nlist 512 [--pq-m 96]
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time
from typing import List, Optional

import torch

from cldrd_tpu_torch.data import (
    TokenCacheDataset,
    token_cache_exists,
    write_token_cache,
)
from cldrd_tpu_torch.data.sequence_dataset import SequenceDataset
from cldrd_tpu_torch.index import IVFIndex, encode_dataset, make_encode_fn
from cldrd_tpu_torch.index.persistence import (
    META_NAME,
    index_exists,
    read_embeddings,
    write_embeddings,
)
from cldrd_tpu_torch.parallel import DATA_AXIS, make_mesh

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
    p.add_argument("--bucket-lengths", type=int, nargs="*", default=None,
                   help="enable length-bucketed encoding: pad each passage "
                        "only to the smallest listed bucket that fits it "
                        "(empty list = default 32/64/128/... ladder). "
                        "The same embeddings, ~token-proportional encode "
                        "time; index row order becomes length-grouped "
                        "(immaterial: identity rides on the id map)")
    p.add_argument("--devices", type=int, default=1,
                   help="data-parallel encode over this many local devices "
                        "(a replica of the model on each, the batch's rows "
                        "split over them; 0 = all local devices). "
                        "--batch-size must be a multiple of the count")
    p.add_argument("--token-cache", default=None,
                   help="directory for the pre-tokenized corpus cache: "
                        "built on first use, then streamed from a memmap "
                        "on every rebuild (the curriculum re-encodes the "
                        "same collection after each iteration)")
    p.add_argument("--ivf-nlist", type=int, default=None,
                   help="ALSO build an IVF index (k-means coarse quantizer "
                        "with this many cells) into <out>/ivf, the "
                        "low-latency serving companion of the exact flat "
                        "store (cli.serve --ivf --nprobe N)")
    p.add_argument("--ivf-slot", type=int, default=None,
                   help="rows per IVF bucket (default: mean cluster size "
                        "rounded up to 128)")
    p.add_argument("--ivf-nprobe", type=int, default=8,
                   help="default probe count stored with the IVF index")
    p.add_argument("--pq-m", type=int, default=None,
                   help="store the IVF companion as product-quantized "
                        "residual codes with this many sub-quantizers "
                        "(FAISS IndexIVFPQ): pq_m * pq_bits / 8 bytes a "
                        "row. Requires --ivf-nlist; dim must divide by "
                        "pq_m")
    p.add_argument("--pq-bits", type=int, default=4, choices=(4, 8),
                   help="bits per PQ code (4: 16 codewords; 8: 256)")
    p.add_argument("--opq", action="store_true",
                   help="with --pq-m: learn an orthogonal pre-rotation "
                        "(FAISS OPQMatrix) that decorrelates sub-spaces "
                        "before coding")
    p.add_argument("--ivf-only", action="store_true",
                   help="build ONLY the IVF companion from the flat store "
                        "already at --out (no re-encoding; --collection/"
                        "--checkpoint are ignored). Requires --ivf-nlist")
    add_model_args(p)
    return p


def _build_ivf(args, embeddings, ids) -> dict:
    """Build and save the IVF companion at ``<out>/ivf``: fp32 for a
    lossless store, int8 when the flat store is int8 (the device dtype is
    chosen at load time, ``cli.serve --hbm-dtype``); ``--pq-m`` makes it
    uint8 residual codes."""
    t0 = time.perf_counter()
    ivf = IVFIndex.build(
        embeddings, ids, nlist=args.ivf_nlist, slot=args.ivf_slot,
        nprobe=args.ivf_nprobe,
        dtype=torch.int8 if args.store_dtype == "int8" else torch.float32,
        pq_m=args.pq_m, pq_bits=args.pq_bits, opq=args.opq,
        device=args.device)
    ivf_dir = os.path.join(args.out, "ivf")
    ivf.save(ivf_dir)
    elapsed = time.perf_counter() - t0
    logger.info("IVF%s index (%d buckets x %d slot) written to %s in %.1fs",
                "PQ" if ivf.is_pq else "", ivf.n_buckets, ivf.slot, ivf_dir,
                elapsed)
    return {"ivf_buckets": ivf.n_buckets, "ivf_slot": ivf.slot,
            "ivf_build_s": elapsed}


def main(argv: Optional[List[str]] = None) -> int:
    setup_logging()
    args = build_parser().parse_args(argv)
    if args.pq_m and not args.ivf_nlist:
        raise SystemExit("--pq-m requires --ivf-nlist (PQ is the IVF "
                         "companion's storage layer)")
    if args.opq and not args.pq_m:
        raise SystemExit("--opq requires --pq-m (it rotates the PQ "
                         "coding space)")
    if args.ivf_only:
        if not args.ivf_nlist:
            raise SystemExit("--ivf-only requires --ivf-nlist")
        if not index_exists(args.out):
            raise SystemExit(
                f"--ivf-only: no flat store at {args.out} (run cli.index "
                "without --ivf-only first)")
        with open(os.path.join(args.out, META_NAME)) as f:
            if json.load(f)["dtype"] == "int8":
                # the IVF follows the flat store's quantization; the
                # dequantize -> per-row requantize round trip is exact
                args.store_dtype = "int8"
        embeddings, ids = read_embeddings(args.out)
        logger.info("building IVF from the existing %d-row store at %s",
                    len(ids), args.out)
        print(json.dumps(_build_ivf(args, embeddings, ids)))
        return 0
    cfg = model_config_from_args(args)
    tokenizer = build_tokenizer(args.tokenizer, vocab_size=cfg.vocab_size)
    model = load_dual_encoder(args.checkpoint, cfg, args.share_weights,
                              args.cosine, compute_dtype_from_args(args),
                              args.device)
    stats = {}
    if args.token_cache:
        if not token_cache_exists(args.token_cache):
            logger.info("building token cache at %s ...", args.token_cache)
            t0 = time.perf_counter()
            write_token_cache(SequenceDataset.create_from_seqs_file(
                args.collection, tokenizer, args.max_length,
                is_query=False), args.token_cache)
            stats["token_cache_write_s"] = time.perf_counter() - t0
        dataset = TokenCacheDataset(args.token_cache)
    else:
        dataset = SequenceDataset.create_from_seqs_file(
            args.collection, tokenizer, args.max_length, is_query=False)
    mesh = None
    if args.devices != 1:
        mesh = make_mesh(args.devices, DATA_AXIS, args.device)
        if args.batch_size % mesh.size:
            raise SystemExit(
                f"--batch-size {args.batch_size} must be a multiple of the "
                f"{mesh.size} devices (rows split evenly)")
    encode = make_encode_fn(model, "passage_embs", mesh=mesh)
    t0 = time.perf_counter()
    embeddings, ids = encode_dataset(encode, dataset, args.batch_size,
                                     bucket_lengths=args.bucket_lengths)
    elapsed = time.perf_counter() - t0
    logger.info("encoded %d passages in %.1fs (%.0f passages/s)", len(ids),
                elapsed, len(ids) / max(elapsed, 1e-9))
    write_embeddings(args.out, embeddings, ids, dtype=args.store_dtype)
    logger.info("index written to %s", args.out)
    stats.update(passages=len(ids), encode_s=elapsed,
                 passages_per_s=len(ids) / max(elapsed, 1e-9))
    if args.ivf_nlist:
        stats.update(_build_ivf(args, embeddings, ids))
    print(json.dumps(stats))
    return 0


if __name__ == "__main__":
    sys.exit(main())
