"""Read chip_smoke's teacher sample check over several seeds on one card.

    python3 tools/teacher_check_seeds.py --out OUT.json [--seeds 0 1 ...]

For each seed, as chip_smoke's teacher phase does for its ``--seed``:
writes the synthetic corpus (``chip_smoke._write_corpus``, 2,000
passages), a MiniLM-L6 cross-encoder with random weights from the seed
(``chip_smoke._write_teacher``, an HF ``BertForSequenceClassification``
state_dict), and scores 256 (query, passage) pairs, the first three
queries each with their relevant passage and random others, in two
batches of 128 at L=256, bf16, through K5 (attention_infer_d32.cu,
five launches a batch). Then ``chip_smoke._teacher_sample_errors`` holds
them to the same model with the plain attention, and reads the plain
attention with the mask ignored (a deliberately wrong attention): each
as the largest |score - plain score| over the spread of the plain
scores, the quantity chip_smoke holds to ``TEACHER_SAMPLE_TOL``. It
reads the same for the model with the einsum attention
(``attention_impl='xla'``, another sound bf16 rounding), and the
kernel's largest |score - plain score| over the largest |plain score|
(a measure that moves with the offset the seed gives every score). Writes
each seed's plain score range too, one JSON object to ``--out``, and
prints it.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
N_PASSAGES, N_QUERIES, N_QUERIES_SAMPLED = 2000, 64, 3


def _sample(work, seed, model):
    import numpy as np

    import chip_smoke as cs
    from cldrd_tpu_torch.cli.common import build_tokenizer
    from cldrd_tpu_torch.data import (
        RerankingDataset,
        load_passages,
        load_queries,
    )
    from cldrd_tpu_torch.evaluation.reranking_evaluator import (
        make_cross_encoder_score_fn,
    )

    paths = cs._write_corpus(work, N_PASSAGES, N_QUERIES, seed)
    rel = {int(line.split("\t")[0]): int(line.split("\t")[2])
           for line in open(paths["qrels"])}
    rng = np.random.default_rng(seed)
    pairs = []
    for qid in range(N_QUERIES_SAMPLED):
        others = [int(p) for p in rng.choice(N_PASSAGES, 100, replace=False)
                  if p != rel[qid]]
        pairs += [(qid, pid) for pid in [rel[qid], *others][:100]]
    pairs = pairs[:cs.TEACHER_SAMPLE]
    dataset = RerankingDataset.from_pairs(
        pairs, load_queries(paths["queries"]),
        load_passages(paths["collection"]),
        build_tokenizer("hash", model.config.vocab_size),
        is_cross_encoder=True, max_len=cs.TEACHER_L,
        with_token_type_ids=True)
    score = make_cross_encoder_score_fn(model)
    return [(batch.query_passage, score(batch)[:batch.n_valid])
            for batch in dataset.batches(cs.TEACHER_BATCH)]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--out", required=True)
    p.add_argument("--seeds", type=int, nargs="+",
                   default=list(range(8)))
    args = p.parse_args(argv)

    import numpy as np
    import torch

    import chip_smoke as cs
    from cldrd_tpu_torch.ops import attention as att

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    work = os.path.join(cs.WORK, "teacher_seeds")
    key = ("infer", "attn_infer_d32_launch")
    rows = []
    for seed in args.seeds:
        shutil.rmtree(work, ignore_errors=True)
        os.makedirs(work)
        path = os.path.join(work, "teacher.pth.tar")
        cs._write_teacher({"seed": seed}, path)
        model = cs._teacher_model(path, "pallas")
        before = att.ROUTE_LAUNCHES[key]
        sample = _sample(work, seed, model)
        launches = att.ROUTE_LAUNCHES[key] - before
        if launches != (cs.TEACHER_LAYERS - 1) * len(sample):
            raise AssertionError(f"seed {seed}: {launches} head_dim-32 K5 "
                                 f"launches for {len(sample)} batches")
        dev = next(model.parameters()).device
        worst, wrong, want = cs._teacher_sample_errors(model, sample, dev)
        got = np.concatenate([g for _, g in sample])
        einsum = cs._score_sample(cs._teacher_model(path, "xla"), sample,
                                  dev)
        spread = float(want.max() - want.min())
        top = float(np.abs(want).max())
        rows.append(dict(
            seed=seed, pairs=int(got.size), kernel_err_of_spread=worst,
            einsum_err_of_spread=float(np.abs(einsum - want).max()) / spread,
            mask_ignored_err_of_spread=wrong,
            kernel_err_of_largest=float(np.abs(got - want).max()) / top,
            plain_min=float(want.min()), plain_max=float(want.max()),
            k5_launches=launches))
        print(json.dumps(rows[-1]), flush=True)
        del model
        torch.cuda.empty_cache()
    shutil.rmtree(work, ignore_errors=True)
    res = {"device": torch.cuda.get_device_name(0), "rows": rows,
           "tolerance": cs.TEACHER_SAMPLE_TOL,
           "kernel_err_of_spread_max": max(r["kernel_err_of_spread"]
                                           for r in rows),
           "einsum_err_of_spread_max": max(r["einsum_err_of_spread"]
                                           for r in rows),
           "mask_ignored_err_of_spread_min": min(
               r["mask_ignored_err_of_spread"] for r in rows)}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
