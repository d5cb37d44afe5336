#!/usr/bin/env python3
"""End-to-end proof that curriculum distillation improves retrieval,
through the PyTorch port's CLIs (port of examples/distill_experiment.py).

A planted-relevance corpus: each query has three truly relevant passages
but the labels know only one; the other two are near-duplicates that a
warmed-up retriever ranks right behind it, so hard-negative mining turns
them into false negatives. Both arms train from the same warm start on
the same mined candidates for the same budget; only the supervision
differs:
  control: binary sparse labels (label mode 1) on the mined candidates;
  distill: curriculum buckets from ``cli.create_training_data
           --teacher-oracle-qrels`` (graded label modes 8/9/10), the
           teacher (graded qrels + noise) rescuing the false negatives.

Pipeline (every step through the port's CLIs, in process):
  1. warm-up:   cli.train on sparse labels with random negatives
  2. iter-0:    cli.index + cli.retrieve + RankingEvaluator
  3. mine:      cli.retrieve top-100 candidates per training query
  4. teacher:   cli.create_training_data --teacher-oracle-qrels
  5. distill:   cli.curriculum, label modes 8/9/10, per-iteration eval
                (length-bucketed on-device index builds)
  6. control:   cli.curriculum, the mined-negative file x3, mode 1
  7. report:    one JSON line; checks["improves_over_iterations"] and
                checks["beats_control"] must both be true.

    python3 tools/distill_experiment_torch.py [--device cpu]
        [--n-queries 128] [--n-passages 50000] [--out DIR]

Runs on the card unless ``--device cpu``; tests/test_torch_distill.py
runs it on the CPU.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def make_corpus(out_dir: str, n_q: int, n_passages: int,
                n_distract: int = 10, seed: int = 0) -> dict:
    """Planted-relevance corpus with incomplete training labels.

    EVERY passage follows the same template ("document on <tokens>") so
    surface form carries no signal — only token identity does (an early
    version with lexically distinct noise let the student classify
    "document-ness" and ace its candidate lists while learning nothing
    about subjects). Query q carries two signature tokens
    (``subjA{q} subjB{q}`` — two so a hash-bucket collision on one cannot
    merge two queries' relevance). Its three relevant passages: variant 0
    (both tokens + short filler, the ONLY labeled one), variants 1/2 —
    UNJUDGED NEAR-DUPLICATES carrying both tokens diluted by several
    unique junk words, so the warm retriever ranks them right behind
    variant 0 (discoverable by mining — a false negative must be FOUND
    before either arm can label it) but below it (headroom for the
    distilled student to pull them up). ``n_distract`` distractors per
    query share ONE signature token and are judged non-relevant;
    background noise passages carry their own unique subject tokens. The
    warm-up file labels variant 0 with RANDOM noise negatives (MS MARCO's
    original triples); the full qrels grade all three variants relevant."""
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    queries, passages, warmup, qrels_full = [], [], [], []
    labeled_pos = {}
    pid = 0
    n_planted = n_q * (3 + n_distract)
    n_noise = max(n_passages - n_planted, 5 * n_q)
    noise_pids = []
    for i in range(n_noise):
        passages.append(
            f"{pid}\tdocument on subjA{10**6 + 2 * i} "
            f"subjB{10**6 + 2 * i + 1} aspect{i % 7} "
            f"extra{rng.integers(10**6)}\n")
        noise_pids.append(pid)
        pid += 1
    noise_pids = np.asarray(noise_pids)
    for q in range(n_q):
        queries.append(f"{q}\tfind subjA{q} subjB{q} details\n")
        variants = []

        def junk(n_words):
            return " ".join(f"junk{rng.integers(10**6)}"
                            for _ in range(n_words))

        texts = [
            f"document on subjA{q} subjB{q} aspect0 extra{rng.integers(10**6)}",
            f"document on subjA{q} subjB{q} aspect1 {junk(5)}",
            f"document on subjA{q} subjB{q} aspect2 {junk(5)}",
        ]
        for text in texts:
            passages.append(f"{pid}\t{text}\n")
            variants.append(pid)
            qrels_full.append(f"{q}\t0\t{pid}\t1\n")
            pid += 1
        for i in range(n_distract):
            tok = f"subjA{q}" if i % 2 == 0 else f"subjB{q}"
            passages.append(
                f"{pid}\tdocument on {tok} junk{rng.integers(10**6)} "
                f"aspect{3 + i} extra{rng.integers(10**6)}\n")
            pid += 1
        labeled_pos[q] = variants[0]
        # label mode 1 layout: 1 relT + 3 most_hard + 2 semi_hard, all
        # negatives random noise (no false negatives yet)
        negs = [int(p) for p in rng.choice(noise_pids, 5, replace=False)]
        warmup.append(json.dumps({
            "qid": q, "relT_pids": [variants[0]],
            "most_hard_pids": negs[:3], "semi_hard_pids": negs[3:],
        }) + "\n")
    paths = {
        "queries": os.path.join(out_dir, "queries.tsv"),
        "passages": os.path.join(out_dir, "collection.tsv"),
        "warmup_train": os.path.join(out_dir, "warmup.train.jsonl"),
        "qrels_full": os.path.join(out_dir, "qrels_full.tsv"),
    }
    open(paths["queries"], "w").write("".join(queries))
    open(paths["passages"], "w").write("".join(passages))
    open(paths["warmup_train"], "w").write("".join(warmup))
    open(paths["qrels_full"], "w").write("".join(qrels_full))
    paths["labeled_pos"] = labeled_pos
    return paths


def make_mined_control_file(cand_run: str, labeled_pos: dict,
                            out_path: str) -> str:
    """The control arm's training file: the SAME mined candidates the
    teacher grades, labeled binarily by the sparse judgments; the top
    non-labeled candidates become 'hard negatives' (including, unknowingly,
    the unlabeled true positives): hard-negative mining without teacher
    denoising."""
    from cldrd_tpu_torch.evaluation import load_run_ranklists

    ranklists = load_run_ranklists(cand_run)
    with open(out_path, "w", encoding="utf-8") as f:
        for qid in sorted(ranklists):
            pos = labeled_pos[int(qid)]
            negs = [p for p in ranklists[qid] if p != pos][:5]
            if len(negs) < 5:
                continue
            f.write(json.dumps({
                "qid": int(qid), "relT_pids": [pos],
                "most_hard_pids": negs[:3], "semi_hard_pids": negs[3:5],
            }) + "\n")
    return out_path


def _mined_discovery(cand_run: str, qrels_path: str) -> dict:
    """Mean number of truly-relevant (qrels_full) passages per query that
    hard-negative mining actually surfaced, + the count of queries where
    it surfaced none."""
    import collections

    qrels = collections.defaultdict(set)
    for line in open(qrels_path):
        q, _, p, _ = line.split("\t")
        qrels[q].add(p)
    found = collections.defaultdict(set)
    for line in open(cand_run):
        q, p = line.split("\t")[:2]
        if p in qrels[q]:
            found[q].add(p)
    rates = [len(found[q]) for q in qrels]
    return {
        "mean_per_query": round(sum(rates) / len(rates), 3),
        "queries_with_zero": sum(1 for r in rates if r == 0),
    }


def _read_eval_tsv(path: str) -> list:
    rows = open(path).read().splitlines()
    header = rows[0].split("\t")
    out = []
    for line in rows[1:]:
        cells = line.split("\t")
        out.append({h: (cells[i] if h == "step" else float(cells[i]))
                    for i, h in enumerate(header)})
    return out


# tiny dims but a 32k hash vocab: the task requires resolving per-passage
# subject/filler tokens, and small bucket counts alias 50k passages' tokens
# into mush (measured: vocab 8192 at 50k passages drops mined-candidate
# discovery of the planted relevants from 1.8/3 to 1.2/3 and warm MRR@10
# from 0.98 to 0.43)
_TINY = json.dumps(dict(vocab_size=32768, max_position_embeddings=64,
                        dim=32, n_layers=2, n_heads=4, hidden_dim=64))


def _model_args(attention_impl: str, device: str) -> list:
    return ["--model-config", _TINY, "--tokenizer", "hash",
            "--share-weights", "--attention-impl", attention_impl,
            "--device", device]


def _base_yaml(out_dir: str, batch_size: int, seed: int = 0) -> str:
    """The reference experiment's train settings (see its comments):
    in-batch negatives, batch 8, one shared tower, fp32, seed-dependent
    training RNG."""
    from cldrd_tpu_torch.train import TrainConfig

    cfg = TrainConfig(max_query_len=16, max_passage_len=24,
                      compute_dtype="float32", warmup_steps=2,
                      logging_steps=50, evaluate_steps=10**6,
                      batch_size=batch_size, in_batch_loss=True,
                      share_weights=True, seed=4680 + seed)
    path = os.path.join(out_dir, "base.yaml")
    cfg.save_yaml(path)
    return path


def run(out_dir: str, n_q: int = 128, n_passages: int = 50_000,
        batch_size: int = 8, warmup_epochs: int = 480,
        epochs=(8, 4, 4), lrs=(1e-3, 5e-4, 5e-4), mine_topk: int = 100,
        teacher_noise: float = 0.05, eval_topk: int = 10, seed: int = 0,
        attention_impl: str = "xla", pack_passages: bool = False,
        device: str = "cuda") -> dict:
    """The whole protocol; returns the report (metrics and verdicts).
    ``attention_impl='pallas'`` + ``pack_passages=True`` is the fast-path
    variant (the attention kernels, their plain versions on the CPU)."""
    from cldrd_tpu_torch.cli import create_training_data as cli_ctd
    from cldrd_tpu_torch.cli import curriculum as cli_curriculum
    from cldrd_tpu_torch.cli import index as cli_index
    from cldrd_tpu_torch.cli import retrieve as cli_retrieve
    from cldrd_tpu_torch.cli import train as cli_train
    from cldrd_tpu_torch.evaluation import RankingEvaluator
    from cldrd_tpu_torch.train import latest_checkpoint

    model = _model_args(attention_impl, device)
    pack_flag = ["--pack-passages"] if pack_passages else \
        ["--no-pack-passages"]
    f = make_corpus(os.path.join(out_dir, "data"), n_q, n_passages,
                    seed=seed)
    yaml = _base_yaml(out_dir, batch_size, seed=seed)
    evaluator = RankingEvaluator(f["qrels_full"])

    # 1. warm-up on the sparse labels with random negatives: the shared
    #    starting point and the retriever that mines candidates (ranknet at
    #    5e-3: a random-init 2-layer student needs the larger pairwise
    #    gradients; both arms then train with the reference's lambda_mrr)
    assert cli_train.main([
        "--training-path", f["warmup_train"], "--queries-path", f["queries"],
        "--passages-path", f["passages"], "--label-mode", "1",
        "--config", yaml, "--learning-rate", "5e-3", "--loss", "ranknet",
        "--num-train-epochs", str(warmup_epochs),
        "--run-folder", out_dir, "--experiment-name", "warmup",
        *pack_flag, *model]) == 0
    warm_ckpt = latest_checkpoint(os.path.join(out_dir, "warmup"))

    # 2. the iteration-0 row: the warm-up student's full-corpus retrieval
    idx_dir = os.path.join(out_dir, "warm_idx")
    assert cli_index.main([
        "--collection", f["passages"], "--checkpoint", warm_ckpt,
        "--out", idx_dir, "--max-length", "24", "--batch-size", "256",
        "--store-dtype", "float32", "--bucket-lengths", *model]) == 0
    retrieve = ["--index", idx_dir, "--queries", f["queries"],
                "--checkpoint", warm_ckpt, "--max-length", "16",
                "--compute-dtype", "float32", *model]
    warm_run = os.path.join(out_dir, "warmup.run.tsv")
    assert cli_retrieve.main([*retrieve, "--run", warm_run,
                              "--topk", str(eval_topk)]) == 0
    iter0 = {k: float(v)
             for k, v in evaluator.compute_metrics(warm_run).items()}

    # 3. candidate mining: top-100 per training query
    cand_run = os.path.join(out_dir, "candidates.run.tsv")
    assert cli_retrieve.main([*retrieve, "--run", cand_run,
                              "--topk", str(mine_topk)]) == 0
    mined_discovery = _mined_discovery(cand_run, f["qrels_full"])

    # 4. oracle teacher -> the curriculum bucket files
    prefix = os.path.join(out_dir, "curr_")
    assert cli_ctd.main([
        "--candidates-run", cand_run, "--queries", f["queries"],
        "--passages", f["passages"], "--out-prefix", prefix,
        "--teacher-oracle-qrels", f["qrels_full"],
        "--teacher-noise", str(teacher_noise), "--seed", str(seed),
        *model]) == 0
    stages = [f"{prefix}{s}.train.jsonl"
              for s in ("5relT_25neg", "10relT_20neg", "20relT_10neg")]
    for s in stages:
        assert os.path.getsize(s) > 0, s

    # 5/6. the two arms: identical warm start, candidates, lrs, epochs and
    #      batch size; only the supervision over the candidates differs
    control_file = make_mined_control_file(
        cand_run, f["labeled_pos"],
        os.path.join(out_dir, "control.train.jsonl"))
    arms = {
        "distill": dict(paths=stages, modes=["8", "9", "10"]),
        "control": dict(paths=[control_file] * 3, modes=["1", "1", "1"]),
    }
    results = {}
    for name, arm in arms.items():
        folder = os.path.join(out_dir, name)
        assert cli_curriculum.main([
            "--queries", f["queries"], "--passages", f["passages"],
            "--training-paths", *arm["paths"],
            "--label-modes", *arm["modes"],
            "--learning-rates", *[str(lr) for lr in lrs],
            "--epochs", *[str(e) for e in epochs],
            "--model-checkpoint", warm_ckpt,
            "--config", yaml, "--run-folder", folder,
            "--eval-queries", f["queries"], "--eval-qrels", f["qrels_full"],
            "--eval-topk", str(eval_topk), "--eval-batch-size", "256",
            "--eval-bucket-lengths", *pack_flag, *model]) == 0
        results[name] = _read_eval_tsv(os.path.join(
            folder, "curriculum_eval.tsv"))

    # 7. verdicts. nDCG@10 and Recall (all 3 planted positives) are the
    #    separating metrics: both arms rank the LABELED positive first, but
    #    only the distilled arm retrieves the planted false negatives.
    #    'improves_over_iterations': every curriculum iteration beats the
    #    pre-distillation baseline (iter0) and the arm does not decay
    #    within the curriculum (the gain typically lands at iteration 1
    #    and plateaus — a plateau is a pass, a slide back toward iter0 is
    #    not). 'beats_control': the same-budget binary-label arm loses on
    #    BOTH metrics.
    met = "nDCG@10"
    rec = next(c for c in results["distill"][0] if c.startswith("Recall@"))
    d_first, d_final = results["distill"][0], results["distill"][-1]
    c_final = results["control"][-1]
    checks = {
        "improves_over_iterations": (
            all(r[met] > iter0[met] for r in results["distill"])
            and d_final[rec] > iter0[rec]
            and d_final[met] >= d_first[met] - 0.02
        ),
        "beats_control": (
            d_final[met] > c_final[met] and d_final[rec] > c_final[rec]
        ),
    }
    return {
        "n_queries": n_q, "n_passages": n_passages, "seed": seed,
        "attention_impl": attention_impl, "pack_passages": pack_passages,
        "device": device, "metric": met, "recall_metric": rec,
        "mined_discovery": mined_discovery,
        "iter0": {met: iter0[met], rec: iter0[rec],
                  "MRR@10": iter0["MRR@10"]},
        "distill": [{"step": r["step"], met: r[met], rec: r[rec],
                     "MRR@10": r["MRR@10"]} for r in results["distill"]],
        "control": [{"step": r["step"], met: r[met], rec: r[rec],
                     "MRR@10": r["MRR@10"]} for r in results["control"]],
        "checks": checks,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--out", default="distill_experiment_out")
    p.add_argument("--n-queries", type=int, default=128)
    p.add_argument("--n-passages", type=int, default=50_000)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--attention-impl", choices=("xla", "pallas"),
                   default="xla",
                   help="'pallas' = the fast-path variant (the attention "
                        "kernels; their plain versions on the CPU)")
    p.add_argument("--pack-passages", action="store_true",
                   help="packed passage rows (the other half of the fast "
                        "path)")
    args = p.parse_args(argv)
    report = run(args.out, n_q=args.n_queries, n_passages=args.n_passages,
                 batch_size=args.batch_size, seed=args.seed,
                 attention_impl=args.attention_impl,
                 pack_passages=args.pack_passages, device=args.device)
    with open(os.path.join(args.out, "report.json"), "w") as fh:
        json.dump(report, fh, indent=1)
    print(json.dumps(report))
    return 0 if all(report["checks"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())
