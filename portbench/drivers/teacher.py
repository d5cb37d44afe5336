"""Teacher scoring: ``cli.create_training_data``'s path, the BERT
cross-encoder through ``rerank_candidates_with_teacher``.

Set-up: ``queries`` queries and their ``candidates`` passages each
(texts of ``query_words`` and ``passage_words``) written to TSVs and
loaded by the port's loaders; the candidate lists in an order from the
seed; the cross-encoder with the seed's weights and the CLI's score
function; ``warmup_passes`` passes.

A pass: ``rerank_candidates_with_teacher`` over every (query, candidate)
pair, flat (``batch_size`` pairs a call, ``max_len`` tokens, token types
on), tokenization included. The window runs whole passes until
``--seconds`` have gone by; its pairs over its seconds are
``window["pairs"]`` (the per-layer ``pairs_s.teacher``). Then
``trace_passes`` more passes are traced, in every run: their device-busy
time a pass is ``teacher_pass_device_ms``, and with ``--trace 1`` the
per-layer readers read the same trace.

The comparison, over every pair of the window's last pass: each score
against the reference's float32 cross-encoder, over the root mean square
of the reference's scores; and each query's list holding its candidates once
each, in the order of its scores.
"""
from __future__ import annotations

import os
import shutil
import time

import numpy as np
import torch

from portbench import inputs, roofline
from portbench.harness import log
from portbench.reference import encoder as ref_encoder
from portbench.reference.text import hash_tokenize

from . import compute_dtype, dims, free_device, port_config

UNIT = "pairs"


def units(traffic: dict) -> int:
    """The (query, passage) pairs of one pass."""
    return traffic["queries"] * traffic["candidates"]


def make_data(seed: int, t: dict):
    """(query texts, passage texts, {qid: candidate pids})."""
    n_q, n_c = t["queries"], t["candidates"]
    q = inputs.texts(seed, 1, n_q, t["query_words"], t["vocab_words"],
                     t["zipf"])
    p = inputs.texts(seed, 2, n_q * n_c, t["passage_words"],
                     t["vocab_words"], t["zipf"])
    g = inputs.rng(seed, "order")
    lists = {qid: (qid * n_c + g.permutation(n_c)).tolist()
             for qid in range(n_q)}
    return q, p, lists


def run(run):
    from cldrd_tpu_torch.data import HashTokenizer
    from cldrd_tpu_torch.data.loaders import load_passages, load_queries
    from cldrd_tpu_torch.data.teacher import rerank_candidates_with_teacher
    from cldrd_tpu_torch.evaluation.reranking_evaluator import (
        make_cross_encoder_score_fn,
    )
    from cldrd_tpu_torch.models import CrossEncoder
    from cldrd_tpu_torch.ops import attention, residual_norm

    t, dev = run.traffic, torch.device(run.device)
    d = dims(run.config)
    qtexts, ptexts, lists = make_data(run.seed, t)
    work = inputs.work_dir()
    inputs.write_tsv(os.path.join(work, "q.tsv"), range(len(qtexts)), qtexts)
    inputs.write_tsv(os.path.join(work, "p.tsv"), range(len(ptexts)), ptexts)
    qid_to_query = load_queries(os.path.join(work, "q.tsv"))
    pid_to_passage = load_passages(os.path.join(work, "p.tsv"))
    shutil.rmtree(work, ignore_errors=True)
    tokenizer = HashTokenizer(vocab_size=d["vocab_size"])

    weights = inputs.make_weights(ref_encoder.cross_encoder_specs(d),
                                  run.seed, dev, d["weights_std"])
    with torch.device(dev):
        model = CrossEncoder(port_config(run.config),
                             dtype=compute_dtype(run.config),
                             arch=run.config["model_type"])
    model.load_state_dict(weights, strict=True)
    model.eval()
    del weights
    score = make_cross_encoder_score_fn(model)
    calls = [0]

    def score_fn(batch):
        calls[0] += 1
        with run.span("score"):
            return score(batch)

    def one_pass():
        with run.span("rerank"):
            return rerank_candidates_with_teacher(
                lists, score_fn, qid_to_query, pid_to_passage, tokenizer,
                max_len=t["max_len"], batch_size=t["batch_size"],
                with_token_type_ids=run.config["model_type"] == "bert")

    for _ in range(t["warmup_passes"]):
        one_pass()
    n_pairs = sum(len(v) for v in lists.values())
    run.window_opens()
    t0 = time.perf_counter()
    passes = 0
    while True:
        last = one_pass()
        passes += 1
        if time.perf_counter() - t0 >= run.seconds:
            break
    run.sync()
    elapsed = time.perf_counter() - t0
    run.close_spans()
    calls_before = calls[0]
    with run.traced(lambda: {
            "attn_infer": attention.LAUNCHES["infer"],
            "residual_norm_fwd": residual_norm.LAUNCHES["fwd"]}):
        for _ in range(t["trace_passes"]):
            one_pass()
    run.window_closed()
    device_s = run.trace_data.all_busy_s()
    traced_calls = calls[0] - calls_before
    del model, score
    free_device()

    keys = traced_keys(qtexts, ptexts, lists, t, d) * t["trace_passes"]
    shapes = {"batch_size": t["batch_size"], "max_len": t["max_len"],
              "calls": traced_calls, "keys": keys, "dim": d["dim"],
              "n_layers": d["n_layers"], "n_heads": d["n_heads"],
              "traced_units": t["trace_passes"],
              "model_units": traced_calls, "model_span": "score"}
    lengths = [min(len(qtexts[q].split()) + len(ptexts[p].split()) + 3,
                   t["max_len"]) for q, ps in lists.items() for p in ps]
    flops = roofline.seq_fwd_flops(lengths, d["dim"], d["hidden_dim"],
                                   d["n_layers"])
    window = {"units": passes, "pairs": passes * n_pairs,
              "flops": passes * flops, "seconds": elapsed}
    return {"attempted": passes * n_pairs, "failed": 0,
            "metrics": {"teacher_pass_device_ms":
                        1e3 * device_s / t["trace_passes"]},
            "window": window, "shapes": shapes,
            "check": lambda: check(run, qtexts, ptexts, lists, last)}


def pair_tokens(qtexts, ptexts, lists, t: dict, d: dict):
    pairs = [(q, p) for q, ps in lists.items() for p in ps]
    tok = hash_tokenize([qtexts[q] for q, _ in pairs], t["max_len"],
                        d["vocab_size"], pairs=[ptexts[p] for _, p in pairs])
    return pairs, tok


def traced_keys(qtexts, ptexts, lists, t, d) -> int:
    """Unmasked keys of a pass's score calls, summed over rows (the padded
    rows of a last partial batch have none)."""
    _, tok = pair_tokens(qtexts, ptexts, lists, t, d)
    return int(tok["attention_mask"].sum())


def reference_scores(run, qtexts, ptexts, lists, quant=None,
                     block: int = 256):
    t, dev = run.traffic, torch.device(run.device)
    d = dims(run.config)
    pairs, tok = pair_tokens(qtexts, ptexts, lists, t, d)
    p = inputs.make_weights(ref_encoder.cross_encoder_specs(d), run.seed,
                            dev, d["weights_std"])
    out = []
    with torch.no_grad():
        for s in range(0, len(pairs), block):
            out.append(ref_encoder.cross_encoder_scores(
                p, d, {k: torch.from_numpy(v[s:s + block]).to(dev)
                       for k, v in tok.items()}, quant=quant))
    del p
    free_device()
    scores = torch.cat(out).cpu().numpy()
    return {pair: float(s) for pair, s in zip(pairs, scores)}


def numbers(got: dict, want: dict, lists: dict) -> dict:
    """``got``: {qid: [(pid, score)] in the order served}."""
    # the scores' root mean square: with random weights every pair's
    # score lies near one value, and their spread is under bf16's rounding
    scale = float(np.sqrt(np.mean(np.square(list(want.values()))))) \
        or 1e-30
    worst, bad = 0.0, 0
    for qid, cands in lists.items():
        served = got.get(qid, [])
        pids = [p for p, _ in served]
        scores = [s for _, s in served]
        if sorted(pids) != sorted(cands) or any(
                a < b for a, b in zip(scores, scores[1:])):
            bad += 1
        for pid, s in served:
            if (qid, pid) in want:
                gap = abs(s - want[(qid, pid)]) / scale
                if gap > worst:
                    worst, where = gap, (qid, pid, s, want[(qid, pid)])
    if worst > 0:
        log(f"worst score gap: query {where[0]} passage {where[1]}: "
            f"{where[2]:.6g} against {where[3]:.6g}; scores' rms {scale:.6g}")
    return {"score_err": worst, "bad_lists": float(bad)}


def check(run, qtexts, ptexts, lists, last) -> dict:
    return numbers(last, reference_scores(run, qtexts, ptexts, lists), lists)


def control(run) -> dict:
    """The reference in the port's place with fp8 (e4m3) products."""
    qtexts, ptexts, lists = make_data(run.seed, run.traffic)
    want = reference_scores(run, qtexts, ptexts, lists)
    ctl = reference_scores(run, qtexts, ptexts, lists,
                           quant=ref_encoder.fp8_e4m3)
    served = {}
    for (q, p), s in ctl.items():
        served.setdefault(q, []).append((p, s))
    served = {q: sorted(v, key=lambda x: -x[1]) for q, v in served.items()}
    return numbers(served, want, lists)
