"""Exact retrieval: ``cli.retrieve``'s path without its run file.

Set-up: the queries (``queries`` texts of ``query_words``) written to a
TSV and loaded as the CLI loads them (``SequenceDataset``, hash
tokenizer, ``max_query_len``); the store's rows made on the device a
block at a time (``store``: clustered, a spread of norms) and quantized
by the port's ``quantize_rows`` into an int8 ``FlatIPIndex``; the dual
encoder with the seed's weights; ``warmup_passes`` passes.

A pass: ``encode_dataset`` of every query (``encode_batch``), then
``FlatIPIndex.search_batched(k, search_batch)``. The window runs whole
passes until ``--seconds`` have gone by; ``retrieve_qps`` is the queries
answered over the window's seconds.

The comparison, over every query of the window's last pass: the query
tower's embeddings, the top-k scores rank by rank, and the reference's
score of each returned row against the reference's own k-th best at
that rank, all against the reference's float32 tower and exact search
over its own quantization of the same rows; and every list holding k
distinct rows of the store.
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
from portbench.reference import search as ref_search
from portbench.reference.text import hash_tokenize

from . import compute_dtype, dims, free_device, port_config

UNIT = "queries"


def units(traffic: dict) -> int:
    """The queries of one pass."""
    return traffic["queries"]


def store_rows(seed: int, store: dict, dim: int, device):
    """Yield (start, float32 rows) of the store, block by block."""
    centres = inputs.store_centres(seed, store["centres"], dim, device)
    n, block = store["rows"], store["block_rows"]
    for b, start in enumerate(range(0, n, block)):
        yield start, inputs.store_block(seed, b, min(block, n - start),
                                        centres, store)


def query_texts(seed: int, traffic: dict):
    return inputs.texts(seed, 1, traffic["queries"], traffic["query_words"],
                        traffic["vocab_words"], traffic["zipf"])


def run(run):
    from cldrd_tpu_torch.data import HashTokenizer, SequenceDataset
    from cldrd_tpu_torch.index import (
        FlatIPIndex,
        encode_dataset,
        make_encode_fn,
        quantize_rows,
    )
    from cldrd_tpu_torch.models import NwayDualEncoder
    from cldrd_tpu_torch.ops import attention, extract_topk, residual_norm

    t, dev = run.traffic, torch.device(run.device)
    cfg = port_config(run.config)
    d = dims(run.config)
    work = inputs.work_dir()
    texts = query_texts(run.seed, t)
    path = os.path.join(work, "queries.tsv")
    inputs.write_tsv(path, range(len(texts)), texts)
    dataset = SequenceDataset.create_from_seqs_file(
        path, HashTokenizer(vocab_size=d["vocab_size"]),
        t["max_query_len"], is_query=True)
    shutil.rmtree(work, ignore_errors=True)

    st = t["store"]
    n_rows = st["rows"]
    codes = torch.empty((n_rows, d["dim"]), dtype=torch.int8, device=dev)
    scales = torch.empty((n_rows,), dtype=torch.float32, device=dev)
    for start, rows in store_rows(run.seed, st, d["dim"], dev):
        c, s = quantize_rows(rows)
        codes[start:start + len(rows)] = c
        scales[start:start + len(rows)] = s
        del rows, c, s
    index = FlatIPIndex.from_tensors(
        codes, torch.arange(n_rows, dtype=torch.int32, device=dev), scales)
    del codes, scales

    weights = inputs.make_weights(ref_encoder.dual_encoder_specs(d),
                                  run.seed, dev, d["weights_std"])
    with torch.device(dev):
        model = NwayDualEncoder(cfg, share_weights=False,
                                dtype=compute_dtype(run.config))
    model.load_state_dict(weights, strict=True)
    del weights
    encode = make_encode_fn(model, "query_embs")

    def one_pass():
        with run.span("encode"):
            q, qids = encode_dataset(encode, dataset, t["encode_batch"])
        with run.span("search"):
            s, i = index.search_batched(q, t["k"],
                                        batch_size=t["search_batch"],
                                        max_in_flight=t["max_in_flight"])
        return q, qids, s, i

    for _ in range(t["warmup_passes"]):
        one_pass()
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
    n_q = len(dataset)
    if run.trace:
        with run.traced(lambda: {
                "extract_topk": extract_topk.LAUNCHES,
                "attn_infer": attention.LAUNCHES["infer"],
                "residual_norm_fwd": residual_norm.LAUNCHES["fwd"]}):
            for _ in range(t["trace_passes"]):
                one_pass()
    run.window_closed()
    del index, model, encode
    free_device()

    batches = -(-n_q // t["search_batch"])
    shapes = {"search_batch": t["search_batch"], "k": t["k"],
              "rows": n_rows, "dim": d["dim"],
              "search_batches": batches * t["trace_passes"],
              "encode_batches": -(-n_q // t["encode_batch"])
              * t["trace_passes"],
              "traced_units": t["trace_passes"]}
    lengths = [min(len(x.split()) + 2, t["max_query_len"]) for x in texts]
    flops = roofline.seq_fwd_flops(lengths, d["dim"], d["hidden_dim"],
                                   d["n_layers"]) \
        + 2.0 * n_q * n_rows * d["dim"]
    window = {"units": passes, "seconds": elapsed,
              "flops": passes * flops}
    return {"attempted": passes * n_q, "failed": 0,
            "metrics": {"retrieve_qps": passes * n_q / elapsed},
            "window": window, "shapes": shapes,
            "check": lambda: check(run, texts, last)}


def reference_store(seed: int, store: dict, dim: int, device):
    """The reference's own quantization of the same rows."""
    codes = torch.empty((store["rows"], dim), dtype=torch.int8,
                        device=device)
    scales = torch.empty((store["rows"],), dtype=torch.float32,
                         device=device)
    for start, rows in store_rows(seed, store, dim, device):
        c, s = ref_search.quantize(rows)
        codes[start:start + len(rows)] = c
        scales[start:start + len(rows)] = s
        del rows
    return codes, scales


def reference_queries(p, d: dict, texts, max_len: int, device, quant=None,
                      block: int = 1024) -> torch.Tensor:
    tok = hash_tokenize(texts, max_len, d["vocab_size"])
    out = []
    with torch.no_grad():
        for s in range(0, len(texts), block):
            out.append(ref_encoder.encode(
                p, "query_encoder.", d,
                torch.from_numpy(tok["input_ids"][s:s + block]).to(device),
                torch.from_numpy(tok["attention_mask"][s:s + block]).to(
                    device), quant=quant))
    return torch.cat(out)


def numbers(q, s, i, q_ref, best, codes, scales) -> dict:
    """The numbers compared. ``q``, ``s``, ``i``: embeddings [Q, D], top-k
    scores and row positions [Q, k] under test; ``q_ref`` and ``best``:
    the reference's embeddings and exact top-k scores."""
    dev = q_ref.device
    q = torch.as_tensor(q, dtype=torch.float32, device=dev)
    s = torch.as_tensor(s, dtype=torch.float32, device=dev)
    i = torch.as_tensor(i, device=dev).to(torch.int64)
    n_rows, k = codes.shape[0], best.shape[1]
    valid = (i >= 0) & (i < n_rows)
    srt = torch.sort(torch.where(valid, i, torch.full_like(i, -1)), 1)[0]
    distinct = (srt[:, 1:] != srt[:, :-1]).all(1) & valid.all(1)
    bad = int((~distinct).sum()) + int(i.shape[1] != k)
    top = best[:, :1].abs().clamp(min=1e-30)
    emb_err = float(((q - q_ref).norm(dim=1)
                     / q_ref.norm(dim=1).clamp(min=1e-30)).max())
    score_err = float(((s - best).abs() / top).max())
    got = ref_search.scores_of(q_ref, i.clamp(0, n_rows - 1), codes, scales)
    rank_gap = (best - got) / top
    rank_err = float(rank_gap.max())
    w = int(rank_gap.max(1).values.argmax())
    log(f"worst rank gap: query {w}, rank "
        f"{int(rank_gap[w].argmax())} of {k}, top score "
        f"{float(best[w, 0]):.6g}, k-th {float(best[w, -1]):.6g}")
    return {"emb_err": emb_err, "score_err": score_err,
            "rank_err": rank_err, "bad_lists": float(bad)}


def check(run, texts, last) -> dict:
    t, dev = run.traffic, torch.device(run.device)
    d = dims(run.config)
    q, qids, s, i = last
    q_ref_p = inputs.make_weights(ref_encoder.dual_encoder_specs(d),
                                  run.seed, dev, d["weights_std"])
    order = [texts[j] for j in np.asarray(qids)]
    q_ref = reference_queries(q_ref_p, d, order, t["max_query_len"], dev)
    del q_ref_p
    codes, scales = reference_store(run.seed, t["store"], d["dim"], dev)
    with torch.no_grad():
        best, _ = ref_search.exact_topk(q_ref, codes, scales, t["k"])
        out = numbers(q, s, i, q_ref, best, codes, scales)
    del codes, scales
    free_device()
    return out


def control(run) -> dict:
    """The reference in the port's place at the precision below bf16:
    the tower's products and the search's queries in fp8 (e4m3)."""
    t, dev = run.traffic, torch.device(run.device)
    d = dims(run.config)
    texts = query_texts(run.seed, t)
    p = inputs.make_weights(ref_encoder.dual_encoder_specs(d), run.seed, dev,
                            d["weights_std"])
    with torch.no_grad():
        q_ref = reference_queries(p, d, texts, t["max_query_len"], dev)
        q_ctl = reference_queries(p, d, texts, t["max_query_len"], dev,
                                  quant=ref_encoder.fp8_e4m3)
        del p
        codes, scales = reference_store(run.seed, t["store"], d["dim"], dev)
        best, _ = ref_search.exact_topk(q_ref, codes, scales, t["k"])
        q8 = torch.cat([ref_encoder.fp8_e4m3(r[None]) for r in q_ctl])
        s_ctl, i_ctl = ref_search.exact_topk(q8, codes, scales, t["k"])
        out = numbers(q_ctl, s_ctl, i_ctl, q_ref, best, codes, scales)
    del codes, scales
    free_device()
    return out
