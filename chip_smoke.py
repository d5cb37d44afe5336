#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (cldrd_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

Phases (each raises on any failure; the script then exits non-zero):

1. build: compile every kernel from cldrd_tpu_torch/csrc/ with nvcc
   (one process per source, all at once) and print the seconds.
2. kernels: each kernel against its plain PyTorch version on the card at
   the shapes the main path gives it (D=768; K1 at N=1,048,576 with
   B=128 and 512 and at the pipeline's N=32,768, k=100; K2 at the
   portable route's ragged batch; bf16, int8 with scales, and fp32
   stores). On integer-valued inputs every dot is exact, so outputs must
   be EQUAL, ties included; on normal data values agree within 1e-5 of
   the largest score and every emitted position scores its slot's value.
3. search: FlatIPIndex stood up on the device at MS MARCO scale
   (8,847,360 x 768 int8 with scales, then 1,048,576 x 768 bf16). K1 is
   first held to its plain version at the int8 store's own shape (EQUAL
   on integer-valued queries) and timed there. Then search_batched at
   B=512, k=1000 over 64 distinct batches per store for QPS, a sample
   checked against a torch exact oracle (full matmul + two-key sort), and
   integer-valued batches that must need no rescue and equal the oracle;
   and topk_binmax at a ragged batch, which takes the portable route.
4. pipeline: the CLIs index -> retrieve -> evaluate at DistilBERT-base
   width with random weights from --seed, the hash tokenizer, 32,768
   synthetic passages at --max-length 256 and 1,024 queries at 30.

Kernel launch counts are set to 0 just before phase 3's searches and read
just after phase 4; a kernel of the path with no launch there fails the
run. The second-to-last line is one JSON object with every kernel's
launches, error, times and bound; the line before it is the card's name
and power limit from nvidia-smi; the last line is the result object.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s of HBM3 and
# operations/s by operand type
PEAK_BYTES = 3.35e12
PEAK_OPS = {"bf16": 989e12, "fp32": 67e12}

D = 768
N_KERNEL = 1_048_576
N_FULL = 8_847_360   # MS MARCO passage collection, padded to 2048 rows
N_BF16 = 1_048_576
N_PIPELINE = 32_768  # passages of the pipeline phase
K = 1000
K_PIPELINE_EXTRACT = 100  # the pipeline's --topk that takes the extract route
SEARCH_BATCH = 512
TIMED_BATCHES = 64   # distinct query batches in each store's QPS window
INT_BATCHES = 4      # integer-valued batches per store (exactness, rescues)
ORACLE_SAMPLE = 32
RAGGED = 200         # a batch K1 does not take: the portable route
ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")


def log(*args):
    print(*args, flush=True)


def time_ms(fn, reps=3, warmup=1):
    """Mean milliseconds per call, CUDA events around ``reps`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes, ops, op_type):
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = ops / PEAK_OPS[op_type] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def op_type(q_dtype, c_dtype):
    if q_dtype == torch.bfloat16 and c_dtype in (torch.bfloat16, torch.int8):
        return "bf16"
    return "fp32"


def k1_bytes_ops(bz, n, d, c_dtype, q_dtype, rounds2, scaled):
    nsup = n // 2048
    nbytes = (n * d * torch.tensor([], dtype=c_dtype).element_size()
              + 4 * n + (4 * n if scaled else 0)
              + bz * d * torch.tensor([], dtype=q_dtype).element_size()
              + 2 * bz * nsup * rounds2 * 4 + bz * nsup * 4)
    return nbytes, 2 * bz * n * d


def k2_bytes_ops(bz, n, d, c_dtype, q_dtype, bin_rows, scaled):
    nbytes = (n * d * torch.tensor([], dtype=c_dtype).element_size()
              + 4 * n + (4 * n if scaled else 0)
              + bz * d * torch.tensor([], dtype=q_dtype).element_size()
              + bz * n * 4 + bz * (n // bin_rows) * 4)
    return nbytes, 2 * bz * n * d


def k1_rounds(bz, n, k):
    """(R, R2) that the extract route gives K1 at this shape."""
    from cldrd_tpu_torch.search import mips

    return (mips._extract_rounds(n, bz, k, 128),
            mips._super_rounds(n, n // 2048, bz, k))


class Store:
    """A generated corpus: codes [N, D], ids [N] (the last rows padding),
    optional scales [N]."""

    def __init__(self, n, d, c_dtype, dev, gen, integer, pad_rows=0):
        if c_dtype == torch.int8:
            self.c = torch.randint(-127, 128, (n, d), generator=gen,
                                   device=dev, dtype=torch.int8)
            self.scales = (torch.rand(n, generator=gen, device=dev) + 0.5) \
                / 127.0
        elif integer:
            self.c = torch.randint(-4, 5, (n, d), generator=gen, device=dev,
                                   dtype=torch.int8).to(c_dtype)
            self.scales = None
        else:
            self.c = torch.randn(n, d, generator=gen, device=dev).to(c_dtype)
            self.scales = None
        self.ids = torch.arange(n, dtype=torch.int32, device=dev)
        if pad_rows:
            self.ids[n - pad_rows:] = -1


def make_queries(bz, d, q_dtype, dev, gen, integer):
    if integer:
        return torch.randint(-4, 5, (bz, d), generator=gen, device=dev,
                             dtype=torch.int8).to(q_dtype)
    return torch.randn(bz, d, generator=gen, device=dev).to(q_dtype)


# ----------------------------------------------------- kernel vs plain


def _close(tag, got, ref, rtol=1e-5):
    """Same -inf pattern; finite values within ``rtol`` of the largest
    reference score. Returns the largest absolute difference."""
    fin = torch.isfinite(ref)
    if not torch.equal(fin, torch.isfinite(got)):
        raise AssertionError(f"{tag}: -inf pattern differs")
    if not bool(fin.any()):
        return 0.0
    err = (got[fin] - ref[fin]).abs().max().item()
    scale = ref[fin].abs().max().item()
    if err > rtol * scale:
        raise AssertionError(f"{tag}: max abs err {err:.3g} > {rtol} x "
                             f"{scale:.3g}")
    return err


def _check_k1(tag, q, c, ids, scales, got, ref, integer):
    """K1's (sup_v, sup_p, rem1) against the plain version's on the same
    inputs. Integer-valued inputs: EQUAL. Normal data (fp32 accumulation
    order differs): values and bounds within 1e-5 of the largest score,
    positions distinct in each super-block's finite slots, and wherever a
    position differs from the plain version's, the row it names scores
    that slot's value (a near-tie) within the same tolerance."""
    if integer:
        for name, a, b in zip(("sup_v", "sup_p", "rem1"), got, ref):
            if not torch.equal(a, b):
                bad = (a != b).sum().item()
                raise AssertionError(f"{tag}: {name} differs in {bad} "
                                     "places on integer-valued inputs")
        return 0.0
    gv, gp, gr = got
    rv, rp, rr = ref
    err = max(_close(f"{tag} sup_v", gv, rv), _close(f"{tag} rem1", gr, rr))
    fin = torch.isfinite(rv)
    tol = 1e-5 * rv[fin].abs().max().item()
    slot = torch.arange(rv.shape[-1], device=rv.device)
    keyed = torch.where(fin, gp.long(), -1 - slot)  # empty slots stay apart
    srt = keyed.sort(-1).values
    if bool((srt[..., 1:] == srt[..., :-1]).any()):
        raise AssertionError(f"{tag}: a position repeats in a super-block")
    mis = (fin & (gp != rp)).nonzero()
    for m0 in range(0, mis.shape[0], 1 << 16):
        b, s, r = mis[m0:m0 + (1 << 16)].unbind(1)
        rows = gp[b, s, r].long()
        true = (q[b].float() * c[rows].float()).sum(-1)
        if scales is not None:
            true = true * scales[rows]
        true = torch.where(ids[rows] >= 0, true, float("-inf"))
        off = (true - rv[b, s, r]).abs()
        if not bool((off <= tol).all()):
            raise AssertionError(f"{tag}: a differing position scores "
                                 f"{off.max().item():.3g} away from its "
                                 f"slot's value (tolerance {tol:.3g})")
    log(f"[kernels] {tag}: {mis.shape[0]} of {int(fin.sum())} positions "
        "differ from the plain version's, all at near-ties")
    return err


def _compare_k1_on(ctx, tag, q, c, ids, scales, k, integer):
    from cldrd_tpu_torch.ops.extract_topk import extract_topk, extract_topk_plain

    bz, n = q.shape[0], c.shape[0]
    R, R2 = k1_rounds(bz, n, k)
    tag = (f"K1 {tag} B={bz} N={n} {str(c.dtype)[6:]} k={k} R={R} R2={R2} "
           f"{'int' if integer else 'normal'}")
    got = extract_topk(q, c, ids, R, R2, 128, scales)
    ref = extract_topk_plain(q, c, ids, R, R2, 128, scales)
    err = _check_k1(tag, q, c, ids, scales, got, ref, integer)
    log(f"[kernels] {tag}: {'EQUAL' if integer else 'agrees'}, "
        f"max_abs_err {err:.3g}")
    ctx["k1_err"] = max(ctx.get("k1_err", 0.0), err)
    ctx.setdefault("k1_checked", []).append(tag)


def _compare_k1(ctx, bz, n, c_dtype, q_dtype, integer, k=K):
    dev, gen = ctx["dev"], ctx["gen"]
    st = Store(n, D, c_dtype, dev, gen, integer, pad_rows=1000)
    q = make_queries(bz, D, q_dtype, dev, gen, integer)
    _compare_k1_on(ctx, "gen", q, st.c, st.ids, st.scales, k, integer)


def _compare_k2_on(ctx, tag, q, c, ids, scales, bin_rows, integer):
    from cldrd_tpu_torch.ops.fused_binmax import fused_binmax, fused_binmax_plain

    tag = (f"K2 {tag} B={q.shape[0]} N={c.shape[0]} {str(c.dtype)[6:]} "
           f"bin={bin_rows} {'int' if integer else 'normal'}")
    got = fused_binmax(q, c, ids, bin_rows, scales)
    ref = fused_binmax_plain(q, c, ids, bin_rows, scales)
    if integer:
        for name, a, b in zip(("scores", "bmax"), got, ref):
            if not torch.equal(a, b):
                raise AssertionError(f"{tag}: {name} differs on "
                                     "integer-valued inputs")
        err = 0.0
    else:
        err = max(_close(f"{tag} {name}", a, b)
                  for name, a, b in zip(("scores", "bmax"), got, ref))
    log(f"[kernels] {tag}: {'EQUAL' if integer else 'agrees'}, "
        f"max_abs_err {err:.3g}")
    ctx["k2_err"] = max(ctx.get("k2_err", 0.0), err)


def _compare_k2(ctx, bz, n, c_dtype, q_dtype, integer, bin_rows=128):
    dev, gen = ctx["dev"], ctx["gen"]
    st = Store(n, D, c_dtype, dev, gen, integer, pad_rows=1000)
    q = make_queries(bz, D, q_dtype, dev, gen, integer)
    _compare_k2_on(ctx, "gen", q, st.c, st.ids, st.scales, bin_rows, integer)


# ------------------------------------------------------------------ phases


def phase_build(ctx):
    from cldrd_tpu_torch.ops import _build

    t0 = time.perf_counter()
    paths = _build.build_all()
    ctx["build_s"] = time.perf_counter() - t0
    for stem in paths:
        report = [l for l in _build.build_log(stem).splitlines()
                  if "registers" in l or "spill" in l or "error" in l]
        log(f"[build] {stem}: {_build.BUILD_SECONDS.get(stem, 0.0):.1f} s")
        for line in report:
            log(f"[build]   {line.strip()}")
    log(f"[build] all kernels: {ctx['build_s']:.1f} s")


def phase_kernels(ctx):
    dev, gen = ctx["dev"], ctx["gen"]
    n = N_KERNEL
    bf16, f32, i8 = torch.bfloat16, torch.float32, torch.int8
    # exactness on integer-valued inputs, ties included
    for bz in (128, SEARCH_BATCH):
        _compare_k1(ctx, bz, n, bf16, bf16, True)
        _compare_k1(ctx, bz, n, i8, bf16, True)
    _compare_k1(ctx, 128, n, f32, f32, True)
    # the pipeline's --topk 100 retrieve over its 32,768-row store
    _compare_k1(ctx, SEARCH_BATCH, N_PIPELINE, bf16, bf16, True,
                k=K_PIPELINE_EXTRACT)
    for bz in (128, RAGGED):
        _compare_k2(ctx, bz, n, bf16, bf16, True)
        _compare_k2(ctx, bz, n, i8, bf16, True)
    _compare_k2(ctx, RAGGED, n, f32, f32, True)
    _compare_k2(ctx, RAGGED, n, bf16, bf16, True, bin_rows=16)
    # normal data: values within 1e-5 relative, positions up to near-ties
    _compare_k1(ctx, 128, n, f32, f32, False)
    _compare_k1(ctx, SEARCH_BATCH, N_PIPELINE, bf16, bf16, False,
                k=K_PIPELINE_EXTRACT)
    _compare_k2(ctx, RAGGED, n, i8, bf16, False)

    # K1 and K2 held to their plain versions and timed at B=512, N=1M bf16
    # (K1 at the bf16 store's shape, K2 at the portable route's widest batch)
    st = Store(n, D, bf16, dev, gen, False)
    q = make_queries(SEARCH_BATCH, D, bf16, dev, gen, False)
    _time_kernels(ctx, "bf16_1M", q, st.c, st.ids, None, k2=True)
    del st, q


def _time_kernels(ctx, tag, q, c, ids, scales, k2=False):
    """At one shape, on normal data: kernel against plain version, then the
    kernel's, the plain version's and the bare bf16 torch.matmul score
    product's times; the results land in ctx["timings"][kernel][tag]."""
    from cldrd_tpu_torch.ops.extract_topk import extract_topk, extract_topk_plain
    from cldrd_tpu_torch.ops.fused_binmax import fused_binmax, fused_binmax_plain

    bz, n = q.shape[0], c.shape[0]
    R, R2 = k1_rounds(bz, n, K)
    _compare_k1_on(ctx, tag, q, c, ids, scales, K, integer=False)
    if k2:
        _compare_k2_on(ctx, tag, q, c, ids, scales, 128, integer=False)
    torch.cuda.empty_cache()
    qb = q.to(torch.bfloat16)
    if c.dtype == torch.bfloat16:
        t_mm = time_ms(lambda: torch.matmul(qb, c.T))
    else:  # the same product over a bf16 copy of the store
        cb = c.to(torch.bfloat16)
        t_mm = time_ms(lambda: torch.matmul(qb, cb.T))
        del cb
    torch.cuda.empty_cache()
    ot = op_type(q.dtype, c.dtype)
    rows = ctx.setdefault("timings", {})
    b1, o1 = k1_bytes_ops(bz, n, D, c.dtype, q.dtype, R2, scales is not None)
    rows.setdefault("extract_topk", {})[tag] = dict(
        ms=time_ms(lambda: extract_topk(q, c, ids, R, R2, 128, scales)),
        plain_ms=time_ms(lambda: extract_topk_plain(q, c, ids, R, R2, 128,
                                                    scales), reps=1),
        bound=bound_ms(b1, o1, ot), matmul_ms=t_mm, B=bz, N=n, R=R, R2=R2)
    if k2:
        b2, o2 = k2_bytes_ops(bz, n, D, c.dtype, q.dtype, 128,
                              scales is not None)
        rows.setdefault("fused_binmax", {})[tag] = dict(
            ms=time_ms(lambda: fused_binmax(q, c, ids, 128, scales)),
            plain_ms=time_ms(lambda: fused_binmax_plain(q, c, ids, 128,
                                                        scales), reps=1),
            bound=bound_ms(b2, o2, ot), matmul_ms=t_mm, B=bz, N=n)
    for kernel in ("extract_topk", "fused_binmax"):
        r = rows.get(kernel, {}).get(tag)
        if r:
            log(f"[time] {kernel} {tag} B={bz} N={n}: kernel {r['ms']:.3f} ms,"
                f" plain {r['plain_ms']:.3f} ms, bound {r['bound'][0]:.3f} ms"
                f" ({r['bound'][1]}), torch.matmul bf16 {t_mm:.3f} ms")


def _oracle(index, q_np, k):
    """Exact top-k by full matmul + one stable descending sort over row
    positions (equal scores keep the lower position): the same two keys
    as the search, computed independently of it."""
    dev = index.device
    q = torch.from_numpy(q_np).to(dev).to(index._query_dtype).float()
    n = index.embeddings.shape[0]
    s = torch.empty((q.shape[0], n), dtype=torch.float32, device=dev)
    step = 1 << 20
    for r0 in range(0, n, step):
        c = index.embeddings[r0:r0 + step].float()
        blk = q @ c.T
        if index.row_scales is not None:
            blk = blk * index.row_scales[r0:r0 + step][None, :]
        s[:, r0:r0 + step] = torch.where(
            index.row_ids[None, r0:r0 + step] >= 0, blk, float("-inf"))
        del c, blk
    v, pos = torch.sort(s, dim=1, descending=True, stable=True)
    v, pos = v[:, :k].cpu().numpy(), pos[:, :k].cpu().numpy()
    del s
    ids = index.row_ids.cpu().numpy()[pos]
    return v, np.where(np.isfinite(v), ids, -1)


def _check_exact(tag, got_v, got_i, ref_v, ref_i):
    if not (np.array_equal(got_i, ref_i) and np.array_equal(got_v, ref_v)):
        bad = int((got_i != ref_i).any(axis=1).sum())
        raise AssertionError(f"{tag}: {bad} sampled queries differ from "
                             "the exact oracle")


def _check_close(tag, got_v, got_i, ref_v, ref_i, rtol=1e-5):
    np.testing.assert_allclose(got_v, ref_v, rtol=rtol, err_msg=tag)
    for r in range(len(ref_v)):
        vk = ref_v[r, -1]
        margin = rtol * abs(vk)
        a = set(got_i[r][got_v[r] > vk + margin])
        b = set(ref_i[r][ref_v[r] > vk + margin])
        if a != b:
            raise AssertionError(f"{tag}: query {r} top-k ids differ away "
                                 "from ties")


def _sample(nq):
    return np.arange(0, nq, max(1, nq // ORACLE_SAMPLE))


def _search_store(ctx, tag, index, q_normal, q_int):
    """search_batched at B=512, k=1000: QPS and the rescued share over
    TIMED_BATCHES distinct batches of normal queries, a sample of which
    must agree with the oracle within 1e-5 (equal id sets away from
    ties); then integer-valued batches (exact scores), which must need no
    rescue and whose sample must equal the oracle."""
    bz = SEARCH_BATCH
    index.search_batched(q_normal[:bz], K, batch_size=bz)  # warm-up
    r0 = index.rescued_queries
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s, i = index.search_batched(q_normal, K, batch_size=bz)
    elapsed = time.perf_counter() - t0
    nq = len(q_normal)
    res = dict(queries=nq, batches=nq // bz, seconds=elapsed,
               qps=nq / elapsed,
               rescued_share=(index.rescued_queries - r0) / nq)
    sample = _sample(nq)
    ref_v, ref_i = _oracle(index, q_normal[sample], K)
    _check_close(f"{tag} normal", s[sample], i[sample], ref_v, ref_i)
    r1 = index.rescued_queries
    si, ii = index.search_batched(q_int, K, batch_size=bz)
    rescued_int = index.rescued_queries - r1
    if rescued_int:
        raise AssertionError(f"{tag}: {rescued_int} of {len(q_int)} "
                             "integer-valued queries failed the certificate "
                             "and were re-scanned")
    sample = _sample(len(q_int))
    ref_v, ref_i = _oracle(index, q_int[sample], K)
    _check_exact(f"{tag} integer", si[sample], ii[sample], ref_v, ref_i)
    res["exact_sampled"] = int(len(sample))
    res["integer_queries_rescued"] = rescued_int
    ctx.setdefault("search", {})[tag] = res
    log(f"[search] {tag}: {nq} queries ({nq // bz} batches) in "
        f"{elapsed:.3f} s = {res['qps']:.1f} QPS (B={bz}, k={K}), rescued "
        f"share {res['rescued_share']:.4f}; {len(q_int)} integer-valued "
        f"queries, none rescued, {len(sample)} sampled equal the exact "
        "oracle")


def prepare_search(ctx):
    """MS MARCO-scale stores generated on the device; K1 held to its plain
    version and timed at the int8 store's shape (before the counted
    window)."""
    from cldrd_tpu_torch.index import FlatIPIndex

    dev, gen = ctx["dev"], ctx["gen"]
    codes = torch.randint(-127, 128, (N_FULL, D), generator=gen, device=dev,
                          dtype=torch.int8)
    scales = (torch.rand(N_FULL, generator=gen, device=dev) + 0.5) / 127
    ids = torch.arange(N_FULL, dtype=torch.int32, device=dev)
    s_int8 = FlatIPIndex.from_tensors(codes, ids, scales)
    c_bf16 = (torch.randint(-32, 33, (N_BF16, D), generator=gen, device=dev,
                            dtype=torch.int8).to(torch.bfloat16) / 16)
    s_bf16 = FlatIPIndex.from_tensors(
        c_bf16, torch.arange(N_BF16, dtype=torch.int32, device=dev))
    # the int8 store's search shape (reduced mode, R=5 and R2=8): EQUAL
    # on integer-valued queries, then agreement and times on normal ones
    q = make_queries(SEARCH_BATCH, D, torch.bfloat16, dev, gen, True)
    _compare_k1_on(ctx, "int8_full", q, codes, ids, scales, K, integer=True)
    q = make_queries(SEARCH_BATCH, D, torch.bfloat16, dev, gen, False)
    _time_kernels(ctx, "int8_full", q, codes, ids, scales)
    _time_search_layer(ctx, "int8_full", s_int8, q)
    _time_search_layer(ctx, "bf16_1M", s_bf16, q)
    return s_int8, s_bf16


def _time_search_layer(ctx, tag, index, q):
    """Device ms of one topk_binmax call as FlatIPIndex makes it (K1,
    selection and certificate; no host fetch): with the kernel's own time
    it splits a search batch into kernel, selection and host shares."""
    from cldrd_tpu_torch.search import mips

    q = q.to(index._query_dtype)
    ms = time_ms(lambda: mips.topk_binmax(
        q, index.embeddings, index.row_ids, K, return_positions=True,
        on_miss="flag", row_scales=index.row_scales))
    ctx.setdefault("search_layer_ms", {})[tag] = ms
    log(f"[time] topk_binmax {tag} B={q.shape[0]} k={K}: {ms:.3f} ms on the "
        "device")


def phase_search(ctx, store_int8, store_bf16):
    from cldrd_tpu_torch.ops import extract_topk as k1_mod
    from cldrd_tpu_torch.search import mips

    rng = np.random.default_rng(ctx["seed"])
    q_normal = rng.standard_normal(
        (SEARCH_BATCH * TIMED_BATCHES, D)).astype(np.float32)
    q_int = rng.integers(-8, 9, (SEARCH_BATCH * INT_BATCHES, D)).astype(
        np.float32)
    _search_store(ctx, "int8", store_int8, q_normal, q_int)
    _search_store(ctx, "bf16", store_bf16, q_normal, q_int)
    # a ragged batch takes topk_binmax's portable route (fused scores +
    # bin max per segment); certified rows must equal the oracle
    dev = store_bf16.device
    v, p, ok = mips.topk_binmax(
        torch.from_numpy(q_int[:RAGGED]).to(dev, torch.bfloat16),
        store_bf16.embeddings, store_bf16.row_ids, K, on_miss="flag")
    ok = ok.cpu().numpy()
    ref_v, ref_i = _oracle(store_bf16, q_int[:RAGGED], K)
    _check_exact("bf16 ragged portable", v.cpu().numpy()[ok],
                 p.cpu().numpy()[ok], ref_v[ok], ref_i[ok])
    log(f"[search] portable route B={RAGGED}: {ok.mean():.4f} certified, all "
        "certified rows equal the oracle")
    if k1_mod.LAUNCHES <= 0:
        raise AssertionError("search ran without an extract_topk launch")
    log(f"[search] extract_topk.LAUNCHES = {k1_mod.LAUNCHES} > 0")


def _write_corpus(work, n_pass, n_q, seed):
    """Synthetic MS MARCO-shaped TSVs: ~56-word passages over a 30k-word
    vocabulary; each query is 6 words of its one relevant passage."""
    rng = np.random.default_rng(seed)
    words = np.array([f"w{i}" for i in range(30_000)])
    lens = rng.integers(30, 82, n_pass)
    paths = {k: os.path.join(work, f"{k}.tsv")
             for k in ("collection", "queries", "qrels")}
    passages = []
    with open(paths["collection"], "w") as f:
        for pid in range(n_pass):
            text = " ".join(words[rng.integers(0, len(words), lens[pid])])
            passages.append(text.split())
            f.write(f"{pid}\t{text}\n")
    rel = rng.choice(n_pass, n_q, replace=False)
    with open(paths["queries"], "w") as fq, open(paths["qrels"], "w") as fr:
        for qid in range(n_q):
            toks = passages[rel[qid]]
            pick = rng.choice(len(toks), 6, replace=False)
            fq.write(f"{qid}\t{' '.join(toks[j] for j in sorted(pick))}\n")
            fr.write(f"{qid}\t0\t{rel[qid]}\t1\n")
    return paths


def _call_cli(main_fn, argv):
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = main_fn(argv)
    if rc != 0:
        raise AssertionError(f"CLI {argv[:2]} exited {rc}")
    lines = buf.getvalue().strip().splitlines()
    return lines, time.perf_counter() - t0


def _check_run_file(path, n_q, k, n_pass):
    by_q = {}
    with open(path) as f:
        for line in f:
            qid, pid, rank, score = line.rstrip("\n").split("\t")
            by_q.setdefault(int(qid), []).append((int(rank), int(pid),
                                                   float(score)))
    if sorted(by_q) != list(range(n_q)):
        raise AssertionError(f"{path}: {len(by_q)} of {n_q} queries ranked")
    for qid, rows in by_q.items():
        ranks = [r for r, _, _ in rows]
        scores = [s for _, _, s in rows]
        pids = [p for _, p, _ in rows]
        if ranks != list(range(1, k + 1)):
            raise AssertionError(f"{path}: query {qid} ranks malformed")
        if any(a < b for a, b in zip(scores, scores[1:])):
            raise AssertionError(f"{path}: query {qid} scores not descending")
        if len(set(pids)) != k or min(pids) < 0 or max(pids) >= n_pass:
            raise AssertionError(f"{path}: query {qid} pids malformed")


def phase_pipeline(ctx):
    from cldrd_tpu_torch.cli import evaluate as cli_evaluate
    from cldrd_tpu_torch.cli import index as cli_index
    from cldrd_tpu_torch.cli import retrieve as cli_retrieve
    from cldrd_tpu_torch.models import DistilBertConfig, NwayDualEncoder
    from cldrd_tpu_torch.ops import extract_topk as k1_mod

    work = os.path.join(WORK, "pipeline")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    n_pass, n_q = N_PIPELINE, 1024
    paths = _write_corpus(work, n_pass, n_q, ctx["seed"])
    model = NwayDualEncoder(DistilBertConfig()).reset_parameters(
        seed=ctx["seed"])
    ckpt = os.path.join(work, "model.pth.tar")
    torch.save({"state_dict": model.state_dict()}, ckpt)
    del model
    common = ["--checkpoint", ckpt, "--tokenizer", "hash", "--device", "cuda"]
    idx = os.path.join(work, "index")
    lines, t_index = _call_cli(cli_index.main, [
        "--collection", paths["collection"], "--out", idx,
        "--max-length", "256", "--batch-size", "512", *common])
    enc = json.loads(lines[-1])
    log(f"[pipeline] index: {n_pass} passages at DistilBERT-base width: "
        f"encode {enc['passages_per_s']:.1f} passages/s "
        f"({enc['encode_s']:.3f} s, host tokenization included), "
        f"{t_index:.1f} s for the whole CLI")
    results = {"index_s": t_index, **enc}
    for hbm, k in (("bfloat16", K), ("int8", K),
                   ("bfloat16", K_PIPELINE_EXTRACT)):
        run = os.path.join(work, f"run_{hbm}_{k}.tsv")
        k1_before = k1_mod.LAUNCHES
        lines, t_ret = _call_cli(cli_retrieve.main, [
            "--index", idx, "--queries", paths["queries"], "--run", run,
            "--topk", str(k), "--max-length", "30",
            "--search-batch-size", str(SEARCH_BATCH), "--hbm-dtype", hbm,
            *common])
        stats = json.loads(lines[-1])
        _check_run_file(run, n_q, k, n_pass)
        metrics = json.loads("\n".join(_call_cli(cli_evaluate.main, [
            "--qrels", paths["qrels"], "--run", run])[0]))
        want = {"MRR@10", "MRR@1000", "Recall@50", "Recall@1000", "nDCG@10",
                "nDCG@100", "MAP@1000", "QueriesRanked"}
        if not want <= set(metrics) or metrics["QueriesRanked"] != n_q:
            raise AssertionError(f"metric dict malformed: {sorted(metrics)}")
        launches = k1_mod.LAUNCHES - k1_before
        results[f"{hbm}_k{k}"] = dict(retrieve_s=t_ret, **stats,
                                      extract_topk_launches=launches,
                                      mrr10=metrics["MRR@10"])
        log(f"[pipeline] retrieve hbm={hbm} k={k}: {t_ret:.1f} s end to end, "
            f"search {stats['qps']:.1f} QPS, rescued "
            f"{stats['rescued_queries']}, extract_topk launches {launches}; "
            f"evaluate MRR@10={metrics['MRR@10']:.4f} "
            f"Recall@1000={metrics['Recall@1000']:.4f}")
    if results[f"bfloat16_k{K_PIPELINE_EXTRACT}"]["extract_topk_launches"] <= 0:
        raise AssertionError("pipeline retrieve launched no extract_topk")
    ctx["pipeline"] = results
    shutil.rmtree(work, ignore_errors=True)


def smi_line():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
            else f"nvidia-smi: {out.stderr.strip()}"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def _kernel_record(ctx, name, src, ref, tag, launches):
    t = ctx["timings"][name][tag]
    return {
        "name": name, "route": "cuda", "source": src, "replaces": ref,
        "launches": launches,
        "max_abs_err": ctx["k1_err" if name == "extract_topk" else "k2_err"],
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound"][0],
        "bound_by": t["bound"][1], "library_ms": None,
        "matmul_ms": t["matmul_ms"], "shape": tag,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    if not torch.cuda.is_available():
        log("chip_smoke: CUDA is not available")
        return 2
    dev = torch.device("cuda", 0)
    from cldrd_tpu_torch.ops import extract_topk as k1_mod
    from cldrd_tpu_torch.ops import fused_binmax as k2_mod

    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    ctx = {"dev": dev, "gen": gen, "seed": args.seed}
    log(f"device: {torch.cuda.get_device_name(0)}; torch "
        f"{torch.__version__}; cuda {torch.version.cuda}")
    t_all = time.perf_counter()

    def run(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(ctx, *a)
        torch.cuda.synchronize()
        log(f"[{name}] phase done in {time.perf_counter() - t0:.1f} s")
        return out

    run("build", phase_build)
    run("kernels", phase_kernels)
    stores = run("prepare", prepare_search)
    # the counted window: every kernel launch of the main path
    k1_mod.LAUNCHES = 0
    k2_mod.LAUNCHES = 0
    run("search", phase_search, *stores)
    del stores
    torch.cuda.empty_cache()
    run("pipeline", phase_pipeline)
    launches = {"extract_topk": k1_mod.LAUNCHES,
                "fused_binmax": k2_mod.LAUNCHES}
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"main path launched no {missing}")
    log(f"[main path] kernel launches: {launches}")
    log(f"total {time.perf_counter() - t_all:.1f} s")
    # every measurement of the run, unrounded, on one line
    log("results " + json.dumps({
        k: ctx.get(k) for k in ("timings", "search_layer_ms", "search",
                                "pipeline", "k1_err", "k2_err", "k1_checked",
                                "build_s")}))
    log(smi_line())
    log(json.dumps({"kernels": [
        _kernel_record(ctx, "extract_topk",
                       "cldrd_tpu_torch/csrc/extract_topk.cu",
                       "cldrd_tpu/search/mips.py:605", "int8_full",
                       launches["extract_topk"]),
        _kernel_record(ctx, "fused_binmax",
                       "cldrd_tpu_torch/csrc/fused_binmax.cu",
                       "cldrd_tpu/search/mips.py:361", "bf16_1M",
                       launches["fused_binmax"]),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
