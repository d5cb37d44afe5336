#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (cldrd_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

Phases (each raises on any failure; the script then exits non-zero):

1. build: compile every kernel from cldrd_tpu_torch/csrc/ with nvcc
   (one process per source, all at once) and print the seconds; read
   every library's SASS and fail if an instruction writes a wgmma's
   register-A operand or touches its accumulators before the wait that
   retires it (cldrd_tpu_torch/ops/_wgmma_check.py; HGMMA and, for K7's
   int8 x int8 variant, IGMMA, which int8_dot_sm90 must hold).
2. kernels: each kernel against its plain PyTorch version on the card at
   the shapes the main path gives it. K1/K2 (D=768; K1 at N=1,048,576
   with B=128 and 512, at the pipeline's N=32,768, k=100, and at bin
   sizes 32, 64 and 256; K2 at the portable route's ragged batch, at
   B=2048 over the 1,769,472-row segment a wide search_batched gives it,
   at every bin size 8-128 with a partial last row tile, and with an
   all-zero query; bf16, int8 with scales, and fp32 stores): on
   integer-valued inputs every dot is exact, so outputs must be EQUAL,
   ties included (K2's bit for bit: a zero sum is +0); on normal data
   values agree within 1e-5 of the largest score and every emitted
   position scores its slot's value. K3/K4/K5 (H=12, D=64; the passage
   tower's B=240, L=256, the query tower's B=8, L=30, packed rows with
   segments, the query encode's B=512, L=30; dropout 0.1, one seed; and
   bf16 rows of 512, which keep the tiled kernels of attention.cu):
   outputs and dq/dk/dv within 1e-5 of the largest magnitude in fp32 and
   2e-2 in bf16. At the passage, query and packed shapes, with the main
   path's padding, the bf16 route of K3/K4 (attention_sm90.cu) is also
   held EQUAL to the plain versions for out, dv, dq and dk on inputs
   where every value is exact in bf16 (every score of a row equal, one-hot
   v, small-integer g: one wrong dropout bit, row sum or dS element
   fails), and its dq and dk within a per-element bound (one bf16 ulp
   per dS term, fp32 sums in another order) on normal data and on the
   model's own train-attention calls of one flat step at full width;
   two launches must give the same bits.
   K6 at the full-corpus serving store (8,388,608 x 768
   int8 with scales, slot 2,048) with B=8 and B=128, P=32, at 1,048,576
   bf16 rows with B=8, and with duplicate probes: EQUAL on
   integer-valued inputs, within 1e-5 on normal data. Each kernel is
   timed against its plain version, its bound and, for attention,
   scaled_dot_product_attention (K6: a gather + bf16 bmm, no one call);
   K3/K4 at the passage shape and at the packed one (64 rows of 256 with
   segments), beside the tiled kernels of attention.cu on the same
   inputs. K1 takes extract_topk_sm90.cu for bf16 queries against bf16
   and int8 stores at bin 128 (B=64, 128, 512 held EQUAL; at B=512 ten
   launches, each EQUAL) and
   extract_topk.cu for fp32 and the other bins; it is timed beside
   extract_topk.cu forced on the same inputs and beside a bare bf16
   torch.matmul over the store. K2 takes fused_binmax_sm90.cu for bf16
   queries against bf16 and int8 stores (fused_binmax.cu for fp32) and
   is timed at B=512 over 1M bf16 rows and at B=2048 over the int8
   store's first 1,769,472 rows (scales) beside fused_binmax.cu forced on
   the same inputs, its plain version and a bare bf16 torch.matmul. K5
   takes attention_infer.cu at the query encode (B=512, L=30) and
   attention_infer_d64.cu at B=240, L=256, each held to its plain
   version with the query tower's padding and with a mask that has
   holes (EQUAL on exact inputs); the first is timed beside
   attention.cu's tiled forward forced on the same inputs, the second
   beside the sm90 forward at p=0 forced (its earlier route), at
   B=240, L=256 and at the flat index build's 512x256 with its passage
   padding (32-86 real keys of 256), each also beside SDPA. K7 (the
   int8 A/B of examples/bench_int8_dot.py: each 1,024-row store tile's
   maximum score for each query; csrc/int8_dot_sm90.cu in its bf16,
   int8_cast and int8_native variants) at N=16,384, tile 128, B=128 and
   at the A/B's N=1,114,112, tile 1,024, B=512: EQUAL its plain version
   on integer-valued inputs in [-127, 127], within 1e-5 relative on a
   normal draw; then the A/B: each variant's device time beside its
   bound, its plain version and the bare product (bf16 torch.matmul;
   torch._int_mm for int8 x int8), a line of the script's own fields a
   variant and one of int8_native's speedups. No path of the port
   launches K7: its launches in the kernels line are the A/B's. K5
   at the MiniLM-L6 teacher's shape (B=128, L=256, H=12, D=32, bf16,
   pairs of 39-90 real tokens) takes attention_infer_d32.cu: within
   2e-2 of its plain version on normal data, EQUAL on exact inputs (two
   forms) with pair padding, with one all-masked batch row and with a
   mask that has holes; timed beside attention.cu's tiled forward forced
   on the same inputs (its earlier route), the plain version, its
   bound and SDPA, with the blocks an SM holds. K5 at every shape of
   the length buckets' ladder (passages at batch 512, L 256: 4096x32,
   2048x64 on attention_infer.cu, 1024x128, 512x256 on
   attention_infer_d64.cu; the teacher at batch 128: 1024x32 to 128x256
   on attention_infer_d32.cu), with a bucket's padding, one row and the
   last eighth of the batch all masked: within 2e-2 of its plain
   version, EQUAL on exact inputs (attention_infer_d64.cu also with a
   mask that has holes), timed beside its bound and SDPA, and
   attention_infer_d64.cu beside the sm90 forward forced. The fused
   dropout -> residual add -> LayerNorm (residual_norm.cu) at the
   passage tower's training sites (61,440 x 768 bf16, dropout 0.1,
   forward and backward) and the teacher's (32,768 x 384, no gradient):
   within one bf16 ulp plus what the row sums' order moves of its plain
   version (ops/residual_norm.py::compare_to_plain), timed beside the
   plain chain, the chain with F.layer_norm and the bytes it must move.
   Every time in the kernels line is a device time: the summed
   durations of the kernels one call launches
   (torch.profiler; a trace whose kernel counts show lost records is
   taken again).
3. search: FlatIPIndex stood up on the device at MS MARCO scale
   (8,847,360 x 768 int8 with scales, then 1,048,576 x 768 bf16). K1 is
   first held to its plain version at the int8 store's own shape (EQUAL
   on integer-valued queries, ten launches) and timed there. Then search_batched at
   B=512, k=1000 over 64 distinct batches per store for QPS, a sample
   checked against a torch exact oracle (full matmul + two-key sort), and
   integer-valued batches that must need no rescue and equal the oracle;
   topk_binmax at a ragged batch, which takes the portable route; and
   search_batched at batch_size=2048 over the int8 store (the portable
   route: K2 on 5 segments a batch), 4 timed batches for QPS with a
   sample against the oracle, and an integer-valued batch whose sample
   must equal it. One wide topk_binmax call is traced beforehand and its
   device time split into K2's and the rest's.
4. train: at DistilBERT-base width from random weights (--seed), the hash
   tokenizer, 32,768 synthetic passages and label-mode 8/9/10 training
   files: cli.curriculum runs three iterations (bz 8, nway 30, Lq 30,
   Lp 256, bf16, dropout 0.1, lambda_mrr, separate towers, flat layout,
   4 steps each; after each iteration its evaluation hook builds a
   length-bucketed index of the 32,768 passages on the card, K5
   through the kernels, and retrieves the 1,024 queries at k=100 (K1):
   three builds, none alive after its iteration, three finite rows of
   curriculum_eval.tsv), cli.train runs 8 steps with --pack-passages,
   and a resume from its step-4 checkpoint must reproduce step 5's
   loss. Every
   loss and grad norm must be finite; K3 must launch in every
   non-final block of both towers at every step, each K3/K4 launch
   through attention_sm90.cu. Prints ms per step and
   examples/s, flat and packed.
5. pipeline: the CLIs index -> retrieve -> evaluate with the trained
   checkpoint over the train phase's 32,768 passages at --max-length 256
   and 1,024 queries at 30; the index and retrieve calls encode with
   --attention-impl pallas (K5); the index call also builds an IVF
   companion (--ivf-nlist 16). Then cli.index --bucket-lengths with
   live tokenization, and with --token-cache twice (the first call
   writes the cache, the second reads it): passages/s of each beside
   the flat call's; each store holds the flat store's ids with rows
   within BUCKET_EMB_TOL of its rows' spread (the encoder with the mask
   ignored must miss it), the cache's two stores EQUAL; retrieve and
   evaluate through the bucketed store. build_index_on_device from the
   cache (bf16 and int8, flat and bucketed) must EQUAL FlatIPIndex.build
   over encode_dataset of the same batches (rows, scales, ids, k=100
   searches), and reconstruct the CLI's flat store rounded to bf16 or
   quantized. range_search over a 1,048,576 x 768 int8 store at two
   depths (K1 at k=1024 and 2048) must EQUAL an exact oracle. Every TSV
   and JSONL parse of the path must take the native parsers. The bf16
   k=100 retrieve runs again with --profile-dir (utils/profiling.py's
   trace around the search alone), in a process of its own as a user
   runs it (its launches join the window): its run file must EQUAL the
   untraced one's, the trace's K1 and K2 kernel events must equal the
   call's launch counts (K1's > 0), and no attention kernel may be in
   it (the query encode's K5 lies outside the window); traced and
   untraced QPS and the trace's size are logged.
6. teacher: a MiniLM-L6 cross-encoder (BertConfig.minilm_l6: 6 x 384,
   12 heads) with random weights from --seed, written as an HF
   BertForSequenceClassification state_dict. cli.retrieve_queries encodes
   the 32,768 passages (K5 through attention_infer_d64.cu) and searches an
   index of the 1,024 queries; cli.create_training_data --teacher-arch
   bert scores the first 512 queries x their top 100 of the pipeline's
   run (51,200 pairs, bf16, B=128, L=256, --attention-impl pallas) and
   writes the four curriculum files: 5 K5 launches a batch, every one
   through attention_infer_d32.cu (none through the tiled forward), every
   score finite, the first 256 pairs within 0.2 of the spread of the
   same model's scores with attention_plain, which the same model with
   the mask ignored must miss (the check's power). One score call is
   traced (torch.profiler) and its device time split by kernel class
   beside its wall time. cli.rerank_eval runs --mode cross with the
   teacher and --mode dual with the trained checkpoint over the same
   candidates. create_training_data and rerank_eval run again with
   --bucket-lengths: the same pairs, the sample within the same
   tolerance, K5 launches counted by bucket shape, pairs/s beside the
   flat run's. cli.export writes both formats,
   and each indexes 4,096 passages EQUAL to the trained checkpoint.
   Prints the teacher's pairs/s and the phase's seconds.
7. serve: a clustered 1,048,576 x 768 int8 store (from --seed, with a
   generator of its own, so earlier phases do not change it) gets an
   IVF companion from cli.index --ivf-only (512 cells, slot 2,048, nprobe
   32), and cli.serve --ivf --hbm-dtype int8 serves it with the trained
   checkpoint: 8 client threads send a burst of 64 /search requests of 1-8
   queries at k=1000, then a timed window of 2,048 such requests. Every
   answer must EQUAL IVFIndex.search of the same query embeddings (ids
   and scores), and each of those searches must launch K6 once; at full
   probe answers agree with the exact oracle, and integer-valued queries
   EQUAL it. Prints recall@10 at nprobe 32 against the oracle (for the
   served queries, beside their mean pairwise cosine, and for queries
   drawn from the store's own distribution), the window's QPS and
   p50/p99 over all its requests, requests against device batches and
   one pass's time by stage; runs
   /add, /remove, /save and /reload once each. A flat-mode daemon (K1)
   and an IVFPQ (96 x 4-bit) daemon with --refine-factor 4 each answer a
   few requests, EQUAL to their direct search. A flat daemon over the
   pipeline's index with the teacher resident (--reranker bert) answers
   /search at rerank_k=100, k=10 and /rerank requests, each EQUAL in ids
   and scores to the teacher scored directly on the same pairs at the
   daemon's batch shape.

8. multi: the multi-device paths and the encoder's options, over every
   visible GPU (with one, every sharded path runs on two shards of
   cuda:0, logged). The 8,847,360 x 768 int8 store in shards EQUALs the
   one-device index on integer-valued queries (B=512, k=1000; one K1
   launch a shard a batch), QPS of both beside each other; the portable
   route on the sharded store (a ragged batch, one
   search_batched(batch_size=2048) batch) EQUALs too, K2 per shard. The
   serve phase's int8 IVF store in shards EQUALs the one-device search at
   nprobe 32 and at full probe (one K6 launch a shard a search), and a
   cli.serve --ivf --shards 0 daemon answers a burst, each answer EQUAL
   to its direct search. build_index_on_device(mesh=) from the
   pipeline's token caches (bf16, int8, flat, bucketed) EQUALs the
   one-device build at a device's share of the batch, by id; cli.index
   --devices 0 and cli.retrieve --shards 0 --profile-dir (a process of
   its own) write the pipeline's run file byte for byte, and the one
   trace holds kernels of every visible device and as many K1/K2 events
   as the call launched (none: k=1000 over 32,768 rows streams). Four
   flat train steps on a torch.distributed group of
   spawned ranks (NCCL, one a GPU; with one GPU, two gloo ranks share
   cuda:0), in three jobs: bf16 at dropout 0.1 (K3/K4 on every rank),
   bf16 at dropout 0 and fp32 with the einsum attention at dropout 0. The
   ranks' losses EQUAL each other's, and are held to one process from the
   same seed: fp32 within 1e-4 (reduction order), bf16 at dropout 0
   within 3e-2 (rounding), and both bf16 jobs within 1e-3 of one process
   that draws the ranks' masks (each rank draws its own; the plain one
   process's distance at dropout 0.1 is printed beside the spread of its
   losses over other dropout streams); ms a step of each. With one GPU a
   one-rank NCCL group in process gives one process's losses, EQUAL.
   One flat step with remat
   off, 'full' and 'dots' (dropout 0.1): ms, peak memory and K3 launches
   a step (doubled under remat), the loss EQUAL and the grads within
   1e-3 (relative L2); one full-remat step at bz 32 x nway 30 (960
   passages of 256) prints its peak memory. The 32,768 passages encoded
   with fused_qkv (K5) and softmax_in_compute_dtype (einsum attention)
   keep every row's cosine to the default store at 0.999 or more, with
   passages/s beside the default's.

Phases 3-8 drive the port's six paths (search, train, pipeline,
teacher, serve, multi). Kernel launch counts are set to 0 just before each and
read just after it: a kernel its path must reach with no launch there
fails the run, every K1 and K2 launch of a window must have gone through
the Hopper entry points (extract_topk_sm90_launch,
fused_binmax_sm90_launch), and every K5 launch through those its path
names (K5_ENTRIES: attn_infer_short_launch and attn_infer_d64_launch
on the train, pipeline and multi paths, attn_infer_d32_launch too on
the teacher and serve paths; the sm90 forward's and the tiled forward's
K5 counts are read and must stay 0); every path but search must launch
the fused LayerNorm's forward, and the train and multi paths its
backward; K5 is also counted by (entry point, B, L)
(ops/attention.py::SHAPE_LAUNCHES). The kernels line sums the six
windows, K5's launches by shape included; K7, on no path, adds the
window of the kernels phase's A/B (its timed calls). The serve phase checks
its answers through the same kernels, so its window is the sum of spans
that each hold only the path's own work (the index CLI, the daemons'
start-up and the requests they answer), counted the same way.
With --data-parallel OUT_JSON the script builds the kernels and runs
only the multi phase's data-parallel check, over every visible GPU (the
check a several-GPU machine adds; its launches are counted apart).
With --compare-routes OUT_JSON the script builds the kernels and runs
only phase_routes: the train phase's curriculum through each
train-attention route (sm90, tiled, plain) from one seed, to show
whether the route changes training (gradients, losses, the trained query
tower's spread and recall) and to time the two kernel routes' train
steps alternately in one process.

The second-to-last line is one JSON object with every kernel's launches,
error, times and bound; the line before it is the card's name and power
limit from nvidia-smi; the last line is the result object.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import io
import json
import os
import re
import shutil
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
import weakref

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s of HBM3 and
# operations/s by operand type
PEAK_BYTES = 3.35e12
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "fp32": 67e12}

D = 768
N_KERNEL = 1_048_576
N_FULL = 8_847_360   # MS MARCO passage collection, padded to 2048 rows
N_BF16 = 1_048_576
N_PIPELINE = 32_768  # passages of the pipeline phase
N_QUERIES = 1024     # queries of the pipeline phase
N_BINS = 262_144     # K1 at bin sizes other than 128
HEADS, HEAD_DIM, N_LAYERS = 12, 64, 6  # DistilBERT-base
TRAIN_BZ, NWAY, TRAIN_LQ, TRAIN_LP = 8, 30, 30, 256  # the train phase's shape
TRAIN_EXAMPLES = 32  # per curriculum iteration: 4 steps at batch 8
ATTN_P, ATTN_SEED = 0.1, 20240611
RESUME_STEP = 4      # the packed run's mid-run checkpoint (of 8 steps)
K = 1000
K_PIPELINE_EXTRACT = 100  # the pipeline's --topk that takes the extract route
SEARCH_BATCH = 512
TIMED_BATCHES = 64   # distinct query batches in each store's QPS window
INT_BATCHES = 4      # integer-valued batches per store (exactness, rescues)
ORACLE_SAMPLE = 32
RAGGED = 200         # a batch K1 does not take: the portable route
WIDE_BATCH = 2048    # search_batched(batch_size=2048): the portable route
WIDE_BATCHES = 4     # wide batches in the search phase's window
N_WIDE_SEGMENT = 1_769_472  # the segment topk_binmax cuts 8.8M rows into
K1_EQUAL_LAUNCHES = 10  # K1 launches held EQUAL at each main-path shape
IVF_NB, IVF_SLOT, IVF_P = 4096, 2048, 32  # full-corpus serving store (K6)
IVF_BF16_NB = 512                         # 1,048,576 bf16 rows (K6)
SERVE_ROWS, SERVE_CENTERS = 1_048_576, 1024
SERVE_NLIST, SERVE_NPROBE = 512, 32
SERVE_CLIENTS, SERVE_REQUESTS = 8, 64     # the checked burst
SERVE_TIMED_REQUESTS = 2048               # the timed window
SERVE_PQ_M = 96                           # 96 x 4-bit codes: 48 bytes a row
# the teacher phase: the MiniLM-L6 cross-encoder (BertConfig.minilm_l6)
TEACHER_QUERIES = 512  # x their top-100 of the pipeline's run: 51,200 pairs
TEACHER_BATCH, TEACHER_L = 128, 256
TEACHER_HEADS, TEACHER_HEAD_DIM, TEACHER_LAYERS = 12, 32, 6
TEACHER_SAMPLE = 256   # pairs held to the plain attention
# of the plain scores' spread; over seeds 0-7 the kernel read 0.060-0.093,
# the einsum attention (another sound bf16 rounding) 0.064-0.107 and the
# plain attention with the mask ignored 0.46-1.76
# (tools/teacher_check_seeds.py)
TEACHER_SAMPLE_TOL = 0.2
# the fused dropout -> residual add -> LayerNorm at the main path's two
# shapes, (rows, D, p, gradient): the passage tower's training sites
# (240 x 256 rows of 768, dropout 0.1) and the teacher's (128 x 256 rows
# of 384, no gradient)
RN_SHAPES = {"train": (TRAIN_BZ * NWAY * TRAIN_LP, D, ATTN_P, True),
             "infer": (TEACHER_BATCH * TEACHER_L,
                       TEACHER_HEADS * TEACHER_HEAD_DIM, 0.0, False)}
RN_EPS = 1e-12
N_EXPORT = 4096        # passages the export round trip indexes
# K5 at the length buckets' shapes (data/bucketing.py's default ladder,
# token-balanced): passages at --batch-size 512, --max-length 256 (head_dim
# 64) and the teacher at B=128, L=256 (head_dim 32); (B, L, H, D)
LADDER_SHAPES = ([(512 * 256 // n, n, HEADS, HEAD_DIM)
                  for n in (32, 64, 128, 256)]
                 + [(TEACHER_BATCH * TEACHER_L // n, n, TEACHER_HEADS,
                     TEACHER_HEAD_DIM) for n in (32, 64, 128, 256)])
# a bucketed store's rows' largest distance from the flat store's, over
# the rows' spread (_row_dist; bf16, other kernels and batch shapes at
# another padded length: the same bits need not come out, though on an
# H100 they did), which the encoder with the mask ignored (~10) misses
BUCKET_EMB_TOL = 0.05
BUCKET_SAMPLE = 256    # passages encoded with the mask ignored
RANGE_K_START = 1024   # range_search's first depth (two depths forced)
N_ONDEVICE_FLAT = 8192  # passages of the flat on-device builds (cut from
#                         32,768: every row pays L=256 there)
RERANK_K, RERANK_TOP = 100, 10  # the rerank daemon's requests
# K7, the int8 A/B of examples/bench_int8_dot.py, at its shape: 1,088
# store tiles of 1,024 rows (the per-chip shard), 512 queries
K7_N, K7_TILE, K7_B = 1_114_112, 1024, 512
K7_SMALL = (16_384, 128, 128)  # N, tile_rows, B of the small checks
K7_RTOL = 1e-5                 # normal data: fp32 summation order only
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


def _device_ms_by_name(prof, per=1):
    """Device milliseconds by kernel name in a torch.profiler trace,
    divided by ``per``. Annotation ranges ("Optimizer.step#AdamW.step")
    span kernels that are counted on their own, so they are left out."""
    out = {}
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total",
                     getattr(evt, "self_cuda_time_total", 0.0))
        if (us <= 0 or evt.device_type != torch.autograd.DeviceType.CUDA
                or getattr(evt, "is_user_annotation", False)
                or evt.key.startswith("Optimizer.")):
            continue
        out[evt.key] = out.get(evt.key, 0.0) + us / 1e3 / per
    return out


def _complete(prof, reps):
    """Whether every kernel of the trace was recorded once per call: a
    kernel count that is not a multiple of ``reps`` means the trace lost
    records."""
    return all(evt.count % reps == 0 for evt in prof.key_averages()
               if evt.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(evt, "is_user_annotation", False))


def device_ms(fn, reps=20, warmup=2, tries=3):
    """Mean device milliseconds per call: the durations of every kernel
    ``fn`` launches, summed (torch.profiler), so the host's time to issue
    a call, which CUDA events around back-to-back calls also take in when
    the kernels are shorter than it, is left out. A trace that lost
    records is taken again; after ``tries`` such traces the time is
    taken with CUDA events (logged)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        if _complete(prof, reps):
            return sum(_device_ms_by_name(prof, reps).values())
    log(f"[time] {tries} traces lost kernel records: CUDA events instead")
    return time_ms(fn, reps=reps)


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


def k1_rounds(bz, n, k, bin_rows=128):
    """(R, R2) that the extract route gives K1 at this shape."""
    from cldrd_tpu_torch.search import mips

    return (mips._extract_rounds(n, bz, k, bin_rows),
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


def _compare_k1_on(ctx, tag, q, c, ids, scales, k, integer, bin_rows=128,
                   launches=1):
    """K1 against its plain version on the same inputs, ``launches`` times
    (a fault that shows on some launches only cannot pass on one)."""
    from cldrd_tpu_torch.ops.extract_topk import extract_topk, extract_topk_plain

    bz, n = q.shape[0], c.shape[0]
    R, R2 = k1_rounds(bz, n, k, bin_rows)
    tag = (f"K1 {tag} B={bz} N={n} {str(c.dtype)[6:]} k={k} R={R} R2={R2} "
           f"bin={bin_rows} {'int' if integer else 'normal'}")
    ref = extract_topk_plain(q, c, ids, R, R2, bin_rows, scales)
    err = max(_check_k1(f"{tag} launch {i + 1}", q, c, ids, scales,
                        extract_topk(q, c, ids, R, R2, bin_rows, scales),
                        ref, integer) for i in range(launches))
    log(f"[kernels] {tag}: {'EQUAL' if integer else 'agrees'} in "
        f"{launches} launch(es), max_abs_err {err:.3g}")
    ctx["k1_err"] = max(ctx.get("k1_err", 0.0), err)
    ctx.setdefault("k1_checked", []).append(tag)


def _compare_k1(ctx, bz, n, c_dtype, q_dtype, integer, k=K, bin_rows=128,
                launches=1):
    dev, gen = ctx["dev"], ctx["gen"]
    st = Store(n, D, c_dtype, dev, gen, integer, pad_rows=1000)
    q = make_queries(bz, D, q_dtype, dev, gen, integer)
    _compare_k1_on(ctx, "gen", q, st.c, st.ids, st.scales, k, integer,
                   bin_rows, launches)


def _close_by_rows(tag, got, ref, rtol=1e-5, rows=256):
    """``_close`` over blocks of ``rows`` query rows, for score tensors too
    large for its temporaries: the same -inf pattern, finite values within
    ``rtol`` of the largest reference value. Returns the largest absolute
    difference."""
    err, scale = 0.0, 0.0
    for r0 in range(0, ref.shape[0], rows):
        g, r = got[r0:r0 + rows], ref[r0:r0 + rows]
        fin = torch.isfinite(r)
        if not torch.equal(fin, torch.isfinite(g)):
            raise AssertionError(f"{tag}: -inf pattern differs")
        if bool(fin.any()):
            err = max(err, (g[fin] - r[fin]).abs().max().item())
            scale = max(scale, r[fin].abs().max().item())
    if err > rtol * scale:
        raise AssertionError(f"{tag}: max abs err {err:.3g} > {rtol} x "
                             f"{scale:.3g}")
    return err


def _compare_k2_on(ctx, tag, q, c, ids, scales, bin_rows, integer):
    """K2 against its plain version on the same inputs. Integer-valued
    inputs: EQUAL bit for bit (a zero sum is +0 in both). Normal data:
    within 1e-5 of the largest score. The tag names the route taken."""
    from cldrd_tpu_torch.ops import fused_binmax as k2

    tag = (f"K2 {tag} B={q.shape[0]} N={c.shape[0]} {str(c.dtype)[6:]} "
           f"bin={bin_rows} {'int' if integer else 'normal'} "
           f"{k2.kernel_route(q.dtype, c.dtype, q.shape[1], bin_rows)}")
    got = k2.fused_binmax(q, c, ids, bin_rows, scales)
    ref = k2.fused_binmax_plain(q, c, ids, bin_rows, scales)
    if integer:
        for name, a, b in zip(("scores", "bmax"), got, ref):
            if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
                bad = int((a.view(torch.int32) != b.view(torch.int32)).sum())
                raise AssertionError(f"{tag}: {name} differs in {bad} "
                                     "places on integer-valued inputs")
        err = 0.0
    else:
        err = max(_close_by_rows(f"{tag} {name}", a, b)
                  for name, a, b in zip(("scores", "bmax"), got, ref))
    del got, ref
    log(f"[kernels] {tag}: {'EQUAL' if integer else 'agrees'}, "
        f"max_abs_err {err:.3g}")
    ctx["k2_err"] = max(ctx.get("k2_err", 0.0), err)
    ctx.setdefault("k2_checked", []).append(tag)


def _compare_k2(ctx, bz, n, c_dtype, q_dtype, integer, bin_rows=128):
    """On integer inputs one query is all zeros: its scores are exactly
    zero sums, which must come out +0."""
    dev, gen = ctx["dev"], ctx["gen"]
    st = Store(n, D, c_dtype, dev, gen, integer, pad_rows=1000)
    q = make_queries(bz, D, q_dtype, dev, gen, integer)
    if integer:
        q[bz // 2] = 0
    _compare_k2_on(ctx, "gen", q, st.c, st.ids, st.scales, bin_rows, integer)
    del st, q
    torch.cuda.empty_cache()


def _time_k2(ctx, tag, q, c, ids, scales, bin_rows=128):
    """K2 at one shape on normal data: held to its plain version, then its
    device time beside fused_binmax.cu forced on the same inputs, the
    plain version, the bare bf16 torch.matmul score product (no one
    PyTorch call computes K2's function) and the bound."""
    from cldrd_tpu_torch.ops.fused_binmax import (
        fused_binmax,
        fused_binmax_plain,
    )

    bz, n = q.shape[0], c.shape[0]
    _compare_k2_on(ctx, tag, q, c, ids, scales, bin_rows, integer=False)
    torch.cuda.empty_cache()
    call = lambda: fused_binmax(q, c, ids, bin_rows, scales)  # noqa: E731
    reps = 5 if bz * n <= (1 << 30) else 3
    t = dict(ms=device_ms(call, reps=reps, warmup=1))
    with _k2_generic():  # the kernel of PRs 1-5, same inputs
        t["generic_ms"] = device_ms(call, reps=2, warmup=1)
    t["plain_ms"] = device_ms(lambda: fused_binmax_plain(q, c, ids, bin_rows,
                                                         scales),
                              reps=1, warmup=1)
    cb = c if c.dtype == torch.bfloat16 else c.to(torch.bfloat16)
    t["matmul_ms"] = device_ms(lambda: torch.matmul(q, cb.T), reps=3,
                               warmup=1)
    del cb
    torch.cuda.empty_cache()
    nbytes, ops = k2_bytes_ops(bz, n, D, c.dtype, q.dtype, bin_rows,
                               scales is not None)
    t.update(bound=bound_ms(nbytes, ops, op_type(q.dtype, c.dtype)),
             bytes=nbytes, ops=ops, B=bz, N=n)
    t["library_note"] = f"none (bf16 matmul alone: {t['matmul_ms']} ms)"
    ctx.setdefault("timings", {}).setdefault("fused_binmax", {})[tag] = t
    log(f"[time] fused_binmax {tag} B={bz} N={n} {str(c.dtype)[6:]}, device "
        f"ms: kernel {t['ms']:.3f} (fused_binmax.cu, forced: "
        f"{t['generic_ms']:.3f}), plain {t['plain_ms']:.3f}, bound "
        f"{t['bound'][0]:.3f} ({t['bound'][1]}), torch.matmul bf16 "
        f"{t['matmul_ms']:.3f}")


# ------------------------------------------------- K7: the int8 A/B

def _k7_compare(ctx, tag, q, c, tile_rows, integer):
    """K7 against its plain version on the same inputs: EQUAL on
    integer-valued inputs (exact in every variant), each maximum within
    K7_RTOL of the plain one's magnitude on normal data."""
    from cldrd_tpu_torch.ops import int8_dot as k7

    route = k7.kernel_route(q.dtype, c.dtype)
    tag = (f"K7 {tag} {route} B={q.shape[0]} N={c.shape[0]} "
           f"tile={tile_rows} {'int' if integer else 'normal'}")
    got = k7.tile_max_scores(q, c, tile_rows)
    ref = k7.tile_max_scores_plain(q, c, tile_rows)
    if got.shape != ref.shape or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{tag}: shape {tuple(got.shape)} or values "
                             "not finite")
    err = (got - ref).abs()
    if integer and not torch.equal(got, ref):
        raise AssertionError(f"{tag}: {int((err > 0).sum())} maxima differ "
                             "on integer-valued inputs")
    if not integer and not bool((err <= K7_RTOL * ref.abs()).all()):
        raise AssertionError(f"{tag}: max abs err {err.max().item():.3g} "
                             f"beyond {K7_RTOL} relative")
    err = err.max().item()
    log(f"[kernels] {tag}: {'EQUAL' if integer else 'agrees'}, max_abs_err "
        f"{err:.3g}")
    ctx["k7_err"] = max(ctx.get("k7_err", 0.0), err)


def _k7_operands(ctx, n, bz, d, variant, integer):
    """The A/B script's draws: int8 codes uniform in [-127, 127] (the
    store, and the native variant's queries), bf16 from a normal draw
    (integer-valued in [-127, 127] when ``integer``)."""
    from cldrd_tpu_torch.ops import int8_dot as k7

    dev, gen = ctx["dev"], ctx["gen"]

    def draw(shape, dtype):
        if dtype == torch.int8 or integer:
            return torch.randint(-127, 128, shape, generator=gen, device=dev,
                                 dtype=torch.int8).to(dtype)
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    q_dtype, c_dtype = {v: k for k, v in k7.ROUTES.items()}[variant]
    return draw((bz, d), q_dtype), draw((n, d), c_dtype)


def _int8_dot_ab(ctx):
    """K7 held to its plain version, at a small shape and at the A/B's
    (N = 1,114,112, tile 1,024, B = 512, D = 768), then the A/B itself:
    each variant's device time beside its bound, its plain version and
    the bare product (torch.matmul in bf16; torch._int_mm for int8 x
    int8), with the script's own fields on a line each and the speedups
    of int8_native. The A/B's launches are K7's path (no path of the port
    launches it): counted from 0 around the timed calls alone."""
    from cldrd_tpu_torch.ops import int8_dot as k7

    n_s, tile_s, b_s = K7_SMALL
    for variant in k7.ROUTES.values():
        for integer in (True, False):
            if integer or variant != "int8_native":
                _k7_compare(ctx, "small", *_k7_operands(
                    ctx, n_s, b_s, D, variant, integer), tile_s, integer)
    dev, gen = ctx["dev"], ctx["gen"]
    # the A/B's stores and queries; the integer-valued bf16 store (the
    # int8 codes widened) only for the bf16 variant's EQUAL check
    c8 = torch.randint(-127, 128, (K7_N, D), generator=gen, device=dev,
                       dtype=torch.int8)
    q8 = torch.randint(-127, 128, (K7_B, D), generator=gen, device=dev,
                       dtype=torch.int8)
    qi = torch.randint(-127, 128, (K7_B, D), generator=gen, device=dev,
                       dtype=torch.int8).to(torch.bfloat16)
    _k7_compare(ctx, "A/B", q8, c8, K7_TILE, True)
    _k7_compare(ctx, "A/B", qi, c8, K7_TILE, True)
    c8b = c8.to(torch.bfloat16)  # also the int8_cast variant's yardstick
    _k7_compare(ctx, "A/B", qi, c8b, K7_TILE, True)
    cb = torch.randn(K7_N, D, generator=gen, device=dev).to(torch.bfloat16)
    qn = torch.randn(K7_B, D, generator=gen, device=dev).to(torch.bfloat16)
    _k7_compare(ctx, "A/B", qn, cb, K7_TILE, False)
    _k7_compare(ctx, "A/B", qn, c8, K7_TILE, False)
    torch.cuda.empty_cache()

    operands = {"bf16": (qn, cb, cb), "int8_cast": (qn, c8, c8b),
                "int8_native": (q8, c8, None)}
    ops = 2 * K7_B * D * K7_N
    rows = ctx.setdefault("timings", {}).setdefault("int8_dot", {})
    k7.LAUNCHES = 0
    for variant, (q, c, cmm) in operands.items():
        ms = device_ms(lambda: k7.tile_max_scores(q, c, K7_TILE))
        peak = "int8" if variant == "int8_native" else "bf16"
        nbytes = (c.numel() * c.element_size() + q.numel() * q.element_size()
                  + 4 * (K7_N // K7_TILE) * K7_B)
        t = dict(ms=ms, bound=bound_ms(nbytes, ops, peak), bytes=nbytes,
                 ops=ops, B=K7_B, N=K7_N, tile_rows=K7_TILE,
                 tflops=ops / ms / 1e9,
                 vs_peak=ops / ms / 1e9 / (PEAK_OPS[peak] / 1e12))
        rows[variant] = t
        log("[time] int8_dot A/B " + json.dumps({
            "variant": variant, "ms": ms, "tflops": t["tflops"],
            f"vs_{peak}_peak_{PEAK_OPS[peak] / 1e12:.0f}": t["vs_peak"]}))
    ctx["k7_launches"] = k7.LAUNCHES
    for variant, (q, c, cmm) in operands.items():
        t = rows[variant]
        t["plain_ms"] = device_ms(
            lambda: k7.tile_max_scores_plain(q, c, K7_TILE), reps=1,
            warmup=1)
        if cmm is not None:
            t["matmul_ms"] = device_ms(lambda: torch.matmul(q, cmm.T),
                                       reps=3, warmup=1)
            t["library_note"] = (f"none (bf16 matmul alone: "
                                 f"{t['matmul_ms']} ms)")
        else:
            try:
                t["int_mm_ms"] = device_ms(
                    lambda: torch._int_mm(c, q.t()), reps=3, warmup=1)
                t["library_note"] = (f"none (torch._int_mm alone: "
                                     f"{t['int_mm_ms']} ms)")
            except RuntimeError as e:
                t["int_mm_ms"] = None
                t["library_note"] = f"none (torch._int_mm refused: {e})"
        torch.cuda.empty_cache()
        log(f"[time] int8_dot {variant} B={K7_B} N={K7_N} tile={K7_TILE}, "
            f"device ms: kernel {t['ms']:.4f}, plain {t['plain_ms']:.3f}, "
            f"bound {t['bound'][0]:.4f} ({t['bound'][1]}), "
            f"{t['library_note']}")
    rows["int8_native"]["launches_from"] = (
        "the kernels phase's A/B (no path of the port launches K7)")
    t_b, t_c, t_n = (rows[v]["ms"] for v in operands)
    ctx["k7_summary"] = {"summary": "int8_native speedup",
                         "vs_bf16": t_b / t_n, "vs_int8_cast": t_c / t_n}
    log("[time] int8_dot A/B " + json.dumps(ctx["k7_summary"]))
    del c8, c8b, cb, q8, qi, qn, operands
    torch.cuda.empty_cache()


# ------------------------------------------------------------------ phases


def phase_build(ctx):
    from cldrd_tpu_torch.ops import _build

    t0 = time.perf_counter()
    paths = _build.build_all()
    ctx["build_s"] = time.perf_counter() - t0
    for stem in paths:
        log(f"[build] {stem}: {_build.BUILD_SECONDS.get(stem, 0.0):.1f} s")
        # one line per kernel: its (mangled) name, registers and spills
        entry = spill = ""
        for line in _build.build_log(stem).splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1] if "'" in line else line.strip()
            elif "spill" in line:
                spill = line.strip()
            elif "registers" in line or "error" in line:
                log(f"[build]   {entry}: {line.strip()}; {spill}")
    log(f"[build] all kernels: {ctx['build_s']:.1f} s")
    # no instruction may write a wgmma's register-A operand or touch its
    # accumulators before the wait that retires it (raises if one does)
    from cldrd_tpu_torch.ops import _wgmma_check

    counts = _wgmma_check.check_libraries(paths.values())

    def named(ops):
        return ", ".join(f"{n} {op}" for op, n in ops.items() if n)

    log("[build] wgmma register hazards: none in " + ", ".join(
        f"{lib} ({named(ops)})" for lib, ops in counts.items() if named(ops)))
    # K7's native variant is the one integer product: its IGMMA must be
    # there (and was followed above)
    k7 = {lib.split("-")[0]: ops for lib, ops in counts.items()}[
        "int8_dot_sm90"]
    if not k7["IGMMA"] or not k7["HGMMA"]:
        raise AssertionError(f"int8_dot_sm90: wgmma counts {k7} (IGMMA and "
                             "HGMMA expected)")
    ctx["wgmma_counts"] = counts


def phase_kernels(ctx):
    dev, gen = ctx["dev"], ctx["gen"]
    n = N_KERNEL
    bf16, f32, i8 = torch.bfloat16, torch.float32, torch.int8
    # exactness on integer-valued inputs, ties included
    # (the main path's batch ten times over: the sm90 kernel's wgmma
    # register hazards showed on some launches only)
    for bz in (64, 128, SEARCH_BATCH):
        reps = K1_EQUAL_LAUNCHES if bz == SEARCH_BATCH else 1
        _compare_k1(ctx, bz, n, bf16, bf16, True, launches=reps)
        _compare_k1(ctx, bz, n, i8, bf16, True, launches=reps)
    _compare_k1(ctx, 128, n, f32, f32, True)
    # the pipeline's --topk 100 retrieve over its 32,768-row store
    _compare_k1(ctx, SEARCH_BATCH, N_PIPELINE, bf16, bf16, True,
                k=K_PIPELINE_EXTRACT)
    # the other bin sizes the extract route admits (int8 store, scales)
    for bin_rows in (32, 64, 256):
        _compare_k1(ctx, 128, N_BINS, i8, bf16, True, bin_rows=bin_rows)
    # K2 (every launch of these but fp32's through fused_binmax_sm90.cu;
    # one query all zeros): the portable route's ragged batch, the wide
    # batch over the segment search_batched(batch_size=2048) gives it, and
    # every bin size with a partial last row tile (N % 128 = bin_rows)
    for bz in (128, RAGGED):
        _compare_k2(ctx, bz, n, bf16, bf16, True)
        _compare_k2(ctx, bz, n, i8, bf16, True)
    _compare_k2(ctx, WIDE_BATCH, N_WIDE_SEGMENT, i8, bf16, True)
    _compare_k2(ctx, RAGGED, n, f32, f32, True)
    for bin_rows in (8, 16, 32, 64):
        _compare_k2(ctx, RAGGED, N_BINS + bin_rows, i8, bf16, True,
                    bin_rows=bin_rows)
    _compare_k2(ctx, 1, N_BINS + 16, bf16, bf16, True, bin_rows=16)
    # normal data: values within 1e-5 relative, positions up to near-ties
    _compare_k1(ctx, 128, n, f32, f32, False)
    _compare_k1(ctx, SEARCH_BATCH, N_PIPELINE, bf16, bf16, False,
                k=K_PIPELINE_EXTRACT)
    _compare_k2(ctx, RAGGED, n, i8, bf16, False)

    # attention: the passage tower (B=240, L=256), the query tower (B=8,
    # L=30, a ragged tile), packed rows (B=8 x 10 rows, segments), the
    # query encode (B=512, L=30); fp32 and bf16
    for dtype in (f32, bf16):
        _attn_check(ctx, "passage", TRAIN_BZ * NWAY, TRAIN_LP, dtype, False)
        _attn_check(ctx, "query", TRAIN_BZ, TRAIN_LQ, dtype, False)
        _attn_check(ctx, "packed", TRAIN_BZ * 10, TRAIN_LP, dtype, True)
        _attn_check(ctx, "encode", SEARCH_BATCH, TRAIN_LQ, dtype, False,
                    p=0.0)
    # rows past 256 keep the tiled kernels in bf16 too
    _attn_check(ctx, "long", 16, 2 * TRAIN_LP, bf16, False)
    # the sm90 route, exactly and element by element, at the main path's
    # shapes with its padding
    for tag, b, length, segments in (
            ("passage", TRAIN_BZ * NWAY, TRAIN_LP, False),
            ("query", TRAIN_BZ, TRAIN_LQ, False),
            ("packed", 64, TRAIN_LP, True)):
        for form in ("dq", "dk"):
            _attn_exact(ctx, tag, b, length, segments, form)
        _attn_tight(ctx, tag, b, length, segments)
    _attn_determinism(ctx, TRAIN_BZ * NWAY, TRAIN_LP)
    _infer_checks(ctx)
    _attn_model_calls_check(ctx)
    torch.cuda.empty_cache()
    _time_attention(ctx)
    torch.cuda.empty_cache()
    _teacher_attention(ctx)
    torch.cuda.empty_cache()
    _ladder_checks(ctx)
    torch.cuda.empty_cache()
    _residual_norm(ctx)

    # K1 and K2 held to their plain versions and timed at B=512, N=1M bf16
    # (K1 at the bf16 store's shape; K2 at the shape of its earlier rows)
    st = Store(n, D, bf16, dev, gen, False)
    q = make_queries(SEARCH_BATCH, D, bf16, dev, gen, False)
    _time_kernels(ctx, "bf16_1M", q, st.c, st.ids, None)
    _time_k2(ctx, "bf16_1M", q, st.c, st.ids, None)
    del st, q
    torch.cuda.empty_cache()
    _ivf_probe_checks(ctx)
    torch.cuda.empty_cache()
    _int8_dot_ab(ctx)


def _compare_k6(ctx, tag, q, rows, probe, scales, integer):
    from cldrd_tpu_torch.ops import ivf_probe as k6

    tag = (f"K6 {tag} B={q.shape[0]} P={probe.shape[1]} "
           f"rows={rows.shape[0]} {str(rows.dtype)[6:]}"
           f"{' scaled' if scales is not None else ''} "
           f"{'int' if integer else 'normal'}")
    got = k6.probe_scores(q, rows, probe, scales, slot=IVF_SLOT)
    ref = k6.probe_scores_plain(q, rows, probe, scales, slot=IVF_SLOT)
    if integer:
        if not torch.equal(got, ref):
            bad = int((got != ref).sum())
            raise AssertionError(f"{tag}: {bad} scores differ on "
                                 "integer-valued inputs")
        err = 0.0
    else:
        err = _close(tag, got, ref)
    log(f"[kernels] {tag}: {'EQUAL' if integer else 'agrees'}, max_abs_err "
        f"{err:.3g}")
    ctx["k6_err"] = max(ctx.get("k6_err", 0.0), err)


def _k6_bytes(q, rows, probe, scaled):
    """Bytes K6 must move on these inputs: each probed bucket's rows (and
    scales) read once however many queries probe it, the queries, the
    probes and the fp32 output written once."""
    nb_read = int(torch.unique(probe).numel())
    per_bucket = IVF_SLOT * rows.shape[1] * rows.element_size()
    b, p = probe.shape
    return (nb_read * (per_bucket + (4 * IVF_SLOT if scaled else 0))
            + q.numel() * q.element_size() + 4 * b * p
            + 4 * b * p * IVF_SLOT), nb_read


def _time_k6(ctx, tag, q, rows, probe, scales):
    """K6, its plain version, and a gather + bmm of the probed rows (no
    single PyTorch call computes K6's function) on the same inputs."""
    from cldrd_tpu_torch.ops import ivf_probe as k6

    b, p = probe.shape
    lane = torch.arange(IVF_SLOT, device=q.device)
    rowix = (probe.long()[:, :, None] * IVF_SLOT + lane).reshape(b, -1)
    qb = q.to(torch.bfloat16)[:, :, None]

    def gather_bmm():
        s = torch.bmm(rows[rowix].to(torch.bfloat16), qb)[..., 0]
        if scales is not None:
            s = s * scales[probe.long()].reshape(b, -1)
        return s

    nbytes, nb_read = _k6_bytes(q, rows, probe, scales is not None)
    ops = 2 * b * p * IVF_SLOT * rows.shape[1]
    r = dict(
        ms=device_ms(lambda: k6.probe_scores(q, rows, probe, scales,
                                             slot=IVF_SLOT)),
        plain_ms=device_ms(lambda: k6.probe_scores_plain(
            q, rows, probe, scales, slot=IVF_SLOT), reps=1, warmup=1),
        gather_bmm_ms=device_ms(gather_bmm, reps=3, warmup=1),
        bound=bound_ms(nbytes, ops, "bf16"), bytes=nbytes,
        buckets_read=nb_read, B=b, P=p, rows=rows.shape[0],
        bytes_per_pair=b * p * IVF_SLOT * rows.shape[1] * rows.element_size())
    r["library_note"] = f"none (gather + bmm: {r['gather_bmm_ms']} ms)"
    ctx.setdefault("timings", {}).setdefault("ivf_probe", {})[tag] = r
    torch.cuda.empty_cache()
    log(f"[time] ivf_probe {tag} B={b} P={p} rows={rows.shape[0]}: kernel "
        f"{r['ms']:.4f} ms, plain {r['plain_ms']:.3f} ms, gather+bmm "
        f"{r['gather_bmm_ms']:.3f} ms, bound {r['bound'][0]:.4f} ms "
        f"({r['bound'][1]}; {nb_read} distinct buckets, {nbytes} bytes)")


def _ivf_probe_checks(ctx):
    """K6 at the full-corpus serving store (8,388,608 x 768 int8 with
    scales: 6.44e9 elements, so row offsets need 64 bits) at B=8 and the
    serve encode batch B=128, and at a 1,048,576-row bf16 store without
    scales at B=8; P=32 probes from the generator; duplicate probes."""
    dev, gen = ctx["dev"], ctx["gen"]
    bf16 = torch.bfloat16
    rows = torch.randint(-127, 128, (IVF_NB * IVF_SLOT, D), generator=gen,
                         device=dev, dtype=torch.int8)
    scales = (torch.rand(IVF_NB, IVF_SLOT, generator=gen, device=dev)
              + 0.5) / 127

    def probes(b, nb):
        return torch.randint(0, nb, (b, IVF_P), generator=gen, device=dev,
                             dtype=torch.int32)

    for b in (8, 128):
        pr = probes(b, IVF_NB)
        _compare_k6(ctx, "int8_full", make_queries(b, D, bf16, dev, gen,
                                                   True), rows, pr, scales,
                    True)
        q = make_queries(b, D, bf16, dev, gen, False)
        _compare_k6(ctx, "int8_full", q, rows, pr, scales, False)
        _time_k6(ctx, f"int8_full_b{b}", q, rows, pr, scales)
    dup = probes(8, IVF_NB)
    dup[:, 1::2] = dup[:, 0::2]            # every probe repeated once
    dup[:, -1] = IVF_NB - 1                # the store's last bucket
    _compare_k6(ctx, "int8_full dup", make_queries(8, D, bf16, dev, gen,
                                                   True), rows, dup, scales,
                True)
    del rows, scales
    torch.cuda.empty_cache()
    nrows = IVF_BF16_NB * IVF_SLOT
    rows = torch.randint(-32, 33, (nrows, D), generator=gen, device=dev,
                         dtype=torch.int8).to(bf16) / 16
    pr = probes(8, IVF_BF16_NB)
    _compare_k6(ctx, "bf16_1M", make_queries(8, D, bf16, dev, gen, True),
                rows, pr, None, True)
    q = make_queries(8, D, bf16, dev, gen, False)
    _compare_k6(ctx, "bf16_1M", q, rows, pr, None, False)
    _time_k6(ctx, "bf16_1M_b8", q, rows, pr, None)
    del rows


def _time_kernels(ctx, tag, q, c, ids, scales):
    """K1 at one shape, on normal data: kernel against plain version, then
    the kernel's, the plain version's and the bare bf16 torch.matmul score
    product's times; the results land in ctx["timings"]["extract_topk"]."""
    from cldrd_tpu_torch.ops.extract_topk import extract_topk, extract_topk_plain

    bz, n = q.shape[0], c.shape[0]
    R, R2 = k1_rounds(bz, n, K)
    _compare_k1_on(ctx, tag, q, c, ids, scales, K, integer=False)
    torch.cuda.empty_cache()
    qb = q.to(torch.bfloat16)
    if c.dtype == torch.bfloat16:
        t_mm = device_ms(lambda: torch.matmul(qb, c.T), reps=3, warmup=1)
    else:  # the same product over a bf16 copy of the store
        cb = c.to(torch.bfloat16)
        t_mm = device_ms(lambda: torch.matmul(qb, cb.T), reps=3, warmup=1)
        del cb
    torch.cuda.empty_cache()
    ot = op_type(q.dtype, c.dtype)
    rows = ctx.setdefault("timings", {})
    b1, o1 = k1_bytes_ops(bz, n, D, c.dtype, q.dtype, R2, scales is not None)
    k1_call = lambda: extract_topk(q, c, ids, R, R2, 128, scales)  # noqa
    with _k1_generic():  # the kernel of PRs 1-4, same inputs
        t_generic = device_ms(k1_call, reps=5, warmup=1)
    rows.setdefault("extract_topk", {})[tag] = dict(
        ms=device_ms(k1_call, reps=5, warmup=1), generic_ms=t_generic,
        plain_ms=device_ms(lambda: extract_topk_plain(q, c, ids, R, R2, 128,
                                                      scales),
                           reps=1, warmup=1),
        bound=bound_ms(b1, o1, ot), matmul_ms=t_mm, B=bz, N=n, R=R, R2=R2)
    r = rows["extract_topk"][tag]
    log(f"[time] extract_topk {tag} B={bz} N={n}, device ms: kernel "
        f"{r['ms']:.3f} (extract_topk.cu, forced: {r['generic_ms']:.3f} "
        f"ms), plain {r['plain_ms']:.3f}, bound {r['bound'][0]:.3f} "
        f"({r['bound'][1]}), torch.matmul bf16 {t_mm:.3f}")


# ------------------------------------------------ attention vs plain


def _attn_segments(ctx, b, length):
    """Packed rows: 3-5 segments of 30-83 tokens a row and a padded tail;
    returns (mask, segment ids)."""
    dev, gen = ctx["dev"], ctx["gen"]
    cuts = torch.randint(30, 84, (b, 5), generator=gen, device=dev).cumsum(1)
    pos = torch.arange(length, device=dev)
    seg = (1 + (pos[None, :, None] >= cuts[:, None, :]).sum(-1)).int()
    seg = torch.where(pos[None] < cuts[:, -1:].clamp(max=length - 7), seg,
                      torch.zeros_like(seg))
    return (seg > 0).int(), seg


def _padded_mask(ctx, b, length):
    """A key mask padded as the main path's rows are: 1/8 to 1/3 of each
    row real (a query's ~8 tokens of 30, a passage's 32-86 of 256)."""
    dev = ctx["dev"]
    n = torch.randint(max(2, length // 8), length // 3 + 2, (b, 1),
                      generator=ctx["gen"], device=dev)
    return (torch.arange(length, device=dev)[None] < n).int()


def _attn_inputs(ctx, b, length, dtype, segments):
    """q, k, v, upstream grad [b, length, H, 64] and a key mask (the first
    row half padded) or, packed, 3-5 segments per row and a padded tail."""
    dev, gen = ctx["dev"], ctx["gen"]
    q, k, v, g = (torch.randn(b, length, HEADS, HEAD_DIM, generator=gen,
                              device=dev).to(dtype) for _ in range(4))
    mask = torch.ones(b, length, dtype=torch.int32, device=dev)
    mask[0, length // 2:] = 0
    seg = None
    if segments:
        mask, seg = _attn_segments(ctx, b, length)
    return q, k, v, g, mask, seg


def _attn_bytes_ops(b, length, dtype, n_tensors, n_dots, n_int=1,
                    heads=HEADS, head_dim=HEAD_DIM, keys=None):
    """Bytes (each [B, L, H, D] operand and each int32 [B, L] mask or
    segment row read or written once) and operations (n_dots products of
    2*B*H*L*L*D) of one attention launch. Given ``keys``, the number of
    unmasked keys over the batch (K5 at p=0: a masked key's weight is
    exactly 0, so its K and V rows are never needed), K and V count those
    rows only and each product 2*H*L*keys*D."""
    item = torch.tensor([], dtype=dtype).element_size()
    row = heads * head_dim * item
    if keys is None:
        keys, n_kv = b * length, 0
    else:
        n_kv = 2  # K and V
    nbytes = ((n_tensors - n_kv) * b * length * row + n_kv * keys * row
              + 4 * n_int * b * length)
    return nbytes, n_dots * 2 * heads * length * keys * head_dim


def _attn_check(ctx, tag, b, length, dtype, segments, p=ATTN_P):
    """K3 + K4 through flash_attention_train, and the plain versions, on
    the same inputs and seed; K5 at p=0 without segments. fp32 within
    1e-5 of the largest magnitude (a wrong dropout bit shows as ~|v|/L),
    bf16 within 2e-2."""
    from cldrd_tpu_torch.ops import attention as att

    q, k, v, g, mask, seg = _attn_inputs(ctx, b, length, dtype, segments)
    qs, ks, vs = (t.clone().requires_grad_() for t in (q, k, v))
    out = att.flash_attention_train(qs, ks, vs, mask, ATTN_SEED, p, seg)
    out.backward(g)
    ref = att.train_fwd_plain(q, k, v, mask, ATTN_SEED, p, seg)
    refs = att.train_bwd_plain(q, k, v, mask, ATTN_SEED, p, seg, g)
    pairs = [("out", out, ref), ("dq", qs.grad, refs[0]),
             ("dk", ks.grad, refs[1]), ("dv", vs.grad, refs[2])]
    if seg is None:
        pairs.append(("K5 out", att.flash_attention(q, k, v, mask),
                      att.attention_plain(q, k, v, mask)))
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    errs = {}
    for name, got, want in pairs:
        err = (got.float() - want.float()).abs().max().item()
        scale = want.float().abs().max().item()
        if not err <= tol * scale:
            raise AssertionError(f"attention {tag} {dtype} {name}: max abs "
                                 f"err {err:.3g} > {tol} x {scale:.3g}")
        errs[name] = err
    log(f"[kernels] attention {tag} B={b} L={length} {str(dtype)[6:]} "
        f"p={p}: out/dq/dk/dv{'/K5' if seg is None else ''} agree with the "
        f"plain versions (max abs err "
        f"{', '.join(f'{e:.3g}' for e in errs.values())}; tolerance {tol} "
        "of the largest magnitude)")
    key = "attn_err_bf16" if dtype == torch.bfloat16 else "attn_err_fp32"
    ctx[key] = max(ctx.get(key, 0.0), *errs.values())


def _attn_exact(ctx, tag, b, length, segments, form, seed=ATTN_SEED + 1,
                p=0.5):
    """The sm90 route on inputs where every value is exact in bf16, with
    the main path's padding (or packed segments): v one-hot over keys, g
    small integers, and every score of a row equal, so each probability
    is 1/l rounded once. For ``form`` "dq": q = 0 and k one-hot over keys;
    for "dk": q one-hot over queries and every key row e_0. At p = 0.5
    (inv and inv32 are 2, exact) every sum is exact, so out, dv, the
    residual ov and dq (or dk) must EQUAL the plain versions: one wrong
    dropout bit (on probs or on dp), row sum or dS element fails."""
    from cldrd_tpu_torch.ops import attention as att

    dev, bf16 = ctx["dev"], torch.bfloat16
    shape = (b, length, HEADS, HEAD_DIM)
    pos = torch.arange(length, device=dev)
    hot = (pos[:, None] % HEAD_DIM
           == torch.arange(HEAD_DIM, device=dev)[None, :])
    hot = hot[None, :, None, :].expand(shape).to(bf16).contiguous()
    if form == "dq":
        q, k = torch.zeros(shape, dtype=bf16, device=dev), hot
    else:
        q, k = hot, torch.zeros(shape, dtype=bf16, device=dev)
        k[..., 0] = 1
    g = torch.randint(-2, 3, shape, generator=ctx["gen"], device=dev).to(
        bf16)
    if segments:
        mask, seg = _attn_segments(ctx, b, length)
    else:
        mask, seg = _padded_mask(ctx, b, length), None
    route = att._kernel_route(bf16, length, HEAD_DIM, "train_fwd")
    out, res = att._launch_fwd(q, k, hot, mask, seed, p, seg, True,
                               "train_fwd")
    dq, dk, dv = att._launch_bwd(q, k, hot, mask, seed, p, seg, res, g)
    ref = att.train_fwd_plain(q, k, hot, mask, seed, p, seg)
    rov = att.residual_ov_plain(q, k, hot, mask, seed, p, seg)
    rq, rk, rv = att.train_bwd_plain(q, k, hot, mask, seed, p, seg, g)
    pairs = (("out", out, ref), ("ov", res[1], rov), ("dv", dv, rv),
             (form, dq, rq) if form == "dq" else (form, dk, rk))
    for name, got, want in pairs:
        if not want.abs().max() > 0:
            raise AssertionError(f"attention exact {tag} {name}: the plain "
                                 "version is all zeros (no test)")
        if not torch.equal(got, want):
            bad = (got != want).sum().item()
            raise AssertionError(f"attention {route} exact {tag} {name}: "
                                 f"{bad} of {got.numel()} elements differ "
                                 "from the plain version")
    n = sum(x.numel() for _, x, _ in pairs)
    log(f"[kernels] attention {route} {tag} B={b} L={length} bf16 p={p}"
        f"{', segments' if segments else ', padded rows'}, exact inputs "
        f"({form} form): out, ov, dv and {form} EQUAL to the plain versions "
        f"({n} elements)")
    ctx["attn_exact_elements"] = ctx.get("attn_exact_elements", 0) + n


def _attn_tight(ctx, tag, b, length, segments, seed=ATTN_SEED + 2):
    """The sm90 route's dq and dk, element by element, against the plain
    backward, on normal data with the main path's padding (or packed
    segments), within ``sm90_bwd_bound``: one bf16 ulp of every dS term,
    fp32 dots in another order, one ulp of the output. A wrong row sum,
    swizzle row or chunk moves whole rows of dS and lies far outside
    it."""
    from cldrd_tpu_torch.ops import attention as att

    bf16 = torch.bfloat16
    q, k, v, g, _, seg = _attn_inputs(ctx, b, length, bf16, segments)
    mask = (seg > 0).int() if segments else _padded_mask(ctx, b, length)
    route = att._kernel_route(bf16, length, HEAD_DIM, "train_fwd")
    _, res = att._launch_fwd(q, k, v, mask, seed, ATTN_P, seg, True,
                             "train_fwd")
    dq, dk, _ = att._launch_bwd(q, k, v, mask, seed, ATTN_P, seg, res, g)
    rq, rk, _ = att.train_bwd_plain(q, k, v, mask, seed, ATTN_P, seg, g)
    bounds = att.sm90_bwd_bound(q, k, v, mask, seed, ATTN_P, seg, g, rq, rk)
    worst = {}
    for name, got, want, bound in (("dq", dq, rq, bounds[0]),
                                   ("dk", dk, rk, bounds[1])):
        err = (got.float() - want.float()).abs()
        ratio = (err / bound.clamp_min(1e-30)).max().item()
        over = (err > bound).sum().item()
        if over:
            raise AssertionError(f"attention {route} {tag} {name}: {over} "
                                 "elements outside the per-element bound "
                                 f"(max err/bound {ratio:.3g})")
        worst[name] = ratio
    log(f"[kernels] attention {route} {tag} B={b} L={length} bf16 p={ATTN_P}"
        f"{', segments' if segments else ', padded rows'}: dq and dk within "
        "the per-element bound of the plain backward "
        f"(largest err/bound: dq {worst['dq']:.3g}, dk {worst['dk']:.3g})")
    ctx.setdefault("attn_tight", {})[tag] = worst


def _attn_model_calls_check(ctx):
    """The model's own train-attention calls of one flat step at
    DistilBERT-base width (random weights from --seed; ``_capture_calls``),
    replayed through the sm90 kernels: out and dv within 2e-2 of the
    largest magnitude of the plain versions, dq and dk element by element
    within ``sm90_bwd_bound``. Random inputs have no common component
    across keys; the model's rows do, and there dS cancels."""
    from cldrd_tpu_torch.ops import attention as att

    work = os.path.join(WORK, "step_check")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    n_pass, n_q = 4096, 256
    corpus = _write_corpus(work, n_pass, n_q, ctx["seed"])
    files = _write_training_files(work, n_q, n_pass, ctx["seed"])
    worst = {}
    calls = _capture_calls(ctx, corpus, files["8"])
    for c in calls:
        q, k, v, mask, s_, p, seg = c["args"]
        g = c["g"].contiguous()
        tag = f"B={q.shape[0]} L={q.shape[1]}"
        out, res = att._launch_fwd(q, k, v, mask, s_, p, seg, True,
                                   "train_fwd")
        dq, dk, dv = att._launch_bwd(q, k, v, mask, s_, p, seg, res, g)
        ref = att.train_fwd_plain(q, k, v, mask, s_, p, seg)
        rq, rk, rv = att.train_bwd_plain(q, k, v, mask, s_, p, seg, g)
        bq, bk = att.sm90_bwd_bound(q, k, v, mask, s_, p, seg, g, rq, rk)
        for name, got, want in (("out", out, ref), ("dv", dv, rv)):
            err = (got.float() - want.float()).abs().max().item()
            if not err <= 2e-2 * want.float().abs().max().item():
                raise AssertionError(f"model call {tag} {name}: max abs err "
                                     f"{err:.3g}")
        for name, got, want, bound in (("dq", dq, rq, bq),
                                       ("dk", dk, rk, bk)):
            err = (got.float() - want.float()).abs()
            ratio = (err / bound.clamp_min(1e-30)).max().item()
            if (err > bound).any():
                raise AssertionError(f"model call {tag} {name}: "
                                     f"{int((err > bound).sum())} elements "
                                     "outside the per-element bound (max "
                                     f"err/bound {ratio:.3g})")
            worst[name] = max(worst.get(name, 0.0), ratio)
    log(f"[kernels] the model's {len(calls)} train-attention calls of one "
        "flat step, replayed through the sm90 kernels: out and dv within "
        "2e-2, dq and dk within the per-element bound of the plain "
        f"versions (largest err/bound: dq {worst['dq']:.3g}, dk "
        f"{worst['dk']:.3g})")
    ctx["attn_model_calls"] = worst
    shutil.rmtree(work, ignore_errors=True)


def _query_tower_mask(ctx, b, length):
    """Most keys padded, as the query tower's rows are (1 to L/3 + 1 real
    tokens of L), and row 1 fully masked (the reference gives 1/L)."""
    dev = ctx["dev"]
    n = torch.randint(1, length // 3 + 2, (b, 1), generator=ctx["gen"],
                      device=dev)
    mask = (torch.arange(length, device=dev)[None] < n).int()
    mask[1] = 0
    return mask


def _infer_checks(ctx):
    """K5 through flash_attention at the query encode (B=512, L=30: the
    short-row kernel of attention_infer.cu) and at B=240, L=256
    (attention_infer_d64.cu), with the query tower's padding (one row
    with no real key) and with a mask that has holes: within 2e-2 of the
    largest magnitude of attention_plain on normal data; on exact inputs
    (every score of a row equal: q = 0 and k one-hot, or q one-hot and
    every key e_0; v one-hot over keys) EQUAL to it."""
    from cldrd_tpu_torch.ops import attention as att

    dev, bf16 = ctx["dev"], torch.bfloat16
    for tag, b, length in (("encode", SEARCH_BATCH, TRAIN_LQ),
                           ("L256", TRAIN_BZ * NWAY, TRAIN_LP)):
        route = att._kernel_route(bf16, length, HEAD_DIM, "infer")
        shape = (b, length, HEADS, HEAD_DIM)
        q, k, v = (torch.randn(shape, generator=ctx["gen"], device=dev)
                   .to(bf16) for _ in range(3))
        masks = {"query-tower padding": _query_tower_mask(ctx, b, length),
                 "holes": _holed_mask(ctx, b, length)}
        errs = {}
        for mtag, mask in masks.items():
            out = att.flash_attention(q, k, v, mask)
            ref = att.attention_plain(q, k, v, mask)
            errs[mtag] = err = (out.float() - ref.float()).abs().max().item()
            if not err <= 2e-2 * ref.float().abs().max().item():
                raise AssertionError(f"K5 {route} {tag} ({mtag}): max abs "
                                     f"err {err:.3g}")
            for form, xs in _exact_forms(dev, shape).items():
                got = att.flash_attention(*xs, mask)
                want = att.attention_plain(*xs, mask)
                if not (want.abs().max() > 0 and torch.equal(got, want)):
                    raise AssertionError(
                        f"K5 {route} {tag} exact ({form}, {mtag}): "
                        f"{int((got != want).sum())} elements differ from "
                        "the plain version")
            del out, ref
        log(f"[kernels] K5 {route} {tag} B={b} L={length} bf16, query-tower "
            f"padding and holes: agrees with the plain version (max abs err "
            f"{errs}; tolerance 2e-2 of the largest magnitude), EQUAL on "
            "exact inputs (two forms)")
        ctx["k5_err"] = max(ctx.get("k5_err", 0.0), *errs.values())
        del q, k, v, masks
    torch.cuda.empty_cache()


def _attn_determinism(ctx, b, length):
    """Two launches of K3 + K4 on the same inputs give the same bits."""
    from cldrd_tpu_torch.ops import attention as att

    q, k, v, g, mask, _ = _attn_inputs(ctx, b, length, torch.bfloat16,
                                       False)
    runs = []
    for _ in range(2):
        out, res = att._launch_fwd(q, k, v, mask, ATTN_SEED, ATTN_P, None,
                                   True, "train_fwd")
        runs.append((out, *res, *att._launch_bwd(
            q, k, v, mask, ATTN_SEED, ATTN_P, None, res, g)))
    for name, x, y in zip(("out", "stats", "ov", "dq", "dk", "dv"), *runs):
        if not torch.equal(x, y):
            raise AssertionError(f"attention {name} differs between two "
                                 "launches on the same inputs")
    log(f"[kernels] attention B={b} L={length} bf16 p={ATTN_P}: two "
        "launches give identical out, residual, dq, dk and dv")


def _time_train_attention(ctx, tag, b, segments):
    """K3 and K4 (L=256, bf16, p=0.1) at batch ``b`` against their plain
    versions, their bounds and scaled_dot_product_attention with the same
    dropout (its backward for K4), which the port never calls. Packed
    rows give SDPA their block-diagonal mask as a dense boolean one."""
    import torch.nn.functional as F

    from cldrd_tpu_torch.ops import attention as att

    rows = ctx.setdefault("timings", {})
    bf16, length = torch.bfloat16, TRAIN_LP
    q, k, v, g, mask, seg = _attn_inputs(ctx, b, length, bf16, segments)
    _, res = att._launch_fwd(q, k, v, mask, ATTN_SEED, ATTN_P, seg, True,
                             "train_fwd")
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    amask = (mask != 0)[:, None, None, :]
    if seg is not None:  # padding rows attend to themselves (no NaN rows)
        amask = ((seg[:, None, :, None] == seg[:, None, None, :]) & amask
                 | torch.eye(length, dtype=torch.bool, device=q.device))
    lib_out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=amask,
                                             dropout_p=ATTN_P)
    gt = g.transpose(1, 2)
    calls = {
        "fwd": lambda: att._launch_fwd(q, k, v, mask, ATTN_SEED, ATTN_P, seg,
                                       True, "train_fwd"),
        "bwd": lambda: att._launch_bwd(q, k, v, mask, ATTN_SEED, ATTN_P, seg,
                                       res, g),
        "lib_fwd": lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=amask, dropout_p=ATTN_P),
        "lib_bwd": lambda: torch.autograd.grad(
            lib_out, (qt, kt, vt), gt, retain_graph=True)}
    dev_ms = {key: device_ms(fn) for key, fn in calls.items()}
    # the tiled kernels of attention.cu on the same inputs, the earlier
    # route of these launches, on the same yardstick
    with _train_attention_route("tiled"):
        _, res_t = att._launch_fwd(q, k, v, mask, ATTN_SEED, ATTN_P, seg,
                                   True, "train_fwd")
        dev_ms["tiled_fwd"] = device_ms(calls["fwd"])
        dev_ms["tiled_bwd"] = device_ms(lambda: att._launch_bwd(
            q, k, v, mask, ATTN_SEED, ATTN_P, seg, res_t, g))
    del lib_out, qt, kt, vt, amask, calls, res_t
    n_int = 1 if seg is None else 2
    nb3, ops3 = _attn_bytes_ops(b, length, bf16, 4, 2, n_int)
    nb4, ops4 = _attn_bytes_ops(b, length, bf16, 7, 5, n_int)
    rows.setdefault("attention_train_fwd", {})[tag] = dict(
        ms=dev_ms["fwd"], tiled_ms=dev_ms["tiled_fwd"],
        plain_ms=device_ms(lambda: att.train_fwd_plain(
            q, k, v, mask, ATTN_SEED, ATTN_P, seg), reps=1, warmup=1),
        bound=bound_ms(nb3, ops3, "bf16"), library_ms=dev_ms["lib_fwd"],
        B=b, L=length)
    rows.setdefault("attention_train_bwd", {})[tag] = dict(
        ms=dev_ms["bwd"], tiled_ms=dev_ms["tiled_bwd"],
        plain_ms=device_ms(lambda: att.train_bwd_plain(
            q, k, v, mask, ATTN_SEED, ATTN_P, seg, g), reps=1, warmup=1),
        bound=bound_ms(nb4, ops4, "bf16"), library_ms=dev_ms["lib_bwd"],
        B=b, L=length)
    del q, k, v, g, res
    torch.cuda.empty_cache()


def _time_attention(ctx):
    """K3 and K4 at the passage tower's shape (B=240, L=256) and at the
    packed one (64 rows of 256 with segments), K5 at the query encode's
    (B=512, L=30), at the passage tower's and at the flat index build's
    (512 x 256 with its passage padding), each against its plain
    version, its bound, its earlier route forced and one PyTorch call
    computing the same function."""
    import torch.nn.functional as F

    from cldrd_tpu_torch.ops import attention as att

    _time_train_attention(ctx, "train", TRAIN_BZ * NWAY, False)
    _time_train_attention(ctx, "packed", 64, True)
    rows = ctx["timings"]
    bf16 = torch.bfloat16
    # K5 at the query encode (B=512, L=30: the short-row kernel) beside the
    # tiled forward of attention.cu forced on the same inputs; at the
    # passage shape (B=240, L=256) and at the flat index build's (512 x
    # 256, 32-86 real keys of 256), attention_infer_d64.cu beside the
    # sm90 forward at p=0 forced (the earlier route of both)
    for name, tag, b, length, old in (
            ("attention_infer", "encode", SEARCH_BATCH, TRAIN_LQ, "tiled"),
            ("attention_infer_d64", "L256", TRAIN_BZ * NWAY, TRAIN_LP,
             "sm90"),
            ("attention_infer_d64", "flat_512x256", SEARCH_BATCH, TRAIN_LP,
             "sm90")):
        q, k, v, _, mask, _ = _attn_inputs(ctx, b, length, bf16, False)
        if tag.startswith("flat"):
            mask = _padded_mask(ctx, b, length)
        amask = (mask != 0)[:, None, None, :]
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        nb5, ops5 = _attn_bytes_ops(b, length, bf16, 4, 2,
                                    keys=int(mask.sum()))
        k5 = lambda: att.flash_attention(q, k, v, mask)  # noqa: E731
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, attn_mask=amask)
        forced = (_train_attention_route("tiled") if old == "tiled"
                  else _k5_sm90())
        with forced:
            t_old = device_ms(k5)
        rows.setdefault(name, {})[tag] = {
            "ms": device_ms(k5), f"{old}_ms": t_old,
            "route": att._kernel_route(bf16, length, HEAD_DIM, "infer"),
            "plain_ms": device_ms(lambda: att.attention_plain(q, k, v, mask),
                                  reps=3, warmup=1),
            "bound": bound_ms(nb5, ops5, "bf16"), "library_ms": device_ms(lib),
            "real_keys": int(mask.sum()), "B": b, "L": length}
        del q, k, v, mask, amask, qt, kt, vt
    olds = {"tiled_ms": "the tiled kernels of attention.cu",
            "sm90_ms": "the sm90 forward at p=0"}
    for name, tag in (("attention_train_fwd", "train"),
                      ("attention_train_bwd", "train"),
                      ("attention_train_fwd", "packed"),
                      ("attention_train_bwd", "packed"),
                      ("attention_infer", "encode"),
                      ("attention_infer_d64", "L256"),
                      ("attention_infer_d64", "flat_512x256")):
        r = rows[name][tag]
        old = "".join(f" ({olds[key]}, forced: {r[key]:.4f} ms)"
                      for key in olds if key in r)
        log(f"[time] {name} {tag} B={r['B']} L={r['L']} bf16, device ms: "
            f"kernel {r['ms']:.4f}{old}, plain {r['plain_ms']:.4f}, "
            f"scaled_dot_product_attention {r['library_ms']:.4f}, bound "
            f"{r['bound'][0]:.4f} ({r['bound'][1]})")


def _pair_mask(ctx, b, length):
    """Keys padded as the teacher's pairs are: [CLS] q [SEP] p [SEP] of
    the pipeline's 6-word queries and 30-81-word passages, 39-90 real
    tokens of 256."""
    n = torch.randint(39, 91, (b, 1), generator=ctx["gen"],
                      device=ctx["dev"])
    return (torch.arange(length, device=ctx["dev"])[None] < n).int()


def _holed_mask(ctx, b, length):
    """Real keys scattered (15% of the keys, values 1, 2 and -1: the
    kernels test != 0) with every third 16-key tile empty."""
    dev, gen = ctx["dev"], ctx["gen"]
    val = torch.tensor([1, 2, -1], dtype=torch.int32, device=dev)
    pick = torch.randint(0, 3, (b, length), generator=gen, device=dev)
    keep = torch.rand(b, length, generator=gen, device=dev) < 0.15
    keep &= (torch.arange(length, device=dev) // 16 % 3 != 1)[None]
    return torch.where(keep, val[pick], torch.zeros_like(val[pick]))


def _exact_forms(dev, shape):
    """Inputs on which every score of a row is equal, as {form: (q, k,
    v)}: q = 0 and k one-hot ("q0"), or q one-hot and every key e_0
    ("k0"); v one-hot over dims by key position. Each probability is 1/l
    rounded once, so a kernel must EQUAL its plain version on them."""
    length, d = shape[1], shape[3]
    pos = torch.arange(length, device=dev)
    hot = (pos[:, None] % d == torch.arange(d, device=dev)[None, :])
    hot = hot[None, :, None, :].expand(shape).to(torch.bfloat16).contiguous()
    zero = torch.zeros(shape, dtype=torch.bfloat16, device=dev)
    e0 = zero.clone()
    e0[..., 0] = 1
    return {"q0": (zero, hot, hot), "k0": (hot, e0, hot)}


def _teacher_attention(ctx):
    """K5 at the MiniLM teacher's shape (bf16, B=128, L=256, H=12, D=32,
    pair padding), which _kernel_route sends to attention_infer_d32.cu:
    within 2e-2 of the largest magnitude of attention_plain on normal
    data, EQUAL to it on exact inputs (every score of a row equal: q = 0
    and k one-hot, or q one-hot and every key e_0; v one-hot over keys),
    each with the pair padding, with one batch row that has no real key
    and with a mask that has holes; timed beside attention.cu's tiled
    forward forced on the same inputs (its earlier route), the plain
    version, its bound and SDPA; and the blocks an SM holds."""
    import ctypes

    import torch.nn.functional as F

    from cldrd_tpu_torch.ops import _build
    from cldrd_tpu_torch.ops import attention as att

    dev, bf16 = ctx["dev"], torch.bfloat16
    b, length = TEACHER_BATCH, TEACHER_L
    h, d = TEACHER_HEADS, TEACHER_HEAD_DIM
    route = att._kernel_route(bf16, length, d, "infer")
    if route != "d32":
        raise AssertionError(f"K5 at the teacher's shape takes {route}")
    shape = (b, length, h, d)
    mask = _pair_mask(ctx, b, length)
    one_masked = mask.clone()
    one_masked[b // 2] = 0
    masks = {"pairs": mask, "one row all masked": one_masked,
             "holes": _holed_mask(ctx, b, length)}
    q, k, v = (torch.randn(shape, generator=ctx["gen"], device=dev).to(bf16)
               for _ in range(3))
    errs = {}
    for tag, m in masks.items():
        ref = att.attention_plain(q, k, v, m)
        errs[tag] = (att.flash_attention(q, k, v, m).float()
                     - ref.float()).abs().max().item()
        if not errs[tag] <= 2e-2 * ref.float().abs().max().item():
            raise AssertionError(f"K5 d32 teacher shape, {tag}: max abs "
                                 f"err {errs[tag]:.3g}")
    exact = _exact_forms(dev, shape)
    for tag, m in masks.items():
        for form, xs in exact.items():
            got = att.flash_attention(*xs, m)
            want = att.attention_plain(*xs, m)
            if not (want.abs().max() > 0 and torch.equal(got, want)):
                raise AssertionError(
                    f"K5 d32 teacher shape exact ({form}, {tag}): "
                    f"{int((got != want).sum())} elements differ from the "
                    "plain version")
    del exact, masks, one_masked
    amask = (mask != 0)[:, None, None, :]
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    nbytes, ops = _attn_bytes_ops(b, length, bf16, 4, 2, heads=h,
                                  head_dim=d, keys=int(mask.sum()))
    k5 = lambda: att.flash_attention(q, k, v, mask)  # noqa: E731
    with _train_attention_route("tiled"):  # attention.cu, the old route
        t_tiled = device_ms(k5)
    blocks = _build.load("attention_infer_d32").attn_infer_d32_blocks_per_sm
    blocks.argtypes, blocks.restype = [ctypes.c_int], ctypes.c_int
    row = dict(
        ms=device_ms(k5), tiled_ms=t_tiled,
        plain_ms=device_ms(lambda: att.attention_plain(q, k, v, mask),
                           reps=3, warmup=1),
        bound=bound_ms(nbytes, ops, "bf16"),
        library_ms=device_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=amask)), blocks_per_sm=blocks(length),
        real_keys=int(mask.sum()), B=b, L=length, H=h, D=d)
    ctx.setdefault("timings", {})["attention_infer_d32"] = {"teacher": row}
    ctx["k5_teacher_err"] = max(errs.values())
    log(f"[kernels] K5 d32 (attention_infer_d32.cu) at the teacher's shape "
        f"B={b} L={length} H={h} D={d} bf16: agrees with the plain version "
        f"(max abs err {errs}; tolerance 2e-2 of the largest magnitude), "
        "EQUAL on exact inputs (two forms) with pair padding, one row all "
        f"masked and holes; {row['blocks_per_sm']} blocks an SM; device "
        f"ms: kernel {row['ms']:.4f} (attention.cu's tiled forward, forced: "
        f"{t_tiled:.4f}), plain {row['plain_ms']:.4f}, "
        f"scaled_dot_product_attention {row['library_ms']:.4f}, bound "
        f"{row['bound'][0]:.4f} ({row['bound'][1]}; {row['real_keys']} "
        "real keys)")
    del q, k, v, mask, amask, qt, kt, vt


def _residual_norm(ctx):
    """The fused dropout -> residual add -> LayerNorm (residual_norm.cu)
    held to its plain version on card tensors at RN_SHAPES, element by
    element (ops/residual_norm.py::compare_to_plain: one bf16 ulp plus
    what the order of the fp32 row sums moves), forward and backward at
    the train shape, the forward alone at the teacher's; each timed beside
    the plain chain, the same chain with the library's LayerNorm
    (F.layer_norm, bf16 weight and bias) and its bound: the bytes of the
    tensors it reads and writes, each once (the backward's partial rows
    of dw and db, its own traffic, are not counted)."""
    import torch.nn.functional as F

    from cldrd_tpu_torch.ops import residual_norm as rn

    dev, gen, bf16 = ctx["dev"], ctx["gen"], torch.bfloat16
    timings = ctx.setdefault("timings", {})
    fwd_rows, errs = {}, {}

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts if t is not None)

    for tag, (rows, d, p, grad) in RN_SHAPES.items():
        x, r, dy = (torch.randn(rows, d, generator=gen, device=dev).to(bf16)
                    for _ in range(3))
        w = 1 + 0.1 * torch.randn(d, generator=gen, device=dev)
        b = 0.1 * torch.randn(d, generator=gen, device=dev)
        u = torch.rand(rows, d, generator=gen, device=dev) if p else None
        errs[tag] = rn.compare_to_plain(x, r, w, b, RN_EPS, u, p,
                                        dy if grad else None)
        leaves = [t.clone().requires_grad_(grad) for t in (x, r, w, b)]

        def plain():
            return rn.dropout_add_layer_norm_plain(*leaves, RN_EPS, u, p)

        def library():
            xx, rr, ww, bb = leaves
            if u is not None:
                xx = torch.where(u >= p, xx / (1.0 - p),
                                 torch.zeros_like(xx))
            return F.layer_norm(xx + rr, (d,), ww.to(bf16), bb.to(bf16),
                                RN_EPS)

        def fwd():
            return rn._launch_fwd(x, r, w, b, RN_EPS, u, p, grad)

        y, s, keep, stats = fwd()
        with torch.set_grad_enabled(grad):
            fwd_rows[tag] = dict(
                ms=device_ms(fwd), plain_ms=device_ms(plain),
                library_ms=device_ms(library),
                bound=bound_ms(nbytes(x, r, u, w, b, y, *(
                    (s, keep, stats) if grad else ())), 0, "fp32"),
                library_note="the chain with F.layer_norm",
                T=rows, D=d, p=p, gradient=grad)
        if grad:
            def bwd():
                return rn._launch_bwd(dy, s, keep, stats, w, p, True)

            y_plain, y_lib = plain(), library()
            outs = bwd()
            timings["residual_norm_bwd"] = {tag: dict(
                ms=device_ms(bwd),
                plain_ms=device_ms(lambda: torch.autograd.grad(
                    y_plain, leaves, dy, retain_graph=True)),
                library_ms=device_ms(lambda: torch.autograd.grad(
                    y_lib, leaves, dy, retain_graph=True)),
                bound=bound_ms(nbytes(dy, s, keep, stats, w, *outs), 0,
                               "fp32"),
                library_note="the chain with F.layer_norm",
                T=rows, D=d, p=p)}
            del y_plain, y_lib, outs
        del x, r, dy, w, b, u, leaves, y, s, keep, stats
        torch.cuda.empty_cache()
    timings["residual_norm_fwd"] = fwd_rows
    ctx["rn_err"] = errs
    for tag, row in fwd_rows.items():
        rows = [("forward", row)]
        if tag in timings["residual_norm_bwd"]:
            rows.append(("backward", timings["residual_norm_bwd"][tag]))
        log(f"[kernels] residual_norm.cu at T={row['T']} D={row['D']} bf16 "
            f"p={row['p']}, residual, gradient {row['gradient']}: agrees "
            f"with the plain version (max abs err {errs[tag]}; one bf16 ulp "
            "plus the row sums' order); device ms: " + "; ".join(
                f"{what} {t['ms']:.4f} (plain {t['plain_ms']:.4f}, with "
                f"F.layer_norm {t['library_ms']:.4f}, bound "
                f"{t['bound'][0]:.4f} {t['bound'][1]})" for what, t in rows))


def _ladder_mask(ctx, b, length):
    """Keys padded as one length bucket's rows are: each row's real
    tokens past the next shorter bucket (a bucket holds the rows longer
    than the one below it), one row with no real key, and the last
    eighth of the batch all padding (a bucket's partial last batch)."""
    n = torch.randint(length // 2 + 1, length + 1, (b, 1),
                      generator=ctx["gen"], device=ctx["dev"])
    mask = (torch.arange(length, device=ctx["dev"])[None] < n).int()
    mask[1] = 0
    mask[b - b // 8:] = 0
    return mask


def _ladder_checks(ctx):
    """K5 at every shape of the length buckets' ladder (LADDER_SHAPES),
    through the route _kernel_route gives each (short, d64, d32), with a
    bucket's padding (_ladder_mask): within 2e-2 of the largest magnitude
    of attention_plain on normal data, EQUAL to it on the exact forms
    (the d64 route also with a mask that has holes); timed beside the
    plain version, its bound (real keys only) and SDPA, and the d64
    route beside the sm90 forward at p=0 forced (its earlier route)."""
    import torch.nn.functional as F

    from cldrd_tpu_torch.ops import attention as att

    dev, bf16 = ctx["dev"], torch.bfloat16
    names = {"short": "attention_infer", "d64": "attention_infer_d64",
             "d32": "attention_infer_d32"}
    for b, length, h, d in LADDER_SHAPES:
        route = att._kernel_route(bf16, length, d, "infer")
        shape = (b, length, h, d)
        mask = _ladder_mask(ctx, b, length)
        q, k, v = (torch.randn(shape, generator=ctx["gen"], device=dev)
                   .to(bf16) for _ in range(3))
        masks = {"bucket": mask}
        if route == "d64":
            masks["holes"] = _holed_mask(ctx, b, length)
        errs = {}
        for mtag, m in masks.items():
            ref = att.attention_plain(q, k, v, m)
            errs[mtag] = err = (att.flash_attention(q, k, v, m).float()
                                - ref.float()).abs().max().item()
            if not err <= 2e-2 * ref.float().abs().max().item():
                raise AssertionError(f"K5 {route} bucket B={b} L={length} "
                                     f"D={d} ({mtag}): max abs err "
                                     f"{err:.3g}")
            del ref
            for form, xs in _exact_forms(dev, shape).items():
                got = att.flash_attention(*xs, m)
                want = att.attention_plain(*xs, m)
                if not (want.abs().max() > 0 and torch.equal(got, want)):
                    raise AssertionError(
                        f"K5 {route} bucket B={b} L={length} D={d} exact "
                        f"({form}, {mtag}): {int((got != want).sum())} "
                        "elements differ from the plain version")
                del got, want
        amask = (mask != 0)[:, None, None, :]
        # SDPA's rows with no key give NaN: let them attend to key 0
        amask[(mask == 0).all(1), :, :, 0] = True
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        keys = int(mask.sum())
        nbytes, ops = _attn_bytes_ops(b, length, bf16, 4, 2, heads=h,
                                      head_dim=d, keys=keys)
        k5 = lambda: att.flash_attention(q, k, v, mask)  # noqa: E731
        row = dict(
            ms=device_ms(k5),
            plain_ms=device_ms(lambda: att.attention_plain(q, k, v, mask),
                               reps=3, warmup=1),
            bound=bound_ms(nbytes, ops, "bf16"),
            library_ms=device_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=amask)),
            route=route, real_keys=keys, B=b, L=length, H=h, D=d)
        old = ""
        if route == "d64":
            with _k5_sm90():
                row["sm90_ms"] = device_ms(k5)
            old = f" (the sm90 forward, forced: {row['sm90_ms']:.4f})"
        ctx.setdefault("timings", {}).setdefault(names[route], {})[
            f"bucket_{b}x{length}"] = row
        key = "k5_teacher_err" if route == "d32" else "k5_err"
        ctx[key] = max(ctx.get(key, 0.0), *errs.values())
        log(f"[kernels] K5 {route} at the bucket shape B={b} L={length} "
            f"H={h} D={d} bf16 (a bucket's padding, one row and the last "
            f"eighth all masked{'; holes' if len(masks) > 1 else ''}): max "
            f"abs err {errs} (tolerance 2e-2 of the largest magnitude), "
            "EQUAL on exact inputs (two forms); device ms: kernel "
            f"{row['ms']:.4f}{old}, plain {row['plain_ms']:.4f}, "
            f"scaled_dot_product_attention {row['library_ms']:.4f}, bound "
            f"{row['bound'][0]:.4f} ({row['bound'][1]}; {keys} real keys)")
        del q, k, v, mask, masks, amask, qt, kt, vt
        torch.cuda.empty_cache()


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
    """Values within ``rtol``; the ids each side ranks above the cut
    vk + margin (vk the oracle's k-th value, margin ``rtol * |vk|``) are
    the same, except an id both sides return with values within margin of
    each other that fall on the two sides of the cut: a score at the cut,
    not a wrong id (logged with both values). Any other difference fails,
    naming the id and its values."""
    np.testing.assert_allclose(got_v, ref_v, rtol=rtol, err_msg=tag)
    for r in range(len(ref_v)):
        vk = ref_v[r, -1]
        margin = rtol * abs(vk)
        cut = vk + margin
        a = set(got_i[r][got_v[r] > cut])
        b = set(ref_i[r][ref_v[r] > cut])
        if a == b:
            continue
        gv = dict(zip(got_i[r].tolist(), got_v[r].tolist()))
        rv = dict(zip(ref_i[r].tolist(), ref_v[r].tolist()))
        for x in sorted(a ^ b):
            at_cut = (x in gv and x in rv
                      and abs(gv[x] - rv[x]) <= margin)
            log(f"[search] {tag}: query {r} id {x}: search "
                f"{gv.get(x)!r}, oracle {rv.get(x)!r}, cut {cut!r} "
                f"({'at the cut' if at_cut else 'WRONG'})")
            if not at_cut:
                raise AssertionError(f"{tag}: query {r} top-k ids differ "
                                     f"away from ties (id {x})")


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
    _compare_k1_on(ctx, "int8_full", q, codes, ids, scales, K, integer=True,
                   launches=K1_EQUAL_LAUNCHES)
    q = make_queries(SEARCH_BATCH, D, torch.bfloat16, dev, gen, False)
    _time_kernels(ctx, "int8_full", q, codes, ids, scales)
    _time_search_layer(ctx, "int8_full", s_int8, q)
    _time_search_layer(ctx, "bf16_1M", s_bf16, q)
    # K2 at the wide batch over the first segment of the int8 store, and
    # one wide topk_binmax call split into K2 and the rest of the route
    qw = make_queries(WIDE_BATCH, D, torch.bfloat16, dev, gen, False)
    seg = slice(0, N_WIDE_SEGMENT)
    _time_k2(ctx, "int8_wide", qw, codes[seg], ids[seg], scales[seg])
    _time_wide_split(ctx, s_int8, qw)
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


def _time_wide_split(ctx, index, q):
    """One topk_binmax call at the wide batch as FlatIPIndex makes it (the
    portable route: K2 per segment, then bin selection, gathers and
    top-k in plain PyTorch), traced: device ms by kernel, split into K2's
    and the rest's, beside the call's CUDA-event time."""
    from torch.profiler import ProfilerActivity, profile

    from cldrd_tpu_torch.search import mips

    q = q.to(index._query_dtype)

    def call():
        return mips.topk_binmax(q, index.embeddings, index.row_ids, K,
                                return_positions=True, on_miss="flag",
                                row_scales=index.row_scales)

    event_ms = time_ms(call, reps=1, warmup=1)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    by_name = _device_ms_by_name(prof)
    k2_ms = sum(v for name, v in by_name.items() if "fused_binmax" in name)
    total = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    ctx.setdefault("search_layer_ms", {})["int8_wide"] = dict(
        event_ms=event_ms, device_ms=total, k2_ms=k2_ms,
        rest_ms=total - k2_ms, top_kernels=top)
    log(f"[time] topk_binmax int8_wide B={q.shape[0]} k={K}: {event_ms:.3f} "
        f"ms (CUDA events); device {total:.3f} ms = K2 {k2_ms:.3f} + rest "
        f"{total - k2_ms:.3f}; largest: "
        + ", ".join(f"{name[:60]} {v:.3f}" for name, v in top))


def _search_wide(ctx, index, q_normal, q_int):
    """search_batched at batch_size=2048 (the portable route, K2 per
    segment): QPS over WIDE_BATCHES batches of normal queries, a sample
    of which must agree with the oracle within 1e-5; then integer-valued
    queries, whose sample must EQUAL it (re-scanned rows included)."""
    bz = WIDE_BATCH
    nq = bz * WIDE_BATCHES
    qn = q_normal[:nq]
    index.search_batched(qn[:bz], K, batch_size=bz)  # warm-up
    r0 = index.rescued_queries
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s, i = index.search_batched(qn, K, batch_size=bz)
    elapsed = time.perf_counter() - t0
    res = dict(queries=nq, batches=WIDE_BATCHES, seconds=elapsed,
               qps=nq / elapsed, rescued_share=(index.rescued_queries - r0)
               / nq)
    sample = _sample(nq)
    ref_v, ref_i = _oracle(index, qn[sample], K)
    _check_close("int8 wide normal", s[sample], i[sample], ref_v, ref_i)
    r1 = index.rescued_queries
    si, ii = index.search_batched(q_int, K, batch_size=bz)
    res["integer_queries_rescued"] = index.rescued_queries - r1
    sample = _sample(len(q_int))
    ref_v, ref_i = _oracle(index, q_int[sample], K)
    _check_exact("int8 wide integer", si[sample], ii[sample], ref_v, ref_i)
    res["exact_sampled"] = int(len(sample))
    ctx.setdefault("search", {})["int8_wide"] = res
    log(f"[search] int8 wide: {nq} queries ({WIDE_BATCHES} batches of {bz}) "
        f"in {elapsed:.3f} s = {res['qps']:.1f} QPS (k={K}), rescued share "
        f"{res['rescued_share']:.4f}; {len(q_int)} integer-valued queries "
        f"({res['integer_queries_rescued']} re-scanned), {len(sample)} "
        "sampled equal the exact oracle")


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
    _search_wide(ctx, store_int8, q_normal, q_int)
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


# the attention kernels' CUDA functions (K3/K4/K5 and the layout check)
ATTN_KERNEL = re.compile(r"\battn_\w+_kernel\b")


def _trace_kernels(logdir):
    """The kernel events of the one trace that ``utils.profiling.trace``
    wrote into ``logdir``, counted by device id: K1's and K2's CUDA
    functions (either route, ops/*.py::KERNEL_NAMES), the attention
    kernels, and every kernel."""
    from cldrd_tpu_torch.ops import extract_topk, fused_binmax
    from cldrd_tpu_torch.utils.profiling import read_trace

    classes = {
        name: re.compile(r"\b(?:%s)\b" % "|".join(mod.KERNEL_NAMES.values()))
        for name, mod in (("extract_topk", extract_topk),
                          ("fused_binmax", fused_binmax))}
    classes["attention"] = ATTN_KERNEL
    out = {name: {} for name in (*classes, "all")}
    events = read_trace(logdir)
    kernels = {}
    for evt in events:
        if evt.get("cat") != "kernel":
            continue
        kernels[evt["args"].get("correlation")] = evt
        dev = int(evt["args"]["device"])
        for name, pat in classes.items():
            if pat.search(evt["name"]):
                out[name][dev] = out[name].get(dev, 0) + 1
        out["all"][dev] = out["all"].get(dev, 0) + 1
    # kernel launches the host recorded whose kernel the trace lacks, by
    # where they fell in the window
    launches = [e for e in events if e.get("cat") == "cuda_runtime"
                and e["name"].startswith(("cudaLaunchKernel",
                                          "cuLaunchKernel"))]
    spans = [(e["ts"], e["ts"] + e.get("dur", 0)) for e in events
             if e.get("ph") == "X" and "ts" in e]
    t0, t1 = min(a for a, _ in spans), max(b for _, b in spans)
    out["lost_launches_ms"] = [
        [round((e["ts"] - t0) / 1e3, 3), round((t1 - e["ts"]) / 1e3, 3)]
        for e in launches if e["args"].get("correlation") not in kernels]
    return out


def _trace_bytes(logdir):
    return sum(os.path.getsize(os.path.join(logdir, f))
               for f in os.listdir(logdir))


def _check_traced_search(tag, counts, launches, devices):
    """A traced search's kernel events (``_trace_kernels``) against the
    launch counters over the call (``launches``): K1's and K2's events
    equal their launches and fall on every device of ``devices`` alike;
    every device of ``devices``, and no other, ran kernels in the window
    (its shard's search); no attention kernel ran there."""
    for name in ("extract_topk", "fused_binmax"):
        seen = sum(counts[name].values())
        if seen != launches[name]:
            raise AssertionError(
                f"{tag}: the trace holds {seen} {name} kernel events for "
                f"{launches[name]} launches ({counts[name]} by device; "
                f"launches without a kernel event at [ms after the first "
                f"event, ms before the last]: {counts['lost_launches_ms']})")
    if set(counts["all"]) != set(devices) or not all(
            counts["all"].values()):
        raise AssertionError(f"{tag}: kernel events by device "
                             f"{counts['all']}, wanted some on each of "
                             f"{sorted(set(devices))} and none elsewhere")
    per_dev = {d: counts["extract_topk"].get(d, 0)
               + counts["fused_binmax"].get(d, 0) for d in devices}
    if len(set(per_dev.values())) != 1:
        raise AssertionError(f"{tag}: search kernel events by device "
                             f"{per_dev}, wanted the same on each")
    if counts["attention"]:
        raise AssertionError(f"{tag}: attention kernels in the search's "
                             f"trace: {counts['attention']}")


_RETRIEVE_CALLS = """
import contextlib, io, json, sys, time
sys.path.insert(0, {root!r})
import chip_smoke
from cldrd_tpu_torch.cli import retrieve
out = []
for argv in {argvs!r}:
    chip_smoke.reset_launches()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = retrieve.main(argv)
    out.append({{"rc": rc, "s": time.perf_counter() - t0,
                "lines": buf.getvalue().strip().splitlines(),
                "launches": chip_smoke.read_launches()}})
print(json.dumps(out))
"""


def _retrieve_calls(argvs):
    """cli.retrieve with each of ``argvs`` in turn, in one process of its
    own, as a user runs it: torch.profiler on the card loses the first
    device records of a session, the more the longer CUPTI has run in the
    process (tools/trace_check.py; PERF.md §6), and this process has
    profiled since its kernels phase. Returns, for each call, its stdout
    lines, seconds and launches (``read_launches`` keys)."""
    out = subprocess.run(
        [sys.executable, "-c", _RETRIEVE_CALLS.format(
            root=ROOT, argvs=[list(a) for a in argvs])],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    if out.returncode:
        raise AssertionError(f"retrieve process exited {out.returncode}: "
                             f"{out.stderr[-3000:]}")
    calls = json.loads(out.stdout.strip().splitlines()[-1])
    for argv, call in zip(argvs, calls):
        if call["rc"] != 0:
            raise AssertionError(f"retrieve {argv[:2]} returned {call['rc']}")
    return calls


def _add_launches(window, more):
    for k, v in more.items():
        window[k] = window.get(k, 0) + v
    return window


def _write_training_files(work, n_q, n_pass, seed):
    """Curriculum files for label modes 8, 9 and 10 (5/10/20 relT
    passages, 25/20/10 negatives split most-hard / semi-hard): each query's
    relevant passage first among its relT, the rest random."""
    rng = np.random.default_rng(seed + 1)
    rel = {}
    with open(os.path.join(work, "qrels.tsv")) as f:
        for line in f:
            qid, _, pid, _ = line.split("\t")
            rel[int(qid)] = int(pid)
    out = {}
    for mode, (n_rel, n_neg) in (("8", (5, 25)), ("9", (10, 20)),
                                 ("10", (20, 10))):
        path = out[mode] = os.path.join(work, f"train_mode{mode}.jsonl")
        with open(path, "w") as f:
            for qid in rng.choice(n_q, TRAIN_EXAMPLES, replace=False):
                pids = [rel[int(qid)]] + [
                    int(p) for p in rng.choice(n_pass, n_rel + n_neg + 1,
                                               replace=False)
                    if p != rel[int(qid)]][:n_rel + n_neg - 1]
                f.write(json.dumps({
                    "qid": int(qid), "relT_pids": pids[:n_rel],
                    "most_hard_pids": pids[n_rel:n_rel + n_neg // 2],
                    "semi_hard_pids": pids[n_rel + n_neg // 2:]}) + "\n")
    return out


def _step_times(records, names, saved=()):
    """Seconds between consecutive steps' metrics (one sync per step at
    logging_steps=1), each run's first step left out (warm-up), and the
    step after a checkpoint save (``saved``: (run, step) pairs) too."""
    gaps = []
    for name in names:
        rs = [r for r in records if r["run"] == name]
        gaps += [b["t"] - a["t"] for a, b in zip(rs, rs[1:])
                 if (name, a["step"]) not in saved]
    return gaps


def _kernel_class(name):
    if "attn_fwd" in name or "attn_infer" in name:
        return "attention forward (K3/K5)"
    if "attn_bwd" in name:
        return "attention backward (K4)"
    low = name.lower()
    if "memcpy" in low or "memset" in low:
        return "copies to and from the host, memsets"
    if any(k in low for k in ("gemm", "xmma", "cutlass", "nvjet", "wgmma")):
        return "matmul (cuBLAS)"
    if any(k in low for k in ("adam", "multi_tensor", "foreach")):
        return "optimizer"
    return "other (elementwise, norms, reductions, copies)"


def _by_class(by_name):
    """Device ms by kernel class from device ms by kernel name."""
    out = {}
    for name, ms in by_name.items():
        out[_kernel_class(name)] = out.get(_kernel_class(name), 0.0) + ms
    return out


def _profile_steps(ctx, corpus, train_file, n_steps=3):
    """For the flat and the packed layout: device time by kernel class and
    the device's idle share over ``n_steps`` train steps of one batch
    after a warm-up step on it (torch.profiler, device activity only, so
    the tracer adds no host work to the steps), at the train phase's
    shape. One batch throughout gives every step the warm-up's shapes, as
    a run's steady state has (packed row counts only grow)."""
    from torch.profiler import ProfilerActivity, profile

    from cldrd_tpu_torch.data import HashTokenizer, NwayDataset
    from cldrd_tpu_torch.models import DistilBertConfig, DropoutRNG
    from cldrd_tpu_torch.train import TrainConfig, Trainer, make_loss_fn
    from cldrd_tpu_torch.train.trainer import batch_to_device

    dev, seed = ctx["dev"], ctx["seed"]
    cfg = TrainConfig(max_query_len=TRAIN_LQ, max_passage_len=TRAIN_LP,
                      batch_size=TRAIN_BZ, label_mode="8", seed=seed,
                      learning_rate=7e-6,
                      run_folder=os.path.join(WORK, "pipeline", "profile"))
    trainer = Trainer(cfg, DistilBertConfig(), device=dev)
    trainer.model.reset_parameters(seed=seed)
    trainer.model.to(dev).train()
    trainer.optimizer = trainer._make_optimizer(100)
    loss_fn = make_loss_fn(cfg)
    out = {}
    for kind, pack in (("flat", False), ("packed", True)):
        data = NwayDataset.create_from_files(
            corpus["queries"], corpus["collection"], train_file,
            HashTokenizer(), TRAIN_LQ, TRAIN_LP, "8", pack_passages=pack)
        batch = batch_to_device(next(data.batches(TRAIN_BZ, seed=seed)),
                                dev)

        def step(i):
            trainer._step(batch, DropoutRNG(seed, i, dev), loss_fn)

        step(0)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(1, n_steps + 1):
                step(i)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        by_name = _device_ms_by_name(prof, n_steps)
        by_class = _by_class(by_name)
        busy = sum(by_class.values())
        rows = batch.get("packed_passages", batch.get(
            "nway_passages"))["input_ids"].shape
        out[kind] = {
            "wall_ms_per_step": wall * 1e3 / n_steps,
            "device_ms_per_step": busy, "by_class_ms": by_class,
            "top_kernels_ms": dict(sorted(by_name.items(),
                                          key=lambda kv: -kv[1])[:12]),
            "idle_share": 1.0 - busy / (wall * 1e3 / n_steps),
            "passage_rows": int(rows[0] * rows[1])}
        del batch
    del trainer
    torch.cuda.empty_cache()
    return out


def phase_train(ctx):
    """cli.curriculum (three iterations, flat), cli.train --pack-passages,
    and a resume from the packed run's mid-run checkpoint, at
    DistilBERT-base width from random weights, bf16, dropout 0.1."""
    from cldrd_tpu_torch.cli import curriculum as cli_curriculum
    from cldrd_tpu_torch.cli import train as cli_train
    from cldrd_tpu_torch.ops import attention as att
    from cldrd_tpu_torch.train import latest_checkpoint
    from cldrd_tpu_torch.train.trainer import Trainer

    work = os.path.join(WORK, "pipeline")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    ctx["corpus"] = _write_corpus(work, N_PIPELINE, N_QUERIES, ctx["seed"])
    files = _write_training_files(work, N_QUERIES, N_PIPELINE, ctx["seed"])
    base = os.path.join(work, "train.yaml")
    with open(base, "w") as f:
        f.write(f"max_query_len: {TRAIN_LQ}\nmax_passage_len: {TRAIN_LP}\n"
                "warmup_steps: 2\nlogging_steps: 1\nevaluate_steps: 1000\n"
                f"compute_dtype: \"bfloat16\"\nseed: {ctx['seed']}\n")
    runs = os.path.join(work, "runs")
    # every step's metrics pass the trainer's finiteness check; record
    # them (and when they arrived) there
    records = []
    check = Trainer._check_finite

    def record(self, m, step):
        records.append({"run": self.cfg.experiment_name, "step": step,
                        "loss": m["loss"], "grad_norm": m["grad_norm"],
                        "t": time.perf_counter()})
        return check(self, m, step)

    Trainer._check_finite = record
    common = ["--config", base, "--tokenizer", "hash", "--device", "cuda",
              "--dropout", "0.1", "--attention-dropout", "0.1",
              "--batch-size", str(TRAIN_BZ), "--run-folder", runs]
    # the per-iteration evaluation builds its index on the card: record
    # each build's time and a weak reference to it (none may outlive its
    # iteration)
    from cldrd_tpu_torch import index as index_lib

    build_on_device, builds = index_lib.build_index_on_device, []

    def tracked(*a, **kw):
        gc.collect()
        if any(ref() is not None for ref, _ in builds):
            raise AssertionError("an earlier iteration's evaluation index "
                                 "is still allocated")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        index = build_on_device(*a, **kw)
        torch.cuda.synchronize()
        builds.append((weakref.ref(index), time.perf_counter() - t0))
        return index

    index_lib.build_index_on_device = tracked
    try:
        before = att.LAUNCHES["train_fwd"]
        routes = dict(att.ROUTE_LAUNCHES)
        _, t_cur = _call_cli(cli_curriculum.main, [
            "--queries", ctx["corpus"]["queries"],
            "--passages", ctx["corpus"]["collection"],
            "--training-paths", files["8"], files["9"], files["10"],
            "--epochs", "1", "1", "1", "--attention-impl", "pallas",
            "--eval-queries", ctx["corpus"]["queries"],
            "--eval-qrels", ctx["corpus"]["qrels"],
            "--eval-batch-size", str(SEARCH_BATCH),
            # k=100 over the 32,768 rows takes the extract route (K1)
            "--eval-topk", str(K_PIPELINE_EXTRACT),
            "--eval-bucket-lengths", *common])
        flat_steps = 3 * TRAIN_EXAMPLES // TRAIN_BZ
        k3_flat = att.LAUNCHES["train_fwd"] - before
        # every block but the cls_only last one, in both towers
        if k3_flat != 2 * (N_LAYERS - 1) * flat_steps:
            raise AssertionError(f"{k3_flat} K3 launches in {flat_steps} "
                                 f"flat steps ({2 * (N_LAYERS - 1)} a step "
                                 "expected)")
        # every train-attention launch of the path takes the sm90 kernels
        # (counted by route: K3 and K5 may share an entry point)
        sm90 = {e: att.ROUTE_LAUNCHES[key] - routes[key] for e, key in (
            ("attn_fwd_sm90_launch", ("train_fwd", "attn_fwd_sm90_launch")),
            ("attn_bwd_sm90_launch", ("train_bwd", "attn_bwd_sm90_launch")))}
        if set(sm90.values()) != {k3_flat}:
            raise AssertionError(f"{sm90} of {k3_flat} flat K3/K4 launches "
                                 "took the sm90 kernels")
        train = ["--queries-path", ctx["corpus"]["queries"],
                 "--passages-path", ctx["corpus"]["collection"],
                 "--training-path", files["8"], "--label-mode", "8",
                 "--num-train-epochs", "2", "--learning-rate", "7e-6",
                 "--pack-passages", *common]
        _, t_pack = _call_cli(cli_train.main, [
            *train, "--experiment-name", "packed", "--evaluate-steps",
            str(RESUME_STEP)])
        _, t_res = _call_cli(cli_train.main, [
            *train, "--experiment-name", "resumed", "--resume",
            os.path.join(runs, "packed",
                         f"checkpoint_{RESUME_STEP}.pth.tar")])
    finally:
        Trainer._check_finite = check
        index_lib.build_index_on_device = build_on_device
    gc.collect()
    if len(builds) != 3 or any(ref() is not None for ref, _ in builds):
        raise AssertionError(f"{len(builds)} evaluation index builds, or "
                             "one still allocated after the curriculum")
    with open(os.path.join(runs, "curriculum_eval.tsv")) as f:
        table = [line.rstrip("\n").split("\t") for line in f]
    evals = [dict(zip(table[0], map(float, row))) for row in table[1:]]
    if len(evals) != 3 or not all(np.isfinite(list(e.values())).all()
                                  for e in evals):
        raise AssertionError(f"curriculum_eval.tsv: {table}")
    bad = [r for r in records
           if not (np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]))]
    if bad or not records:
        raise AssertionError(f"non-finite training metrics: {bad[:3]}")
    by = {(r["run"], r["step"]): r for r in records}
    nxt = RESUME_STEP + 1
    straight = by[("packed", nxt)]["loss"]
    resumed = by[("resumed", nxt)]["loss"]
    if abs(resumed - straight) > 1e-6 * abs(straight):
        raise AssertionError(f"resumed step {nxt} loss {resumed!r} != the "
                             f"uninterrupted run's {straight!r}")
    packed_steps = 2 * TRAIN_EXAMPLES // TRAIN_BZ
    if sorted(s for (r, s) in by if r == "resumed") != list(
            range(nxt, packed_steps + 1)):
        raise AssertionError(f"the resumed run did not start at step {nxt}")
    flat = _step_times(records, [f"curriculum_iter{i}" for i in (1, 2, 3)])
    packed = _step_times(records, ["packed", "resumed"],
                         saved={("packed", RESUME_STEP)})
    res = {"curriculum_s": t_cur, "packed_s": t_pack, "resume_s": t_res,
           "eval_build_s": [t for _, t in builds],
           "eval_build_passages_per_s": [N_PIPELINE / t for _, t in builds],
           "eval_mrr10": [e["MRR@10"] for e in evals],
           "flat_step_ms": float(np.median(flat)) * 1e3,
           "packed_step_ms": float(np.median(packed)) * 1e3,
           "flat_steps_ms": [x * 1e3 for x in flat],
           "packed_steps_ms": [x * 1e3 for x in packed],
           "resume_loss_equal": resumed == straight,
           "losses": {f"{r['run']}:{r['step']}": r["loss"] for r in records},
           "grad_norms": [r["grad_norm"] for r in records]}
    for kind in ("flat", "packed"):
        res[f"{kind}_examples_per_s"] = TRAIN_BZ / res[f"{kind}_step_ms"] * 1e3
    profiles = _profile_steps(ctx, ctx["corpus"], files["8"])
    for kind, prof in profiles.items():
        res[f"{kind}_profile"] = prof
        log(f"[train] {kind} step, profiled ({prof['passage_rows']} passage "
            f"rows of {TRAIN_LP}): {prof['wall_ms_per_step']:.1f} ms wall, "
            f"{prof['device_ms_per_step']:.1f} ms of kernels (idle share "
            f"{prof['idle_share']:.3f}): " + ", ".join(
                f"{k} {v:.1f} ms" for k, v in sorted(
                    prof["by_class_ms"].items(), key=lambda kv: -kv[1])))
        for name, ms in prof["top_kernels_ms"].items():
            log(f"[train]   {ms:8.3f} ms  {name[:110]}")
    ctx["train"] = res
    ctx["trained_ckpt"] = latest_checkpoint(
        os.path.join(runs, "curriculum_iter3"))
    log(f"[train] cli.curriculum, 3 iterations x {TRAIN_EXAMPLES // TRAIN_BZ}"
        f" steps (bz {TRAIN_BZ}, nway {NWAY}, Lq {TRAIN_LQ}, Lp {TRAIN_LP}, "
        f"bf16, dropout 0.1, flat): {t_cur:.1f} s, {k3_flat} K3 launches, "
        f"all through attn_fwd_sm90/attn_bwd_sm90; "
        f"cli.train --pack-passages: {t_pack:.1f} s; resume from step "
        f"{RESUME_STEP}: {t_res:.1f} s, step {nxt} loss {resumed!r} "
        f"{'EQUAL to' if resumed == straight else 'within 1e-6 of'} the "
        f"uninterrupted run's {straight!r}")
    log(f"[train] the per-iteration evaluation (--eval-bucket-lengths, "
        f"the default ladder, batch {SEARCH_BATCH}): 3 on-card index builds "
        f"of {N_PIPELINE} passages in "
        + ", ".join(f"{t:.2f}" for t in res["eval_build_s"])
        + " s (" + ", ".join(f"{r:.1f}" for r in
                             res["eval_build_passages_per_s"])
        + " passages/s, host tokenization included), each freed before "
        "the next iteration; MRR@10 " + ", ".join(
            f"{m:.4f}" for m in res["eval_mrr10"]))
    log(f"[train] step: flat {res['flat_step_ms']:.1f} ms "
        f"({res['flat_examples_per_s']:.1f} examples/s), packed "
        f"{res['packed_step_ms']:.1f} ms ({res['packed_examples_per_s']:.1f} "
        f"examples/s); median over {len(flat)} and {len(packed)} steps; "
        f"{len(records)} steps, every loss and grad norm finite")


def phase_pipeline(ctx):
    from cldrd_tpu_torch.cli import evaluate as cli_evaluate
    from cldrd_tpu_torch.cli import index as cli_index
    from cldrd_tpu_torch.cli import retrieve as cli_retrieve
    from cldrd_tpu_torch.ops import extract_topk as k1_mod

    work = os.path.join(WORK, "pipeline")
    n_pass, n_q = N_PIPELINE, N_QUERIES
    paths = ctx["corpus"]
    ckpt = ctx["trained_ckpt"]  # the curriculum's last checkpoint
    common = ["--checkpoint", ckpt, "--tokenizer", "hash", "--device", "cuda"]
    from cldrd_tpu_torch import native
    from cldrd_tpu_torch.data import loaders

    for name in ("_tsvparse", "_jsonlparse"):
        native.load(name)  # raises if a parser does not build
    parses = dict(loaders.PARSES)
    idx = os.path.join(work, "index")
    lines, t_index = _call_cli(cli_index.main, [
        "--collection", paths["collection"], "--out", idx,
        "--max-length", str(TRAIN_LP), "--batch-size", "512",
        "--attention-impl", "pallas", "--ivf-nlist", "16", *common])
    enc = json.loads(lines[-1])
    from cldrd_tpu_torch.index import IVFIndex

    ivf = IVFIndex.load(os.path.join(idx, "ivf"), device=ctx["dev"])
    if ivf.n_vectors != n_pass or enc["ivf_buckets"] != ivf.n_buckets:
        raise AssertionError(f"the pipeline's IVF companion holds "
                             f"{ivf.n_vectors} of {n_pass} passages")
    del ivf
    log(f"[pipeline] index: {n_pass} passages at DistilBERT-base width: "
        f"encode {enc['passages_per_s']:.1f} passages/s "
        f"({enc['encode_s']:.3f} s, host tokenization included), "
        f"{t_index:.1f} s for the whole CLI; IVF companion "
        f"{enc['ivf_buckets']} buckets x {enc['ivf_slot']} in "
        f"{enc['ivf_build_s']:.1f} s")
    results = {"index_s": t_index, **enc}

    def retrieve_argv(run, hbm, k):
        return ["--index", idx, "--queries", paths["queries"], "--run", run,
                "--topk", str(k), "--max-length", str(TRAIN_LQ),
                "--search-batch-size", str(SEARCH_BATCH), "--hbm-dtype", hbm,
                "--attention-impl", "pallas", *common]

    for hbm, k in (("bfloat16", K), ("int8", K),
                   ("bfloat16", K_PIPELINE_EXTRACT)):
        run = os.path.join(work, f"run_{hbm}_{k}.tsv")
        k1_before = k1_mod.LAUNCHES
        lines, t_ret = _call_cli(cli_retrieve.main,
                                 retrieve_argv(run, hbm, k))
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
    results["traced"] = _traced_retrieve(work, retrieve_argv, results)
    results["buckets"] = _pipeline_buckets(ctx, work, idx, common, results)
    results["on_device"] = _on_device_builds(ctx, work, idx)
    results["range_search"] = _range_search_check(ctx)
    used = {k: loaders.PARSES[k] - parses[k] for k in parses}
    if used["python"] or not used["native"]:
        raise AssertionError(f"the pipeline's parses: {used} (native "
                             "parsers not in use)")
    results["parses"] = used
    log(f"[pipeline] every TSV/JSONL parse of the path took the native "
        f"parsers: {used}")
    ctx["pipeline"] = results
    # the traced retrieve's process launched kernels of this path too
    return _add_launches(read_launches(), results["traced"].pop("window"))


def _traced_retrieve(work, retrieve_argv, results):
    """The bf16 k=100 retrieve (K1's extract route) again with
    --profile-dir, in a process of its own between two untraced calls:
    every run file EQUAL to the pipeline's, and the trace's K1/K2 kernel
    events equal to the traced call's launches (K1's > 0), on cuda:0,
    with no attention kernel (the query encode's K5 runs before the
    window). The process's launches (``window``) join the pipeline's."""
    k = K_PIPELINE_EXTRACT
    logdir = os.path.join(work, f"trace_k{k}")
    runs = [os.path.join(work, f"run_bfloat16_{k}_{tag}.tsv")
            for tag in ("before", "traced", "after")]
    # untraced, traced, untraced in one process: the first call also
    # pays the process's first launches
    calls = _retrieve_calls([
        retrieve_argv(runs[0], "bfloat16", k),
        [*retrieve_argv(runs[1], "bfloat16", k), "--profile-dir", logdir],
        retrieve_argv(runs[2], "bfloat16", k)])
    window = {}
    for call in calls:
        _add_launches(window, call["launches"])
    traced = calls[1]["launches"]
    launches = {n: traced[n] for n in ("extract_topk", "fused_binmax")}
    with open(os.path.join(work, f"run_bfloat16_{k}.tsv"), "rb") as f:
        want = f.read()
    for run in runs:
        with open(run, "rb") as f:
            if f.read() != want:
                raise AssertionError(f"{os.path.basename(run)}: another run "
                                     "file than the pipeline's own call")
    if launches["extract_topk"] <= 0:
        raise AssertionError("the traced retrieve launched no extract_topk")
    counts = _trace_kernels(logdir)
    _check_traced_search("pipeline --profile-dir", counts, launches, [0])
    qps = [json.loads(c["lines"][-1])["qps"] for c in calls]
    out = {"qps_untraced_traced_untraced": qps,
           "retrieve_s": [c["s"] for c in calls],
           "trace_bytes": _trace_bytes(logdir), "launches": launches,
           "kernel_events": {n: sum(counts[n].values()) for n in (
               "extract_topk", "fused_binmax", "attention", "all")},
           "window": window}
    log(f"[pipeline] retrieve --profile-dir (bf16, k={k}) in a process of "
        f"its own, between two untraced calls: every run file EQUAL the "
        f"pipeline's; trace {out['trace_bytes']} bytes, "
        f"{out['kernel_events']['all']} kernel events, of them K1 "
        f"{out['kernel_events']['extract_topk']} / K2 "
        f"{out['kernel_events']['fused_binmax']} (= launches {launches}), "
        f"no attention kernel; search QPS untraced / traced / untraced "
        f"{qps[0]:.1f} / {qps[1]:.1f} / {qps[2]:.1f}; seconds a call "
        + " / ".join(f"{c['s']:.2f}" for c in calls))
    return out


def _pallas_model_config():
    """The trained checkpoint's config (DistilBERT-base) with K5 in its
    encodes (``attention_impl="pallas"``)."""
    from cldrd_tpu_torch.models import DistilBertConfig

    return DistilBertConfig(attention_impl="pallas")


def _row_dist(a, b):
    """The largest per-row ||a - b|| (rows aligned by id) over the rows'
    spread about their mean in ``b`` (the root mean square of
    ||b - mean(b)||): the rows of a trained tower share one direction, so
    their norms would hide how far a row moved among the others."""
    spread = np.sqrt(((b - b.mean(0)) ** 2).sum(1).mean())
    return float(np.linalg.norm(a - b, axis=1).max() / spread)


def _mask_ignored_dist(ctx, texts):
    """The same distance for an encoder that ignores the attention mask
    (the plain attention over every key): ``texts`` encoded at their
    length buckets' widths against the same at the flat width. A port
    that let padding into attention would read this, not ~1e-2."""
    from cldrd_tpu_torch.cli.common import build_tokenizer, load_dual_encoder
    from cldrd_tpu_torch.data.bucketing import (
        default_bucket_lengths,
        required_lengths,
    )
    from cldrd_tpu_torch.index.builder import make_encode_fn

    cfg = _pallas_model_config()
    model = load_dual_encoder(ctx["trained_ckpt"], cfg, False, False,
                              torch.bfloat16, ctx["dev"])
    encode = make_encode_fn(model, "passage_embs")
    tok = build_tokenizer("hash", vocab_size=cfg.vocab_size)(texts, TRAIN_LP)
    ladder = np.asarray(default_bucket_lengths(TRAIN_LP))
    widths = ladder[np.searchsorted(ladder,
                                    required_lengths(tok["attention_mask"]))]
    with _plain_attention(ignore_mask=True):
        flat = encode(tok).cpu().numpy()
        bucketed = np.empty_like(flat)
        for w in np.unique(widths):
            rows = np.flatnonzero(widths == w)
            bucketed[rows] = encode({k: v[rows, :w] for k, v in
                                     tok.items()}).cpu().numpy()
    del model
    return _row_dist(bucketed, flat)


def _pipeline_buckets(ctx, work, flat_idx, common, results):
    """cli.index --bucket-lengths (the default ladder) with live
    tokenization, then with --token-cache twice (the first call writes
    the cache, the second reads it): passages/s of each beside the flat
    store's; the same id set as the flat store and per-row embeddings
    within BUCKET_EMB_TOL of it (the mask ignored must miss it); the
    cache's two stores EQUAL; retrieve + evaluate over the bucketed
    store, MRR@10 beside the flat store's."""
    from cldrd_tpu_torch.cli import evaluate as cli_evaluate
    from cldrd_tpu_torch.cli import index as cli_index
    from cldrd_tpu_torch.cli import retrieve as cli_retrieve
    from cldrd_tpu_torch.data import load_passages
    from cldrd_tpu_torch.index.persistence import read_embeddings

    paths = ctx["corpus"]
    cache = os.path.join(work, "token_cache")
    base = ["--collection", paths["collection"], "--max-length", str(TRAIN_LP),
            "--batch-size", "512", "--attention-impl", "pallas",
            "--bucket-lengths", *common]
    runs = {}
    for name, extra in (("bucketed", []),
                        ("cache_write", ["--token-cache", cache]),
                        ("cache_read", ["--token-cache", cache])):
        out = os.path.join(work, f"index_{name}")
        lines, t = _call_cli(cli_index.main, [*base, "--out", out, *extra])
        runs[name] = dict(_last_json(lines), seconds=t, out=out)
    if ("token_cache_write_s" not in runs["cache_write"]
            or "token_cache_write_s" in runs["cache_read"]):
        raise AssertionError("the token cache was not written once and "
                             "read once")
    flat_e, flat_ids = read_embeddings(flat_idx)
    order = np.argsort(flat_ids)
    stores, dists = {}, {}
    for name, r in runs.items():
        e, ids = read_embeddings(r.pop("out"))
        o = np.argsort(ids)
        if not np.array_equal(ids[o], flat_ids[order]):
            raise AssertionError(f"the {name} store's ids differ from the "
                                 "flat store's")
        if np.array_equal(ids, flat_ids):
            raise AssertionError(f"the {name} store's rows are in the flat "
                                 "order (no buckets)")
        stores[name] = e[o]
        dists[name] = _row_dist(e[o], flat_e[order])
    if not np.array_equal(stores["cache_read"], stores["cache_write"]):
        raise AssertionError("two encodes of the cache differ")
    passages = load_passages(paths["collection"])
    wrong = _mask_ignored_dist(ctx, [passages[int(i)] for i in
                                     flat_ids[order][:BUCKET_SAMPLE]])
    if not max(dists.values()) <= BUCKET_EMB_TOL < wrong:
        raise AssertionError(f"bucketed stores' distance from the flat "
                             f"store {dists}, mask ignored {wrong:.3g} "
                             f"(tolerance {BUCKET_EMB_TOL})")
    run = os.path.join(work, "run_bucketed.tsv")
    lines, _ = _call_cli(cli_retrieve.main, [
        "--index", os.path.join(work, "index_cache_read"), "--queries",
        paths["queries"], "--run", run, "--topk", str(K), "--max-length",
        str(TRAIN_LQ), "--search-batch-size", str(SEARCH_BATCH),
        "--hbm-dtype", "bfloat16", "--attention-impl", "pallas", *common])
    _check_run_file(run, N_QUERIES, K, N_PIPELINE)
    metrics = json.loads("\n".join(_call_cli(cli_evaluate.main, [
        "--qrels", paths["qrels"], "--run", run])[0]))
    n = N_PIPELINE
    res = {"runs": runs, "row_dist": dists, "mask_ignored_dist": wrong,
           "mrr10": metrics["MRR@10"],
           "cache_write_passages_per_s":
               n / runs["cache_write"]["token_cache_write_s"]}
    log(f"[pipeline] encode passages/s ({n} passages, batch 512 at L="
        f"{TRAIN_LP}, --attention-impl pallas): flat "
        f"{results['passages_per_s']:.1f}; --bucket-lengths (default "
        f"ladder) with live tokenization "
        f"{runs['bucketed']['passages_per_s']:.1f}; --token-cache write "
        f"{res['cache_write_passages_per_s']:.1f} (tokenize + write, "
        f"{runs['cache_write']['token_cache_write_s']:.2f} s), then its "
        f"bucketed encode {runs['cache_write']['passages_per_s']:.1f}; "
        f"cache read + buckets {runs['cache_read']['passages_per_s']:.1f} "
        "(CLI seconds "
        + ", ".join(f"{r['seconds']:.1f}" for r in runs.values()) + ")")
    log(f"[pipeline] bucketed stores: the flat store's {n} ids, per-row "
        f"distance from it {dists} (tolerance {BUCKET_EMB_TOL}; the "
        f"encoder with the mask ignored: {wrong:.3g} over "
        f"{BUCKET_SAMPLE} passages); the cache's two stores EQUAL; "
        f"MRR@10 {metrics['MRR@10']:.4f} through the bucketed store, "
        f"{results[f'bfloat16_k{K}']['mrr10']:.4f} through the flat one")
    return res


def _same_index(tag, got, want, n, q, k):
    """Two stores of the same n rows: the same ids, row for row, EQUAL
    rows (and scales), rows past n unused (id -1, finite scale), and
    EQUAL searches."""
    if not torch.equal(got.row_ids[:n], want.row_ids[:n]) or bool(
            (got.row_ids[n:] >= 0).any()):
        raise AssertionError(f"{tag}: row ids differ")
    if not torch.equal(got.embeddings[:n], want.embeddings[:n]):
        raise AssertionError(f"{tag}: stored rows differ")
    if want.row_scales is not None and not (
            torch.equal(got.row_scales[:n], want.row_scales[:n])
            and bool(torch.isfinite(got.row_scales).all())):
        raise AssertionError(f"{tag}: row scales differ or are not finite")
    gv, gi = got.search(q, k)
    wv, wi = want.search(q, k)
    if not (np.array_equal(gi, wi) and np.array_equal(gv, wv)):
        raise AssertionError(f"{tag}: searches differ")


def _on_device_builds(ctx, work, flat_idx):
    """build_index_on_device from the token cache (bf16 and int8, flat
    and with the default ladder) against FlatIPIndex.build over
    encode_dataset of the same batch stream: the same row ids and EQUAL
    rows, scales and searches (k=100, 512 queries); and reconstruct on
    the flat bf16 and int8 stores against the flat CLI store's rows
    rounded to bf16 and quantized per row. The flat builds (every row at
    L=256) take a cache of the first N_ONDEVICE_FLAT passages."""
    from cldrd_tpu_torch.cli.common import build_tokenizer, load_dual_encoder
    from cldrd_tpu_torch.data import (
        SequenceDataset,
        TokenCacheDataset,
        load_passages,
        write_token_cache,
    )
    from cldrd_tpu_torch.index import (
        FlatIPIndex,
        build_index_on_device,
        encode_dataset,
        make_encode_fn,
        quantize_rows,
    )
    from cldrd_tpu_torch.index.persistence import read_embeddings

    dev = ctx["dev"]
    model = load_dual_encoder(ctx["trained_ckpt"], _pallas_model_config(),
                              False, False, torch.bfloat16, dev)
    encode = make_encode_fn(model, "passage_embs")
    passages = load_passages(ctx["corpus"]["collection"])
    sub = os.path.join(work, "token_cache_flat")
    write_token_cache(SequenceDataset(
        {pid: passages[pid] for pid in list(passages)[:N_ONDEVICE_FLAT]},
        build_tokenizer("hash", vocab_size=model.config.vocab_size),
        TRAIN_LP, is_query=False), sub)
    caches = {None: TokenCacheDataset(sub),
              (): TokenCacheDataset(os.path.join(work, "token_cache"))}
    q = make_queries(SEARCH_BATCH, D, torch.bfloat16, dev, ctx["gen"], False)
    disk_e, disk_ids = read_embeddings(flat_idx)
    rows = np.arange(0, N_ONDEVICE_FLAT, N_ONDEVICE_FLAT // 64)
    pick = disk_ids[rows]
    if not np.array_equal(caches[None].ids, disk_ids[:N_ONDEVICE_FLAT]):
        raise AssertionError("the flat store's first rows are not the "
                             "sub-cache's passages")
    res = {}
    for ladder, ds in caches.items():
        tag = "flat" if ladder is None else "bucketed"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        embs, ids = encode_dataset(encode, ds, 512, bucket_lengths=ladder)
        t_host = time.perf_counter() - t0
        for dtype in (torch.bfloat16, torch.int8):
            name = f"{tag}_{str(dtype)[6:]}"
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            index = build_index_on_device(encode, ds, 512, D, dtype=dtype,
                                          bucket_lengths=ladder, device=dev)
            torch.cuda.synchronize()
            t_dev = time.perf_counter() - t0
            host = FlatIPIndex.build(embs, ids, dtype=dtype, device=dev)
            _same_index(f"on-device build {name}", index, host, len(ids), q,
                        K_PIPELINE_EXTRACT)
            if ladder is None:  # the CLI's flat store, read back
                got = index.reconstruct(pick)
                if dtype == torch.int8:
                    codes, sc = quantize_rows(disk_e[rows])
                    want = codes.astype(np.float32) * sc[:, None]
                else:
                    want = torch.from_numpy(disk_e[rows]).to(
                        torch.bfloat16).float().numpy()
                if not np.array_equal(got, want):
                    raise AssertionError(f"reconstruct {name} differs from "
                                         "the CLI's flat store")
            res[name] = {"build_s": t_dev, "passages_per_s": len(ids) / t_dev,
                         "encode_dataset_s": t_host,
                         "rows": int(index.embeddings.shape[0])}
            del index, host
        del embs
    del model
    torch.cuda.empty_cache()
    log("[pipeline] build_index_on_device from the token cache: the same "
        "row ids and EQUAL rows, scales and k=100 searches as "
        "FlatIPIndex.build over encode_dataset of the same stream; "
        + "; ".join(f"{k} {v['build_s']:.2f} s ({v['passages_per_s']:.1f} "
                    f"passages/s, {v['rows']} rows; encode_dataset "
                    f"{v['encode_dataset_s']:.2f} s)" for k, v in res.items())
        + f"; reconstruct of {len(pick)} ids EQUAL to the CLI's flat store "
        "rounded to bf16 and quantized per row")
    return res


def _range_search_check(ctx):
    """range_search over a 1,048,576 x 768 int8 store with scales, on
    8 integer-valued queries: every dot is exact, so the hits must EQUAL
    an exact oracle's (full matmul, strictly above the radius), sorted.
    The radius is the largest 1,536th score of the queries, so the
    search runs at depths RANGE_K_START and 2 x RANGE_K_START (K1 at
    k=1024 and 2048); a max_passes of 1 must raise; reconstruct
    dequantizes the stored codes."""
    from cldrd_tpu_torch.index import FlatIPIndex

    dev, gen = ctx["dev"], ctx["gen"]
    st = Store(N_KERNEL, D, torch.int8, dev, gen, True)
    index = FlatIPIndex.from_tensors(st.c, st.ids, st.scales)
    q = make_queries(8, D, torch.bfloat16, dev, gen, True)
    exact = (q.float() @ st.c.float().T) * st.scales[None, :]
    # the largest (1.5 k_start)-th score: one query needs the second depth
    rank = RANGE_K_START * 3 // 2 - 1
    radius = float(exact.sort(dim=1, descending=True).values[:, rank].max())
    depths, search = [], index.search

    def counted(queries, k):
        depths.append(k)
        return search(queries, k)

    index.search = counted
    q_np = q.float().cpu().numpy()
    t0 = time.perf_counter()
    lims, scores, ids = index.range_search(q_np, radius,
                                           k_start=RANGE_K_START)
    seconds = time.perf_counter() - t0
    depths = list(depths)  # the max_passes check below searches too
    if depths != [RANGE_K_START, 2 * RANGE_K_START]:
        raise AssertionError(f"range_search depths {depths}")
    for i in range(len(q_np)):
        keep = exact[i] > radius
        want_v, order = exact[i][keep].sort(descending=True, stable=True)
        want_i = st.ids[keep][order]
        got_i, got_v = ids[lims[i]:lims[i + 1]], scores[lims[i]:lims[i + 1]]
        if not (np.array_equal(got_v, want_v.cpu().numpy())
                and set(got_i.tolist()) == set(want_i.cpu().tolist())):
            raise AssertionError(f"range_search query {i}: "
                                 f"{len(got_i)} hits, oracle {int(keep.sum())}")
    try:
        index.range_search(q_np, radius, k_start=RANGE_K_START, max_passes=1)
        raise AssertionError("range_search with max_passes=1 did not raise")
    except RuntimeError as e:
        if "unsaturated" not in str(e):
            raise
    pick = np.arange(0, N_KERNEL, N_KERNEL // 64)
    got = index.reconstruct(pick)
    want = (st.c[torch.from_numpy(pick).to(dev)].float()
            * st.scales[torch.from_numpy(pick).to(dev)][:, None])
    if not np.array_equal(got, want.cpu().numpy()):
        raise AssertionError("reconstruct of the int8 store differs")
    hits = np.diff(lims).tolist()
    log(f"[pipeline] range_search over {N_KERNEL} x {D} int8 + scales, 8 "
        f"integer-valued queries, radius {radius!r}: depths {depths}, hits "
        f"{hits} EQUAL to the exact oracle, {seconds * 1e3:.1f} ms; "
        "max_passes=1 raises; reconstruct EQUAL to codes x scales")
    del index, st, exact
    torch.cuda.empty_cache()
    return {"radius": radius, "depths": depths, "hits": hits,
            "seconds": seconds}


# ---------------------------------------------------------------- teacher


def _last_json(lines):
    """The last JSON object a CLI printed (its log lines go to stdout
    too)."""
    start = max(i for i, line in enumerate(lines) if line.startswith("{"))
    return json.loads("\n".join(lines[start:]))


def _write_teacher(ctx, path):
    """A MiniLM-L6 cross-encoder (BertConfig.minilm_l6) with random
    weights from --seed, written as an HF BertForSequenceClassification
    state_dict (the reference teacher's checkpoint layout)."""
    from cldrd_tpu_torch.models import BertConfig, CrossEncoder
    from cldrd_tpu_torch.models.convert import cross_encoder_to_hf

    gen = torch.Generator().manual_seed(ctx["seed"] + 7)
    model = CrossEncoder(BertConfig.minilm_l6(), arch="bert")
    model.reset_parameters(gen)
    torch.save(cross_encoder_to_hf(model.state_dict(), "bert"), path)


def _teacher_model(path, impl):
    from cldrd_tpu_torch.cli.common import (
        cross_encoder_config,
        load_cross_encoder,
    )

    return load_cross_encoder(path, cross_encoder_config(
        "bert", "full", None, impl), "bert", torch.bfloat16, "cuda")


@contextlib.contextmanager
def _plain_attention(ignore_mask=False):
    """The encoder's K5 calls take attention_plain (no kernel); with
    ``ignore_mask`` they attend to every key, padding too: a deliberately
    wrong attention, whose scores show what the sample check can see."""
    from cldrd_tpu_torch.models import distilbert
    from cldrd_tpu_torch.ops import attention as att

    kernel = distilbert.flash_attention

    def plain(q, k, v, mask):
        return att.attention_plain(
            q, k, v, torch.ones_like(mask) if ignore_mask else mask)

    distilbert.flash_attention = plain
    try:
        yield
    finally:
        distilbert.flash_attention = kernel


def _score_sample(model, sample, dev):
    """The model's scores of the sampled batches' tokens, concatenated."""
    with torch.inference_mode():
        return np.concatenate([model({
            k: torch.from_numpy(v).to(dev, torch.int64)
            for k, v in tokens.items()}).float().cpu().numpy()[:len(got)]
            for tokens, got in sample])


def _teacher_sample_errors(model, sample, dev):
    """The largest |score - plain score| over the sampled batches, over
    the spread (max - min) of the plain scores: for the recorded scores,
    and for the plain attention with the mask ignored (no kernel
    launches); and the plain scores. The spread, not the largest
    magnitude: a random-init teacher's scores sit at an offset of either
    sign that its seed sets, while bf16 rounding moves a score by about
    the same amount whatever the offset (tools/teacher_check_seeds.py)."""
    from cldrd_tpu_torch.ops import attention as att

    before = att.LAUNCHES["infer"]
    with _plain_attention():
        want = _score_sample(model, sample, dev)
    with _plain_attention(ignore_mask=True):
        bad = _score_sample(model, sample, dev)
    if att.LAUNCHES["infer"] != before:
        raise AssertionError("the plain check launched a kernel")
    got = np.concatenate([g for _, g in sample])
    spread = float(want.max() - want.min())
    return (float(np.abs(got - want).max()) / spread,
            float(np.abs(bad - want).max()) / spread, want)


def _trace_score_call(fn, batch, calls=3):
    """One teacher score call (tokens to the card, the cross-encoder, the
    scores back) traced by torch.profiler (device activity only) over
    ``calls`` calls after a warm-up one: device ms a call by kernel
    class and by kernel, the call's wall ms and the device's idle share."""
    from torch.profiler import ProfilerActivity, profile

    fn(batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn(batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / calls
    by_name = _device_ms_by_name(prof, calls)
    by_class = _by_class(by_name)
    busy = sum(by_class.values())
    return {"calls": calls, "wall_ms": wall, "device_ms": busy,
            "idle_share": 1.0 - busy / wall, "by_class_ms": by_class,
            "top_kernels_ms": dict(sorted(by_name.items(),
                                          key=lambda kv: -kv[1])[:10])}


def phase_teacher(ctx):
    """The teacher and rerank path at full width: cli.retrieve_queries,
    cli.create_training_data with the MiniLM-L6 teacher, cli.rerank_eval
    (cross and dual), cli.export in both formats into cli.index."""
    from cldrd_tpu_torch.cli import create_training_data as cli_ctd
    from cldrd_tpu_torch.cli import export as cli_export
    from cldrd_tpu_torch.cli import index as cli_index
    from cldrd_tpu_torch.cli import rerank_eval as cli_rerank_eval
    from cldrd_tpu_torch.cli import retrieve_queries as cli_rq
    from cldrd_tpu_torch.index.persistence import read_embeddings
    from cldrd_tpu_torch.ops import attention as att

    t_phase = time.perf_counter()
    work = os.path.join(WORK, "teacher")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    paths, ckpt = ctx["corpus"], ctx["trained_ckpt"]
    common = ["--tokenizer", "hash", "--device", "cuda"]
    teacher = ctx["teacher_ckpt"] = os.path.join(work, "teacher.pth.tar")
    _write_teacher(ctx, teacher)
    res = {}

    # inverse retrieval: passages -> their top queries over a query index
    qidx = os.path.join(work, "qindex")
    _call_cli(cli_index.main, [
        "--collection", paths["queries"], "--out", qidx, "--max-length",
        str(TRAIN_LQ), "--checkpoint", ckpt, *common])
    p2q = os.path.join(work, "p2q.tsv")
    lines, t_rq = _call_cli(cli_rq.main, [
        "--query-index", qidx, "--passages", paths["collection"], "--run",
        p2q, "--topk", "20", "--max-length", str(TRAIN_LP),
        "--search-batch-size", str(SEARCH_BATCH), "--attention-impl",
        "pallas", "--checkpoint", ckpt, *common])
    _check_run_file(p2q, N_PIPELINE, 20, N_QUERIES)
    res["retrieve_queries"] = dict(_last_json(lines), seconds=t_rq)
    log(f"[teacher] retrieve_queries: {N_PIPELINE} passages -> top 20 of "
        f"{N_QUERIES} queries in {t_rq:.1f} s")

    # candidates: the first TEACHER_QUERIES queries' top 100 of the
    # pipeline's k=100 run
    cands = os.path.join(work, "cands.tsv")
    src = os.path.join(WORK, "pipeline", f"run_bfloat16_{K_PIPELINE_EXTRACT}"
                       ".tsv")
    n_pairs = 0
    with open(src) as f, open(cands, "w") as out:
        for line in f:
            if int(line.split("\t", 1)[0]) < TEACHER_QUERIES:
                out.write(line)
                n_pairs += 1
    if n_pairs != TEACHER_QUERIES * K_PIPELINE_EXTRACT:
        raise AssertionError(f"{n_pairs} candidate pairs")

    # the teacher scores them: record every batch's scores, keep the
    # first batches' inputs for the check against the plain attention
    make_fn = cli_ctd.make_cross_encoder_score_fn

    def recorder(seen):
        """A score-function factory that records every batch's scores
        and (qid, pid) pairs in ``seen``, and the first batches' inputs
        for the check against the plain attention."""
        seen.update(scores=[], pairs=[], sample=[], batches=0, s=0.0)

        def recording(model):
            fn = seen["fn"] = make_fn(model)

            def score(batch):
                t0 = time.perf_counter()
                out = fn(batch)
                seen["s"] += time.perf_counter() - t0
                seen["batches"] += 1
                if seen["batches"] == 3:  # a full batch, traced below
                    seen["traced"] = batch
                n = batch.n_valid
                seen["scores"].append(out[:n])
                seen["pairs"].append(np.stack([batch.qids[:n],
                                               batch.pids[:n]], 1))
                if len(seen["sample"]) * TEACHER_BATCH < TEACHER_SAMPLE:
                    seen["sample"].append((batch.query_passage, out[:n]))
                return out
            return score
        return recording

    seen = {}

    keys = {r: ("infer", f"attn_{r}_launch")
            for r in ("infer_d32", "fwd")}
    before = {r: att.ROUTE_LAUNCHES[key] for r, key in keys.items()}
    ctd_argv = [
        "--candidates-run", cands, "--queries", paths["queries"],
        "--passages", paths["collection"], "--teacher-checkpoint",
        teacher, "--teacher-arch", "bert", "--model-size", "full",
        "--attention-impl", "pallas", "--compute-dtype", "bfloat16",
        "--max-length", str(TEACHER_L), "--batch-size", str(TEACHER_BATCH),
        *common]
    cli_ctd.make_cross_encoder_score_fn = recorder(seen)
    try:
        lines, t_ctd = _call_cli(cli_ctd.main, [
            *ctd_argv, "--out-prefix", os.path.join(work, "cl_")])
    finally:
        cli_ctd.make_cross_encoder_score_fn = make_fn
    d32, tiled = (att.ROUTE_LAUNCHES[keys[r]] - before[r]
                  for r in ("infer_d32", "fwd"))
    files = _last_json(lines)
    want_batches = -(-n_pairs // TEACHER_BATCH)
    if seen["batches"] != want_batches:
        raise AssertionError(f"{seen['batches']} teacher batches")
    if d32 != (TEACHER_LAYERS - 1) * want_batches or tiled:
        raise AssertionError(f"{d32} head_dim-32 K5 launches and {tiled} "
                             f"tiled for {want_batches} teacher batches")
    scores = np.concatenate(seen["scores"])
    if scores.shape != (n_pairs,) or not np.isfinite(scores).all():
        raise AssertionError("teacher scores not finite or malformed")
    res["score_call_trace"] = trace = _trace_score_call(seen["fn"],
                                                        seen.pop("traced"))
    log(f"[teacher] one score call (B={TEACHER_BATCH} pairs, traced over "
        f"{trace['calls']} calls): wall {trace['wall_ms']:.3f} ms, device "
        f"{trace['device_ms']:.3f} ms (idle {trace['idle_share']:.1%}); by "
        "class: " + json.dumps(trace["by_class_ms"]) + "; top kernels: "
        + json.dumps(trace["top_kernels_ms"]))
    stages = {}
    for stage, path in files.items():
        rows = [json.loads(x) for x in open(path)]
        stages[stage] = len(rows)
        if len(rows) != TEACHER_QUERIES or not all(
                np.isfinite(r["relT_scores"]).all() for r in rows):
            raise AssertionError(f"{path}: {len(rows)} rows")
    if len(stages) != 4:
        raise AssertionError(f"curriculum files {sorted(stages)}")
    # the sample, scored directly with the plain attention; the same with
    # the mask ignored must miss the tolerance, or the check sees nothing
    worst, wrong, plain = _teacher_sample_errors(
        _teacher_model(teacher, "pallas"), seen["sample"], ctx["dev"])
    if not worst <= TEACHER_SAMPLE_TOL:
        raise AssertionError(f"teacher sample: max abs err {worst:.3g} of "
                             "the plain scores' spread")
    if not wrong > TEACHER_SAMPLE_TOL:
        raise AssertionError(f"teacher sample: the mask ignored reads only "
                             f"{wrong:.3g} of the plain scores' spread")
    res["create_training_data"] = dict(
        pairs=n_pairs, seconds=t_ctd, pairs_per_s=n_pairs / t_ctd,
        score_s=seen["s"], score_pairs_per_s=n_pairs / seen["s"],
        batches=want_batches, d32_launches=d32, stages=stages,
        sample_rel_err=worst, sample_mask_ignored_rel_err=wrong,
        score_range=[float(scores.min()),
                                           float(scores.max())])
    log(f"[teacher] create_training_data: {n_pairs} pairs (MiniLM-L6, bf16,"
        f" B={TEACHER_BATCH}, L={TEACHER_L}) in {t_ctd:.1f} s = "
        f"{n_pairs / t_ctd:.1f} pairs/s end to end ({n_pairs / seen['s']:.1f}"
        f" pairs/s in the score calls, {seen['s']:.1f} s); {d32} K5 "
        f"launches through attn_infer_d32_launch = {TEACHER_LAYERS - 1} x "
        f"{want_batches} batches (tiled forward: 0); every "
        "score finite; "
        f"{TEACHER_SAMPLE} sampled pairs within {worst:.3g} of the spread "
        f"of the plain attention's scores (tolerance {TEACHER_SAMPLE_TOL}; "
        f"the plain attention with the mask ignored: {wrong:.3g}); stages "
        f"{stages}")

    res["bucketed"] = _teacher_buckets(ctx, cli_ctd, recorder, ctd_argv,
                                       work, seen, plain, t_ctd)

    # rerank evaluation: the teacher (cross) and the trained tower (dual),
    # flat and with length buckets
    metrics = {}
    for mode, extra in (("cross", ["--checkpoint", teacher, "--teacher-arch",
                                   "bert", "--model-size", "full",
                                   "--max-length", str(TEACHER_L)]),
                        ("dual", ["--checkpoint", ckpt, "--max-query-len",
                                  str(TRAIN_LQ), "--max-passage-len",
                                  str(TRAIN_LP)])):
        for layout, buckets in (("flat", []),
                                ("bucketed", ["--bucket-lengths"])):
            key = mode if layout == "flat" else f"{mode}_bucketed"
            lines, t_re = _call_cli(cli_rerank_eval.main, [
                "--candidates-run", cands, "--queries", paths["queries"],
                "--passages", paths["collection"], "--qrels",
                paths["qrels"], "--mode", mode, "--batch-size",
                str(TEACHER_BATCH), "--attention-impl", "pallas", *extra,
                *buckets, *common])
            metrics[key] = dict(_last_json(lines), seconds=t_re)
            if metrics[key]["QueriesRanked"] != TEACHER_QUERIES or not all(
                    np.isfinite(v) for v in metrics[key].values()):
                raise AssertionError(f"rerank_eval {key}: {metrics[key]}")
            log(f"[teacher] rerank_eval --mode {mode} {layout} ({t_re:.1f} "
                "s): " + json.dumps({k: v for k, v in metrics[key].items()
                                     if k != "seconds"}))
    res["rerank_eval"] = metrics

    # export in both formats; each round-trips into cli.index
    sub = os.path.join(work, "subset.tsv")
    with open(paths["collection"]) as f, open(sub, "w") as out:
        for _, line in zip(range(N_EXPORT), f):
            out.write(line)
    ref_ckpt = os.path.join(work, "export.pth.tar")
    hf_dir = os.path.join(work, "hf")
    _call_cli(cli_export.main, ["--checkpoint", ckpt, "--out", ref_ckpt,
                                *common])
    _call_cli(cli_export.main, ["--checkpoint", ckpt, "--out", hf_dir,
                                "--format", "hf", *common])
    hf_ckpt = os.path.join(work, "from_hf.pth.tar")
    torch.save({"state_dict": {
        f"{t}.{k}": v for t in ("query_encoder", "passage_encoder")
        for k, v in torch.load(os.path.join(hf_dir, t, "pytorch_model.bin"),
                               weights_only=True).items()}}, hf_ckpt)
    embs = {}
    for name, c in (("trained", ckpt), ("reference", ref_ckpt),
                    ("hf", hf_ckpt)):
        out_dir = os.path.join(work, f"idx_{name}")
        _call_cli(cli_index.main, ["--collection", sub, "--out", out_dir,
                                   "--max-length", str(TRAIN_LP),
                                   "--checkpoint", c, *common])
        embs[name] = read_embeddings(out_dir)
    for name in ("reference", "hf"):
        if not (np.array_equal(embs[name][0], embs["trained"][0])
                and np.array_equal(embs[name][1], embs["trained"][1])):
            raise AssertionError(f"the {name} export indexes differently")
    log(f"[teacher] export: reference and hf formats index {N_EXPORT} "
        "passages EQUAL to the trained checkpoint")
    res["seconds"] = time.perf_counter() - t_phase
    log(f"[teacher] teacher pairs/s {n_pairs / t_ctd:.1f} (end to end); "
        f"phase {res['seconds']:.1f} s")
    ctx["teacher"] = res


def _teacher_buckets(ctx, cli_ctd, recorder, argv, work, flat, plain,
                     t_flat):
    """cli.create_training_data --bucket-lengths (the default ladder) over
    the flat run's pairs: the same pairs, every score finite, the flat
    run's sampled pairs within TEACHER_SAMPLE_TOL of the plain
    attention's scores' spread (the mask ignored misses it: checked on
    the flat run), head_dim-32 K5 launches counted by bucket length
    (TEACHER_LAYERS - 1 a batch, none through the tiled forward), and
    pairs/s beside the flat run's."""
    from cldrd_tpu_torch.ops import attention as att

    seen, make_fn = {}, cli_ctd.make_cross_encoder_score_fn
    shapes = dict(att.SHAPE_LAUNCHES)
    tiled = att.ROUTE_LAUNCHES[("infer", "attn_fwd_launch")]
    cli_ctd.make_cross_encoder_score_fn = recorder(seen)
    try:
        lines, t_ctd = _call_cli(cli_ctd.main, [
            *argv, "--bucket-lengths", "--out-prefix",
            os.path.join(work, "clb_")])
    finally:
        cli_ctd.make_cross_encoder_score_fn = make_fn
    by_len = {}
    for key, n in att.SHAPE_LAUNCHES.items():
        if key[1] == "attn_infer_d32_launch" and n > shapes.get(key, 0):
            length = f"{key[2]}x{key[3]}"
            by_len[length] = by_len.get(length, 0) + n - shapes.get(key, 0)
    if (sum(by_len.values()) != (TEACHER_LAYERS - 1) * seen["batches"]
            or att.ROUTE_LAUNCHES[("infer", "attn_fwd_launch")] != tiled):
        raise AssertionError(f"bucketed teacher: {by_len} head_dim-32 K5 "
                             f"launches for {seen['batches']} batches")
    got = dict(zip(map(tuple, np.concatenate(seen["pairs"]).tolist()),
                   np.concatenate(seen["scores"]).tolist()))
    pairs = np.concatenate(flat["pairs"])
    if set(got) != set(map(tuple, pairs.tolist())) or not np.isfinite(
            list(got.values())).all():
        raise AssertionError("bucketed teacher: other pairs, or a score "
                             "not finite")
    sample = pairs[:len(plain)]
    err = float(np.abs(np.array([got[tuple(p)] for p in sample.tolist()])
                       - plain).max()) / float(plain.max() - plain.min())
    if not err <= TEACHER_SAMPLE_TOL:
        raise AssertionError(f"bucketed teacher sample: {err:.3g} of the "
                             "plain scores' spread")
    flat_s = np.concatenate(flat["scores"])
    spread = float(flat_s.max() - flat_s.min())
    moved = float(np.abs(np.array([got[tuple(p)] for p in pairs.tolist()])
                         - flat_s).max()) / spread
    n = len(pairs)
    res = dict(pairs=n, seconds=t_ctd, pairs_per_s=n / t_ctd,
               score_s=seen["s"], score_pairs_per_s=n / seen["s"],
               batches=seen["batches"], d32_launches_by_shape=by_len,
               sample_rel_err=err, max_rel_diff_from_flat=moved,
               files=sorted(_last_json(lines)))
    log(f"[teacher] create_training_data --bucket-lengths (default ladder):"
        f" {n} pairs in {t_ctd:.1f} s = {n / t_ctd:.1f} pairs/s end to end "
        f"(flat: {n / t_flat:.1f}), {n / seen['s']:.1f} pairs/s in the "
        f"score calls ({seen['s']:.2f} s, {seen['batches']} batches); "
        f"head_dim-32 K5 launches by BxL {by_len} (tiled forward: 0); "
        f"sampled pairs within {err:.3g} of the plain attention's spread "
        f"(tolerance {TEACHER_SAMPLE_TOL}); every pair within {moved:.3g} "
        "of its flat score (of the spread)")
    return res


# ------------------------------------------------------------------ serve

# the daemons answer on localhost only; no proxy from the environment
_HTTP = urllib.request.build_opener(urllib.request.ProxyHandler({}))


def _http(url, path, payload=None, timeout=600):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url + path, data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with _HTTP.open(req, timeout=timeout) as r:
            return json.loads(r.read())
    except urllib.error.HTTPError as e:  # the service's own message
        raise AssertionError(f"{path}: HTTP {e.code}: {e.read()[:2000]!r}")


class _Daemon:
    """cli.serve in this process on a free port, served from a thread.
    ``passes`` records every device pass: its texts, query embeddings and
    the index's answer, through wrappers on the service's own pass and on
    its index's search; ``search`` is the index's unwrapped search."""

    def __init__(self, argv):
        from cldrd_tpu_torch.cli import serve as cli_serve

        args = cli_serve.build_parser().parse_args(
            [*argv, "--port", "0", "--device", "cuda", "--tokenizer", "hash",
             "--topk", str(K)])
        t0 = time.perf_counter()
        self.httpd = cli_serve.serve(args)
        self.start_s = time.perf_counter() - t0
        self.svc = self.httpd.RequestHandlerClass.service
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        self.passes = []
        index, svc = self.svc.index, self.svc
        self.search = index.search
        device_pass = svc._search_device

        def recorded_pass(texts, k):
            self.passes.append({"texts": list(texts), "calls": []})
            return device_pass(texts, k)

        def recorded_search(q, k, **kw):
            s, i = self.search(q, k, **kw)
            self.passes[-1]["calls"].append((q.detach().clone(), s, i))
            return s, i

        svc._search_device = recorded_pass
        index.search = recorded_search
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)
        self.thread.start()

    def close(self):
        self.svc.close()
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(timeout=60)
        if self.thread.is_alive():
            raise AssertionError("the serve thread did not stop")


def _pass_arrays(ps):
    """(query embeddings [n, D] fp32 on the host, scores, ids) of one
    recorded device pass."""
    embs, s, i = zip(*ps["calls"])
    return (torch.cat(embs).float().cpu().numpy(), np.concatenate(s),
            np.concatenate(i))


def _served_rows(s, i):
    """The answer the service builds from one search row: valid ids with
    their scores."""
    valid = i >= 0
    return [{"id": int(a), "score": float(b)}
            for a, b in zip(i[valid], s[valid])]


def _check_served(tag, daemon, sent, answers):
    """Every recorded pass EQUALs the index's own search of the pass's
    query embeddings (ids and scores), and every answer EQUALs the row of
    a pass that searched its text (a text sent twice may ride in two
    passes)."""
    rows = {}
    for n, ps in enumerate(daemon.passes):
        if not ps["calls"]:
            raise AssertionError(f"{tag}: pass {n} recorded no search")
        for embs, s0, i0 in ps["calls"]:
            s, i = daemon.search(embs, daemon.svc.default_k)
            if not (np.array_equal(s, s0) and np.array_equal(i, i0)):
                raise AssertionError(f"{tag}: pass {n} differs from the "
                                     "index's search of its own query "
                                     "embeddings")
        _, s, i = _pass_arrays(ps)
        for r, text in enumerate(ps["texts"]):
            rows.setdefault(text, []).append(_served_rows(s[r], i[r]))
    for texts, ans in zip(sent, answers):
        for text, ranked in zip(texts, ans["results"]):
            # every request asks for K
            if not any(ranked == row[:K] for row in rows[text]):
                raise AssertionError(f"{tag}: the answer to {text!r} is not "
                                     "its pass's search row")
    return sum(len(t) for t in sent)


def _serve_store(ctx, work, seed):
    """A clustered 1,048,576 x 768 store (SERVE_CENTERS Gaussian blobs),
    written as the int8 flat store by write_embeddings. It is drawn from
    its own generator, seeded with ``seed``, so what earlier phases draw
    does not change it. Returns (its directory, the blob centres)."""
    from cldrd_tpu_torch.index import write_embeddings

    dev = ctx["dev"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    centers = torch.randn(SERVE_CENTERS, D, generator=gen, device=dev)
    which = torch.randint(0, SERVE_CENTERS, (SERVE_ROWS,), generator=gen,
                          device=dev)
    x = centers[which] + 0.5 * torch.randn(SERVE_ROWS, D, generator=gen,
                                           device=dev)
    store = os.path.join(work, "store")
    write_embeddings(store, x.cpu().numpy(),
                     np.arange(SERVE_ROWS, dtype=np.int64), dtype="int8")
    return store, centers


def _recall_at_10(hits, ref):
    return float(np.mean([len(set(a) & set(b)) / 10.0
                          for a, b in zip(hits[:, :10], ref)]))


def _send(url, requests, clients):
    """``requests`` (lists of texts) from ``clients`` threads, each sending
    its share in turn; returns (answers, each request's seconds as its
    client saw them, wall seconds)."""
    answers = [None] * len(requests)
    took = [None] * len(requests)
    errors = []

    def client(c):
        try:
            for n in range(c, len(requests), clients):
                t0 = time.perf_counter()
                answers[n] = _http(url, "/search",
                                   {"queries": requests[n], "k": K})
                took[n] = time.perf_counter() - t0
        except Exception as e:  # reported below, after every join
            errors.append(e)

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(clients)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    wall = time.perf_counter() - t0
    if errors or any(th.is_alive() for th in threads):
        raise AssertionError(f"clients failed: {errors[:3]}")
    return answers, took, wall


@contextlib.contextmanager
def _counted(total):
    """The kernel launches of the enclosed work alone: the counts are set
    to 0 on entry and read on exit into the yielded dict, which is also
    added to ``total``."""
    span = {}
    reset_launches()
    yield span
    span.update(read_launches())
    for k, v in span.items():
        total[k] = total.get(k, 0) + v


def _one_launch_a_search(tag, passes, span):
    """Each IVF search the recorded passes made launched K6 once within
    ``span``; returns the number of searches."""
    searches = sum(len(p["calls"]) for p in passes)
    if not 0 < searches == span["ivf_probe"]:
        raise AssertionError(f"the {tag}'s {searches} IVF searches made "
                             f"{span['ivf_probe']} ivf_probe launches")
    return searches


def _serve_breakdown(svc, search, texts):
    """Where one device pass of the IVF daemon spends its time, for a pass
    of ``len(texts)`` queries (ms, host clock around synchronised work):
    tokenizing, the query encode (padded to the encode batch), the
    index's search to host arrays, K6 inside those searches (CUDA events
    around the index's own probe_scores call), and building the answer's
    hit lists and JSON."""
    from cldrd_tpu_torch.index import ivf_index

    def host_ms(fn, reps=5):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e3, out

    n = len(texts)
    t_tok, tokens = host_ms(lambda: svc._pad(
        svc.tokenizer(texts, svc.max_length), svc.encode_batch))
    t_enc, embs = host_ms(lambda: svc.encode_fn(tokens)[:n])
    kernel, events = ivf_index.probe_scores, []

    def timed_probe(q, *a, **kw):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = kernel(q, *a, **kw)
        ev[1].record()
        events.append((ev, q.shape[0]))
        return out

    ivf_index.probe_scores = timed_probe
    try:
        t_search, (s, i) = host_ms(lambda: search(embs, svc.default_k))
    finally:
        ivf_index.probe_scores = kernel
    torch.cuda.synchronize()
    if not events:
        raise AssertionError("the IVF search did not reach probe_scores")
    k6 = float(np.mean([a.elapsed_time(b) for (a, b), _ in events]))
    t_json, _ = host_ms(lambda: json.dumps({"results": [
        _served_rows(s[r], i[r]) for r in range(n)]}))
    return {"queries": n, "padded_to": events[0][1], "tokenize_ms": t_tok,
            "encode_ms": t_enc, "search_ms": t_search, "k6_ms": k6,
            "answer_json_ms": t_json}


def phase_serve(ctx):
    """The IVF serving path: cli.index --ivf-only, then cli.serve --ivf
    --hbm-dtype int8 with the trained checkpoint under 8 concurrent
    clients; then flat and IVFPQ + refine daemons. Returns the launch
    counts of the path's own work."""
    from cldrd_tpu_torch.cli import index as cli_index
    from cldrd_tpu_torch.index import load_index

    work = os.path.join(WORK, "serve")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    t0 = time.perf_counter()
    store, centers = _serve_store(ctx, work, ctx["seed"])
    t_store = time.perf_counter() - t0
    ivf_cli = ["--collection", ctx["corpus"]["collection"], "--out", store,
               "--ivf-only", "--ivf-nlist", str(SERVE_NLIST), "--ivf-nprobe",
               str(SERVE_NPROBE), "--device", "cuda"]
    # the path's launch window holds its own work alone (the index CLI, the
    # daemons' start-up with its warm-up, the clients' requests, the
    # updates); the checks below search through the same kernels outside it
    own = dict.fromkeys(read_launches(), 0)
    with _counted(own):
        lines, t_ivf = _call_cli(cli_index.main, ivf_cli)
    built = json.loads(lines[-1])
    log(f"[serve] clustered {SERVE_ROWS} x {D} int8 store in {t_store:.1f} "
        f"s; cli.index --ivf-only: {built['ivf_buckets']} buckets x "
        f"{built['ivf_slot']} rows in {t_ivf:.1f} s")
    rng = np.random.default_rng(ctx["seed"] + 2)
    with open(ctx["corpus"]["queries"]) as f:
        texts = [line.rstrip("\n").split("\t", 1)[1] for line in f]
    order = iter(rng.permutation(len(texts)))

    def draw(n_req, lo=1, hi=8):
        return [[texts[next(order)] for _ in range(int(m))]
                for m in rng.integers(lo, hi + 1, n_req)]

    common = ["--checkpoint", ctx["trained_ckpt"], "--max-length",
              str(TRAIN_LQ)]
    res = {"store_s": t_store, "ivf_build_s": t_ivf, **built}

    # --- IVF daemon, int8 store, K6
    with _counted(own) as start_k:
        dmn = _Daemon(["--index", store, "--ivf", "--hbm-dtype", "int8",
                       *common])
    try:
        ivf = dmn.svc.index
        if ivf.nprobe != SERVE_NPROBE or ivf.buckets.dtype != torch.int8:
            raise AssertionError("the daemon did not load the int8 IVF store "
                                 f"at nprobe {SERVE_NPROBE}")
        # a checked burst, then a timed window of SERVE_TIMED_REQUESTS
        # (texts drawn with replacement); the daemon's latency ring holds
        # 2,048 requests, so /healthz then reads the window alone
        sent = draw(SERVE_REQUESTS)
        with _counted(own) as burst_k:
            answers, _, burst_wall = _send(dmn.url, sent, SERVE_CLIENTS)
        searches = _one_launch_a_search("burst", dmn.passes, burst_k)
        nq_burst = _check_served("ivf", dmn, sent, answers)
        passes = list(dmn.passes)
        dmn.passes.clear()
        window = [[texts[j] for j in rng.integers(0, len(texts), m)]
                  for m in rng.integers(1, 9, SERVE_TIMED_REQUESTS)]
        with _counted(own) as timed_k:
            answers, took, wall = _send(dmn.url, window, SERVE_CLIENTS)
        health = _http(dmn.url, "/healthz")
        _one_launch_a_search("window", dmn.passes, timed_k)
        nq = _check_served("ivf timed", dmn, window, answers)
        took_ms = np.sort(np.asarray(took)) * 1e3
        timed = list(dmn.passes)
        passes += timed
        flat = load_index(store, dtype=torch.int8, device=ctx["dev"])
        # recall@10 at nprobe 32 against the exact oracle, over every
        # served query
        arrays = [_pass_arrays(p) for p in passes]
        embs = np.concatenate([a[0] for a in arrays])
        hits = np.concatenate([a[2][:, :10] for a in arrays])
        ref = np.concatenate([_oracle(flat, embs[r:r + 128], 10)[1]
                              for r in range(0, len(embs), 128)])
        recall = _recall_at_10(hits, ref)
        # how alike the served queries are: near 1, they are one query
        # and recall@10 reads that one query's luck on this store
        spread = _spread(torch.from_numpy(embs[:2048]))
        # the served queries come from a text tower the store was not made
        # by; queries from the store's own distribution (a blob centre
        # plus the store's noise), as one encoder's queries and passages
        # share a space, searched directly at the same nprobe
        pick = torch.randint(0, SERVE_CENTERS, (256,), generator=ctx["gen"],
                             device=ctx["dev"])
        q_in = (centers[pick] + 0.5 * torch.randn(
            256, D, generator=ctx["gen"], device=ctx["dev"])).cpu().numpy()
        recall_in = _recall_at_10(
            dmn.search(q_in, 10)[1],
            np.concatenate([_oracle(flat, q_in[r:r + 128], 10)[1]
                            for r in (0, 128)]))
        breakdown = _serve_breakdown(dmn.svc, dmn.search,
                                     texts[:max(1, round(nq / len(timed)))])
        # the whole probe: answers agree with the exact oracle (normal
        # queries) and EQUAL it on integer-valued ones
        ivf.nprobe = ivf.n_buckets
        dmn.passes.clear()
        full_sent = draw(4, 4, 4)
        with _counted(own):
            full = [_http(dmn.url, "/search", {"queries": t, "k": K})
                    for t in full_sent]
        _check_served("ivf full probe", dmn, full_sent, full)
        for ps in dmn.passes:
            embs_p, s_p, i_p = _pass_arrays(ps)
            _check_close("ivf full probe vs oracle", s_p, i_p,
                         *_oracle(flat, embs_p, K))
        q_int = rng.integers(-8, 9, (8, D)).astype(np.float32)
        s_int, i_int = dmn.search(q_int, K, nprobe=ivf.n_buckets)
        _check_exact("ivf full probe integer", s_int, i_int,
                     *_oracle(flat, q_int, K))
        ivf.nprobe = SERVE_NPROBE
        del flat
        # live updates, persistence, blue/green reload
        n0 = _http(dmn.url, "/healthz")["n_vectors"]
        with _counted(own):
            add = _http(dmn.url, "/add", {
                "ids": [SERVE_ROWS + 1, SERVE_ROWS + 2],
                "texts": texts[:2]})
            rem = _http(dmn.url, "/remove", {
                "ids": [answers[0]["results"][0][0]["id"]]})
            snap = os.path.join(work, "snapshot")
            saved = _http(dmn.url, "/save", {"dir": snap})
            reloaded = _http(dmn.url, "/reload", {"dir": snap})
            after = _http(dmn.url, "/search", {"queries": texts[2:6],
                                               "k": K})
        counts = [add["n_vectors"], rem["n_vectors"], saved["n_vectors"],
                  reloaded["n_vectors"]]
        if counts != [n0 + 2, n0 + 1, n0 + 1, n0 + 1]:
            raise AssertionError(f"/add /remove /save /reload counts {counts} "
                                 f"from {n0}")
        if len(after["results"]) != 4 or any(
                len(r) != K for r in after["results"]):
            raise AssertionError("the reloaded index answered short lists")
    finally:
        dmn.close()
    ivf_k6 = own["ivf_probe"]
    res["ivf"] = {
        "burst": {"requests": SERVE_REQUESTS, "queries": nq_burst,
                  "wall_s": burst_wall},
        "requests": SERVE_TIMED_REQUESTS, "clients": SERVE_CLIENTS,
        "queries": nq, "wall_s": wall, "qps": nq / wall,
        "latency_p50_ms": float(np.percentile(took_ms, 50)),
        "latency_p99_ms": float(np.percentile(took_ms, 99)),
        "latency_max_ms": float(took_ms[-1]),
        "latency_mean_ms": float(took_ms.mean()),
        "recall_at_10": recall, "recall_queries": len(embs),
        "served_query_spread": spread,
        "recall_at_10_store_queries": recall_in,
        "pass_breakdown": breakdown,
        "healthz": health, "device_passes": len(timed),
        "start_s": dmn.start_s,
        "update_ms": {k: v["elapsed_ms"] for k, v in (
            ("add", add), ("remove", rem), ("save", saved),
            ("reload", reloaded))},
        "ivf_probe_launches": {"start": start_k["ivf_probe"],
                               "burst": burst_k["ivf_probe"],
                               "timed": timed_k["ivf_probe"],
                               "daemon": ivf_k6}}
    log(f"[serve] ivf int8, nprobe {SERVE_NPROBE}, k={K}, {SERVE_CLIENTS} "
        f"clients: checked burst of {SERVE_REQUESTS} requests ({nq_burst} "
        f"queries) in {burst_wall:.3f} s; timed window of "
        f"{SERVE_TIMED_REQUESTS} requests ({nq} queries) in {wall:.3f} s = "
        f"{nq / wall:.1f} QPS; latency over every request of the window "
        f"(client side) p50 {res['ivf']['latency_p50_ms']:.2f} ms, p99 "
        f"{res['ivf']['latency_p99_ms']:.2f} ms, max {took_ms[-1]:.2f} ms "
        f"(daemon ring: p50 {health['latency_p50_ms']} ms, p99 "
        f"{health['latency_p99_ms']} ms); {SERVE_TIMED_REQUESTS} requests in "
        f"{len(timed)} device passes; recall@10 vs the exact oracle "
        f"{recall:.4f} over {len(embs)} served queries (mean pairwise "
        f"cosine of the first 2,048: {spread['mean_pairwise_cosine']!r}; "
        f"queries from the "
        f"store's own distribution: {recall_in:.4f}); every answer EQUAL to "
        f"IVFIndex.search of its query embeddings; full probe agrees with "
        f"the oracle (integer queries EQUAL); /add /remove /save /reload "
        f"ok; ivf_probe launches of the daemon's own work {ivf_k6} "
        f"(start-up {start_k['ivf_probe']}, burst {burst_k['ivf_probe']} = "
        f"its {searches} searches, window {timed_k['ivf_probe']}); one pass "
        f"of {breakdown['queries']} queries (ms): " + ", ".join(
            f"{k[:-3]} {v:.3f}" for k, v in breakdown.items()
            if k.endswith("_ms")))

    # --- flat daemon over the same store (K1)
    with _counted(own) as flat_k:
        dmn = _Daemon(["--index", store, "--hbm-dtype", "int8", *common])
    try:
        sent = draw(3)
        with _counted(own) as span:
            answers = [_http(dmn.url, "/search", {"queries": t, "k": K})
                       for t in sent]
        _check_served("flat", dmn, sent, answers)
    finally:
        dmn.close()
    flat_k1 = flat_k["extract_topk"] + span["extract_topk"]
    if span["extract_topk"] <= 0:
        raise AssertionError("the flat daemon's requests launched no "
                             "extract_topk")
    res["flat"] = {"start_s": dmn.start_s, "extract_topk_launches": flat_k1}
    log(f"[serve] flat int8 daemon: {len(sent)} requests, every answer EQUAL "
        "to FlatIPIndex.search of its query embeddings; extract_topk "
        f"launches of its own work {flat_k1} (requests {span['extract_topk']})")

    # --- two stages: a flat daemon over the pipeline's index with the
    # MiniLM teacher resident (K1, then K5 on attention_infer_d32.cu)
    res["rerank"] = _serve_rerank(ctx, own)

    # the int8 IVF companion stays for the multi phase (the PQ build
    # below writes over <store>/ivf)
    shutil.copytree(os.path.join(store, "ivf"),
                    os.path.join(WORK, "multi_ivf"))
    # --- IVFPQ (SERVE_PQ_M x 4-bit) + exact refine over the flat disk store
    with _counted(own):
        lines, t_pq = _call_cli(cli_index.main, [
            *ivf_cli, "--pq-m", str(SERVE_PQ_M), "--pq-bits", "4"])
        dmn = _Daemon(["--index", store, "--ivf", "--refine-factor", "4",
                       *common])
    try:
        if not dmn.svc.index.is_pq:
            raise AssertionError("the PQ daemon did not load a PQ store")
        sent = draw(3)
        with _counted(own):
            answers = [_http(dmn.url, "/search", {"queries": t, "k": K})
                       for t in sent]
        _check_served("ivfpq refine", dmn, sent, answers)
        health = _http(dmn.url, "/healthz")
    finally:
        dmn.close()
    res["pq"] = {"build_s": t_pq, **json.loads(lines[-1]),
                 "start_s": dmn.start_s, "refine_factor":
                 health["refine_factor"]}
    log(f"[serve] ivfpq {SERVE_PQ_M} x 4-bit (built in {t_pq:.1f} s) + "
        f"refine x4 daemon: {len(sent)} requests, every answer EQUAL to "
        "RefinedIndex.search of its query embeddings")
    ctx["serve"] = res
    return own


def _serve_rerank(ctx, own):
    """cli.serve --reranker bert over the pipeline's 32,768-passage index
    with the teacher phase's checkpoint: /search with rerank_k=100, k=10
    and /rerank over explicit texts; every answer EQUALS the teacher
    scored directly (CrossEncoder, the same kernels) on the same pairs at
    the daemon's batch shape, in ids and scores."""
    from cldrd_tpu_torch.data import HashTokenizer, TsvDocStore
    from cldrd_tpu_torch.data.reranking_dataset import RerankingDataset
    from cldrd_tpu_torch.evaluation import make_cross_encoder_score_fn

    paths = ctx["corpus"]
    with _counted(own) as start:
        dmn = _Daemon([
            "--index", os.path.join(WORK, "pipeline", "index"),
            "--checkpoint", ctx["trained_ckpt"], "--max-length",
            str(TRAIN_LQ), "--attention-impl", "pallas", "--reranker",
            "bert", "--reranker-checkpoint", ctx["teacher_ckpt"],
            "--passages", paths["collection"], "--rerank-max-length",
            str(TEACHER_L), "--rerank-batch-size", str(TEACHER_BATCH)])
    try:
        with open(paths["queries"]) as f:
            texts = [line.rstrip("\n").split("\t", 1)[1] for line in f]
        sent = texts[-4:]
        with _counted(own) as span:
            searched = [_http(dmn.url, "/search", {
                "queries": [t], "k": RERANK_TOP, "rerank_k": RERANK_K})
                for t in sent]
            explicit = [_http(dmn.url, "/rerank", {
                "query": t, "passages": texts[:20]}) for t in sent[:2]]
        passes = list(dmn.passes)
    finally:
        dmn.close()
    teacher = _teacher_model(ctx["teacher_ckpt"], "pallas")
    direct = make_cross_encoder_score_fn(teacher)
    tok = HashTokenizer(teacher.config.vocab_size)

    def score(query, passages):
        ds = RerankingDataset.from_pairs(
            [(0, i) for i in range(len(passages))], {0: query},
            dict(enumerate(passages)), tok, is_cross_encoder=True,
            max_len=TEACHER_L, with_token_type_ids=True)
        out = np.zeros(len(passages), np.float32)
        for batch in ds.batches(TEACHER_BATCH):
            s = direct(batch)
            out[batch.pids[:batch.n_valid]] = s[:batch.n_valid]
        return out

    docs = TsvDocStore(paths["collection"])
    for q, answer, ps in zip(sent, searched, passes):
        ids = [int(i) for i in ps["calls"][0][2][0][:RERANK_K]]
        s = score(q, docs.get_many(ids))
        order = np.argsort(-s, kind="stable")[:RERANK_TOP]
        want = [(ids[i], float(s[i])) for i in order]
        got = [(h["id"], h["score"]) for h in answer["results"][0]]
        if got != want:
            raise AssertionError("a rerank_k answer differs from the "
                                 "teacher scored directly")
    for q, answer in zip(sent, explicit):
        s = score(q, texts[:20])
        want = [(int(i), float(s[i]))
                for i in np.argsort(-s, kind="stable")]
        if [(h["index"], h["score"]) for h in answer["results"]] != want:
            raise AssertionError("a /rerank answer differs from the "
                                 "teacher scored directly")
    d32 = (start["k5:attn_infer_d32_launch"]
           + span["k5:attn_infer_d32_launch"])
    # teacher batches: a warm-up, the rerank_k and the /rerank requests
    # (20 passages in a batch of 128: rows with no real token, too)
    batches = 1 + (len(sent) * -(-RERANK_K // TEACHER_BATCH)
                   + len(explicit) * -(-20 // TEACHER_BATCH))
    want = (TEACHER_LAYERS - 1) * batches
    if d32 != want:
        raise AssertionError(f"the rerank daemon made {d32} head_dim-32 K5 "
                             f"launches, not {want}")
    log(f"[serve] rerank daemon (MiniLM-L6 resident, pair batch "
        f"{TEACHER_BATCH} x {TEACHER_L}): {len(sent)} /search requests at "
        f"rerank_k={RERANK_K}, k={RERANK_TOP} and {len(explicit)} /rerank "
        "requests, every answer EQUAL to the teacher scored directly on "
        f"the same pairs (ids and scores); head_dim-32 K5 launches {d32} "
        f"(start-up {start['k5:attn_infer_d32_launch']}), extract_topk "
        f"{span['extract_topk']}")
    return {"start_s": dmn.start_s, "requests": len(sent) + len(explicit),
            "d32_launches": d32,
            "extract_topk_launches": span["extract_topk"]}


# ------------------------------------------- train-attention route study

# ------------------------------------------------------------- multi phase

MULTI_SEED_OFFSET = 3       # the multi phase's own store generator
MULTI_TIMED_BATCHES = 16    # B=512 batches in each QPS window
MULTI_DP_STEPS = 4          # data-parallel flat steps
# the data-parallel jobs: (name, attention_impl, compute dtype, dropout)
DP_JOBS = (("bf16_p0.1", "pallas", "bfloat16", 0.1),
           ("bf16_p0", "pallas", "bfloat16", 0.0),
           ("fp32_p0", "xla", "float32", 0.0))
MULTI_DP_RTOL = 1e-4        # fp32 losses: reduction order
# bf16 bounds from readings on H100s (PERF.md), two gloo ranks on one
# card and four NCCL ranks on four:
MULTI_DP_ROUND_RTOL = 3e-2  # dropout 0 against one process: read 3.97e-3
                            # (2 ranks) and 1.18e-2 (4: rows of 2)
MULTI_DP_SAME_RTOL = 1e-3   # one process with the ranks' masks: read 0
MULTI_DP_STREAMS = (1, 2)   # one process's other dropout streams
DP_RANKS_ONE_GPU = 2        # ranks sharing cuda:0 (gloo) on one GPU
MULTI_GRAD_TOL = 1e-3       # remat's grads: ||g - g0|| / ||g0||
WIDE_BZ = 32                # the remat step at bz 32 x nway 30
OPTION_COS = 0.999          # min row cosine of an option's store


def _base_config(**overrides):
    """DistilBERT-base, the train phase's model, with ``overrides``."""
    from cldrd_tpu_torch.models import DistilBertConfig

    return DistilBertConfig(**overrides)


def _multi_mesh(ctx):
    """Every visible GPU; with one, the shards repeat cuda:0 (the sharded
    code paths on one card)."""
    from cldrd_tpu_torch.parallel import CORPUS_AXIS, Mesh, make_mesh

    n = torch.cuda.device_count()
    if n > 1:
        return make_mesh(n, CORPUS_AXIS, ctx["dev"].type)
    log("[multi] one GPU: every sharded path runs on two shards of "
        f"cuda:0, and data-parallel training on {DP_RANKS_ONE_GPU} gloo "
        "ranks that share it")
    return Mesh((ctx["dev"], ctx["dev"]), CORPUS_AXIS)


def _k_count(name):
    return read_launches()[name]


def _multi_search(ctx, mesh):
    """The 8.8M int8 store in mesh.size shards against the same store on
    one device: EQUAL on integer-valued queries (ids and scores), one K1
    launch per shard per batch; QPS of both on normal queries; the
    portable route (a ragged batch, one search_batched(batch_size=2048)
    batch) EQUAL too, K2 per shard."""
    from cldrd_tpu_torch.index import FlatIPIndex
    from cldrd_tpu_torch.search import mips

    dev = ctx["dev"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(ctx["seed"] + MULTI_SEED_OFFSET)
    codes = torch.randint(-127, 128, (N_FULL, D), generator=gen, device=dev,
                          dtype=torch.int8)
    scales = (torch.rand(N_FULL, generator=gen, device=dev) + 0.5) / 127
    ids = torch.arange(N_FULL, dtype=torch.int32, device=dev)
    one = FlatIPIndex.from_tensors(codes, ids, scales)
    sharded = FlatIPIndex.from_tensors(codes, ids, scales, mesh=mesh)
    rng = np.random.default_rng(ctx["seed"] + MULTI_SEED_OFFSET)
    q_int = rng.integers(-8, 9, (SEARCH_BATCH * INT_BATCHES, D)).astype(
        np.float32)
    q_normal = rng.standard_normal(
        (SEARCH_BATCH * MULTI_TIMED_BATCHES, D)).astype(np.float32)
    res = {"shards": mesh.size}
    k1 = _k_count("extract_topk")
    si, ii = sharded.search_batched(q_int, K, batch_size=SEARCH_BATCH)
    k1 = _k_count("extract_topk") - k1
    want = INT_BATCHES * mesh.size
    if k1 != want:
        raise AssertionError(f"the sharded search made {k1} K1 launches "
                             f"({want} expected)")
    res["integer_rescued"] = sharded.rescued_queries
    oi_s, oi_i = one.search_batched(q_int, K, batch_size=SEARCH_BATCH)
    _check_exact("sharded int8 integer", si, ii, oi_s, oi_i)
    for tag, index in (("one", one), ("sharded", sharded)):
        index.search_batched(q_normal[:SEARCH_BATCH], K,
                             batch_size=SEARCH_BATCH)   # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s, i = index.search_batched(q_normal, K, batch_size=SEARCH_BATCH)
        res[f"{tag}_qps"] = len(q_normal) / (time.perf_counter() - t0)
        res[f"{tag}_ids"] = i
    if not np.array_equal(res.pop("one_ids"), res.pop("sharded_ids")):
        raise AssertionError("sharded and one-device searches of normal "
                             "queries differ")
    # the portable route per shard: a ragged batch and a wide batch
    q = torch.from_numpy(q_int[:RAGGED]).to(dev, torch.bfloat16)
    k2 = _k_count("fused_binmax")
    v, p, ok = mips.sharded_topk(q, sharded.embeddings, sharded.row_ids, K,
                                 mesh, return_positions=True,
                                 on_miss="flag",
                                 row_scales=sharded.row_scales)
    k2_ragged = _k_count("fused_binmax") - k2
    v1, p1, ok1 = mips.topk_binmax(q, codes, ids, K, return_positions=True,
                                   on_miss="flag", row_scales=scales)
    both = (ok & ok1).cpu().numpy()
    _check_exact("sharded ragged portable", v.cpu().numpy()[both],
                 p.cpu().numpy()[both], v1.cpu().numpy()[both],
                 p1.cpu().numpy()[both])
    k2 = _k_count("fused_binmax")
    ws, wi = sharded.search_batched(q_int[:WIDE_BATCH], K,
                                    batch_size=WIDE_BATCH)
    k2_wide = _k_count("fused_binmax") - k2
    ows, owi = one.search_batched(q_int[:WIDE_BATCH], K,
                                  batch_size=WIDE_BATCH)
    _check_exact("sharded wide portable", ws, wi, ows, owi)
    if k2_ragged < mesh.size or k2_wide < mesh.size:
        raise AssertionError(f"the portable route made {k2_ragged} and "
                             f"{k2_wide} K2 launches over {mesh.size} "
                             "shards")
    res.update(k1_launches_integer=k1, k2_ragged=k2_ragged,
               k2_wide=k2_wide, ragged_certified=float(both.mean()))
    log(f"[multi] exact search, {N_FULL} x {D} int8 in {mesh.size} shards: "
        f"{len(q_int)} integer-valued queries EQUAL to the one-device "
        f"index ({k1} K1 launches, one a shard a batch; "
        f"{res['integer_rescued']} re-scanned); QPS (B="
        f"{SEARCH_BATCH}, k={K}) sharded {res['sharded_qps']:.1f} vs one "
        f"device {res['one_qps']:.1f}; portable route: ragged B={RAGGED} "
        f"({k2_ragged} K2 launches, {both.mean():.4f} certified, EQUAL) and "
        f"search_batched(batch_size={WIDE_BATCH}) ({k2_wide} K2 launches, "
        "EQUAL)")
    del one, sharded, codes, scales, ids
    torch.cuda.empty_cache()
    return res


def _multi_ivf(ctx, mesh, ivf_dir):
    """The serve phase's int8 IVF store in mesh.size shards EQUAL to the
    one-device IVFIndex at nprobe 32 and at full probe (one K6 launch a
    shard a search); then cli.serve --ivf --shards 0 answers a burst,
    each answer EQUAL to the daemon's direct search."""
    from cldrd_tpu_torch.index import IVFIndex

    one = IVFIndex.load(ivf_dir, dtype=torch.int8, device=ctx["dev"])
    sharded = IVFIndex.load(ivf_dir, dtype=torch.int8, mesh=mesh)
    rng = np.random.default_rng(ctx["seed"] + 4)
    res = {"n_buckets": sharded.n_buckets, "n_real": sharded.n_real}
    for nprobe in (SERVE_NPROBE, sharded.n_real):
        for b in (1, 8):
            q = rng.standard_normal((b, D)).astype(np.float32)
            k6 = _k_count("ivf_probe")
            s, i = sharded.search(q, K, nprobe=nprobe)
            k6 = _k_count("ivf_probe") - k6
            s1, i1 = one.search(q, K, nprobe=nprobe)
            if not (np.array_equal(s, s1) and np.array_equal(i, i1)):
                raise AssertionError(f"sharded IVF at nprobe {nprobe}, B={b}"
                                     " differs from the one-device search")
            if k6 != mesh.size:
                raise AssertionError(f"a sharded IVF search made {k6} K6 "
                                     f"launches over {mesh.size} shards")
    del one, sharded
    rng = np.random.default_rng(ctx["seed"] + 5)
    with open(ctx["corpus"]["queries"]) as f:
        texts = [line.rstrip("\n").split("\t", 1)[1] for line in f]
    sent = [[texts[j] for j in rng.integers(0, len(texts), m)]
            for m in rng.integers(1, 9, SERVE_REQUESTS)]
    dmn = _Daemon(["--index", ivf_dir, "--ivf", "--hbm-dtype", "int8",
                   "--shards", "0", "--checkpoint", ctx["trained_ckpt"],
                   "--max-length", str(TRAIN_LQ)])
    try:
        index = dmn.svc.index
        if index.mesh is None or index.mesh.size != torch.cuda.device_count():
            raise AssertionError("--shards 0 did not shard over every GPU")
        k6 = _k_count("ivf_probe")
        answers, _, wall = _send(dmn.url, sent, SERVE_CLIENTS)
        k6 = _k_count("ivf_probe") - k6
        nq = _check_served("sharded ivf", dmn, sent, answers)
        searches = sum(len(p["calls"]) for p in dmn.passes)
    finally:
        dmn.close()
    if k6 < searches * index.mesh.size:
        raise AssertionError(f"the --shards 0 daemon's {searches} searches "
                             f"made {k6} K6 launches")
    res["daemon"] = {"requests": len(sent), "queries": nq,
                     "qps": nq / wall, "start_s": dmn.start_s,
                     "shards": index.mesh.size}
    log(f"[multi] IVF int8 ({res['n_real']} buckets, padded to "
        f"{res['n_buckets']}) in {mesh.size} shards EQUAL to one device at "
        f"nprobe {SERVE_NPROBE} and full probe, B=1 and 8, one K6 launch a "
        f"shard a search; cli.serve --ivf --shards 0 "
        f"({index.mesh.size} shard(s)): {len(sent)} requests, {nq} "
        f"queries, every answer EQUAL to its direct search")
    return res


def _by_id(index):
    """(ids, rows, scales) of a flat index's real rows, sorted by id."""
    from cldrd_tpu_torch.parallel import Sharded

    ids = index._host_ids()
    keep = np.flatnonzero(ids >= 0)
    order = keep[np.argsort(ids[keep], kind="stable")]

    def rows(x):
        if x is None:
            return None
        if isinstance(x, Sharded):
            return x.take(order)
        return x[torch.from_numpy(order).to(x.device)]

    return ids[order], rows(index.embeddings), rows(index.row_scales)


def _multi_builds(ctx, mesh):
    """build_index_on_device(mesh=) from the pipeline's token caches
    (bf16 and int8, flat and bucketed) against the one-device build at a
    device's share of the batch: the same ids and EQUAL rows and scales,
    by id. Then cli.index --devices 0 (512 rows a device) and
    cli.retrieve --shards 0 --profile-dir (a process of its own) write
    the pipeline's run file again, and its trace holds kernels of every
    device."""
    from cldrd_tpu_torch.cli import index as cli_index
    from cldrd_tpu_torch.cli.common import load_dual_encoder
    from cldrd_tpu_torch.data import TokenCacheDataset
    from cldrd_tpu_torch.index import build_index_on_device, make_encode_fn

    work = os.path.join(WORK, "pipeline")
    model = load_dual_encoder(ctx["trained_ckpt"], _pallas_model_config(),
                              False, False, torch.bfloat16, ctx["dev"])
    one_enc = make_encode_fn(model, "passage_embs")
    dp_enc = make_encode_fn(model, "passage_embs", mesh=mesh)
    per = 512 // mesh.size
    res = {}
    for ladder, cache in ((None, "token_cache_flat"), ((), "token_cache")):
        ds = TokenCacheDataset(os.path.join(work, cache))
        for dtype in (torch.bfloat16, torch.int8):
            tag = f"{'flat' if ladder is None else 'bucketed'}_" \
                  f"{str(dtype)[6:]}"
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = build_index_on_device(dp_enc, ds, 512, D, dtype=dtype,
                                        bucket_lengths=ladder, mesh=mesh)
            torch.cuda.synchronize()
            t_dp = time.perf_counter() - t0
            want = build_index_on_device(one_enc, ds, per, D, dtype=dtype,
                                         bucket_lengths=ladder,
                                         device=ctx["dev"])
            gi, gr, gs = _by_id(got)
            wi, wr, ws = _by_id(want)
            if not (np.array_equal(gi, wi) and len(gi) == len(ds)
                    and torch.equal(gr.cpu(), wr.cpu())
                    and (ws is None or torch.equal(gs.cpu(), ws.cpu()))):
                raise AssertionError(f"sharded build {tag} differs from "
                                     "the one-device build by id")
            res[tag] = {"build_s": t_dp, "passages_per_s": len(ds) / t_dp,
                        "shard_rows": got.embeddings.part_rows}
            del got, want
    del model, one_enc, dp_enc
    torch.cuda.empty_cache()
    idx = os.path.join(WORK, "multi_index")
    ndev = torch.cuda.device_count()
    common = ["--checkpoint", ctx["trained_ckpt"], "--tokenizer", "hash",
              "--device", "cuda", "--attention-impl", "pallas"]
    lines, t_index = _call_cli(cli_index.main, [
        "--collection", ctx["corpus"]["collection"], "--out", idx,
        "--max-length", str(TRAIN_LP), "--batch-size", str(512 * ndev),
        "--devices", "0", *common])
    run = os.path.join(WORK, "multi_run.tsv")
    logdir = os.path.join(WORK, "multi_trace")
    call, = _retrieve_calls([[
        "--index", idx, "--queries", ctx["corpus"]["queries"], "--run", run,
        "--topk", str(K), "--max-length", str(TRAIN_LQ),
        "--search-batch-size", str(SEARCH_BATCH), "--hbm-dtype", "bfloat16",
        "--shards", "0", "--profile-dir", logdir, *common]])
    window = call["launches"]
    launches = {n: window[n] for n in ("extract_topk", "fused_binmax")}
    ref = os.path.join(work, f"run_bfloat16_{K}.tsv")
    with open(run, "rb") as a, open(ref, "rb") as b:
        if a.read() != b.read():
            raise AssertionError("cli.index --devices 0 + cli.retrieve "
                                 "--shards 0 wrote another run file than "
                                 "the pipeline's")
    counts = _trace_kernels(logdir)
    _check_traced_search("multi retrieve --shards 0 --profile-dir", counts,
                         launches, range(ndev))
    res["cli"] = {"index_s": t_index, **json.loads(lines[-1]),
                  "traced_qps": json.loads(call["lines"][-1])["qps"],
                  "trace_bytes": _trace_bytes(logdir),
                  "search_launches": launches,
                  "search_events_by_device": {
                      d: counts["extract_topk"].get(d, 0)
                      + counts["fused_binmax"].get(d, 0) for d in range(ndev)},
                  "kernel_events_by_device": counts["all"],
                  "window": window}
    log("[multi] sharded on-device builds from the token caches EQUAL the "
        f"one-device builds by id (rows, scales, ids; {per} rows a device "
        "a batch): " + "; ".join(
            f"{k} {v['build_s']:.2f} s ({v['passages_per_s']:.1f} "
            f"passages/s)" for k, v in res.items() if k != "cli")
        + f"; cli.index --devices 0 ({ndev} GPU(s), "
        f"{res['cli']['passages_per_s']:.1f} passages/s) + cli.retrieve "
        "--shards 0 --profile-dir wrote the pipeline's run file byte for "
        f"byte ({res['cli']['traced_qps']:.1f} QPS traced); its trace "
        f"({res['cli']['trace_bytes']} bytes) holds kernels of every "
        f"device {res['cli']['kernel_events_by_device']}, K1/K2 events "
        f"{res['cli']['search_events_by_device']} by device for launches "
        f"{res['cli']['search_launches']}"
        + ("" if any(launches.values()) else
           f" (k={K} over {N_PIPELINE} rows takes the streaming route)"))
    return res


def _dp_trainer_run(small, job, world, rank, stream=None, same_masks=0):
    """Train MULTI_DP_STEPS flat steps of ``job`` (a DP_JOBS entry) at the
    train phase's shape, in this process as rank ``rank`` of ``world`` (no
    group when world is 0). A single process may instead draw each step's
    dropout from ``stream`` (another draw of the masks on the same weights
    and data), or, with ``same_masks`` = n, compute the data-parallel step
    of n ranks: rank r's rows of the global batch through the towers with
    rank r's dropout stream of the step, the loss the global batch's, so
    it draws the ranks' masks and only the order of the gradient sum
    differs from theirs. Returns the step losses, ms a step (wall time
    between the hooks of steps 2 on: each step's metrics are read on the
    host, so a hook follows its step's device work) and the run's kernel
    launches. ``small`` carries what a spawned rank needs (it re-imports
    this module)."""
    from cldrd_tpu_torch.data import HashTokenizer, NwayDataset
    from cldrd_tpu_torch.models import DropoutRNG
    from cldrd_tpu_torch.train import TrainConfig, Trainer
    from cldrd_tpu_torch.train import trainer as trainer_mod

    name, impl, dtype, dropout = job
    model_cfg = _base_config(attention_impl=impl, dropout=dropout,
                             attention_dropout=dropout)
    run_folder = os.path.join(
        small["run_folder"], f"{name}_{world}_{rank}_{stream}_{same_masks}")
    cfg = TrainConfig(max_query_len=TRAIN_LQ, max_passage_len=TRAIN_LP,
                      batch_size=TRAIN_BZ, label_mode="8",
                      compute_dtype=dtype, seed=small["seed"],
                      learning_rate=7e-6, warmup_steps=2, logging_steps=1,
                      evaluate_steps=1000, num_train_epochs=1,
                      experiment_name="dp", run_folder=run_folder)
    data = NwayDataset.create_from_files(
        small["queries"], small["collection"], small["train_file"],
        HashTokenizer(model_cfg.vocab_size), TRAIN_LQ, TRAIN_LP, "8")

    class StreamRNG(DropoutRNG):
        def __init__(self, seed, step, device, **_):
            super().__init__(seed, step, device, stream=stream)

    class SameMasks(Trainer):
        steps = 0

        def _logits(self, batch, rng):
            n = TRAIN_BZ // same_masks
            q, p = [], []
            for r in range(same_masks):
                part = {k: {f: t[r * n:(r + 1) * n] for f, t in d.items()}
                        for k, d in batch.items()
                        if k in ("query", "nway_passages")}
                rng = DropoutRNG(self.cfg.seed, self.steps, self.device,
                                 stream=r)
                q.append(self.model.query_embs(part["query"], rng).float())
                p.append(self.model.nway_passage_embs(
                    part["nway_passages"], rng).float())
            self.steps += 1
            return self.model.logits(torch.cat(q), torch.cat(p))

    trainer = (SameMasks if same_masks else Trainer)(
        cfg, model_cfg, device=small["device"])
    if trainer.distributed != (world > 0):
        raise AssertionError("the trainer did not see its process group")
    if not world:
        # a reference run: its end-of-training checkpoint is not read
        trainer._save = lambda step, epoch: None
    losses, hooks = [], []

    def hook(step, m):
        hooks.append(time.perf_counter())
        losses.append(m["loss"])

    before = read_launches()
    if stream is not None:
        trainer_mod.DropoutRNG = StreamRNG
    try:
        trainer.train(data, step_hook=hook)
    finally:
        trainer_mod.DropoutRNG = DropoutRNG
    launches = {k: v - before.get(k, 0) for k, v in read_launches().items()}
    shutil.rmtree(run_folder, ignore_errors=True)
    gaps = np.diff(hooks)
    return {"losses": losses, "step_ms": float(np.mean(gaps)) * 1e3,
            "launches": launches}


def _dp_rank(rank, world, port, small, out):
    import torch.distributed as dist

    if small["device"] == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(small["backend"],
                            init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    try:
        runs = {job[0]: _dp_trainer_run(small, job, world, rank)
                for job in DP_JOBS}
        with open(f"{out}.{rank}.json", "w") as f:
            json.dump(runs, f)
    finally:
        dist.destroy_process_group()


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rel(a, b):
    """Largest relative difference of two loss curves."""
    return float(np.max(np.abs(np.subtract(a, b)) / np.abs(b)))


def _multi_dp(ctx):
    """MULTI_DP_STEPS flat steps at the train phase's shape on a
    torch.distributed group of spawned ranks (NCCL, one a GPU; with one
    GPU, DP_RANKS_ONE_GPU ranks share cuda:0 over gloo), in each job of
    DP_JOBS. The ranks' losses EQUAL each other's (every rank computes the
    global batch's loss); bf16 at dropout 0.1 runs K3/K4 on every rank.
    Held to one process from the same seed: within MULTI_DP_SAME_RTOL of
    the one process that draws the ranks' masks (bf16 jobs: only the
    order of the gradient sum differs), fp32 with the einsum attention at
    dropout 0 within MULTI_DP_RTOL and bf16 at dropout 0 within
    MULTI_DP_ROUND_RTOL of the plain one process. At dropout 0.1 the
    plain one process draws other masks: its distance is printed beside
    the spread of its losses over MULTI_DP_STREAMS, as are ms a step of
    each job, ranks beside one process. The ranks' launches (processes of
    their own) are returned for the phase's window. With one GPU a
    one-rank NCCL group in this process also trains the bf16 job at
    dropout 0.1, EQUAL to one process."""
    import torch.distributed as dist
    import torch.multiprocessing as mp

    gpus = torch.cuda.device_count()
    world = gpus if gpus > 1 else DP_RANKS_ONE_GPU
    backend = "nccl" if gpus > 1 else "gloo"
    small = {"seed": ctx["seed"], "device": ctx["dev"].type,
             "backend": backend, "run_folder": os.path.join(WORK, "dp"),
             "queries": ctx["corpus"]["queries"],
             "collection": ctx["corpus"]["collection"],
             "train_file": os.path.join(WORK, "pipeline",
                                        "train_mode8.jsonl")}
    t0 = time.perf_counter()
    single = {job[0]: _dp_trainer_run(small, job, 0, 0) for job in DP_JOBS}
    same = {job[0]: _dp_trainer_run(small, job, 0, 0, same_masks=world)
            for job in DP_JOBS if job[2] == "bfloat16"}
    masks = DP_JOBS[0]
    draws = [_dp_trainer_run(small, masks, 0, 0, stream=s)["losses"]
             for s in MULTI_DP_STREAMS]
    t_single = time.perf_counter() - t0
    # the ranks share the card with this process's cached blocks
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out = os.path.join(WORK, "dp_runs")
    mp.start_processes(_dp_rank, args=(world, _free_port(), small, out),
                       nprocs=world, start_method="spawn")
    ranks = []
    for r in range(world):
        with open(f"{out}.{r}.json") as f:
            ranks.append(json.load(f))
    t_dp = time.perf_counter() - t0
    ref = single[masks[0]]["losses"]
    res = {"world": world, "gpus": gpus, "backend": backend,
           "steps": MULTI_DP_STEPS, "dp_s": t_dp, "single_s": t_single,
           "mask_draws": draws,
           "mask_spread": max(_rel(d, ref) for d in draws), "jobs": {}}
    window, failed = {}, []
    if gpus == 1:
        # the NCCL code path on one card: a one-rank group in this
        # process, which draws one process's masks
        dist.init_process_group("nccl", init_method="tcp://127.0.0.1:"
                                f"{_free_port()}", world_size=1, rank=0)
        try:
            res["nccl_one_rank"] = _dp_trainer_run(small, masks, 1, 0)
        finally:
            dist.destroy_process_group()
        if res["nccl_one_rank"]["losses"] != ref:
            failed.append(f"one NCCL rank: losses "
                          f"{res['nccl_one_rank']['losses']} differ from "
                          f"one process's {ref}")
        del res["nccl_one_rank"]["launches"]
    for name, impl, dtype, dropout in DP_JOBS:
        runs = [r[name] for r in ranks]
        got = runs[0]["losses"]
        for r, run in enumerate(runs):
            if len(run["losses"]) != MULTI_DP_STEPS:
                failed.append(f"{name}: rank {r} took "
                              f"{len(run['losses'])} steps")
            elif run["losses"] != got:
                failed.append(f"{name}: rank {r}'s losses {run['losses']} "
                              f"differ from rank 0's {got}")
            for k, v in run["launches"].items():
                window[k] = window.get(k, 0) + v
        one = single[name]["losses"]
        job = res["jobs"][name] = {
            "losses": got, "single_losses": one,
            "rel_err": _rel(got, one),
            "step_ms": [run["step_ms"] for run in runs],
            "single_step_ms": single[name]["step_ms"],
            "k3_launches": [run["launches"]["attention_train_fwd"]
                            for run in runs],
            "k4_launches": [run["launches"]["attention_train_bwd"]
                            for run in runs]}
        checks = []
        if dropout == 0.0:
            checks.append(("one process", one, MULTI_DP_RTOL if
                           dtype == "float32" else MULTI_DP_ROUND_RTOL))
        if name in same:
            job["same_masks_losses"] = same[name]["losses"]
            job["same_masks_rel_err"] = _rel(got, same[name]["losses"])
            checks.append(("one process with the ranks' masks",
                           same[name]["losses"], MULTI_DP_SAME_RTOL))
        for what, want, bound in checks:
            if not _rel(got, want) <= bound:
                failed.append(f"{name}: the ranks' losses {got} are "
                              f"{_rel(got, want):.3g} from {what}'s {want} "
                              f"(bound {bound})")
        if dropout > 0.0 and not (min(job["k3_launches"]) > 0
                                  and min(job["k4_launches"]) > 0):
            failed.append(f"{name}: K3/K4 launches by rank "
                          f"{job['k3_launches']} / {job['k4_launches']}")
    res["rank_launches"] = window
    log(f"[multi] data-parallel training, {world} {backend.upper()} ranks "
        f"on {gpus} GPU(s), {MULTI_DP_STEPS} flat steps (bz {TRAIN_BZ} x "
        f"nway {NWAY}); against one process: " + "; ".join(
            f"{n} {v['rel_err']:.3e}"
            + (f" (with the ranks' masks {v['same_masks_rel_err']:.3e})"
               if "same_masks_rel_err" in v else "")
            + f", {v['step_ms'][0]:.2f} ms a step vs "
            f"{v['single_step_ms']:.2f}, K3/K4 by rank "
            f"{v['k3_launches']}/{v['k4_launches']}"
            for n, v in res["jobs"].items())
        + f"; one process over {len(draws)} other dropout streams: "
        f"{res['mask_spread']:.3e} ({t_dp:.1f} s ranks, {t_single:.1f} s "
        "one process)" + (
            f"; one NCCL rank {res['nccl_one_rank']['losses']}, "
            f"{res['nccl_one_rank']['step_ms']:.2f} ms a step"
            if "nccl_one_rank" in res else ""))
    log("[multi] data-parallel losses " + json.dumps(
        {n: {k: v[k] for k in ("losses", "single_losses",
                               "same_masks_losses") if k in v}
         for n, v in res["jobs"].items()} | {"mask_draws": draws}))
    if failed:
        raise AssertionError("; ".join(failed))
    log("[multi] data-parallel: the ranks' losses EQUAL each other's and "
        "within their bounds")
    return res


def _remat_steps(ctx):
    """One flat step at the train phase's shape with remat off, 'full' and
    'dots' (dropout 0.1, K3/K4): ms a step, peak memory, K3 launches a
    step; the loss EQUAL and the grads within MULTI_GRAD_TOL of remat
    off. Then one 'full' step at bz WIDE_BZ x nway 30: its peak memory.
    Earlier checks' objects are collected first (a daemon's handler class
    keeps its service in a reference cycle), so a peak holds the model,
    its batch and the step alone; ``base_bytes`` is what was allocated
    before the model."""
    import dataclasses

    from cldrd_tpu_torch.data import HashTokenizer, NwayDataset
    from cldrd_tpu_torch.models import DropoutRNG, NwayDualEncoder
    from cldrd_tpu_torch.train import TrainConfig, make_loss_fn
    from cldrd_tpu_torch.train.trainer import batch_to_device

    dev, seed = ctx["dev"], ctx["seed"]
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev)
    cfg = _base_config(attention_impl="pallas")
    model = NwayDualEncoder(cfg, dtype=torch.bfloat16).reset_parameters(
        seed=seed)
    model.to(dev).train()
    params = [p for _, p in model.named_parameters()]
    loss_fn = make_loss_fn(TrainConfig(label_mode="8"))
    data = NwayDataset.create_from_files(
        ctx["corpus"]["queries"], ctx["corpus"]["collection"],
        os.path.join(WORK, "pipeline", "train_mode8.jsonl"),
        HashTokenizer(cfg.vocab_size), TRAIN_LQ, TRAIN_LP, "8")

    def set_remat(on, policy="full"):
        for enc in (model.query_encoder, model.passage_encoder):
            enc.config = dataclasses.replace(enc.config, remat=on,
                                             remat_policy=policy)

    def step(batch):
        logits = model(batch["query"], batch["nway_passages"],
                       rng=DropoutRNG(seed, 0, dev))
        loss = loss_fn(logits, batch["labels"], batch["teacher_scores"])
        return loss, torch.autograd.grad(loss, params, allow_unused=True)

    def measured(batch):
        step(batch)                                   # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        k3 = _k_count("attention_train_fwd")
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        loss, grads = step(batch)
        t1.record()
        torch.cuda.synchronize()
        return (loss.item(), grads, t0.elapsed_time(t1),
                torch.cuda.max_memory_allocated(dev),
                _k_count("attention_train_fwd") - k3)

    batch = batch_to_device(next(data.batches(TRAIN_BZ, seed=seed)), dev)
    res, ref = {}, None
    for tag, on, policy in (("off", False, "full"), ("full", True, "full"),
                            ("dots", True, "dots")):
        set_remat(on, policy)
        loss, grads, ms, peak, k3 = measured(batch)
        if ref is None:
            ref = (loss, grads)
            err = 0.0
        else:
            if loss != ref[0]:
                raise AssertionError(f"remat {tag}: loss {loss} != "
                                     f"{ref[0]} without remat")
            num = sum(float((g.float() - r.float()).square().sum())
                      for g, r in zip(grads, ref[1]) if g is not None)
            den = sum(float(r.float().square().sum())
                      for r in ref[1] if r is not None)
            err = (num / den) ** 0.5
            if not err <= MULTI_GRAD_TOL:
                raise AssertionError(f"remat {tag}: grads {err:.3g} from "
                                     "remat off")
        res[tag] = {"ms": ms, "peak_bytes": peak, "k3_launches": k3,
                    "loss": loss, "grad_rel_err": err}
        del grads
    if res["full"]["k3_launches"] != 2 * res["off"]["k3_launches"]:
        raise AssertionError(f"K3 launches a step: {res['off']} without "
                             f"remat, {res['full']} with it")
    ref = None
    set_remat(True, "full")
    wide = batch_to_device(next(data.batches(WIDE_BZ, seed=seed)), dev)
    loss, grads, ms, peak, k3 = measured(wide)
    if not np.isfinite(loss):
        raise AssertionError(f"the wide remat step's loss is {loss}")
    res["wide_full"] = {"ms": ms, "peak_bytes": peak, "k3_launches": k3,
                        "passages": WIDE_BZ * NWAY, "loss": loss}
    res["base_bytes"] = base
    del grads, wide, batch, model
    torch.cuda.empty_cache()
    log(f"[multi] remat, one flat step (bz {TRAIN_BZ} x nway {NWAY}, L "
        f"{TRAIN_LP}, dropout 0.1): "
        + "; ".join(f"{t} {v['ms']:.2f} ms, peak {v['peak_bytes'] / 2**30:.2f}"
                    f" GiB, {v['k3_launches']} K3 launches, grads "
                    f"{v['grad_rel_err']:.2e} from off"
                    for t, v in res.items() if t in ("off", "full", "dots"))
        + f"; the loss EQUAL; full remat at bz {WIDE_BZ} x nway {NWAY} "
        f"({WIDE_BZ * NWAY} passages of {TRAIN_LP}): "
        f"{res['wide_full']['ms']:.2f} ms, peak "
        f"{res['wide_full']['peak_bytes'] / 2**30:.2f} GiB; allocated "
        f"before the model {base / 2**30:.2f} GiB")
    return res


def _multi_options(ctx):
    """The 32,768 pipeline passages (the bucketed token cache) encoded
    with fused_qkv (K5) and softmax_in_compute_dtype (the einsum
    attention, where the option applies), each against the default
    store of the same attention: the same ids, every row's cosine at
    least OPTION_COS; passages/s of each."""
    import dataclasses

    from cldrd_tpu_torch.cli.common import load_dual_encoder
    from cldrd_tpu_torch.data import TokenCacheDataset
    from cldrd_tpu_torch.index import encode_dataset, make_encode_fn

    ds = TokenCacheDataset(os.path.join(WORK, "pipeline", "token_cache"))
    res = {}
    for impl, option in (("pallas", "fused_qkv"),
                         ("xla", "softmax_in_compute_dtype")):
        stores = {}
        for on in (False, True):
            cfg = _base_config(attention_impl=impl, **{option: on})
            model = load_dual_encoder(ctx["trained_ckpt"], cfg, False, False,
                                      torch.bfloat16, ctx["dev"])
            enc = make_encode_fn(model, "passage_embs")
            encode_dataset(enc, ds, 512, bucket_lengths=())   # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            e, i = encode_dataset(enc, ds, 512, bucket_lengths=())
            stores[on] = (e, i, len(i) / (time.perf_counter() - t0))
            del model, enc
        (e0, i0, r0), (e1, i1, r1) = stores[False], stores[True]
        if not np.array_equal(i0, i1):
            raise AssertionError(f"{option}: ids differ")
        cos = (e0 * e1).sum(1) / (np.linalg.norm(e0, axis=1)
                                  * np.linalg.norm(e1, axis=1))
        if not cos.min() >= OPTION_COS:
            raise AssertionError(f"{option}: min row cosine {cos.min()}")
        res[option] = {"attention_impl": impl, "min_cosine": float(cos.min()),
                       "row_dist": _row_dist(e1, e0),
                       "passages_per_s": r1, "default_passages_per_s": r0,
                       "bit_equal": bool(np.array_equal(e0, e1))}
    torch.cuda.empty_cache()
    log(f"[multi] encoder options over the {len(ds)} passages (bucketed): "
        + "; ".join(f"{k} ({v['attention_impl']}) {v['passages_per_s']:.1f} "
                    f"vs {v['default_passages_per_s']:.1f} passages/s, min "
                    f"cosine {v['min_cosine']:.6f}, row dist "
                    f"{v['row_dist']:.4f}, bit-equal {v['bit_equal']}"
                    for k, v in res.items()))
    return res


def phase_multi(ctx):
    """The multi-device paths and the encoder's options: the sharded exact
    search, sharded IVF (and a --shards 0 daemon), sharded on-device
    builds and the CLIs' --devices/--shards, data-parallel training over
    NCCL (gloo ranks sharing cuda:0 with one GPU), remat off/full/dots and
    the wide remat step, fused_qkv and softmax_in_compute_dtype encodes.
    Returns the path's launches."""
    mesh = _multi_mesh(ctx)
    res = {"gpus": torch.cuda.device_count(),
           "mesh": [str(d) for d in mesh.devices]}
    res["search"] = _multi_search(ctx, mesh)
    res["ivf"] = _multi_ivf(ctx, mesh, os.path.join(WORK, "multi_ivf"))
    res["builds"] = _multi_builds(ctx, mesh)
    res["dp"] = _multi_dp(ctx)
    res["remat"] = _remat_steps(ctx)
    res["options"] = _multi_options(ctx)
    ctx["multi"] = res
    shutil.rmtree(WORK, ignore_errors=True)
    # the spawned ranks' and the traced retrieve's launches belong to the
    # path's window too
    window = _add_launches(read_launches(), res["dp"].pop("rank_launches"))
    return _add_launches(window, res["builds"]["cli"].pop("window"))


ROUTES = ("sm90", "tiled", "plain")


@contextlib.contextmanager
def _train_attention_route(route):
    """Train attention on the card through one route: "sm90" (what
    _kernel_route picks for bf16, head_dim 64, L <= 256), "tiled" (the
    kernels of attention.cu, forced; K5's launches too) or "plain" (the
    plain PyTorch versions, on the card's tensors)."""
    from cldrd_tpu_torch.ops import attention as att

    saved = att._kernel_route, att._route
    if route == "tiled":
        att._kernel_route = lambda dtype, length, head_dim, name: "tiled"
    elif route == "plain":
        att._route = lambda q: "plain"
    elif route != "sm90":
        raise ValueError(route)
    try:
        yield
    finally:
        att._kernel_route, att._route = saved


@contextlib.contextmanager
def _k5_sm90():
    """K5 at head_dim 64 and 64 < L <= 256 on the card through the sm90
    forward at p=0, forced (the route's kernel before
    attention_infer_d64.cu), in place of what _kernel_route picks."""
    from cldrd_tpu_torch.ops import attention as att

    saved = att._kernel_route

    def route(dtype, length, head_dim, name):
        picked = saved(dtype, length, head_dim, name)
        return "sm90" if picked == "d64" else picked

    att._kernel_route = route
    try:
        yield
    finally:
        att._kernel_route = saved


@contextlib.contextmanager
def _k1_generic():
    """K1 on the card through extract_topk.cu, forced (the kernel of PRs
    1-4), in place of what kernel_route picks."""
    from cldrd_tpu_torch.ops import extract_topk as k1_mod

    saved = k1_mod.kernel_route
    k1_mod.kernel_route = lambda *a: "generic"
    try:
        yield
    finally:
        k1_mod.kernel_route = saved


@contextlib.contextmanager
def _k2_generic():
    """K2 on the card through fused_binmax.cu, forced (the kernel of PRs
    1-5), in place of what kernel_route picks."""
    from cldrd_tpu_torch.ops import fused_binmax as k2_mod

    saved = k2_mod.kernel_route
    k2_mod.kernel_route = lambda *a: "generic"
    try:
        yield
    finally:
        k2_mod.kernel_route = saved


def _route_model_config():
    from cldrd_tpu_torch.models import DistilBertConfig

    return DistilBertConfig()


def _tower_diff(named, ref, got):
    """For each tower: |got - ref| / |ref| over its gradients, their
    cosine, and the parameter with the largest relative difference."""
    out = {}
    for tower in ("query_encoder", "passage_encoder"):
        keys = [i for i, n in enumerate(named) if n.startswith(tower + ".")]
        diff = sum(float((got[i] - ref[i]).double().square().sum())
                   for i in keys)
        norm = sum(float(ref[i].double().square().sum()) for i in keys)
        norm_g = sum(float(got[i].double().square().sum()) for i in keys)
        dot = sum(float((got[i].double() * ref[i].double()).sum())
                  for i in keys)
        worst = max(keys, key=lambda i: float(
            (got[i] - ref[i]).norm() / ref[i].norm().clamp_min(1e-30)))
        # the parameters that hold most of the difference
        top = sorted(keys, key=lambda i: -float((got[i] - ref[i]).norm()))
        out[tower] = {
            "rel_diff": (diff / norm) ** 0.5,
            "cosine": dot / (norm * norm_g) ** 0.5,
            "worst_param": named[worst],
            "worst_rel_diff": float((got[worst] - ref[worst]).norm()
                                    / ref[worst].norm().clamp_min(1e-30)),
            "top_diff": [(named[i], float((got[i] - ref[i]).norm()),
                          float(ref[i].norm())) for i in top[:6]]}
    return out


def _step_setup(ctx, corpus, train_file, n_batches=1):
    """A Trainer at the train phase's shape with random weights from
    --seed, its loss, and the first ``n_batches`` flat batches of
    ``train_file`` on the card."""
    from cldrd_tpu_torch.data import HashTokenizer, NwayDataset
    from cldrd_tpu_torch.train import TrainConfig, Trainer, make_loss_fn
    from cldrd_tpu_torch.train.trainer import batch_to_device

    dev, seed = ctx["dev"], ctx["seed"]
    cfg = TrainConfig(max_query_len=TRAIN_LQ, max_passage_len=TRAIN_LP,
                      batch_size=TRAIN_BZ, label_mode="8", seed=seed,
                      run_folder=os.path.join(WORK, "grads"))
    model_cfg = _route_model_config()
    trainer = Trainer(cfg, model_cfg, device=dev)
    trainer.model.reset_parameters(seed=seed)
    trainer.model.to(dev).train()
    data = NwayDataset.create_from_files(
        corpus["queries"], corpus["collection"], train_file,
        HashTokenizer(vocab_size=model_cfg.vocab_size), TRAIN_LQ, TRAIN_LP,
        "8")
    batches = [batch_to_device(b, dev) for b, _ in
               zip(data.batches(TRAIN_BZ, seed=seed), range(n_batches))]
    return trainer.model, make_loss_fn(cfg), batches


def _step_loss(model, loss_fn, batch, ctx):
    from cldrd_tpu_torch.models import DropoutRNG

    logits = model(batch["query"], batch.get("nway_passages"),
                   batch.get("packed_passages"),
                   rng=DropoutRNG(ctx["seed"], 0, ctx["dev"]))
    return loss_fn(logits, batch["labels"], batch["teacher_scores"]), logits


def _route_grads(ctx, corpus, train_file, n_batches=4):
    """One flat step's gradients (same weights, batch and dropout stream)
    through each route, each route's against the plain route's, for each
    of ``n_batches`` batches: how far kernels that agree with the plain
    versions call by call move a step of this model."""
    model, loss_fn, batches = _step_setup(ctx, corpus, train_file,
                                          n_batches)
    named, params = zip(*[(n, p) for n, p in model.named_parameters()
                          if p.requires_grad])
    res = []
    for batch in batches:
        grads, losses, logits = {}, {}, {}
        for route in ROUTES:
            with _train_attention_route(route):
                loss, out = _step_loss(model, loss_fn, batch, ctx)
                g = torch.autograd.grad(loss, params, allow_unused=True)
            grads[route] = [torch.zeros_like(p, dtype=torch.float32)
                            if x is None else x.float()
                            for p, x in zip(params, g)]
            losses[route] = float(loss.detach())
            logits[route] = out.detach().float()
        res.append({
            "loss": losses,
            "logits_rel_diff_vs_plain": {
                r: float((logits[r] - logits["plain"]).norm()
                         / logits["plain"].norm()) for r in ("sm90", "tiled")},
            "vs_plain": {r: _tower_diff(named, grads["plain"], grads[r])
                         for r in ("sm90", "tiled")},
            "sm90_vs_tiled": _tower_diff(named, grads["tiled"],
                                         grads["sm90"])})
        del grads
    del model, batches
    torch.cuda.empty_cache()
    return res


def _err_stats(got, ref):
    d, r = got.detach().double() - ref.double(), ref.double()
    rms = r.square().mean().sqrt().clamp_min(1e-300)
    return {"rms": float(d.square().mean().sqrt() / rms),
            "along": float((d * r).mean() / rms ** 2),
            "max": float(d.abs().max() / r.abs().max().clamp_min(1e-300))}


def _capture_calls(ctx, corpus, train_file):
    """The model's own train-attention calls of one flat step (random
    weights from --seed, the sm90 route): each call's arguments and the
    upstream gradient its output received."""
    from cldrd_tpu_torch.models import distilbert

    model, loss_fn, (batch,) = _step_setup(ctx, corpus, train_file)
    calls, orig = [], distilbert.flash_attention_train

    def record(q, k, v, mask, seed, dropout_p=0.0, segment_ids=None):
        out = orig(q, k, v, mask, seed, dropout_p, segment_ids)
        c = {"args": (q.detach(), k.detach(), v.detach(), mask, seed,
                      dropout_p, segment_ids)}
        out.register_hook(lambda gr, c=c: c.__setitem__("g", gr.detach()))
        calls.append(c)
        return out

    distilbert.flash_attention_train = record
    try:
        _step_loss(model, loss_fn, batch, ctx)[0].backward()
    finally:
        distilbert.flash_attention_train = orig
    del model, batch
    return calls


def _route_captured(ctx, corpus, train_file):
    """Each of the model's calls (``_capture_calls``) replayed through the
    sm90 and tiled kernels against the plain versions: per call, each
    route's error statistics (RMS and component along plain, over the
    RMS of plain; max over the largest magnitude) for out, dq, dk, dv."""
    from cldrd_tpu_torch.ops import attention as att

    res = []
    for c in _capture_calls(ctx, corpus, train_file):
        q, k, v, mask, s_, p, seg = c["args"]
        g = c["g"].contiguous()
        want = [att.train_fwd_plain(q, k, v, mask, s_, p, seg),
                *att.train_bwd_plain(q, k, v, mask, s_, p, seg, g)]
        row = {"B": q.shape[0], "L": q.shape[1],
               "real_keys": float(mask.float().sum(1).mean())}
        for route in ("sm90", "tiled"):
            qs, ks, vs = (t.clone().requires_grad_() for t in (q, k, v))
            with _train_attention_route(route):
                out = att.flash_attention_train(qs, ks, vs, mask, s_, p, seg)
                out.backward(g)
            row[route] = {n: _err_stats(x, w) for n, x, w in zip(
                ("out", "dq", "dk", "dv"),
                (out, qs.grad, ks.grad, vs.grad), want)}
        res.append(row)
        log(f"[routes] model call B={row['B']} L={row['L']} (real keys "
            f"{row['real_keys']:.1f}): " + "; ".join(
                f"{r} " + ", ".join(
                    f"{n} rms {e['rms']:.2e} along {e['along']:+.1e}"
                    for n, e in row[r].items()) for r in ("sm90", "tiled")))
    torch.cuda.empty_cache()
    return res


def _route_kernel_errors(ctx):
    """Each kernel route's error against the plain versions at the passage
    and query shapes, with the main path's padding, p = 0.1: the RMS of
    (route - plain) and its mean, over the RMS of plain, and its component
    along plain (a scale bias shows there; rounding averages out)."""
    from cldrd_tpu_torch.ops import attention as att

    bf16, res = torch.bfloat16, {}
    for tag, b, length in (("passage", TRAIN_BZ * NWAY, TRAIN_LP),
                           ("query", TRAIN_BZ, TRAIN_LQ)):
        q, k, v, g, _, _ = _attn_inputs(ctx, b, length, bf16, False)
        mask = _padded_mask(ctx, b, length)
        want = [att.train_fwd_plain(q, k, v, mask, ATTN_SEED, ATTN_P),
                *att.train_bwd_plain(q, k, v, mask, ATTN_SEED, ATTN_P, None,
                                     g)]
        for route in ("sm90", "tiled"):
            qs, ks, vs = (t.clone().requires_grad_() for t in (q, k, v))
            with _train_attention_route(route):
                out = att.flash_attention_train(qs, ks, vs, mask, ATTN_SEED,
                                                ATTN_P)
                out.backward(g)
            for name, got, ref in zip(("out", "dq", "dk", "dv"),
                                      (out, qs.grad, ks.grad, vs.grad),
                                      want):
                d, r = got.detach().double() - ref.double(), ref.double()
                rms = r.square().mean().sqrt()
                res.setdefault(tag, {}).setdefault(route, {})[name] = {
                    "rms": float(d.square().mean().sqrt() / rms),
                    "mean": float(d.mean() / rms),
                    "along": float((d * r).mean() / rms ** 2)}
        log(f"[routes] kernel error vs plain, {tag} B={b} L={length}: "
            + "; ".join(f"{route} " + ", ".join(
                f"{n} rms {e['rms']:.3e} along {e['along']:+.3e}"
                for n, e in errs.items())
                for route, errs in res[tag].items()))
        del q, k, v, g, want
    torch.cuda.empty_cache()
    return res


def _query_embs(ckpt, texts, dev, seed):
    """fp32 query embeddings of ``texts`` from a checkpoint (or, with
    ``ckpt`` None, the random init from ``seed``), as the daemon encodes
    them: hash tokenizer, max length 30, bf16, batches of 128."""
    from cldrd_tpu_torch.cli.common import build_tokenizer, load_dual_encoder
    from cldrd_tpu_torch.index.builder import make_encode_fn

    cfg = _route_model_config()
    model = load_dual_encoder(ckpt, cfg, False, False, torch.bfloat16, dev,
                              seed=seed)
    encode = make_encode_fn(model, "query_embs")
    tok = build_tokenizer("hash", vocab_size=cfg.vocab_size)
    embs = torch.cat([encode(tok(texts[s:s + 128], TRAIN_LQ))
                      for s in range(0, len(texts), 128)])
    del model
    return embs


def _spread(e):
    """Mean pairwise cosine of the rows (diagonal left out), mean norm, and
    the share of the squared norm along the mean direction."""
    n = e.shape[0]
    u = e / e.norm(dim=1, keepdim=True)
    cos = (u @ u.T).sum().item()
    mean = e.mean(0)
    along = ((e @ (mean / mean.norm())) ** 2).sum() / (e ** 2).sum()
    return {"mean_pairwise_cosine": (cos - n) / (n * (n - 1)),
            "mean_norm": e.norm(dim=1).mean().item(),
            "share_along_mean": along.item()}


def phase_routes(ctx):
    """The train phase's curriculum (3 x 4 flat steps, same data and seed)
    through each train-attention route, to tell whether the route moves
    training: one step's gradients against the plain route's; each step's
    loss and grad norm; the trained query tower's embedding spread and
    recall@10 at nprobe 32 on the serve phase's clustered store; and the
    flat and packed step times of the sm90 and tiled routes, alternated
    (tiled, sm90, sm90, tiled) in one process."""
    from cldrd_tpu_torch.cli import curriculum as cli_curriculum
    from cldrd_tpu_torch.cli import index as cli_index
    from cldrd_tpu_torch.cli import train as cli_train
    from cldrd_tpu_torch.index import IVFIndex, load_index
    from cldrd_tpu_torch.train import latest_checkpoint
    from cldrd_tpu_torch.train.trainer import Trainer

    dev, seed = ctx["dev"], ctx["seed"]
    work = os.path.join(WORK, "routes")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    corpus = _write_corpus(work, N_PIPELINE, N_QUERIES, seed)
    files = _write_training_files(work, N_QUERIES, N_PIPELINE, seed)
    base = os.path.join(work, "train.yaml")
    with open(base, "w") as f:
        f.write(f"max_query_len: {TRAIN_LQ}\nmax_passage_len: {TRAIN_LP}\n"
                "warmup_steps: 2\nlogging_steps: 1\nevaluate_steps: 1000\n"
                f"compute_dtype: \"bfloat16\"\nseed: {seed}\n")
    res = {"kernel_errors": _route_kernel_errors(ctx),
           "captured": _route_captured(ctx, corpus, files["8"]),
           "grads": _route_grads(ctx, corpus, files["8"])}
    for i, step in enumerate(res["grads"]):
        log(f"[routes] batch {i}: one step's logits vs plain (relative) "
            f"{step['logits_rel_diff_vs_plain']}; losses {step['loss']}")
        for r, d in step["vs_plain"].items():
            log(f"[routes] batch {i}: gradients, {r} vs plain: " + "; ".join(
                f"{t} rel diff {v['rel_diff']:.3e}, cosine {v['cosine']:.6f}"
                for t, v in d.items()))
    for r, d in res["grads"][0]["vs_plain"].items():
        for t, v in d.items():
            log(f"[routes] batch 0: {r} {t} largest differences (|diff|, "
                "|plain|): " + ", ".join(f"{n} {a:.3e} {b:.3e}"
                                         for n, a, b in v["top_diff"]))
    runs = os.path.join(work, "runs")
    common = ["--config", base, "--tokenizer", "hash", "--device", "cuda",
              "--dropout", "0.1", "--attention-dropout", "0.1",
              "--batch-size", str(TRAIN_BZ)]
    records = []
    check = Trainer._check_finite

    def record(self, m, step):
        records.append({"run": self.cfg.experiment_name, "step": step,
                        "loss": m["loss"], "grad_norm": m["grad_norm"],
                        "t": time.perf_counter()})
        return check(self, m, step)

    Trainer._check_finite = record
    ckpts, traj, flat_ms, packed_ms = {}, {}, {}, {}
    try:
        for i, route in enumerate(("tiled", "sm90", "plain", "sm90",
                                   "tiled")):
            folder = os.path.join(runs, f"{i}_{route}")
            n0 = len(records)
            with _train_attention_route(route):
                _call_cli(cli_curriculum.main, [
                    "--queries", corpus["queries"],
                    "--passages", corpus["collection"],
                    "--training-paths", files["8"], files["9"], files["10"],
                    "--epochs", "1", "1", "1", "--run-folder", folder,
                    *common])
            mine = records[n0:]
            run = [(r["loss"], r["grad_norm"]) for r in mine]
            if route in traj and traj[route] != run:
                raise AssertionError(f"two {route} curricula from one seed "
                                     "gave different losses")
            traj[route] = run
            ckpts.setdefault(route, latest_checkpoint(
                os.path.join(folder, "curriculum_iter3")))
            flat_ms.setdefault(route, []).extend(
                x * 1e3 for x in _step_times(
                    mine, [f"curriculum_iter{j}" for j in (1, 2, 3)]))
        train = ["--queries-path", corpus["queries"],
                 "--passages-path", corpus["collection"],
                 "--training-path", files["8"], "--label-mode", "8",
                 "--num-train-epochs", "2", "--learning-rate", "7e-6",
                 "--pack-passages", "--evaluate-steps", "1000", *common]
        for i, route in enumerate(("tiled", "sm90", "sm90", "tiled")):
            name = f"packed_{i}_{route}"
            n0 = len(records)
            with _train_attention_route(route):
                _call_cli(cli_train.main, [
                    *train, "--run-folder", os.path.join(runs, name),
                    "--experiment-name", name])
            packed_ms.setdefault(route, []).extend(
                x * 1e3 for x in _step_times(records[n0:], [name]))
    finally:
        Trainer._check_finite = check
    res["trajectory"] = {r: {"loss": [x for x, _ in v],
                             "grad_norm": [y for _, y in v]}
                         for r, v in traj.items()}
    for r in ("sm90", "tiled"):
        d = [abs(a - b) for (a, _), (b, _) in zip(traj[r], traj["plain"])]
        res["trajectory"][r]["max_loss_diff_vs_plain"] = max(d)
    res["step_ms"] = {
        kind: {r: {"median": float(np.median(v)), "all": v}
               for r, v in ms.items()}
        for kind, ms in (("flat", flat_ms), ("packed", packed_ms))}
    for r, v in res["trajectory"].items():
        log(f"[routes] {r} curriculum: losses "
            + " ".join(f"{x:.4f}" for x in v["loss"]) + "; grad norms "
            + " ".join(f"{x:.3f}" for x in v["grad_norm"]))
    for kind, by in res["step_ms"].items():
        log(f"[routes] {kind} step (median ms): " + ", ".join(
            f"{r} {v['median']:.2f} over {len(v['all'])} steps"
            for r, v in by.items()))

    # the trained query towers on the serve phase's store
    with open(corpus["queries"]) as f:
        texts = [line.rstrip("\n").split("\t", 1)[1] for line in f]
    embs = {"init": _query_embs(None, texts, dev, seed)}
    for r in ROUTES:
        embs[r] = _query_embs(ckpts[r], texts, dev, seed)
    res["queries"] = {name: _spread(e) for name, e in embs.items()}
    # recall@10 at nprobe 32 on the serve phase's store (seed --seed) and
    # on two more drawn the same way
    for k in range(3):
        store, _ = _serve_store(ctx, work, seed + k)
        _call_cli(cli_index.main, [
            "--collection", corpus["collection"], "--out", store,
            "--ivf-only", "--ivf-nlist", str(SERVE_NLIST), "--ivf-nprobe",
            str(SERVE_NPROBE), "--device", "cuda"])
        ivf = IVFIndex.load(os.path.join(store, "ivf"), dtype=torch.int8,
                            device=dev)
        ivf.nprobe = SERVE_NPROBE
        flat = load_index(store, dtype=torch.int8, device=dev)
        for name, e in embs.items():
            q = e.cpu().numpy()
            ref = np.concatenate([_oracle(flat, q[r:r + 128], 10)[1]
                                  for r in range(0, len(q), 128)])
            hits = np.concatenate([ivf.search(q[r:r + 128], 10)[1]
                                   for r in range(0, len(q), 128)])
            res["queries"][name].setdefault("recall_at_10", []).append(
                _recall_at_10(hits, ref))
        del flat, ivf
        shutil.rmtree(store)
    for name in embs:
        log(f"[routes] query tower {name}: " + ", ".join(
            f"{k} {v}" for k, v in res["queries"][name].items()))
    for a, b in (("sm90", "plain"), ("tiled", "plain"), ("sm90", "tiled")):
        cos = torch.nn.functional.cosine_similarity(embs[a], embs[b], dim=1)
        res["queries"][f"{a}_vs_{b}_cosine"] = cos.mean().item()
        log(f"[routes] query embeddings {a} vs {b}: mean cosine "
            f"{cos.mean().item():.6f}, min {cos.min().item():.6f}")
    del embs
    ctx["routes"] = res
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


def _kernel_record(ctx, name, src, ref, tag, launches, err, by_shape=None):
    t = ctx["timings"][name][tag]
    rec = {
        "name": name, "route": "cuda", "source": src, "replaces": ref,
        "launches": launches, "max_abs_err": err,
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound"][0],
        "bound_by": t["bound"][1], "library_ms": t.get("library_ms"),
        "shape": tag,
    }
    for key in ("matmul_ms", "library_note", "generic_ms", "tiled_ms",
                "sm90_ms", "real_keys", "int_mm_ms", "tflops", "vs_peak",
                "launches_from"):
        if key in t:
            rec[key] = t[key]
    # the kernel's other timed shapes, by tag
    others = {k: {key: v[key] for key in ("ms", "generic_ms", "sm90_ms",
                                          "plain_ms", "matmul_ms",
                                          "library_ms", "real_keys",
                                          "tflops", "vs_peak")
                  if key in v}
              | {"bound_ms": v["bound"][0], "bound_by": v["bound"][1]}
              for k, v in ctx["timings"][name].items() if k != tag}
    if others:
        rec["other_shapes"] = others
    if by_shape:
        rec["launches_by_shape"] = by_shape
    return rec


# (record name, counter, source, TPU kernel, timed shape, error key)
KERNELS = [
    ("extract_topk", ("extract_topk", None), "csrc/extract_topk_sm90.cu",
     "cldrd_tpu/search/mips.py:605", "int8_full", "k1_err"),
    ("fused_binmax", ("fused_binmax", None), "csrc/fused_binmax_sm90.cu",
     "cldrd_tpu/search/mips.py:361", "bf16_1M", "k2_err"),
    ("attention_train_fwd", ("attention", "train_fwd"),
     "csrc/attention_sm90.cu", "cldrd_tpu/ops/attention.py:204", "train",
     "attn_err_bf16"),
    ("attention_train_bwd", ("attention", "train_bwd"),
     "csrc/attention_sm90.cu", "cldrd_tpu/ops/attention.py:257", "train",
     "attn_err_bf16"),
    # K5 by route (ops/attention.py::_kernel_route): the query encode's
    # L=30 on attention_infer.cu; passages at 64 < L <= 256 (every index
    # build, the evaluation hook, the serve path's encodes) on
    # attention_infer_d64.cu; the MiniLM-L6 teacher's head_dim 32 on
    # attention_infer_d32.cu
    ("attention_infer", ("attention", ("infer", "attn_infer_short_launch")),
     "csrc/attention_infer.cu", "cldrd_tpu/ops/attention.py:61", "encode",
     "k5_err"),
    ("attention_infer_d64", ("attention", ("infer", "attn_infer_d64_launch")),
     "csrc/attention_infer_d64.cu", "cldrd_tpu/ops/attention.py:61", "L256",
     "k5_err"),
    ("attention_infer_d32", ("attention", ("infer", "attn_infer_d32_launch")),
     "csrc/attention_infer_d32.cu", "cldrd_tpu/ops/attention.py:61",
     "teacher", "k5_teacher_err"),
    ("ivf_probe", ("ivf_probe", None), "csrc/ivf_probe.cu",
     "cldrd_tpu/ops/ivf_probe.py:60", "int8_full_b8", "k6_err"),
    # K7 lies on no path: its launches are the kernels phase's A/B
    ("int8_dot", ("int8_dot", None), "csrc/int8_dot_sm90.cu",
     "examples/bench_int8_dot.py:37", "int8_native", "k7_err"),
    # no TPU kernel: XLA fuses the JAX block's Dropout, add and LayerNorm;
    # every LayerNorm site of the port's encoders (the train shape timed,
    # the teacher's among the forward's other shapes)
    ("residual_norm_fwd", ("residual_norm", "fwd"), "csrc/residual_norm.cu",
     "cldrd_tpu/models/distilbert.py:341", "train", "rn_err"),
    ("residual_norm_bwd", ("residual_norm", "bwd"), "csrc/residual_norm.cu",
     "cldrd_tpu/models/distilbert.py:341", "train", "rn_err"),
]


def _counters():
    from cldrd_tpu_torch.ops import (
        attention,
        extract_topk,
        fused_binmax,
        int8_dot,
        ivf_probe,
        residual_norm,
    )

    return {"extract_topk": extract_topk, "fused_binmax": fused_binmax,
            "attention": attention, "ivf_probe": ivf_probe,
            "int8_dot": int8_dot, "residual_norm": residual_norm}


# the C entry points whose launches the paths must show: every K1 and K2
# launch of the main path through its sm90 kernel
ENTRIES = {"extract_topk": ("extract_topk", "extract_topk_sm90_launch"),
           "fused_binmax": ("fused_binmax", "fused_binmax_sm90_launch")}
# K5's entry points on each path: the query encode's L=30 and the
# passage buckets up to 64 take the short-row kernel; passages at
# 64 < L <= 256 (the train path's evaluation, the pipeline's index
# calls, the teacher path's passage tower) attention_infer_d64.cu; the
# MiniLM teacher (head_dim 32) attention_infer_d32.cu, on the teacher
# path and in the serve path's rerank daemon (whose warm-up encodes a
# passage at L=256). No path's K5 takes the sm90 forward or the tiled
# forward (read, to show they stay 0)
K5_ALL = ("attn_infer_short_launch", "attn_infer_d64_launch",
          "attn_infer_d32_launch", "attn_fwd_sm90_launch", "attn_fwd_launch")
K5_ENTRIES = {"train": K5_ALL[:2], "pipeline": K5_ALL[:2],
              "teacher": K5_ALL[:3], "serve": K5_ALL[:3],
              "multi": K5_ALL[:2]}


def reset_launches():
    for mod in _counters().values():
        if isinstance(mod.LAUNCHES, dict):
            for key in mod.LAUNCHES:
                mod.LAUNCHES[key] = 0
        else:
            mod.LAUNCHES = 0
        for counts in ("ENTRY_LAUNCHES", "ROUTE_LAUNCHES"):
            for key in getattr(mod, counts, {}):
                getattr(mod, counts)[key] = 0
        if hasattr(mod, "SHAPE_LAUNCHES"):
            mod.SHAPE_LAUNCHES.clear()


def read_launches():
    """Launches by kernel record (KERNELS; a (name, entry) key reads
    attention's ROUTE_LAUNCHES), as "entry:<name>" by the C entry point
    of ENTRIES, and as "k5:<name>" K5's launches by entry point."""
    mods = _counters()
    out = {}
    att = mods["attention"]
    for name, (m, key), *_ in KERNELS:
        if key is None:
            out[name] = mods[m].LAUNCHES
        elif isinstance(key, tuple):
            out[name] = mods[m].ROUTE_LAUNCHES[key]
        else:
            out[name] = mods[m].LAUNCHES[key]
    for m, entry in ENTRIES.values():
        out[f"entry:{entry}"] = mods[m].ENTRY_LAUNCHES[entry]
    for entry in K5_ALL:
        out[f"k5:{entry}"] = att.ROUTE_LAUNCHES[("infer", entry)]
    out["k5"] = att.LAUNCHES["infer"]  # K5, every route
    # K5 by shape: "shape:<entry>:<B>x<L>"
    for (name, entry, b, length), n in att.SHAPE_LAUNCHES.items():
        if name == "infer" and n:
            out[f"shape:{entry}:{b}x{length}"] = n
    return out


def check_entries(path, window):
    """Every K1 and K2 launch of a path's window went through the Hopper
    entry point, and every K5 launch through the entry points its path
    names (K5_ENTRIES; the short-row kernel elsewhere)."""
    for name, (_, entry) in ENTRIES.items():
        if window[name] != window[f"entry:{entry}"]:
            raise AssertionError(
                f"the {path} path's {window[name]} {name} launches took "
                f"{entry} {window[f'entry:{entry}']} times")
    k5 = K5_ENTRIES.get(path, ("attn_infer_short_launch",))
    through = sum(window[f"k5:{e}"] for e in k5)
    if window["k5"] != through:
        raise AssertionError(
            f"the {path} path's {window['k5']} K5 launches took "
            f"{'/'.join(k5)} {through} times")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--compare-routes", metavar="OUT_JSON", default=None,
                   help="instead of the smoke run: build the kernels, run "
                        "the train-attention route study (phase_routes) "
                        "and write its results to OUT_JSON")
    p.add_argument("--data-parallel", metavar="OUT_JSON", default=None,
                   help="instead of the smoke run: build the kernels, write "
                        "the train phase's corpus, run the multi phase's "
                        "data-parallel check (_multi_dp) over every visible "
                        "GPU and write its results to OUT_JSON")
    args = p.parse_args(argv)

    if not torch.cuda.is_available():
        log("chip_smoke: CUDA is not available")
        return 2
    dev = torch.device("cuda", 0)
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
    if args.compare_routes:
        run("routes", phase_routes)
        with open(args.compare_routes, "w") as f:
            json.dump(ctx["routes"], f, indent=1)
        log(smi_line())
        return 0
    if args.data_parallel:
        work = os.path.join(WORK, "pipeline")
        shutil.rmtree(work, ignore_errors=True)
        os.makedirs(work)
        ctx["corpus"] = _write_corpus(work, N_PIPELINE, N_QUERIES, args.seed)
        _write_training_files(work, N_QUERIES, N_PIPELINE, args.seed)
        reset_launches()
        res = run("data-parallel", _multi_dp)
        shutil.rmtree(WORK, ignore_errors=True)
        res["card"] = smi_line()
        with open(args.data_parallel, "w") as f:
            json.dump(res, f, indent=1)
        log(smi_line())
        return 0
    run("kernels", phase_kernels)
    ctx["stores"] = run("prepare", prepare_search)
    # each path of the port runs in its own counted window: the counts are
    # set to 0 just before it and read just after, and every kernel the
    # path must reach has launched there
    launches = {name: 0 for name, *_ in KERNELS}
    for name, fn, needs in (
            ("search", lambda c: phase_search(c, *c.pop("stores")),
             ("extract_topk", "fused_binmax")),
            ("train", phase_train,
             ("attention_train_fwd", "attention_train_bwd", "extract_topk",
              "attention_infer", "attention_infer_d64", "residual_norm_fwd",
              "residual_norm_bwd")),
            ("pipeline", phase_pipeline,
             ("extract_topk", "attention_infer", "attention_infer_d64",
              "residual_norm_fwd")),
            ("teacher", phase_teacher,
             ("attention_infer", "attention_infer_d64",
              "attention_infer_d32", "residual_norm_fwd")),
            ("serve", phase_serve,
             ("ivf_probe", "extract_topk", "attention_infer_d32",
              "residual_norm_fwd")),
            ("multi", phase_multi,
             ("extract_topk", "fused_binmax", "ivf_probe",
              "attention_train_fwd", "attention_train_bwd",
              "attention_infer", "attention_infer_d64", "residual_norm_fwd",
              "residual_norm_bwd"))):
        reset_launches()
        own = run(name, fn)
        # the serve phase checks its answers through the same kernels, so
        # it counts its path's own spans apart and returns them; the multi
        # phase adds its spawned ranks' launches
        window = read_launches() if own is None else own
        log(f"[{name}] kernel launches: {window}")
        missing = [k for k in needs if window[k] <= 0]
        if missing:
            raise AssertionError(f"the {name} path launched no {missing}")
        check_entries(name, window)
        for k, v in window.items():
            launches[k] = launches.get(k, 0) + v
        torch.cuda.empty_cache()
    # K7's path is the kernels phase's A/B (no path of the port reaches it)
    launches["int8_dot"] += ctx["k7_launches"]
    missing = [k for k, v in launches.items() if v <= 0
               and not k.startswith(("entry:", "k5:", "shape:"))
               and k != "k5"]
    if missing:
        raise AssertionError(f"main path launched no {missing}")
    log(f"[main path] kernel launches: {launches}")
    log(f"total {time.perf_counter() - t_all:.1f} s")
    # every measurement of the run, unrounded, on one line
    log("results " + json.dumps({
        k: ctx.get(k) for k in ("timings", "search_layer_ms", "search",
                                "train", "pipeline", "teacher", "serve",
                                "multi",
                                "k1_err", "k5_teacher_err",
                                "attn_tight", "attn_exact_elements",
                                "attn_model_calls",
                                "k2_err", "k2_checked", "k6_err",
                                "attn_err_fp32",
                                "attn_err_bf16",
                                "k5_err", "k1_checked", "build_s",
                                "k7_err", "k7_summary", "wgmma_counts",
                                "rn_err")}))
    log(smi_line())
    def by_shape(counter):
        """The main path's K5 launches of one entry point, by B x L."""
        if not isinstance(counter[1], tuple):
            return None
        prefix = f"shape:{counter[1][1]}:"
        return {k[len(prefix):]: v for k, v in launches.items()
                if k.startswith(prefix)}

    log(json.dumps({"kernels": [
        _kernel_record(ctx, name, f"cldrd_tpu_torch/{src}", ref, tag,
                       launches[name], ctx[err], by_shape(counter))
        for name, counter, src, ref, tag, err in KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
