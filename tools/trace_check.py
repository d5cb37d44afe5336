#!/usr/bin/env python3
"""Does ``utils.profiling.trace`` hold every kernel launched inside it?

On the card, at the shape of chip_smoke's traced pipeline retrieve
(a 32,768 x 768 bf16 store, 1,024 queries searched at B=512, k=100: two
K1 launches a call through ``FlatIPIndex.search_batched``), trace the
search ``--reps`` times in each variant and count, per trace, K1's
kernel events against its launch counter, every kernel event against
every kernel launch the runtime API events show, and, for each launch
whose kernel event is missing, where it fell in the window (ms after the
first event and before the last):

- plain: the search alone inside the trace;
- sync_first: every device synchronized right after the trace starts;
- sleep_first: 50 ms of host sleep right after the trace starts;
- sleep_last: 50 ms of host sleep after the search, before the trace
  stops;
- spin_first: a 2e7-cycle spin kernel (``torch.cuda._sleep``, ~10 ms)
  on the device right after the trace starts.

Each trace also gives the spread of (kernel start - its launch's host
timestamp) over its launches: a kernel cannot start before its launch,
so a negative offset measures how far the device's timestamps run
behind the host's, which would push a kernel launched early in the
window outside it. The variants run again after each of ``--ages``
seconds of idling (CUPTI started at age 0 by a device-only
torch.profiler session, as chip_smoke.device_ms starts it; with
``--no-early-session`` the first trace starts it).

    python3 tools/trace_check.py --out OUT.json [--reps 10] [--ages 0 120]
        [--keep DIR]

``--keep DIR`` copies each age's first plain trace into DIR.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from cldrd_tpu_torch.index import FlatIPIndex  # noqa: E402
from cldrd_tpu_torch.ops import extract_topk as k1  # noqa: E402
from cldrd_tpu_torch.utils.profiling import read_trace, trace  # noqa: E402

K1 = re.compile(r"\b(?:%s)\b" % "|".join(k1.KERNEL_NAMES.values()))
LAUNCH = re.compile(r"^cu(?:da)?LaunchKernel")


def _sync_all():
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


VARIANTS = {
    "plain": (None, None),
    "sync_first": (_sync_all, None),
    "sleep_first": (lambda: time.sleep(0.05), None),
    "sleep_last": (None, lambda: time.sleep(0.05)),
    "spin_first": (lambda: torch.cuda._sleep(20_000_000), None),
}


def traced_search(index, q, logdir, first, last):
    before = k1.LAUNCHES
    with trace(logdir):
        if first:
            first()
        index.search_batched(q, 100, 512)
        if last:
            last()
    events = read_trace(logdir)
    kernels = [e for e in events if e.get("cat") == "kernel"]
    launches = [e for e in events if e.get("cat") == "cuda_runtime"
                and LAUNCH.match(e["name"])]
    seen = {e["args"].get("correlation"): e for e in kernels}
    lost = [e for e in launches if e["args"].get("correlation") not in seen]
    offsets = sorted(seen[e["args"]["correlation"]]["ts"] - e["ts"]
                     for e in launches if e["args"].get("correlation") in seen)
    stamps = [e["ts"] for e in events if "ts" in e and e.get("ph") == "X"]
    t0, t1 = min(stamps), max(e["ts"] + e.get("dur", 0) for e in events
                               if "ts" in e and e.get("ph") == "X")
    return {"k1_launches": k1.LAUNCHES - before,
            "k1_events": sum(bool(K1.search(e["name"])) for e in kernels),
            "kernel_events": len(kernels), "launch_events": len(launches),
            "lost_at_ms": [[round((e["ts"] - t0) / 1e3, 3),
                            round((t1 - e["ts"]) / 1e3, 3)] for e in lost],
            "launch_to_kernel_us": [offsets[0], offsets[len(offsets) // 2],
                                    offsets[-1]] if offsets else None}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", required=True)
    p.add_argument("--reps", type=int, default=10)
    p.add_argument("--ages", type=float, nargs="+", default=[0.0])
    p.add_argument("--keep", default=None)
    p.add_argument("--no-early-session", action="store_true")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("trace_check: CUDA is not available")
        return 2
    rng = np.random.default_rng(0)
    store = rng.standard_normal((32_768, 768), np.float32)
    index = FlatIPIndex.build(store, np.arange(32_768), device="cuda")
    q = rng.standard_normal((1024, 768), np.float32)
    index.search_batched(q, 100, 512)  # build, load and warm K1
    torch.cuda.synchronize()
    from torch.profiler import ProfilerActivity, profile

    if not args.no_early_session:
        with profile(activities=[ProfilerActivity.CUDA]):
            index.search_batched(q, 100, 512)
            torch.cuda.synchronize()
    t_cupti = time.perf_counter()
    out = {"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), "torch": torch.__version__,
        "env": {k: v for k, v in os.environ.items()
                if "CUPTI" in k or "KINETO" in k}}
    root = tempfile.mkdtemp()
    try:
        for age in args.ages:
            time.sleep(max(0.0, t_cupti + age - time.perf_counter()))
            res = out.setdefault(f"age_{age:g}", {})
            for rep in range(args.reps):
                for name, (first, last) in VARIANTS.items():
                    logdir = os.path.join(root, f"{age}_{name}_{rep}")
                    res.setdefault(name, []).append(
                        traced_search(index, q, logdir, first, last))
                    if args.keep and rep == 0 and name == "plain":
                        shutil.copytree(logdir, os.path.join(
                            args.keep, f"age_{age:g}"), dirs_exist_ok=True)
            for name, runs in res.items():
                print(f"age {age:g} s", name, "complete",
                      sum(r["k1_events"] == r["k1_launches"] for r in runs),
                      "of", len(runs), "lost",
                      [r["lost_at_ms"] for r in runs if r["lost_at_ms"]],
                      "launch->kernel us (min, median, max) of the first",
                      runs[0]["launch_to_kernel_us"])
    finally:
        shutil.rmtree(root, ignore_errors=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
