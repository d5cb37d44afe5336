"""Measure the design choices of K1 (csrc/extract_topk_sm90.cu) on one card.

    python3 tools/k1_variants.py --out OUT.json

Builds, with the port's nvcc flags, into build/k1_variants/:
- ``kept``: csrc/extract_topk_sm90.cu as it is;
- ``hbm_order``: the same with the block order turned around (a
  super-block's B/64 blocks run one grid-width apart instead of side by
  side), so every re-read of a super-block misses L2: its time beside
  ``kept`` is what L2 sharing buys;
- ``wait0``: the same with ``wgmma.wait_group 0`` after every chunk (no
  product in flight while the next chunk's fragments are written);
- ``nocopy``: the same without ``copy_reg`` (bf16 fragments as plain
  copies of their loads): built for its machine code only;
- ``parts``: tools/k1_parts.cu, the score loop alone with 64 or 128
  queries a block, its rows loaded by the wgmma warps or through a
  producer warp's ring (TMA, 64-byte bulk copies or 16-byte cp.async),
  and, with 64 queries and register loads, without the widening or
  without the products, or the products alone (their ``checked`` is then
  false by design).

Then checks each library's SASS for wgmma register hazards
(``cldrd_tpu_torch/ops/_wgmma_check.py``), and times the variants at K1's
main-path shape (B=512 over an 8,847,360 x 768 int8 store with scales,
R=5, R2=8; the 1,048,576-row bf16 store at R=7, R2=16 for ``kept`` and
``wait0``), each library in a process of its own, as device times
(``chip_smoke.device_ms``). Also lists the kernels torch.profiler records
for ``scaled_dot_product_attention`` at B=240, L=256 under each backend,
beside CUDA-event times. Writes one JSON object to ``--out``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
OUT_DIR = ROOT / "build" / "k1_variants"
SRC = ROOT / "cldrd_tpu_torch" / "csrc" / "extract_topk_sm90.cu"
PATCHES = {
    "kept": [],
    "hbm_order": [("  const int qc = blockIdx.x % nqc;\n"
                   "  const long long sup = blockIdx.x / nqc;",
                   "  const int qc = blockIdx.x / nsup;\n"
                   "  const long long sup = blockIdx.x % nsup;")],
    "wait0": [("          wg_commit();\n          wg_wait<1>();",
               "          wg_commit();\n          wg_wait<0>();")],
    "nocopy": [("copy_reg(w[2 * s])", "w[2 * s]"),
               ("copy_reg(w[2 * s + 1])", "w[2 * s + 1]")],
}
N_INT8, N_BF16, D, B = 8_847_360, 1_048_576, 768, 512


def build():
    from cldrd_tpu_torch.ops import _build

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    src = SRC.read_text()
    jobs = {}
    for name, edits in PATCHES.items():
        text = src
        for old, new in edits:
            if text.count(old) < 1:
                raise AssertionError(f"{name}: patch target not found")
            text = text.replace(old, new)
        (OUT_DIR / f"{name}.cu").write_text(text)
    for name in [*PATCHES, "parts"]:
        cu = (ROOT / "tools" / "k1_parts.cu" if name == "parts"
              else OUT_DIR / f"{name}.cu")
        jobs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I",
             str(_build.CSRC_DIR), "-o", str(OUT_DIR / f"{name}.so"),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    report = {}
    for name, proc in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc {name}:\n{log}")
        report[name] = [ln.strip() for ln in log.splitlines()
                        if "registers" in ln or "spill" in ln]
    return report


def sass_hazards():
    from cldrd_tpu_torch.ops import _wgmma_check

    out = {}
    for name in [*PATCHES, "parts"]:
        sass = _wgmma_check.library_sass(OUT_DIR / f"{name}.so")
        (OUT_DIR / f"{name}.sass").write_text(sass)
        hz = _wgmma_check.hazards(sass)
        out[name] = {"hgmma": sum(ln.count("HGMMA") for ln in
                                  sass.splitlines()),
                     "hazards": len(hz), "first": [str(h) for h in hz[:6]]}
    return out


# ------------------------------------------------------------ workers


def _stores(dev):
    import torch

    gen = torch.Generator(device=dev).manual_seed(0)
    c8 = torch.randint(-127, 128, (N_INT8, D), generator=gen, device=dev,
                       dtype=torch.int8)
    scales = (torch.rand(N_INT8, generator=gen, device=dev) + 0.5) / 127
    ids8 = torch.arange(N_INT8, dtype=torch.int32, device=dev)
    cb = (torch.randint(-32, 33, (N_BF16, D), generator=gen, device=dev,
                        dtype=torch.int8).to(torch.bfloat16) / 16)
    idsb = torch.arange(N_BF16, dtype=torch.int32, device=dev)
    q = torch.randn(B, D, generator=gen, device=dev).to(torch.bfloat16)
    qi = torch.randint(-4, 5, (B, D), generator=gen, device=dev).to(
        torch.bfloat16)
    return c8, scales, ids8, cb, idsb, q, qi


def _k1_call(lib, q, c, ids, scales, r, r2):
    import torch

    fn = lib.extract_topk_sm90_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                    ctypes.c_int] + [ctypes.c_void_p] * 5
                   + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    bz, nsup = q.shape[0], c.shape[0] // 2048
    dev = q.device
    outs = (torch.empty(bz, nsup, r2, device=dev),
            torch.empty(bz, nsup, r2, dtype=torch.int32, device=dev),
            torch.empty(bz, nsup, device=dev))
    code = {torch.bfloat16: 1, torch.int8: 2}

    def call():
        rc = fn(q.data_ptr(), 1, c.data_ptr(), code[c.dtype],
                ids.data_ptr(), None if scales is None else scales.data_ptr(),
                *(o.data_ptr() for o in outs), bz, nsup, D, r, r2,
                torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"launch failed: {rc}")
        return outs
    return call


def worker(name):
    import torch

    import chip_smoke as cs

    dev = torch.device("cuda")
    c8, scales, ids8, cb, idsb, q, qi = _stores(dev)
    res = {}
    lib = ctypes.CDLL(str(OUT_DIR / f"{name}.so"))
    if name == "parts":
        return _parts(lib, q, qi, c8, cs)
    k1 = _k1_call(lib, q, c8, ids8, scales, 5, 8)
    res["int8_B512_ms"] = cs.device_ms(k1, reps=5, warmup=1)
    if name == "kept":
        res["int8_B64_ms"] = cs.device_ms(
            _k1_call(lib, q[:64].contiguous(), c8, ids8, scales, 5, 8),
            reps=5, warmup=1)
    res["bf16_1M_B512_ms"] = cs.device_ms(
        _k1_call(lib, q, cb, idsb, None, 7, 16), reps=5, warmup=1)
    if name == "wait0":  # held to the plain version on integer inputs
        from cldrd_tpu_torch.ops.extract_topk import extract_topk_plain
        for tag, c, ids, sc, r, r2 in (("int8", c8, ids8, scales, 5, 8),
                                       ("bf16", cb, idsb, None, 7, 16)):
            n = 2048 * 512
            got = _k1_call(lib, qi, c[:n], ids[:n], None if sc is None
                           else sc[:n], r, r2)()
            ref = extract_topk_plain(qi, c[:n], ids[:n], r, r2, 128,
                                     None if sc is None else sc[:n])
            res[f"{tag}_equal"] = all(torch.equal(a, b)
                                      for a, b in zip(got, ref))
    return res


def _parts(lib, q, qi, c8, cs):
    """Each (queries a block, ring) variant's time, and a check that it
    computed every score: on integer-valued queries, the max over a
    block's outputs equals the max of its queries' scores over its
    super-block."""
    import torch

    fn = lib.k1_parts_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p])
    nsup = c8.shape[0] // 2048
    out = torch.empty(nsup * (B // 64) * 256, device=q.device)
    res = {}
    modes = ("ldg", "tma", "bulk", "cpasync", "nowiden", "nomma",
             "products")
    for qb, mode in ([(64, m) for m in range(7)]
                     + [(128, m) for m in (0, 1, 2, 3, 6)]):
        tag = f"qb{qb}_{modes[mode]}"

        def call(qq=q, ns=nsup, qb=qb, mode=mode, tag=tag):
            rc = fn(qq.data_ptr(), c8.data_ptr(), out.data_ptr(), B, ns, D,
                    qb, mode, torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"{tag}: launch failed: {rc}")
        call(qi, 8)
        torch.cuda.synchronize()
        nq = B // qb
        got = out[:8 * nq * 256].view(8, nq, 256).amax(-1)
        s = (qi.float() @ c8[:8 * 2048].float().T).view(nq, qb, 8, 2048)
        ref = s.amax(dim=(1, 3)).T
        res[f"{tag}_checked"] = bool(torch.equal(got, ref))
        res[f"{tag}_ms"] = cs.device_ms(call, reps=5, warmup=1)
    return res


def sdpa():
    """Kernels and times of scaled_dot_product_attention at B=240, L=256
    (chip_smoke's K5 library call), under the default choice and each
    backend forced."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs

    dev = torch.device("cuda")
    ctx = {"dev": dev, "gen": torch.Generator(device=dev).manual_seed(0)}
    q, k, v, _, mask, _ = cs._attn_inputs(ctx, 240, 256, torch.bfloat16,
                                          False)
    amask = (mask != 0)[:, None, None, :]
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    out = {"bound_ms": cs.bound_ms(*cs._attn_bytes_ops(240, 256,
                                                       torch.bfloat16, 4, 2),
                                   "bf16")[0]}
    choices = [("default", None), ("efficient", SDPBackend.EFFICIENT_ATTENTION),
               ("cudnn", SDPBackend.CUDNN_ATTENTION),
               ("math", SDPBackend.MATH)]
    for tag, backend in choices:
        def lib():
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=amask)
        try:
            cm = sdpa_kernel([backend]) if backend else _null()
            with cm:
                lib()
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(20):
                        lib()
                    torch.cuda.synchronize()
                kernels = {
                    e.key: [e.count, round(getattr(
                        e, "self_device_time_total",
                        getattr(e, "self_cuda_time_total", 0.0)) / 20e3, 5),
                        str(e.device_type)]
                    for e in prof.key_averages()}
                out[tag] = {"kernels": kernels,
                            "device_ms": cs.device_ms(lib),
                            "event_ms": cs.time_ms(lib, reps=50, warmup=3)}
        except RuntimeError as e:
            out[tag] = {"error": str(e)[:300]}
    return out


class _null:
    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out")
    ap.add_argument("--worker")
    ap.add_argument("--sdpa", action="store_true")
    ap.add_argument("--only", nargs="*", help="workers to run (default: "
                    "kept hbm_order wait0 parts kept sdpa)")
    args = ap.parse_args()
    if args.worker or args.sdpa:
        res = worker(args.worker) if args.worker else sdpa()
        print("RESULT " + json.dumps(res), flush=True)
        return 0
    t0 = time.perf_counter()
    result = {"registers": build(), "build_s": time.perf_counter() - t0}
    result["sass"] = sass_hazards()
    print(json.dumps(result["sass"], indent=1), flush=True)
    runs = {}
    # the kept kernel first and last: the drift between them bounds how
    # far apart two processes' readings are on this card
    for i, name in enumerate(args.only or ["kept", "hbm_order", "wait0",
                                           "parts", "kept", "sdpa"]):
        argv = ["--sdpa"] if name == "sdpa" else ["--worker", name]
        p = subprocess.run([sys.executable, __file__, *argv],
                           capture_output=True, text=True, timeout=600)
        line = [ln for ln in p.stdout.splitlines()
                if ln.startswith("RESULT ")]
        runs[f"{i}_{name}"] = (json.loads(line[-1][7:]) if line else
                               {"rc": p.returncode,
                                "stderr": p.stderr[-2000:]})
        print(name, json.dumps(runs[f"{i}_{name}"]), flush=True)
    result["runs"] = runs
    result["smi"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result, indent=1))
    print(result["smi"], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
