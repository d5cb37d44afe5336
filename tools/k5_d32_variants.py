"""Measure the parts of K5's head_dim-32 kernel (csrc/attention_infer_d32.cu)
on one card.

    python3 tools/k5_d32_variants.py --out OUT.json [--only NAME ...]
                                     [--source OTHER.cu]

Builds, with the port's nvcc flags, into build/k5_d32_variants/, patched
copies of csrc/attention_infer_d32.cu:
- ``kept``: the source as it is;
- ``no_skip``: every key tile kept, padded or not (the function is the
  same, so its bits must EQUAL ``kept``'s: what skipping saves);
- ``fast_exp``: ``__expf`` (ex2.approx of x * log2 e) in place of
  ``expf`` (another function, within a few fp32 ulps);
- ``no_exp`` (timing only, the output is wrong): the softmax's
  exponentials replaced by the difference itself;
- ``blocks3``: ``__launch_bounds__`` for 3 resident blocks an SM in place
  of 4 (more registers, fewer warps);
- ``warps8``: eight warps a block (two row tiles each at L = 256) and
  two resident blocks an SM, in place of four warps and four blocks;
- ``no_store`` (timing only): no output stores;
- ``timeline``: each block records, for its thread 0, its SM, the cycles
  of its three phases (the mask and the kept tiles; the copies and the
  barrier; the row tiles, to a closing barrier), its kept tiles and the
  global timer at its start and end, read back after one launch.

Then, each library in a process of its own (several libraries exporting
the same C symbol in one process fail), holds the variants that keep the
function to ``attention_plain`` (within 2e-2 of the largest magnitude on
normal data, EQUAL on the exact forms q0 and k0 with the pair padding,
one all-masked row and a holed mask; ``no_skip`` also EQUAL to ``kept``
on normal data) and times every variant at the MiniLM-L6 teacher's shape
(B=128, L=256, H=12, D=32, bf16, pairs of 39-90 real tokens) as device
times (``chip_smoke.device_ms``), twice each, with the blocks an SM holds.
Writes one JSON object to ``--out``.

``--source`` also builds another copy of the kernel with the same entry
points (an earlier design) as it is, ``source_kept``, checked and timed
beside the variants in the same call.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
OUT_DIR = ROOT / "build" / "k5_d32_variants"
SRC = ROOT / "cldrd_tpu_torch" / "csrc" / "attention_infer_d32.cu"
PATCHES = {
    "kept": [],
    "no_skip": [("__ballot_sync(FULL, lane < ntile && (real != 0 || !any));",
                 "__ballot_sync(FULL, lane < ntile);")],
    "fast_exp": [("s[2 * j + hn][e] = expf(", "s[2 * j + hn][e] = __expf(")],
    "no_exp": [("s[2 * j + hn][e] = expf(s[2 * j + hn][e] - m[e >> 1]);",
                "s[2 * j + hn][e] = s[2 * j + hn][e] - m[e >> 1];")],
    "blocks3": [("__launch_bounds__(THREADS, 4)",
                 "__launch_bounds__(THREADS, 3)")],
    "warps8": [("constexpr int WARPS = 4;", "constexpr int WARPS = 8;"),
               ("__launch_bounds__(THREADS, 4)",
                "__launch_bounds__(THREADS, 2)")],
    "no_store": [("      if (r < L)\n", "      if (r < 0)\n")],
    "timeline": [
        ("__global__ void __launch_bounds__(THREADS, 4)",
         "__device__ unsigned long long d32_timeline[65536 * 8];\n"
         "__global__ void __launch_bounds__(THREADS, 4)"),
        ("  extern __shared__ __align__(128) unsigned char smem[];\n",
         "  extern __shared__ __align__(128) unsigned char smem[];\n"
         "  const long long tl0 = clock64();\n"
         "  unsigned long long gt0;\n"
         "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(gt0));\n"),
        ("  // K and V of the kept tiles: slot s",
         "  const long long tl1 = clock64();\n"
         "  // K and V of the kept tiles: slot s"),
        ("  __syncthreads();\n\n  const int mi",
         "  __syncthreads();\n  const long long tl2 = clock64();\n\n"
         "  const int mi"),
        ("                                  t * 8) = row;\n    }\n  }\n}\n",
         "                                  t * 8) = row;\n    }\n  }\n"
         "  __syncthreads();\n"
         "  if (threadIdx.x == 0) {\n"
         "    unsigned smid;\n"
         "    asm volatile(\"mov.u32 %0, %%smid;\" : \"=r\"(smid));\n"
         "    unsigned long long gt3;\n"
         "    asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(gt3));\n"
         "    unsigned long long* rec =\n"
         "        d32_timeline + 8 * (blockIdx.y * gridDim.x + blockIdx.x);\n"
         "    rec[0] = smid;\n    rec[1] = tl1 - tl0;\n"
         "    rec[2] = tl2 - tl1;\n    rec[3] = clock64() - tl2;\n"
         "    rec[4] = gt0;\n    rec[5] = gt3;\n    rec[6] = nkept;\n"
         "  }\n}\n"),
        ("}  // namespace cldrd_attn_d32\n",
         "}  // namespace cldrd_attn_d32\n\n"
         "extern \"C\" int d32_timeline_read(void* dst, int blocks) {\n"
         "  return (int)cudaMemcpyFromSymbol(\n"
         "      dst, cldrd_attn_d32::d32_timeline,\n"
         "      blocks * 8 * sizeof(unsigned long long));\n"
         "}\n")],
}
KEEPS_FUNCTION = ("kept", "no_skip", "fast_exp", "blocks3", "warps8",
                  "timeline")
B, L, H, D = 128, 256, 12, 32


def _patched(name: str, src: str) -> str:
    for old, new in PATCHES[name]:
        if src.count(old) != 1:
            raise AssertionError(f"{name}: patch target not found once")
        src = src.replace(old, new)
    return src


def build(names, src_path=SRC, prefix=""):
    from cldrd_tpu_torch.ops import _build

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    src = Path(src_path).read_text()
    jobs = {}
    for name in names:
        name = prefix + name
        cu = OUT_DIR / f"{name}.cu"
        cu.write_text(_patched(name[len(prefix):], src))
        jobs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC_DIR),
             "-o", str(OUT_DIR / f"{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    out = {}
    for name, proc in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        out[name] = [line.strip() for line in log.splitlines()
                     if "registers" in line or "spill" in line]
    return out


def _launch(lib, q, k, v, mask):
    import torch

    out = torch.empty_like(q)
    fn = lib.attn_infer_d32_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                   + [ctypes.c_float, ctypes.c_void_p])
    scale = float(torch.tensor(D ** -0.5).to(torch.bfloat16))
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
             out.data_ptr(), q.shape[0], q.shape[1], q.shape[2], scale,
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed with CUDA error {err}")
    return out


def _masks(ctx):
    """chip_smoke's teacher masks: the pair padding (39-90 real keys), the
    same with one row all masked, and a holed mask."""
    import chip_smoke as cs

    pairs = cs._pair_mask(ctx, B, L)
    one = pairs.clone()
    one[B // 2] = 0
    return {"pairs": pairs, "one_all_masked": one,
            "holes": cs._holed_mask(ctx, B, L)}


def _timeline(lib, call):
    """One launch's per-block records (see ``timeline``): phase cycles
    (mean and percentiles over the blocks), blocks an SM ran, the
    kernel's span and the blocks' mean span on the global timer (ns)."""
    import numpy as np
    import torch

    call()
    torch.cuda.synchronize()
    n = B * H  # one block an item (b, h)
    buf = (ctypes.c_ulonglong * (8 * n))()
    err = lib.d32_timeline_read(buf, n)
    if err:
        raise RuntimeError(f"timeline read failed with CUDA error {err}")
    rec = np.frombuffer(buf, dtype=np.uint64).reshape(n, 8).astype(np.int64)
    out = {}
    for i, phase in ((1, "mask_cycles"), (2, "copies_cycles"),
                     (3, "rows_cycles")):
        out[phase] = {"mean": float(rec[:, i].mean()),
                      **{f"p{p}": float(np.percentile(rec[:, i], p))
                         for p in (10, 50, 90)}}
    per_sm = np.bincount(rec[:, 0])
    out["blocks_per_sm_run"] = [int(per_sm.min()), int(per_sm.max())]
    out["span_ns"] = int(rec[:, 5].max() - rec[:, 4].min())
    out["block_ns_mean"] = float((rec[:, 5] - rec[:, 4]).mean())
    out["kept_tiles_mean"] = float(rec[:, 6].mean())
    return out


def worker(lib_name):
    """One library in this process: its checks and its times."""
    import torch

    import chip_smoke as cs
    from cldrd_tpu_torch.ops.attention import attention_plain

    lib = ctypes.CDLL(str(OUT_DIR / f"{lib_name}.so"))
    name = lib_name.removeprefix("source_")
    blocks = lib.attn_infer_d32_blocks_per_sm
    blocks.argtypes, blocks.restype = [ctypes.c_int], ctypes.c_int
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    masks = _masks({"dev": dev, "gen": g})
    q, k, v = (torch.randn(B, L, H, D, generator=g, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    res = {"blocks_per_sm": blocks(L)}
    if name in KEEPS_FUNCTION:
        errs, exact = {}, True
        for tag, m in masks.items():
            ref = attention_plain(q, k, v, m).float()
            got = _launch(lib, q, k, v, m).float()
            errs[tag] = ((got - ref).abs().max() / ref.abs().max()).item()
            for xs in cs._exact_forms(dev, (B, L, H, D)).values():
                exact &= torch.equal(_launch(lib, *xs, m),
                                     attention_plain(*xs, m))
        res["rel_err"], res["exact_equal"] = errs, bool(exact)
        torch.save(_launch(lib, q, k, v, masks["pairs"]).cpu(),
                   OUT_DIR / f"{lib_name}.out.pt")
    mask = masks["pairs"]
    call = lambda: _launch(lib, q, k, v, mask)  # noqa: E731
    res["ms"] = [cs.device_ms(call) for _ in range(2)]
    if name == "timeline":
        res["timeline"] = _timeline(lib, call)
    res["card"] = cs.smi_line()
    print(json.dumps(res))


def main():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--out", required=True)
    p.add_argument("--only", nargs="*", default=list(PATCHES))
    p.add_argument("--source", default=None)
    p.add_argument("--worker", help=argparse.SUPPRESS)
    args = p.parse_args()
    if args.worker:
        worker(args.worker)
        return
    import torch

    names = list(args.only)
    out = {"registers": build(names), "runs": {}}
    if args.source:
        out["source"] = args.source
        out["registers"].update(build(["kept"], args.source, "source_"))
        names.append("source_kept")
    for name in names:
        proc = subprocess.run([sys.executable, __file__, "--out", args.out,
                               "--worker", name], capture_output=True,
                              text=True, cwd=ROOT)
        if proc.returncode:
            raise RuntimeError(f"{name} failed:\n{proc.stderr[-3000:]}")
        out["runs"][name] = json.loads(proc.stdout.strip().splitlines()[-1])
        print(name, out["registers"][name], out["runs"][name], flush=True)
    if "kept" in names and "no_skip" in names:
        out["no_skip_equals_kept"] = torch.equal(
            *(torch.load(OUT_DIR / f"{n}.out.pt") for n in ("kept",
                                                            "no_skip")))
        print("no_skip EQUAL to kept:", out["no_skip_equals_kept"])
    Path(args.out).write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
