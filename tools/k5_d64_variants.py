"""Measure the parts of K5's head_dim-64 kernel (csrc/attention_infer_d64.cu)
on one card.

    python3 tools/k5_d64_variants.py --out OUT.json [--only NAME ...]
                                     [--source OTHER.cu]

Builds, with the port's nvcc flags, into build/k5_d64_variants/, patched
copies of csrc/attention_infer_d64.cu:
- ``kept``: the source as it is;
- ``no_skip``: every key tile kept, padded or not (the function is the
  same, so its bits must EQUAL ``kept``'s: what skipping saves);
- ``exact_exp``: ``expf`` of the scaled difference in place of
  ``ex2.approx`` (another rounding of the same function);
- ``div_norm``: each probability the correctly rounded e / sum
  (attention_sm90.cu's div_row) in place of e * (1 / sum) (another
  rounding of the same function);
- ``even_pairs``, ``quads``: kept slots rounded up to four or to eight
  (pad slots of zeros), so blocks take two or four of the instantiations
  (fewer code paths, more products);
- ``no_exp`` (timing only, the output is wrong): the exponentials
  replaced by their arguments;
- ``short3``: the 8-tile build (L <= 128) for 3 resident blocks an SM in
  place of 4 (more registers, fewer warps);
- ``no_store`` (timing only): no output stores;
- ``timeline``: each block records, for its thread 0, its SM, the cycles
  of its three phases (the mask, the ballots and the fills; the copies
  and the barrier that Q and K have arrived; the query chunks, V's wait
  included, to a closing barrier), its kept tiles and the global timer
  at its start and end, read back after one launch.

Then, each library in a process of its own (several libraries exporting
the same C symbol in one process fail), holds the variants that keep the
function to ``attention_plain`` (within 2e-2 of the largest magnitude on
normal data, EQUAL on the exact forms q0 and k0, with a bucket's padding,
a holed mask and all-masked rows) and times every variant, twice each,
at four shapes of the passage tower (bf16, H=12, D=64): B=240, L=256
(one row half padded), the buckets' 1024x128 and 512x256
(``chip_smoke._ladder_mask``) and the flat index build's 512x256
(``chip_smoke._padded_mask``: 32-86 real keys of 256), as device times
(``chip_smoke.device_ms``), with the blocks an SM holds. ``kept`` also
times, in the same process, the sm90 forward at p=0 forced (the route's
old kernel) and scaled_dot_product_attention. Writes one JSON object to
``--out``.

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
OUT_DIR = ROOT / "build" / "k5_d64_variants"
SRC = ROOT / "cldrd_tpu_torch" / "csrc" / "attention_infer_d64.cu"
EXP = "s[8 * j + e] = ex2_approx((s[8 * j + e] - m[(e >> 1) & 1]) * c2);"
PATCHES = {
    "kept": [],
    "no_skip": [("__ballot_sync(FULL, lane < ntile && (real != 0 || !any));",
                 "__ballot_sync(FULL, lane < ntile);")],
    "exact_exp": [(EXP, "s[8 * j + e] = expf((s[8 * j + e] - "
                        "m[(e >> 1) & 1]) * SCALE);")],
    "div_norm": [("      pa[i] = pack_bf16(s[2 * i] * rl[x], s[2 * i + 1] * rl[x]);",
                  "      pa[i] = pack_bf16(\n"
                  "          fmaf(fmaf(-s[2 * i] * rl[x], l[x], s[2 * i]), "
                  "rl[x], s[2 * i] * rl[x]),\n"
                  "          fmaf(fmaf(-s[2 * i + 1] * rl[x], l[x], "
                  "s[2 * i + 1]), rl[x], s[2 * i + 1] * rl[x]));")],
    "even_pairs": [("  return (((L + KT - 1) / KT) + 1) & ~1;",
                    "  return (((L + KT - 1) / KT) + 3) & ~3;"),
                   ("nslot = (nkept + 1) & ~1;", "nslot = (nkept + 3) & ~3;")],
    "quads": [("  return (((L + KT - 1) / KT) + 1) & ~1;",
               "  return (((L + KT - 1) / KT) + 7) & ~7;"),
              ("nslot = (nkept + 1) & ~1;", "nslot = (nkept + 7) & ~7;")],
    "no_exp": [(EXP, "s[8 * j + e] = (s[8 * j + e] - m[(e >> 1) & 1]) "
                     "* c2;")],
    "short3": [("using Short = Build<SHORT_TILES, 4>;",
                "using Short = Build<SHORT_TILES, 3>;")],
    "no_store": [("      if (tok < r.L)\n", "      if (tok < 0)\n")],
    "timeline": [
        ("template <int NT, int MINB>\n__global__",
         "__device__ unsigned long long d64_timeline[65536 * 8];\n"
         "template <int NT, int MINB>\n__global__"),
        ("  extern __shared__ unsigned char smem_raw[];\n",
         "  extern __shared__ unsigned char smem_raw[];\n"
         "  const long long tl0 = clock64();\n"
         "  unsigned long long gt0;\n"
         "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(gt0));\n"),
        ("  // K (with Q, group 0), then V (group 1)",
         "  const long long tl1 = clock64();\n"
         "  // K (with Q, group 0), then V (group 1)"),
        ("  __syncthreads();\n\n  const Row r",
         "  __syncthreads();\n  const long long tl2 = clock64();\n\n"
         "  const Row r"),
        ("  rows_by_pairs<NT / 2>(nslot / 2, r);\n}\n",
         "  rows_by_pairs<NT / 2>(nslot / 2, r);\n"
         "  __syncthreads();\n"
         "  if (threadIdx.x == 0) {\n"
         "    unsigned smid;\n"
         "    asm volatile(\"mov.u32 %0, %%smid;\" : \"=r\"(smid));\n"
         "    unsigned long long gt3;\n"
         "    asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(gt3));\n"
         "    unsigned long long* rec =\n"
         "        d64_timeline + 8 * (blockIdx.y * gridDim.x + blockIdx.x);\n"
         "    rec[0] = smid;\n    rec[1] = tl1 - tl0;\n"
         "    rec[2] = tl2 - tl1;\n    rec[3] = clock64() - tl2;\n"
         "    rec[4] = gt0;\n    rec[5] = gt3;\n    rec[6] = nkept;\n"
         "  }\n}\n"),
        ("}  // namespace cldrd_attn_d64\n",
         "}  // namespace cldrd_attn_d64\n\n"
         "extern \"C\" int d64_timeline_read(void* dst, int blocks) {\n"
         "  return (int)cudaMemcpyFromSymbol(\n"
         "      dst, cldrd_attn_d64::d64_timeline,\n"
         "      blocks * 8 * sizeof(unsigned long long));\n"
         "}\n")],
}
KEEPS_FUNCTION = ("kept", "no_skip", "exact_exp", "div_norm", "even_pairs",
                  "quads", "short3", "timeline")
H, D = 12, 64
# (tag, B, L, mask): the passage tower's K5 shapes
SHAPES = (("240x256", 240, 256, "half_row"), ("1024x128", 1024, 128, "ladder"),
          ("512x256", 512, 256, "ladder"), ("512x256_flat", 512, 256, "flat"))


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
                     if any(w in line for w in ("registers", "spill",
                                                "wgmma", "Performance"))]
    return out


def _launch(lib, q, k, v, mask):
    import torch

    out = torch.empty_like(q)
    fn = lib.attn_infer_d64_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                   + [ctypes.c_float, ctypes.c_void_p])
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
             out.data_ptr(), q.shape[0], q.shape[1], q.shape[2], 0.125,
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed with CUDA error {err}")
    return out


def _mask(ctx, kind, b, length):
    import torch

    import chip_smoke as cs

    if kind == "ladder":
        return cs._ladder_mask(ctx, b, length)
    if kind == "flat":
        return cs._padded_mask(ctx, b, length)
    if kind == "holes":
        return cs._holed_mask(ctx, b, length)
    mask = torch.ones(b, length, dtype=torch.int32, device=ctx["dev"])
    mask[0, length // 2:] = 0  # chip_smoke._attn_inputs's
    return mask


def _timeline(lib, call, blocks):
    """One launch's per-block records (see ``timeline``): phase cycles
    (mean and percentiles over the blocks), blocks an SM ran, the
    kernel's span and the blocks' mean span on the global timer (ns)."""
    import numpy as np
    import torch

    call()
    torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * (8 * blocks))()
    err = lib.d64_timeline_read(buf, blocks)
    if err:
        raise RuntimeError(f"timeline read failed with CUDA error {err}")
    rec = np.frombuffer(buf, dtype=np.uint64).reshape(blocks, 8).astype(
        np.int64)
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


def _old_route_and_sdpa(q, k, v, mask):
    """Device ms of the sm90 forward at p=0 forced on these inputs (the
    route's kernel before attention_infer_d64.cu) and of one
    scaled_dot_product_attention call (rows with no key attend to key 0,
    where SDPA would give NaN)."""
    import torch.nn.functional as F

    import chip_smoke as cs
    from cldrd_tpu_torch.ops import attention as att

    amask = (mask != 0)[:, None, None, :]
    amask[(mask == 0).all(1), :, :, 0] = True
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    with cs._k5_sm90():
        sm90 = cs.device_ms(lambda: att.flash_attention(q, k, v, mask))
    return sm90, cs.device_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=amask))


def worker(lib_name):
    """One library in this process: its checks and its times."""
    import torch

    import chip_smoke as cs
    from cldrd_tpu_torch.ops.attention import attention_plain

    lib = ctypes.CDLL(str(OUT_DIR / f"{lib_name}.so"))
    name = lib_name.removeprefix("source_")
    blocks = lib.attn_infer_d64_blocks_per_sm
    blocks.argtypes, blocks.restype = [ctypes.c_int], ctypes.c_int
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    ctx = {"dev": dev, "gen": g}
    res = {"blocks_per_sm": {n: blocks(n) for n in (128, 256)}, "shapes": {}}
    for tag, b, length, kind in SHAPES:
        shape = (b, length, H, D)
        q, k, v = (torch.randn(shape, generator=g, device=dev)
                   .to(torch.bfloat16) for _ in range(3))
        mask = _mask(ctx, kind, b, length)
        row = {"real_keys": int((mask != 0).sum())}
        if name in KEEPS_FUNCTION:
            errs, exact = {}, True
            masks = {kind: mask, "holes": _mask(ctx, "holes", b, length)}
            for mtag, m in masks.items():
                ref = attention_plain(q, k, v, m).float()
                got = _launch(lib, q, k, v, m).float()
                errs[mtag] = ((got - ref).abs().max()
                              / ref.abs().max()).item()
                for xs in cs._exact_forms(dev, shape).values():
                    exact &= torch.equal(_launch(lib, *xs, m),
                                         attention_plain(*xs, m))
            row["rel_err"], row["exact_equal"] = errs, bool(exact)
            torch.save(_launch(lib, q, k, v, mask).cpu(),
                       OUT_DIR / f"{lib_name}.{tag}.out.pt")
        call = lambda: _launch(lib, q, k, v, mask)  # noqa: E731
        row["ms"] = [cs.device_ms(call) for _ in range(2)]
        if name == "kept":
            row["sm90_ms"], row["sdpa_ms"] = _old_route_and_sdpa(q, k, v,
                                                                 mask)
        if name == "timeline":
            row["timeline"] = _timeline(lib, call, b * H)
        res["shapes"][tag] = row
        del q, k, v, mask
        torch.cuda.empty_cache()
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

    from cldrd_tpu_torch.ops import _build

    names = list(args.only)
    _build.build_all()  # the sm90 forward, the old route, for ``kept``
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
        print(name, out["registers"][name], json.dumps(out["runs"][name]),
              flush=True)
    if "kept" in names and "no_skip" in names:
        out["no_skip_equals_kept"] = all(torch.equal(
            *(torch.load(OUT_DIR / f"{n}.{tag}.out.pt")
              for n in ("kept", "no_skip"))) for tag, *_ in SHAPES)
        print("no_skip EQUAL to kept:", out["no_skip_equals_kept"])
    Path(args.out).write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
