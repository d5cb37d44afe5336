"""Measure the parts of K2 (csrc/fused_binmax_sm90.cu) on one card.

    python3 tools/k2_variants.py --out OUT.json [--only NAME ...]
                                 [--source OTHER.cu]

Builds, with the port's nvcc flags, into build/k2_variants/, patched
copies of csrc/fused_binmax_sm90.cu:
- ``kept``: the source as it is;
- ``no_epilogue``: no score staging, TMA stores or bin maxima (the
  products, the feed and the row factors stay);
- ``no_products``: no wgmma (the consumers still wait for every chunk and
  release it; the epilogue writes whatever the accumulators hold);
- ``no_widen``: int8 codes copied into the ring unwidened (two words per
  word of codes);
- ``one_producer``: int8 fed by one producer warpgroup (four 16-byte
  pieces a thread) in place of two;
- ``no_prefetch``: without the int8 producer's L2 prefetch of the next
  tile;
- ``ring4``: four ring stages in place of seven;
- ``no_tma_store``: the epilogue stages its scores but issues no store;
- ``ahead4`` / ``ahead6``: int8 codes loaded four or six chunks ahead in
  registers in place of three;
- ``tiles64``: stripes of 64 row tiles a block in place of 32;
- ``no_read_wait`` / ``no_pair_bar`` / ``no_staging`` /
  ``early_release`` (timing only, the scores may be wrong): the epilogue
  without the wait for its stores to read the staging stages, without
  the barrier of both consumers before it writes them, without the
  staging writes, or with the two stages handed back before it.

Then checks each library's SASS for wgmma register hazards
(``cldrd_tpu_torch/ops/_wgmma_check.py``) and, each library in a process
of its own, holds the variants that keep the function (all but
``no_epilogue``, ``no_products``, ``no_widen`` and ``no_tma_store``) to
``fused_binmax_plain`` bit for bit on integer inputs (a zero query, a
partial last tile), and times every variant at K2's two
shapes: B=512 over a 1,048,576 x 768 bf16 store, and B=2048 over a
1,769,472 x 768 int8 store with scales (the segment a wide
``search_batched`` gives K2), as device times (``chip_smoke.device_ms``),
twice each. Writes one JSON object to ``--out``.

``--source`` builds the variants from another copy of the kernel with the
same entry point (an earlier design, from git history); ``kept`` then
times that design as it is.
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
OUT_DIR = ROOT / "build" / "k2_variants"
SRC = ROOT / "cldrd_tpu_torch" / "csrc" / "fused_binmax_sm90.cu"
EPILOGUE_START = "    // scores out by TMA through the tile's last two stages"
EPILOGUE_END = "  if (lead) bulk_wait0();  // the scores are written"
PATCHES = {
    "kept": [],
    "no_epilogue": "cut",  # EPILOGUE_START .. the tile loop's end
    "no_products": [(
        "        mma_n128(acc, sdesc(st + wg * BOX + kk * 32),\n"
        "                 sdesc(st + Q_PART + kk * 32), (k | kk) != 0);",
        "        ;")],
    "no_widen": [(
        "            for (int q = 0; q < 4; ++q) widen4(w4[q], o[2 * q], "
        "o[2 * q + 1]);",
        "            for (int q = 0; q < 4; ++q) {\n"
        "              o[2 * q] = w4[q];\n"
        "              o[2 * q + 1] = w4[q] ^ 0x40404040u;\n"
        "            }")],
    "one_producer": [
        ("  return i8 ? 512 : 384;", "  return 384;"),
        ("constexpr int feed_for(bool i8) { return i8 ? 256 : 128; }",
         "constexpr int feed_for(bool i8) { return 128; }")],
    "no_prefetch": [(
        "              prefetch_l2(c8 + r0 * row_bytes,\n"
        "                          (uint32_t)((r1 - r0) * row_bytes));",
        "              (void)r1;")],
    "ring4": [("  const int s = fit < MAX_STAGES ? fit : MAX_STAGES;",
               "  const int s = fit < 4 ? fit : 4;")],
    "no_tma_store": [(
        "        tma_store(&map_s, r0 + 32 * b, qw, stg[b >> 1] + (b & 1) * "
        "BOX);", "        ;")],
    "ahead4": [("    constexpr int AHEAD = 3;",
                "    constexpr int AHEAD = 4;")],
    "ahead6": [("    constexpr int AHEAD = 3;",
                "    constexpr int AHEAD = 6;")],
    "tiles64": [("constexpr int TILES_PER_BLOCK = 32;",
                 "constexpr int TILES_PER_BLOCK = 64;")],
    "no_read_wait": [("    if (lead) bulk_wait_read0();\n    wg_bar(wg);\n"
                      "    mbar_arrive_warp(empty + 8 * held);",
                      "    mbar_arrive_warp(empty + 8 * held);")],
    "no_pair_bar": [("    consumers_bar();\n    const int r0",
                     "    const int r0")],
    "no_staging": [("        st_shared_v2f(box + ql * 128 + ((chunk ^ g) << 4)"
                    " + 8 * (t & 1),\n                      acc[4 * j + 2 * x],"
                    " acc[4 * j + 2 * x + 1]);", "        (void)box;")],
    "early_release": [
        ("    consumers_bar();\n    const int r0",
         "    mbar_arrive_warp(empty + 8 * held);\n"
         "    mbar_arrive_warp(empty + 8 * prev);\n    const int r0"),
        ("    if (lead) bulk_wait_read0();\n    wg_bar(wg);\n"
         "    mbar_arrive_warp(empty + 8 * held);\n"
         "    mbar_arrive_warp(empty + 8 * prev);\n", "")],
}
KEEPS_FUNCTION = ("kept", "one_producer", "no_prefetch", "ring4", "ahead4",
                  "ahead6", "tiles64")
D = 768
SHAPES = {"bf16_1M": (512, 1_048_576, "bf16"),
          "int8_wide": (2048, 1_769_472, "int8")}


def _patched(name: str, src: str) -> str:
    edits = PATCHES[name]
    if edits == "cut":
        a, b = src.index(EPILOGUE_START), src.index(EPILOGUE_END)
        # hand the last two stages back and close the tile loop
        return (src[:a] + "    mbar_arrive_warp(empty + 8 * held);\n"
                "    mbar_arrive_warp(empty + 8 * prev);\n  }\n" + src[b:])
    for old, new in edits:
        if src.count(old) != 1:
            raise AssertionError(f"{name}: patch target not found once")
        src = src.replace(old, new)
    return src


def build(names, src_path):
    from cldrd_tpu_torch.ops import _build

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    src = Path(src_path).read_text()
    jobs = {}
    for name in names:
        cu = OUT_DIR / f"{name}.cu"
        cu.write_text(_patched(name, src))
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


def _launch(lib, q, c, ids, scales, bin_rows=128):
    import torch

    from cldrd_tpu_torch.ops import _build

    bz, n = q.shape[0], c.shape[0]
    out_s = torch.empty((bz, n), dtype=torch.float32, device=q.device)
    out_b = torch.empty((bz, n // bin_rows), dtype=torch.float32,
                        device=q.device)
    fn = lib.fused_binmax_sm90_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    err = fn(q.data_ptr(), _build.dtype_code(q.dtype), c.data_ptr(),
             _build.dtype_code(c.dtype), ids.data_ptr(),
             None if scales is None else scales.data_ptr(), out_s.data_ptr(),
             out_b.data_ptr(), bz, n, q.shape[1], bin_rows,
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed with CUDA error {err}")
    return out_s, out_b


def _store(dev, g, n, kind):
    import torch

    if kind == "int8":
        c = torch.randint(-127, 128, (n, D), generator=g, device=dev,
                          dtype=torch.int8)
        return c, (torch.rand(n, generator=g, device=dev) + 0.5) / 127
    return torch.randn(n, D, generator=g, device=dev).to(torch.bfloat16), None


def worker(name):
    """One library in this process: the bit check (integer inputs, a
    zero query, partial last tile) and the two shapes' times."""
    import torch

    import chip_smoke as cs
    from cldrd_tpu_torch.ops.fused_binmax import fused_binmax_plain

    lib = ctypes.CDLL(str(OUT_DIR / f"{name}.so"))
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    res = {"checked": None}
    if name in KEEPS_FUNCTION:
        ok = True
        for kind in ("bf16", "int8"):
            n = 65_536 + 16
            c, sc = _store(dev, g, n, kind)
            if kind == "bf16":
                c = torch.randint(-4, 5, (n, D), generator=g, device=dev,
                                  dtype=torch.int8).to(torch.bfloat16)
            q = torch.randint(-4, 5, (200, D), generator=g, device=dev,
                              dtype=torch.int8).to(torch.bfloat16)
            q[100] = 0
            ids = torch.arange(n, dtype=torch.int32, device=dev)
            ids[-500:] = -1
            got = _launch(lib, q, c, ids, sc, 16)
            ref = fused_binmax_plain(q, c, ids, 16, sc)
            ok &= all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                      for a, b in zip(got, ref))
        res["checked"] = bool(ok)
    for tag, (bz, n, kind) in SHAPES.items():
        c, sc = _store(dev, g, n, kind)
        ids = torch.arange(n, dtype=torch.int32, device=dev)
        q = torch.randn(bz, D, generator=g, device=dev).to(torch.bfloat16)
        call = lambda: _launch(lib, q, c, ids, sc)  # noqa: E731
        res[tag] = [cs.device_ms(call, reps=3, warmup=1) for _ in range(2)]
        del c, sc, q
        torch.cuda.empty_cache()
    res["card"] = cs.smi_line()
    print(json.dumps(res))


def main():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--out", required=True)
    p.add_argument("--only", nargs="*", default=list(PATCHES))
    p.add_argument("--source", default=str(SRC))
    p.add_argument("--worker", help=argparse.SUPPRESS)
    args = p.parse_args()
    if args.worker:
        worker(args.worker)
        return
    from cldrd_tpu_torch.ops import _wgmma_check

    names = args.only
    regs = build(names, args.source)
    hgmma = _wgmma_check.check_libraries(
        [OUT_DIR / f"{name}.so" for name in names])
    out = {"source": args.source, "registers": regs, "hgmma": hgmma,
           "runs": {}}
    for name in names:
        proc = subprocess.run([sys.executable, __file__, "--out", args.out,
                               "--worker", name], capture_output=True,
                              text=True, cwd=ROOT)
        if proc.returncode:
            raise RuntimeError(f"{name} failed:\n{proc.stderr[-3000:]}")
        out["runs"][name] = json.loads(proc.stdout.strip().splitlines()[-1])
        print(name, out["runs"][name], flush=True)
    Path(args.out).write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
