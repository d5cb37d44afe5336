"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics;
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, the numbers compared each with its
limit. Exits 2, printing no result, without as many CUDA devices as the
cell asks for, when the port is not beside it, or when JAX or the JAX
package was loaded. Build and kernel caches stay inside the checkout
(``build/``).
"""
import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, "build",
                                                       "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      os.path.join(ROOT, "build", "torch_extensions"))
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from portbench import harness

    cell = harness.Cell(args.workload)
    import torch

    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell.chips:
        harness.log(f"needs {cell.chips} CUDA device(s); found {found}")
        return 2
    try:
        import cldrd_tpu_torch
    except ImportError as e:
        harness.log(f"the port is not beside the benchmark: {e}")
        return 2
    if not os.path.abspath(cldrd_tpu_torch.__file__).startswith(ROOT):
        harness.log(f"the port found ({cldrd_tpu_torch.__file__}) is not "
                    "this checkout's")
        return 2
    result = harness.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace))
    found = harness.forbidden_modules()
    if found:
        harness.log("JAX or the JAX package was loaded: " + ", ".join(found))
        return 2
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
