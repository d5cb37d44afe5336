"""Readings that the limits of ``correct`` are set from, on the chip.

    python3 portbench/calibrate.py --workload <name> --seeds 1,2,... \\
        [--control-seeds 7,8,9] [--seconds 2] [--out FILE.json]

In one process: the cell run with a short window on each of ``--seeds``
(the numbers the port's sound runs give), then on each of
``--control-seeds`` the control (the reference in the port's place at
fp8) and, where the driver has them, its planted faults, each judged as
the cell judges the port (after a run of the port on that seed where
the driver follows the port's own state). Prints one JSON line a
reading and writes all of them to ``--out``.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    import importlib

    import torch

    from portbench import harness

    cell = harness.Cell(args.workload)
    driver = importlib.import_module("portbench.drivers."
                                     + cell.traffic["driver"])
    harness.log("card:", harness.card_line())
    out = []

    def emit(rec):
        out.append(rec)
        print(json.dumps(rec), flush=True)

    for seed in [int(s) for s in args.seeds.split(",") if s]:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = harness.run_cell(cell, seed, args.seconds, False)
        emit({"kind": "program", "seed": seed, "correct": res["correct"],
              "numbers": {k: v["value"] for k, v in res["checks"].items()},
              "metrics": {k: v["value"] for k, v in res["metrics"].items()},
              "memory_peak_bytes": res["device"]["memory_peak_bytes"],
              "seconds": time.perf_counter() - t0})
    for seed in [int(s) for s in args.control_seeds.split(",") if s]:
        run = harness.Run(cell, seed, args.seconds, False)
        # a driver that follows the port's own state judges from a run
        program = driver.run(run) \
            if getattr(driver, "CONTROL_NEEDS_RUN", False) else None
        for kind in ("control", "fault_half_batch", "fault_no_exchange"):
            fn = getattr(driver, kind, None)
            if fn is None:
                continue
            t0 = time.perf_counter()
            try:
                numbers = fn(run) if program is None else fn(run, program)
            except NotImplementedError:
                continue
            except Exception as e:  # a control that crashes has failed
                numbers = {"error": repr(e)}
            emit({"kind": kind, "seed": seed, "numbers": numbers,
                  "seconds": time.perf_counter() - t0})
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
