"""Readings for the limits of ``correct``: many seeds of one cell in one
process, the program as the configuration states it or, with
``--control``, one precision below (a float32 plane and vectors for a
float64 configuration, a bfloat16 plane for a float32 one).

    python3 -m csr5_bench.calibrate --workload <cell> --seconds <s> \
        --seeds <n> [<n> ...] [--control]

Prints one JSON line per seed: the numbers compared, the count of outputs
compared, the shape and the set-up phases. A cell of more chips runs every
seed in one set of ranks (``ranks.py``). The benchmark's own runs do not
run it.
"""

import argparse
import gc
import json
import sys

import torch

from . import harness, ranks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibration needs a CUDA device", file=sys.stderr)
        return 2

    def report(seed, r):
        print(json.dumps({"workload": args.workload, "seed": seed, "control": args.control,
                          "correct": r["correct"], "attempted": r["attempted"],
                          "checks": r["checks"], "metrics": r["metrics"],
                          "memory_peak_bytes": r["device"]["memory_peak_bytes"],
                          "shape": r["shape"], "phases": r["phases"]}), flush=True)

    if ranks.chips_of(args.workload) > 1:  # every seed in one set of ranks
        seeds = iter(args.seeds)
        ranks.run_cells(args.workload, [(seed, args.control) for seed in args.seeds],
                        args.seconds, False, on_result=lambda r: report(next(seeds), r))
        return 0
    for seed in args.seeds:
        r = harness.run_cell(args.workload, seed, args.seconds, False, control=args.control)
        report(seed, r)
        del r
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
