"""The benchmark's one command: one run of one cell, on one card or, for a
cell of more chips, as one rank on each (``ranks.py``).

    python3 -m csr5_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. It makes the cell's matrix and inputs
from ``--seed``, converts the matrix, warms the cell's shapes, runs the
closed loop for ``--seconds`` (with ``--trace 1``: a short profiled
window instead, and the per-layer metrics), checks the outputs against
the plain reference, and prints each number compared beside its limit as
the last lines of standard error and one JSON object as the last line of
standard output. Without a CUDA card it exits 2 and prints no result.
"""

import time

_T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
#: build and kernel caches, at fixed paths inside the checkout
CACHES = {
    "TORCH_EXTENSIONS_DIR": "torch_extensions",
    "TRITON_CACHE_DIR": "triton",
    "CUDA_CACHE_PATH": "cuda",
}
#: top-level modules that no run may load: JAX, and the JAX package
#: (compared whole: the program's name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "benchmark_spmv_using_csr5_tpu", "bench")


def loaded_forbidden(modules=None) -> list:
    """The forbidden top-level names among ``modules`` (default:
    ``sys.modules``)."""
    tops = {name.split(".", 1)[0] for name in (sys.modules if modules is None else modules)}
    return sorted(tops.intersection(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / "_bench_cache" / sub)

    import torch

    from . import harness

    chips = next((w["chips"] for w in harness.load_spec(ROOT)["workloads"]
                  if w["name"] == args.workload), None)
    if chips is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    if chips == 1:
        result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                                  t_start=_T_START)
    else:  # one process per chip (ranks.py)
        from . import ranks

        try:
            result = ranks.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                                    t_start=_T_START)
        except ranks.RankFailure as exc:
            print(f"{args.workload}: {exc}", file=sys.stderr)
            return 1
    bad = loaded_forbidden()
    if bad:
        print(f"the run loaded forbidden modules: {', '.join(bad)}", file=sys.stderr)
        return 3
    emit(result)
    return 0


def emit(result: dict, out=None, err=None) -> None:
    """Each number compared beside its limit as the last lines of ``err``,
    then the result as one JSON line on ``out``, its ``checks`` last."""
    out, err = out or sys.stdout, err or sys.stderr
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r} "
              f"({c['compared']} outputs compared)", file=err)
    err.flush()
    line = {k: v for k, v in result.items() if k != "checks"}
    line["checks"] = result["checks"]
    print(json.dumps(line), file=out, flush=True)


if __name__ == "__main__":
    sys.exit(main())
