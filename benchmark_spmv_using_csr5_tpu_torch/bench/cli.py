"""CLI: ``python -m benchmark_spmv_using_csr5_tpu_torch.bench.cli <matrix.mtx>``.

The counterpart of ``benchmark_spmv_using_csr5_tpu/bench/cli.py`` with the
same arguments (``cli.py:56-104``):

    cli.py matrix.mtx [--sigma N] [--num-run N] [--backend auto|cuda|torch]
    cli.py --synthetic banded:500000:27

Only the CSR5 SpMV path runs (``--format csr5``, ``--spmm 1``, float32
values). Every other choice raises with the ROADMAP item that ports it.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..config import AUTO_TUNED_SIGMA
from ..utils import mmio, synth
from .harness import BenchResult, run_benchmark

#: arguments the port does not run yet -> the ROADMAP item that ports them
NOT_PORTED = {
    "float64": "--dtype float64 is kernel K4 (ROADMAP queue 1 item 7)",
    "spmm": "--spmm K>1 is kernel K2 (ROADMAP queue 1 item 8)",
    "dia": "--format dia is kernels K5/K6 (ROADMAP queue 1 item 9)",
    "hyb": "--format hyb is ops/hyb.py over K5 and K1 (ROADMAP queue 1 item 9)",
    "bandblock": "--format bandblock is kernel K7 (ROADMAP queue 1 item 8)",
    "auto": "--format auto is ops/select.py (ROADMAP queue 1 item 9)",
    "autotune": "--autotune is the autotuned build (ROADMAP queue 1 item 2)",
    "reorder": "--reorder is ops/select.py with RCM (ROADMAP queue 1 item 9)",
}


def load_matrix(args):
    dtype = np.dtype(args.dtype)
    if args.synthetic:
        kind, *params = args.synthetic.split(":")
        if kind == "banded":
            m, bw = int(params[0]), int(params[1])
            a = synth.banded(m, bw, dtype=dtype)
        elif kind == "powerlaw":
            m, mean = int(params[0]), float(params[1])
            a = synth.power_law(m, m, mean, dtype=dtype)
        elif kind == "random":
            m, dens = int(params[0]), float(params[1])
            a = synth.random_csr(m, m, dens, dtype=dtype)
        elif kind == "scatband":
            m, npr, bw = int(params[0]), int(params[1]), int(params[2])
            a = synth.scattered_band(m, npr, bw, dtype=dtype)
        elif kind == "fem":
            m = int(params[0])
            nb = int(params[1]) if len(params) > 1 else 21
            nbw = int(params[2]) if len(params) > 2 else 1400
            a = synth.fem_blocks(m, neighbors=nb, node_bandwidth=nbw, dtype=dtype)
        else:
            raise SystemExit(f"unknown synthetic kind {kind!r}")
        return a.indptr, a.indices, a.data.astype(dtype), a.shape, args.synthetic
    if not args.matrix:
        raise SystemExit("usage: cli.py <matrix.mtx> | --synthetic KIND:...")
    rp, ci, v, shape = mmio.read_mtx_csr(args.matrix, dtype=dtype)
    return rp, ci, v, shape, args.matrix


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="CSR5 SpMV benchmark (PyTorch + CUDA)")
    ap.add_argument("matrix", nargs="?", help=".mtx file (Matrix Market)")
    ap.add_argument(
        "--synthetic",
        help="banded:M:BW | powerlaw:M:MEAN | random:M:DENSITY | "
        "scatband:M:NNZROW:BW | fem:M[:NEIGHBORS[:NODEBW]]",
    )
    ap.add_argument("--sigma", type=int, default=AUTO_TUNED_SIGMA)
    ap.add_argument("--dtype", default="float32", choices=["float32", "float64"])
    ap.add_argument("--num-run", type=int, default=50)
    ap.add_argument(
        "--backend",
        default="auto",
        choices=["auto", "cuda", "torch"],
        help="auto: the CUDA kernel when a card is present, else the plain "
        "version on the CPU; cuda: the kernel, and fail without a card; "
        "torch: the plain version on the CPU",
    )
    ap.add_argument("--spmm", type=int, default=1, metavar="K")
    ap.add_argument(
        "--format", default="csr5", choices=["csr5", "dia", "hyb", "bandblock", "auto"]
    )
    ap.add_argument("--autotune", action="store_true")
    ap.add_argument("--reorder", choices=["none", "rcm", "auto"], default="none")
    return ap.parse_args(argv)


def run(argv=None) -> BenchResult:
    """Parse ``argv``, load the matrix and benchmark it."""
    args = parse_args(argv)
    for chosen, key in (
        (args.dtype == "float64", "float64"),
        (args.spmm != 1, "spmm"),
        (args.format != "csr5", args.format),
        (args.autotune, "autotune"),
        (args.reorder != "none", "reorder"),
    ):
        if chosen:
            raise NotImplementedError(f"not ported yet: {NOT_PORTED[key]}")
    if args.backend == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--backend cuda: no CUDA device is available")
    device = {"auto": None, "cuda": "cuda", "torch": "cpu"}[args.backend]
    rp, ci, v, shape, name = load_matrix(args)
    return run_benchmark(
        name, rp, ci, v, shape, sigma=args.sigma, num_run=args.num_run, device=device
    )


def main(argv=None) -> int:
    res = run(argv)
    print(res.report())
    return 0 if res.check_ok else 1


if __name__ == "__main__":
    sys.exit(main())
