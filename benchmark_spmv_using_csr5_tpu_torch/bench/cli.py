"""CLI: ``python -m benchmark_spmv_using_csr5_tpu_torch.bench.cli <matrix.mtx>``.

The counterpart of ``benchmark_spmv_using_csr5_tpu/bench/cli.py`` with the
same arguments (``cli.py:56-104``):

    cli.py matrix.mtx [--sigma N] [--num-run N] [--backend auto|cuda|torch]
           [--format csr5|dia|hyb|bandblock|auto] [--reorder none|rcm|auto]
           [--spmm K] [--dtype float32|float64] [--autotune]
    cli.py --synthetic banded:500000:27 --format auto [--spmm 8]

It runs on the card (``--backend auto``, the default, or ``cuda``) and
exits without one; ``--backend torch`` runs the plain versions on the
CPU. Float32 values run through these kernels:

- SpMV (``--spmm 1``): CSR5 (K1, or K1p on a matrix with the packed
  column plane), DIA (K5), HYB5 (K5 + K1);
- SpMM (``--spmm K``, K > 1): ``--format csr5`` (K2 or K2p), ``--format
  dia`` (K6), ``--format bandblock`` (K7, also at K = 1).

CSR5 SpMV on a matrix beyond the JAX package's VMEM cap (m + n over
18,119,393, e.g. ``--synthetic banded:20000000:27``) runs on the row-sliced
form through K3, by the same rule as the JAX CLI, which has no flag for it
either.

``--dtype float64`` runs CSR5 SpMV on a float64 plane (K4); every other
format, and SpMM, has no float64 kernel and exits naming it.

``--format auto`` picks the format from the structure (``ops/select.py``);
with ``--spmm K > 1`` it picks bandblock when ``build_bandblock`` takes the
matrix, else dia if the structure says dia, else csr5, exactly as the JAX
CLI (``cli.py:134-154``). ``--format hyb --spmm K > 1`` exits with the JAX
CLI's message: HYB5 is a SpMV format there. ``--reorder`` applies RCM
first. ``--autotune`` converts CSR5 with the structure-aware sigma
re-tune (``build_csr5_autotuned``).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import scipy.sparse as sp
import torch

from ..config import AUTO_TUNED_SIGMA
from ..ops.bandmm import bandblock_accepts
from ..ops.select import apply_plan, select_format, select_plan
from ..utils import mmio, reorder, synth
from . import harness
from .harness import BenchResult

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
        help="auto (a spelling of cuda) and cuda: the CUDA kernels on the "
        "card, and fail without one; torch: the plain versions on the CPU",
    )
    ap.add_argument("--spmm", type=int, default=1, metavar="K")
    ap.add_argument(
        "--format", default="csr5", choices=["csr5", "dia", "hyb", "bandblock", "auto"]
    )
    ap.add_argument("--autotune", action="store_true")
    ap.add_argument("--reorder", choices=["none", "rcm", "auto"], default="none")
    return ap.parse_args(argv)


def _device(args) -> str:
    """The device of ``--backend``: the card unless ``torch``; raises
    when the card is missing."""
    if args.backend == "torch":
        return "cpu"
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"--backend {args.backend}: no CUDA device is available "
            "(--backend torch runs the plain versions on the CPU)"
        )
    return "cuda"


def run(argv=None) -> BenchResult:
    """Parse ``argv``, load the matrix and benchmark it."""
    args = parse_args(argv)
    _device(args)  # before loading the matrix
    rp, ci, v, shape, name = load_matrix(args)
    return run_matrix(args, name, rp, ci, v, shape)


def run_matrix(args, name, rp, ci, v, shape) -> BenchResult:
    """Reorder, pick the format and benchmark a loaded matrix given as
    ``(rp, ci, v, shape)``: the part of the JAX ``main`` after
    ``load_matrix`` (``cli.py:106-168``). ``args`` is what
    :func:`parse_args` returns."""
    device = _device(args)
    notes = []
    if args.reorder == "auto":
        if shape[0] == shape[1]:
            plan = select_plan(rp, ci, shape)
            if plan.reorder is not None:
                (rp, ci, v, shape), _ = apply_plan((rp, ci, v, shape), plan)
                name = f"{name}+{plan.reorder}"
                notes.append(
                    f"auto-reorder: bandwidth {plan.bandwidth_before} -> "
                    f"{plan.bandwidth_after} ({plan.plan_ms:.0f} ms)"
                )
    elif args.reorder != "none":
        if shape[0] != shape[1]:
            raise SystemExit("--reorder requires a square matrix")
        a_perm, _ = reorder.reorder_for_locality(
            sp.csr_matrix((v, ci, rp), shape=shape), method=args.reorder
        )
        rp, ci, v = a_perm.indptr, a_perm.indices, a_perm.data
        name = f"{name}+{args.reorder}"
    fmt = args.format
    if fmt == "auto":
        fmt = select_format(rp, ci, shape)
        if args.spmm > 1:
            # multi-rhs: the band-block path whenever the matrix's 128-row
            # blocks have bounded windows, else dia or csr5
            if bandblock_accepts((rp, ci, v, shape)):
                fmt = "bandblock"
            elif fmt != "dia":
                fmt = "csr5"
        notes.append(f"auto-selected format: {fmt}")
    R = max(args.spmm, 1)
    run = {"num_run": args.num_run, "device": device}
    if fmt == "dia":
        res = harness.run_dia(name, rp, ci, v, shape, R, **run)
    elif fmt == "hyb":
        if args.spmm > 1:
            raise SystemExit("--format hyb supports SpMV only (--spmm 1)")
        res = harness.run_hyb(name, rp, ci, v, shape, **run)
    elif fmt == "bandblock":
        res = harness.run_bandblock(name, rp, ci, v, shape, R, **run)
    else:
        res = harness.run_benchmark(
            name, rp, ci, v, shape, sigma=args.sigma, num_rhs=args.spmm,
            autotune=args.autotune, **run
        )
    res.plan = "; ".join(notes)
    return res


def main(argv=None) -> int:
    res = run(argv)
    print(res.report())
    return 0 if res.check_ok else 1


if __name__ == "__main__":
    sys.exit(main())
