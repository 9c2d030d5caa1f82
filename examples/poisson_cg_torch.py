"""Solve a 2D Poisson problem with CG on the port's CSR5 SpMV (kernel K1).

    python examples/poisson_cg_torch.py [grid_side] [--device cuda|cpu]

Builds the 5-point finite-difference Laplacian (SPD, 5 diagonals) on a
grid_side x grid_side grid (default 256), converts it to CSR5 on the
device (the card by default; ``--device cpu`` runs the plain version),
and solves A x = b with 300 iterations of the port's conjugate gradient.
Prints the relative residual |A x - b| / |b| (by scipy, on the host) and
the solve's seconds. The PyTorch counterpart of ``poisson_cg.py``.
"""

import argparse
import os
import sys
import time

import numpy as np
import scipy.sparse as sp
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark_spmv_using_csr5_tpu_torch import build_csr5, csr5_spmv  # noqa: E402
from benchmark_spmv_using_csr5_tpu_torch.models import solvers  # noqa: E402


def laplacian_2d(k: int) -> sp.csr_matrix:
    one = np.ones(k)
    t = sp.diags([-one, 2 * one, -one], [-1, 0, 1], shape=(k, k))
    eye = sp.identity(k)
    return (sp.kron(eye, t) + sp.kron(t, eye)).tocsr().astype(np.float32)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("grid_side", nargs="?", type=int, default=256)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    k = args.grid_side
    a = laplacian_2d(k)
    m = a.shape[0]
    print(f"2D Poisson {k}x{k}: m={m}, nnz={a.nnz}, device {args.device}")

    a5 = build_csr5((a.indptr, a.indices, a.data, a.shape), device=args.device)
    x_true = np.random.default_rng(0).standard_normal(m).astype(np.float32)
    b = (a @ x_true).astype(np.float32)
    bd = torch.from_numpy(b).to(args.device)

    spmv = lambda v: csr5_spmv(a5, v)  # noqa: E731
    t0 = time.perf_counter()
    x, _ = solvers.conjugate_gradient(spmv, bd, iters=300)
    x = x.cpu().numpy()  # waits for the device
    dt = time.perf_counter() - t0
    rel = float(np.linalg.norm(a @ x - b) / np.linalg.norm(b))
    print(f"CG 300 iters in {dt:.3f} s  |r|/|b| = {rel:.2e}")
    return {"rel_residual": rel, "seconds": dt}


if __name__ == "__main__":
    main()
