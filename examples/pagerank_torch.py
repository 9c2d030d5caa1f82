"""PageRank over a synthetic power-law graph on the port's CSR5 SpMV.

    python examples/pagerank_torch.py [nodes] [--device cuda|cpu]

Builds a power-law graph of ``nodes`` nodes (default 100,000), its
column-stochastic transition matrix P^T as CSR5 on the device (the card
by default; ``--device cpu`` runs the plain version), and runs 50
PageRank iterations (damping 0.85) of the port's solver. Prints the
seconds, the top nodes, their mass and the total mass (1 up to rounding,
since each iteration renormalises). The PyTorch counterpart of
``pagerank.py``.
"""

import argparse
import os
import sys
import time

import numpy as np
import scipy.sparse as sp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark_spmv_using_csr5_tpu_torch import build_csr5, csr5_spmv  # noqa: E402
from benchmark_spmv_using_csr5_tpu_torch.models import solvers  # noqa: E402
from benchmark_spmv_using_csr5_tpu_torch.utils import synth  # noqa: E402


def transition_matrix(n: int) -> sp.csr_matrix:
    """The column-stochastic transition matrix P^T (rank flows along
    P^T r) of a power-law graph of ``n`` nodes, mean out-degree 12."""
    g = sp.csr_matrix(synth.power_law(n, n, 12.0, dtype=np.float32))
    g.data[:] = 1.0
    out_deg = np.maximum(np.asarray(g.sum(axis=1)).ravel(), 1.0)
    return sp.csr_matrix((sp.diags(1.0 / out_deg) @ g).T).astype(np.float32)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("nodes", nargs="?", type=int, default=100_000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    n = args.nodes
    pt = transition_matrix(n)
    print(f"graph: n={n}, edges={pt.nnz}, device {args.device}")

    a5 = build_csr5((pt.indptr, pt.indices, pt.data, pt.shape), device=args.device)
    spmv = lambda v: csr5_spmv(a5, v)  # noqa: E731
    t0 = time.perf_counter()
    r = solvers.pagerank(spmv, n, damping=0.85, iters=50, device=args.device)
    r = r.cpu().numpy()  # waits for the device
    dt = time.perf_counter() - t0
    top = np.argsort(r)[-5:][::-1]
    mass = float(r.astype(np.float64).sum())
    print(f"PageRank 50 iters in {dt:.3f} s; top nodes: {top} (mass {r[top].sum():.3f}); "
          f"total mass {mass:.7f}")
    return {"mass": mass, "top": top.tolist(), "seconds": dt}


if __name__ == "__main__":
    main()
