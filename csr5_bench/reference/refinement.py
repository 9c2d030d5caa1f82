"""The plain reference of mixed-precision iterative refinement, in plain
torch: CG in float32 on a float32 copy of A's values inside float64
refinement, whose residual r = b - A x and update x += d run in float64
(Buttari, Dongarra, Kurzak, Luszczek and Tomov, ACM TOMS 34(4), 2008;
HPG-MxP applies it to HPCG's problem).

It runs the loop that ``solvers.iterative_refinement`` runs, with the
same counts: ``outer_iters`` steps, each ``inner_iters`` CG iterations
from d0 = 0 on the float32 residual, then one float64 residual more. It
imports nothing of the program and no JAX.
"""

from __future__ import annotations

import torch

from . import BLOCK_NNZ, CSR, _safe_div


def lo_matmul(a: CSR, val: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``A @ x`` for x of shape (n,) with A's values ``val`` (one per
    nonzero) in x's precision, in blocks of nonzeros as ``CSR.matmul``."""
    y = torch.zeros(a.shape[0], dtype=x.dtype, device=x.device)
    nnz = a.col.shape[0]
    for s in range(0, nnz, BLOCK_NNZ):
        e = min(nnz, s + BLOCK_NNZ)
        y.index_add_(0, a.row[s:e], val[s:e].to(x.dtype) * x[a.col[s:e]])
    return y


def conjugate_gradient_lo(a: CSR, val: torch.Tensor, b: torch.Tensor, iters: int) -> torch.Tensor:
    """The CG iterate after ``iters`` iterations from x0 = 0, in b's
    precision, on A with the values ``val``."""
    x = torch.zeros_like(b)
    r = b.clone()
    p = r.clone()
    rs = torch.dot(r, r)
    for _ in range(iters):
        ap = lo_matmul(a, val, p)
        alpha = _safe_div(rs, torch.dot(p, ap))
        x = x + alpha * p
        r = r - alpha * ap
        rs_new = torch.dot(r, r)
        p = r + _safe_div(rs_new, rs) * p
        rs = rs_new
    return x


def iterative_refinement(a: CSR, b: torch.Tensor, outer_iters: int, inner_iters: int,
                         lo: torch.dtype = torch.float32) -> torch.Tensor:
    """x after ``outer_iters`` steps of float64 refinement from x0 = 0, each
    correction d the CG iterate after ``inner_iters`` iterations in ``lo``
    on A's values rounded to ``lo``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    b = b.to(torch.float64)
    val = a.val.to(lo)
    x = torch.zeros_like(b)
    for _ in range(outer_iters):
        r = b - a.matmul(x)
        x = x + conjugate_gradient_lo(a, val, r.to(lo), inner_iters).to(torch.float64)
    return x
