"""The plain reference: float64 sparse products and solves in plain torch.

It computes again, from the CSR arrays the benchmark handed to the
program, what the timed path produced: ``A @ X``, HPCG's CG iterate and
the PageRank iterate. Nothing here imports the program or JAX. Products
run in blocks of nonzeros (gather, multiply, ``index_add_``), so a
reference on the card fits beside nothing but the matrix.
"""

from __future__ import annotations

import torch

#: nonzeros per block of a product
BLOCK_NNZ = 1 << 25


class CSR:
    """A float64 copy of a CSR matrix on ``device``, with each nonzero's
    row: ``row_ptr`` (m + 1), ``col`` and ``val`` (nnz,)."""

    def __init__(self, row_ptr, col, val, shape, device):
        self.shape = tuple(shape)
        self.row_ptr = torch.as_tensor(row_ptr).to(device=device, dtype=torch.int64)
        self.col = torch.as_tensor(col).to(device=device, dtype=torch.int64)
        self.val = torch.as_tensor(val).to(device=device, dtype=torch.float64)
        deg = self.row_ptr[1:] - self.row_ptr[:-1]
        self.row = torch.repeat_interleave(torch.arange(self.shape[0], device=device), deg)

    def matmul(self, x: torch.Tensor) -> torch.Tensor:
        """``A @ x`` in float64 for x of shape (n,) or (n, R)."""
        x = x.to(torch.float64)
        xm = x[:, None] if x.dim() == 1 else x
        y = torch.zeros((self.shape[0], xm.shape[1]), dtype=torch.float64, device=x.device)
        nnz = self.col.shape[0]
        for s in range(0, nnz, BLOCK_NNZ):
            e = min(nnz, s + BLOCK_NNZ)
            y.index_add_(0, self.row[s:e], self.val[s:e, None] * xm[self.col[s:e]])
        return y[:, 0] if x.dim() == 1 else y


def _safe_div(num, den):
    ok = den != 0
    return torch.where(ok, num / torch.where(ok, den, torch.ones_like(den)), torch.zeros_like(num))


def conjugate_gradient(a: CSR, b: torch.Tensor, iters: int) -> torch.Tensor:
    """The CG iterate after ``iters`` iterations from x0 = 0, in float64."""
    b = b.to(torch.float64)
    x = torch.zeros_like(b)
    r = b.clone()
    p = r.clone()
    rs = torch.dot(r, r)
    for _ in range(iters):
        ap = a.matmul(p)
        alpha = _safe_div(rs, torch.dot(p, ap))
        x = x + alpha * p
        r = r - alpha * ap
        rs_new = torch.dot(r, r)
        p = r + _safe_div(rs_new, rs) * p
        rs = rs_new
    return x


def pagerank(a: CSR, damping: float, iters: int) -> torch.Tensor:
    """``iters`` steps of r <- d A r + (1 - d) / n, each renormalised to
    sum 1, from the uniform vector, in float64."""
    n = a.shape[0]
    r = torch.full((n,), 1.0 / n, dtype=torch.float64, device=a.val.device)
    for _ in range(iters):
        r = damping * a.matmul(r) + (1.0 - damping) / n
        r = r / torch.clamp(r.sum(), min=1e-30)
    return r
