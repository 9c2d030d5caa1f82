"""Golden CSR SpMV and SpMM: the serial oracle of ``CSR5_cuda/main.cu:336-355``.

The counterpart of ``benchmark_spmv_using_csr5_tpu/ops/reference.py``:
segment sums by ``index_add_`` in torch (CSR and COO SpMV, CSR SpMM), and
the serial numpy loop.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.formats import COOMatrix, CSRMatrix


def _row_ids(a: CSRMatrix, device) -> torch.Tensor:
    """Per-nonzero row index from row_ptr (the COO expansion)."""
    return torch.repeat_interleave(
        torch.arange(a.m, device=device), torch.diff(a.row_ptr).long().to(device)
    )


def csr_spmv(a: CSRMatrix, x: torch.Tensor, alpha=1.0) -> torch.Tensor:
    """y = alpha * A @ x via a segment sum over rows."""
    prod = a.values.to(x.dtype) * x[a.col_idx.long()]
    y = torch.zeros(a.m, dtype=x.dtype, device=x.device).index_add_(0, _row_ids(a, x.device), prod)
    return alpha * y


def coo_spmv(a: COOMatrix, x: torch.Tensor, alpha=1.0) -> torch.Tensor:
    """y = alpha * A @ x for a COO matrix (duplicates are summed)."""
    prod = a.values.to(x.dtype) * x[a.col.long()]
    y = torch.zeros(a.shape[0], dtype=x.dtype, device=x.device).index_add_(0, a.row.long(), prod)
    return alpha * y


def csr_spmm(a: CSRMatrix, x: torch.Tensor, alpha=1.0) -> torch.Tensor:
    """Y = alpha * A @ X for dense X of shape (n, R) (multi-rhs SpMV)."""
    prod = a.values.to(x.dtype)[:, None] * x[a.col_idx.long()]
    y = torch.zeros((a.m, x.shape[1]), dtype=x.dtype, device=x.device)
    return alpha * y.index_add_(0, _row_ids(a, x.device), prod)


def csr_spmv_numpy(row_ptr, col_idx, values, x, alpha=1.0):
    """Host-side numpy oracle (exact serial semantics, main.cu:336-355)."""
    m = len(row_ptr) - 1
    y = np.zeros(m, dtype=np.result_type(values.dtype, x.dtype))
    for i in range(m):
        s = 0.0
        for j in range(row_ptr[i], row_ptr[i + 1]):
            s += values[j] * x[col_idx[j]]
        y[i] = alpha * s
    return y
