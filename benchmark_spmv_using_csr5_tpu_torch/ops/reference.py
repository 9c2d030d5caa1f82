"""Golden CSR SpMV: the serial oracle of ``CSR5_cuda/main.cu:336-355``.

The counterpart of ``benchmark_spmv_using_csr5_tpu/ops/reference.py``:
a segment sum by ``index_add_`` in torch, and the serial numpy loop.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.formats import CSRMatrix


def csr_spmv(a: CSRMatrix, x: torch.Tensor, alpha=1.0) -> torch.Tensor:
    """y = alpha * A @ x via a segment sum over rows."""
    rows = torch.repeat_interleave(
        torch.arange(a.m, device=x.device), torch.diff(a.row_ptr).long()
    )
    prod = a.values.to(x.dtype) * x[a.col_idx.long()]
    y = torch.zeros(a.m, dtype=x.dtype, device=x.device).index_add_(0, rows, prod)
    return alpha * y


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
