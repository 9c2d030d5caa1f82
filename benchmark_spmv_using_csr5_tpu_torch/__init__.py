"""benchmark_spmv_using_csr5_tpu_torch: the PyTorch + CUDA port of the
CSR5 SpMV framework in ``benchmark_spmv_using_csr5_tpu`` (the JAX
package, which stays the reference it is tested against).

It imports torch, numpy and scipy, never jax. CSR5 SpMV (``csrc/csr5_spmv.cu``)
and DIA SpMV and SpMM (``csrc/dia_spmv.cu``) run through hand-written CUDA
kernels on CUDA tensors and through their plain PyTorch versions on CPU
tensors; HYB5 runs the two; ``select_format`` picks one from the structure:

    >>> from benchmark_spmv_using_csr5_tpu_torch import build_csr5, csr5_spmv
    >>> a5 = build_csr5(scipy_csr_matrix, device="cuda")
    >>> y = csr5_spmv(a5, x_cuda_float32)
    >>> d = build_dia(scipy_csr_matrix, device="cuda")   # None if not banded
    >>> y = dia_spmv(d, x_cuda_float32)

The CUDA libraries are built with nvcc at the first launch, not at import.
"""

from .config import AUTO_TUNED_SIGMA, CSR5Config, Format, Status, compute_sigma
from .models.formats import (
    CSR5Matrix,
    CSRMatrix,
    col_tiles_of,
    csr5_from_numpy,
    csr5_to_numpy,
    dia_from_numpy,
    dia_to_numpy,
)
from .ops.convert import build_csr5, csr5_to_csr
from .ops.csr5_kernel import csr5_spmv_cuda
from .ops.csr5_spmv import csr5_spmv, csr5_spmv_torch
from .ops.dia import DIAMatrix, build_dia, dia_spmm, dia_spmv, dia_supported
from .ops.hyb import HYBMatrix, build_hyb, hyb_spmv
from .ops.reference import csr_spmv, csr_spmv_numpy
from .ops.select import analyze_diagonals, select_format, select_plan

__all__ = [
    "AUTO_TUNED_SIGMA",
    "CSR5Config",
    "Format",
    "Status",
    "compute_sigma",
    "CSRMatrix",
    "CSR5Matrix",
    "col_tiles_of",
    "csr5_from_numpy",
    "csr5_to_numpy",
    "build_csr5",
    "csr5_to_csr",
    "csr5_spmv",
    "csr5_spmv_cuda",
    "csr5_spmv_torch",
    "csr_spmv",
    "csr_spmv_numpy",
    "DIAMatrix",
    "build_dia",
    "dia_from_numpy",
    "dia_to_numpy",
    "dia_spmm",
    "dia_spmv",
    "dia_supported",
    "HYBMatrix",
    "build_hyb",
    "hyb_spmv",
    "analyze_diagonals",
    "select_format",
    "select_plan",
]
