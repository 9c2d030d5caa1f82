"""benchmark_spmv_using_csr5_tpu_torch: the PyTorch + CUDA port of the
CSR5 SpMV framework in ``benchmark_spmv_using_csr5_tpu`` (the JAX
package, which stays the reference it is tested against).

It imports torch, numpy and scipy, never jax. CSR5 SpMV and SpMM
(``csrc/csr5_spmv.cu``, ``csrc/csr5_spmm.cu``), DIA SpMV and SpMM
(``csrc/dia_spmv.cu``) and band-block SpMM (``csrc/bandmm.cu``) run through
hand-written CUDA kernels on CUDA tensors and through their plain PyTorch
versions on CPU tensors; HYB5 runs DIA and CSR5 together; ``select_format``
picks a format from the structure:

    >>> from benchmark_spmv_using_csr5_tpu_torch import build_csr5, csr5_spmv
    >>> a5 = build_csr5(scipy_csr_matrix, device="cuda")
    >>> y = csr5_spmv(a5, x_cuda_float32)
    >>> Y = csr5_spmm(a5, X_cuda_float32)                 # X (n, R)
    >>> d = build_dia(scipy_csr_matrix, device="cuda")   # None if not banded
    >>> y = dia_spmv(d, x_cuda_float32)
    >>> bb = build_bandblock(scipy_csr_matrix, device="cuda")  # None if not banded
    >>> Y = bandmm_spmm(bb, X_cuda_float32)

The CUDA libraries are built with nvcc at the first launch, not at import.
"""

from .config import AUTO_TUNED_SIGMA, CSR5Config, Format, Status, compute_sigma
from .models.formats import (
    COOMatrix,
    CSR5Matrix,
    CSRMatrix,
    col_tiles_of,
    csr5_from_numpy,
    csr5_to_numpy,
    dia_from_numpy,
    dia_to_numpy,
)
from .ops.convert import build_csr5, csr5_to_csr
from .ops.bandmm import (
    BandBlockMatrix,
    bandmm_spmm,
    bandmm_spmm_torch,
    bandmm_spmv,
    bandmm_supported,
    build_bandblock,
)
from .ops.csr5_kernel import csr5_spmm_cuda, csr5_spmv_cuda
from .ops.csr5_spmv import csr5_spmm, csr5_spmm_torch, csr5_spmv, csr5_spmv_torch
from .ops.dia import DIAMatrix, build_dia, dia_spmm, dia_spmv, dia_supported
from .ops.hyb import HYBMatrix, build_hyb, hyb_spmm, hyb_spmv
from .ops.reference import coo_spmv, csr_spmm, csr_spmv, csr_spmv_numpy
from .ops.select import analyze_diagonals, select_format, select_plan

__all__ = [
    "AUTO_TUNED_SIGMA",
    "CSR5Config",
    "Format",
    "Status",
    "compute_sigma",
    "COOMatrix",
    "CSRMatrix",
    "CSR5Matrix",
    "col_tiles_of",
    "csr5_from_numpy",
    "csr5_to_numpy",
    "build_csr5",
    "csr5_to_csr",
    "csr5_spmm",
    "csr5_spmm_cuda",
    "csr5_spmm_torch",
    "csr5_spmv",
    "csr5_spmv_cuda",
    "csr5_spmv_torch",
    "coo_spmv",
    "csr_spmm",
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
    "hyb_spmm",
    "hyb_spmv",
    "BandBlockMatrix",
    "build_bandblock",
    "bandmm_spmm",
    "bandmm_spmm_torch",
    "bandmm_spmv",
    "bandmm_supported",
    "analyze_diagonals",
    "select_format",
    "select_plan",
]
