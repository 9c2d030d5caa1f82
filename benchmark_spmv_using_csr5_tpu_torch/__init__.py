"""benchmark_spmv_using_csr5_tpu_torch: the PyTorch + CUDA port of the
CSR5 SpMV framework in ``benchmark_spmv_using_csr5_tpu`` (the JAX
package, which stays the reference it is tested against).

It imports torch, numpy and scipy, never jax. CSR5 SpMV runs through a
hand-written CUDA kernel (``csrc/csr5_spmv.cu``) on CUDA tensors and
through its plain PyTorch version on CPU tensors:

    >>> from benchmark_spmv_using_csr5_tpu_torch import build_csr5, csr5_spmv
    >>> a5 = build_csr5(scipy_csr_matrix, device="cuda")
    >>> y = csr5_spmv(a5, x_cuda_float32)

The CUDA library is built with nvcc at the first launch, not at import.
"""

from .config import AUTO_TUNED_SIGMA, CSR5Config, Format, Status, compute_sigma
from .models.formats import (
    CSR5Matrix,
    CSRMatrix,
    col_tiles_of,
    csr5_from_numpy,
    csr5_to_numpy,
)
from .ops.convert import build_csr5, csr5_to_csr
from .ops.csr5_kernel import csr5_spmv_cuda
from .ops.csr5_spmv import csr5_spmv, csr5_spmv_torch
from .ops.reference import csr_spmv, csr_spmv_numpy

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
]
