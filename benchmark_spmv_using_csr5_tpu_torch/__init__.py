"""benchmark_spmv_using_csr5_tpu_torch: the PyTorch + CUDA port of the
CSR5 SpMV framework in ``benchmark_spmv_using_csr5_tpu`` (the JAX
package, which stays the reference it is tested against).

It imports torch, numpy and scipy, never jax. CSR5 SpMV in float32
and float64 and SpMM (``csrc/csr5_spmv.cu``, ``csrc/csr5_spmv_f64.cu``,
``csrc/csr5_spmm.cu``; the packed column plane where the matrix has
one), row-sliced CSR5 SpMV (``csrc/csr5_sliced.cu``), DIA SpMV and SpMM
(``csrc/dia_spmv.cu``) and
band-block SpMM (``csrc/bandmm.cu``) run through hand-written CUDA kernels
on CUDA tensors and through their plain PyTorch versions on CPU tensors;
HYB5 runs DIA and CSR5 together; ``select_format`` picks a format from
the structure. The builders put their planes on the card unless given
``device="cpu"``, and raise without a card:

    >>> from benchmark_spmv_using_csr5_tpu_torch import build_csr5, csr5_spmv
    >>> a5 = build_csr5(scipy_csr_matrix)
    >>> y = csr5_spmv(a5, x_cuda_float32)
    >>> Y = csr5_spmm(a5, X_cuda_float32)                 # X (n, R)
    >>> a64 = build_csr5(scipy_csr_matrix, value_dtype=torch.float64)
    >>> y = csr5_spmv(a64, x_cuda_float64)                # K4
    >>> sl = build_csr5_sliced(scipy_csr_matrix)         # None if unsliceable
    >>> y = sliced_spmv(sl, x_cuda_float32)               # K3
    >>> d = build_dia(scipy_csr_matrix)                  # None if not banded
    >>> y = dia_spmv(d, x_cuda_float32)
    >>> bb = build_bandblock(scipy_csr_matrix)           # None if not banded
    >>> Y = bandmm_spmm(bb, X_cuda_float32)
    >>> h = SpMVHandle(m, n).inputCSR(nnz, row_ptr, col_idx, values).asCSR5()
    >>> x, res = solvers.conjugate_gradient(lambda v: csr5_spmv(a5, v), b)

The CUDA libraries are built with nvcc at the first launch, not at import.
"""

from .config import AUTO_TUNED_SIGMA, CSR5Config, Format, Status, compute_sigma
from .models.formats import (
    COOMatrix,
    CSR5Matrix,
    CSRMatrix,
    col_tiles_from_packed,
    col_tiles_of,
    csr5_from_df64,
    csr5_from_numpy,
    csr5_to_numpy,
    csr_from_numpy,
    csr_from_scipy,
    dia_from_numpy,
    dia_to_numpy,
)
from .models import solvers
from .models.handle import SpMVHandle
from .ops.convert import build_csr5, build_csr5_autotuned, csr5_to_csr
from .ops.bandmm import (
    BandBlockMatrix,
    bandmm_spmm,
    bandmm_spmm_torch,
    bandmm_spmv,
    bandmm_supported,
    build_bandblock,
)
from .ops.bigslice import (
    SlicedCSR5,
    build_csr5_sliced,
    should_slice,
    sliced_from_numpy,
    sliced_spmm,
    sliced_spmv,
    sliced_spmv_torch,
    sliced_to_numpy,
)
from .ops.bigslice_kernel import sliced_spmv_cuda
from .ops.csr5_f64 import csr5_spmv_f64_cuda, f64_supported
from .ops.csr5_kernel import csr5_spmm_cuda, csr5_spmv_cuda
from .ops.csr5_spmv import (
    csr5_spmm,
    csr5_spmm_packed_torch,
    csr5_spmm_torch,
    csr5_spmv,
    csr5_spmv_packed_torch,
    csr5_spmv_torch,
)
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
    "col_tiles_from_packed",
    "col_tiles_of",
    "csr5_from_df64",
    "csr5_from_numpy",
    "csr5_to_numpy",
    "csr_from_numpy",
    "csr_from_scipy",
    "SpMVHandle",
    "solvers",
    "build_csr5",
    "build_csr5_autotuned",
    "csr5_to_csr",
    "csr5_spmm",
    "csr5_spmm_cuda",
    "csr5_spmm_packed_torch",
    "csr5_spmm_torch",
    "csr5_spmv",
    "csr5_spmv_cuda",
    "csr5_spmv_f64_cuda",
    "csr5_spmv_packed_torch",
    "csr5_spmv_torch",
    "SlicedCSR5",
    "build_csr5_sliced",
    "should_slice",
    "sliced_from_numpy",
    "sliced_spmm",
    "sliced_spmv",
    "sliced_spmv_cuda",
    "sliced_spmv_torch",
    "sliced_to_numpy",
    "f64_supported",
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
