"""DIA (diagonal) format: the structured-matrix path, and kernels K5/K6.

The counterpart of ``benchmark_spmv_using_csr5_tpu/ops/dia.py``. A matrix
whose nonzeros lie on few diagonals stores one value plane per diagonal,
``data[k, i] = A[i, i + offsets[k]]``, and y needs no column stream:

    y[i] = sum_k data[k, i] * (alpha * x)[i + offsets[k]]

- :func:`build_dia` is the JAX host build (native plan + fill, or the
  numpy route), with the same ``CHUNK_ROWS`` padding and both layouts, so
  every plane equals the JAX one element for element.
- :func:`dia_spmv_torch` and :func:`dia_spmm_torch` are the plain PyTorch
  versions of K5 and K6 (the twins of ``dia_spmv_xla``/``dia_spmm_xla``),
  with products and sums in float32 as the Pallas kernels take them.
- :func:`dia_spmv` and :func:`dia_spmm` dispatch: CUDA tensors go through
  the hand-written kernels (:mod:`.dia_kernel`, ``csrc/dia_spmv.cu``), CPU
  tensors through the plain versions. Nothing else.

One difference from the JAX build: ``value_dtype="auto"`` tests the
*summed* plane for a lossless bfloat16 round trip. The JAX gate tests the
values before duplicates are summed, so two entries that are exact in
bfloat16 alone but not as a sum would be stored lossily there.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import DEFAULT_DEVICE, resolve_device
LANES = 128
#: hard cap on stored diagonals (the JAX package's gate; the kernels keep
#: the offsets in shared memory and take any count up to it)
MAX_DIAGS = 96
#: minimum nnz / (ndiag * m) so stored zeros don't dominate the stream
MIN_FILL = 0.2
#: rows the planes are padded to a multiple of (the JAX package's grid
#: step), so every plane can be compared with the JAX one
CHUNK_ROWS = 16384
#: the kernels index rows and x with int32 arithmetic
_INT32_MAX = 2**31 - 1


@dataclasses.dataclass
class DIAMatrix:
    """Diagonal-storage sparse matrix: data[k, i] = A[i, i + offsets[k]].

    The JAX ``DIAMatrix``'s fields (``dia.py:46-87``), plus
    ``offsets_t``, the offsets as an int32 tensor on the plane's device
    for the kernels, and ``launch_plan``, which the kernels' wrapper
    fills the first time it checks the planes. ``data`` is zero where a
    diagonal leaves the matrix and in the rows ``m..m_pad-1``. Layouts:

    - interleaved: ``data`` is (m_pad/128, ndiag, 128); element (k, i)
      lies at ``((i >> 7) * ndiag + k) * 128 + (i & 127)``;
    - diag-major: ``data`` is (ndiag, m_pad); element (k, i) at
      ``k * m_pad + i``.
    """

    shape: Tuple[int, int]
    offsets: Tuple[int, ...]
    nnz_stored: int
    data: torch.Tensor
    m_pad: int = 0
    interleaved: bool = False
    offsets_t: Optional[torch.Tensor] = None
    launch_plan: Optional[tuple] = dataclasses.field(
        default=None, init=False, repr=False, compare=False
    )

    def __post_init__(self):
        if self.offsets_t is None:
            self.offsets_t = torch.tensor(
                self.offsets, dtype=torch.int32, device=self.data.device
            )

    @property
    def m(self) -> int:
        return self.shape[0]

    @property
    def n(self) -> int:
        return self.shape[1]

    @property
    def ndiag(self) -> int:
        return len(self.offsets)

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype


def _as_host(csr):
    if isinstance(csr, tuple):
        row_ptr, col_idx, values, shape = csr
    elif hasattr(csr, "indptr"):
        row_ptr, col_idx, values, shape = csr.indptr, csr.indices, csr.data, csr.shape
    else:  # the port's CSRMatrix
        row_ptr, col_idx, values = (
            t.cpu().numpy() for t in (csr.row_ptr, csr.col_idx, csr.values)
        )
        shape = csr.shape
    return (
        np.asarray(row_ptr, np.int64),
        np.asarray(col_idx, np.int64),
        np.asarray(values),
        tuple(shape),
    )


def _bf16_lossless(plane: torch.Tensor) -> bool:
    """True iff every element of the (summed) plane survives float32 ->
    bfloat16 -> float32 unchanged."""
    return bool(torch.equal(plane.to(torch.bfloat16).to(torch.float32), plane))


def build_dia(
    csr,
    max_diags: int = MAX_DIAGS,
    min_fill: float = MIN_FILL,
    value_dtype=None,
    layout: str = "interleaved",
    device=DEFAULT_DEVICE,
) -> Optional[DIAMatrix]:
    """CSR -> DIA, or None when the matrix is not diagonal-structured
    (``dia.py:105-194``).

    Duplicate (row, col) entries are summed, matching the CSR oracle.
    ``value_dtype`` is None (the input dtype, float64 narrowed to
    float32), ``torch.float32``, ``torch.bfloat16``, or ``"auto"``:
    bfloat16 only when the summed plane is lossless in it. The plane is
    copied onto ``device`` (default: the card).
    """
    device = resolve_device(device, "build_dia")
    row_ptr, col_idx, values, (m, n) = _as_host(csr)
    nnz = int(values.shape[0])
    if nnz == 0:
        return None
    m_pad = -(-m // CHUNK_ROWS) * CHUNK_ROWS
    interleaved = layout == "interleaved"

    # native two-pass build (interleaved float32 only): the plan bails at
    # the (max_diags+1)-th distinct offset, the fill sums duplicates
    from ..utils import nativelib

    data = None
    if interleaved and values.dtype == np.float32:
        plan = nativelib.dia_plan(row_ptr, col_idx, m, n, max_diags)
        if plan is not None:
            if isinstance(plan, int):  # -1: more than max_diags offsets
                return None
            uniq = plan
            if nnz < min_fill * len(uniq) * m:
                return None
            data = nativelib.dia_fill(
                row_ptr, col_idx, values, uniq, m, n, m_pad, arena="dia:data"
            )
    if data is None:
        rows = np.repeat(np.arange(m, dtype=np.int64), np.diff(row_ptr))
        off = col_idx - rows
        uniq, inv = np.unique(off, return_inverse=True)
        if len(uniq) > max_diags or nnz < min_fill * len(uniq) * m:
            return None
        # np.add.at sums duplicates (scipy .dia_matrix parity)
        if interleaved:
            data = np.zeros((m_pad // LANES, len(uniq), LANES), values.dtype)
            np.add.at(data, (rows >> 7, inv, rows & (LANES - 1)), values)
        else:
            data = np.zeros((len(uniq), m_pad), values.dtype)
            np.add.at(data, (inv, rows), values)
    # always a copy: the native plane lives in the reused host arena
    plane = torch.from_numpy(np.ascontiguousarray(data)).to(
        device=device, dtype=torch.float32, copy=True
    )
    if value_dtype == "auto":
        value_dtype = torch.bfloat16 if _bf16_lossless(plane) else None
    if value_dtype is not None:
        plane = plane.to(value_dtype)
    return DIAMatrix(
        shape=(m, n),
        offsets=tuple(int(o) for o in uniq),
        nnz_stored=nnz,
        data=plane,
        m_pad=m_pad,
        interleaved=interleaved,
    )


def dia_supported(dia: Optional[DIAMatrix]) -> bool:
    """True when K5 takes the matrix: float32 or bfloat16 planes, at most
    ``MAX_DIAGS`` diagonals (the offsets sit in shared memory), and rows
    and x indices that fit int32. The JAX package's VMEM budget
    (``dia.py:205-217``) has no counterpart on the card: the kernel reads
    x from global memory at any size."""
    if dia is None:
        return False
    if dia.data.dtype not in (torch.float32, torch.bfloat16):
        return False
    if not 1 <= dia.ndiag <= MAX_DIAGS:
        return False
    reach = dia.m_pad + max(abs(o) for o in dia.offsets)
    return reach <= _INT32_MAX and dia.n <= _INT32_MAX


def dia_spmm_supported(dia: Optional[DIAMatrix], num_rhs: int) -> bool:
    """:func:`dia_supported` for K6 with ``num_rhs`` right-hand sides: any
    R >= 1 (the kernel walks R in chunks of at most 16 accumulators),
    with the (n, R) and (m, R) element counts inside int32 too."""
    return dia_supported(dia) and _rhs_fit(dia, num_rhs)


def _rhs_fit(dia: DIAMatrix, num_rhs: int) -> bool:
    """K6's limit on R: at least 1, and (n, R), (m, R) inside int32."""
    return num_rhs >= 1 and max(dia.m_pad, dia.n) * num_rhs <= _INT32_MAX


def _data_diag(dia: DIAMatrix) -> torch.Tensor:
    """(ndiag, m_pad) view of the value planes regardless of layout."""
    if dia.interleaved:
        return dia.data.permute(1, 0, 2).reshape(dia.ndiag, dia.m_pad)
    return dia.data


def _shifted_x(dia: DIAMatrix, xa: torch.Tensor):
    """``(xp, pad_l)``: ``xa`` zero-padded along its last dimension so that
    ``xp[..., pad_l + off + i]`` is x[i + off] (or 0 outside the matrix)
    for every row i < m_pad."""
    offs = dia.offsets
    pad_l = max(0, -min(offs))
    pad_r = max(0, dia.m_pad + max(offs) - dia.n)
    return torch.nn.functional.pad(xa, (pad_l, pad_r)), pad_l


def dia_spmv_torch(dia: DIAMatrix, x: torch.Tensor, alpha=1.0) -> torch.Tensor:
    """The plain version of K5: y = alpha * A @ x with static slices
    (``dia_spmv_xla``, ``dia.py:433-450``). alpha is folded into x and the
    products are summed in float32 in diagonal order, as K5 does."""
    dd = _data_diag(dia)
    xp, pad_l = _shifted_x(dia, x.to(torch.float32) * alpha)
    acc = torch.zeros(dia.m_pad, dtype=torch.float32, device=x.device)
    for k, off in enumerate(dia.offsets):
        s = pad_l + off
        acc = acc + dd[k].to(torch.float32) * xp[s : s + dia.m_pad]
    return acc[: dia.m].to(x.dtype)


def dia_spmm_torch(dia: DIAMatrix, xm: torch.Tensor, alpha=1.0) -> torch.Tensor:
    """The plain version of K6: Y = alpha * A @ X for X (n, R), Y (m, R)
    (``dia_spmm_xla``, ``dia.py:415-430``), summed as :func:`dia_spmv_torch`."""
    dd = _data_diag(dia)
    xp, pad_l = _shifted_x(dia, (xm.to(torch.float32) * alpha).T)  # (R, n + pads)
    acc = torch.zeros((xm.shape[1], dia.m_pad), dtype=torch.float32, device=xm.device)
    for k, off in enumerate(dia.offsets):
        s = pad_l + off
        acc = acc + dd[k].to(torch.float32)[None, :] * xp[:, s : s + dia.m_pad]
    return acc[:, : dia.m].T.contiguous().to(xm.dtype)


def _on_cuda(x: torch.Tensor, backend: str) -> bool:
    """True when the call goes to the kernel (see :func:`dia_spmv`)."""
    if backend not in ("auto", "cuda", "torch"):
        raise ValueError(f"unknown backend {backend!r} (auto|cuda|torch)")
    if backend == "torch" and x.is_cuda:
        raise ValueError(
            "backend='torch' runs the plain version on CPU tensors only; "
            "CUDA tensors go through the kernel"
        )
    return backend == "cuda" or x.is_cuda


def dia_spmv(
    dia: DIAMatrix, x: torch.Tensor, alpha=1.0, backend: str = "auto"
) -> torch.Tensor:
    """y = alpha * A @ x: K5 for CUDA tensors, the plain version for CPU
    tensors. ``backend`` names the path the caller expects (``"auto"``
    follows the device); a mismatch raises instead of changing path."""
    if _on_cuda(x, backend):
        from .dia_kernel import dia_spmv_cuda

        return dia_spmv_cuda(dia, x, alpha)
    return dia_spmv_torch(dia, x, alpha)


def dia_spmm(
    dia: DIAMatrix, xm: torch.Tensor, alpha=1.0, backend: str = "auto"
) -> torch.Tensor:
    """Y = alpha * A @ X for X (n, R): K6 for CUDA tensors, the plain
    version for CPU tensors (as :func:`dia_spmv`)."""
    if _on_cuda(xm, backend):
        from .dia_kernel import dia_spmm_cuda

        return dia_spmm_cuda(dia, xm, alpha)
    return dia_spmm_torch(dia, xm, alpha)
