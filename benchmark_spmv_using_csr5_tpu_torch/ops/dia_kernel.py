"""The Python wrappers of K5 and K6, the hand-written CUDA DIA kernels.

The kernels (``csrc/dia_spmv.cu``) replace the JAX package's Pallas
kernels ``ops/dia.py::_dia_kernel``/``_dia_kernel_streamx`` (K5, SpMV) and
``_dia_spmm_kernel``/``_dia_spmm_kernel_streamx`` (K6, SpMM). y is written
once per row, so it is allocated with ``torch.empty``. alpha is folded into
x first, as ``_dia_spmv_jit`` does.

The wrappers raise on anything the kernels do not take, and never fall
back to the plain versions (:func:`.dia.dia_spmv_torch`,
:func:`.dia.dia_spmm_torch`). They are kept lean because at banded500k
the host's time per call is of the order of K5's device time: the
matrix's planes are checked once and the result (the launch plan) is
kept on the matrix; each call checks only x, and launches through
``utils/cuda_build.py::launch``.
"""

from __future__ import annotations

import torch

from ..utils import cuda_build
from .dia import LANES, DIAMatrix, _rhs_fit, dia_supported


def _plan(dia: DIAMatrix, who: str) -> tuple:
    """``(data, offsets_t, spmv_entry, spmm_entry, device, args)`` for ``dia``:
    its planes checked once, kept on the matrix while they are the same
    tensors at the same addresses. ``args`` are the kernels' leading
    arguments (data, offsets, then m, n, nd, m_pad, interleaved)."""
    d, offs = dia.data, dia.offsets_t
    p = dia.launch_plan
    if (p is not None and p[0] is d and p[1] is offs
            and p[5][:2] == (d.data_ptr(), offs.data_ptr())):
        return p
    nd = dia.ndiag
    want = (dia.m_pad // LANES, nd, LANES) if dia.interleaved else (nd, dia.m_pad)
    if not d.is_cuda or offs.device != d.device:
        raise ValueError(f"{who}: the DIA planes must be CUDA tensors on one device")
    if tuple(d.shape) != want or not d.is_contiguous():
        raise ValueError(f"{who}: data must be a contiguous {want} plane, got {tuple(d.shape)}")
    if d.data_ptr() % 16:
        raise ValueError(f"{who}: the value plane is not 16-byte aligned")
    if offs.dtype != torch.int32 or tuple(offs.shape) != (nd,) or not offs.is_contiguous():
        raise ValueError(f"{who}: offsets_t must be a contiguous ({nd},) int32 tensor")
    if not dia_supported(dia):
        raise ValueError(
            f"{who}: the matrix exceeds the kernels' limits (float32/bfloat16 "
            "values, 1 to MAX_DIAGS diagonals, int32 rows)"
        )
    dt = "bf16" if d.dtype == torch.bfloat16 else "f32"
    p = (
        d,
        offs,
        f"dia_spmv_{dt}",
        f"dia_spmm_{dt}",
        d.device,
        (d.data_ptr(), offs.data_ptr(), dia.m, dia.n, nd, dia.m_pad, int(dia.interleaved)),
    )
    dia.launch_plan = p
    return p


def _check_x(x: torch.Tensor, dev: torch.device, shape, who: str) -> None:
    """Raise unless ``x`` is a contiguous float32 ``shape`` tensor on
    ``dev``."""
    if x.device == dev and x.dtype == torch.float32 and x.shape == shape and x.is_contiguous():
        return
    if x.dtype != torch.float32:
        raise NotImplementedError(
            f"{who}: x dtype {x.dtype}; only float32 runs here (float64 runs CSR5 SpMV "
            "on K4: build_csr5(..., value_dtype=torch.float64))"
        )
    if x.device != dev:
        raise ValueError(f"{who}: x is on {x.device}, the DIA planes on {dev}")
    raise ValueError(f"{who}: x must be a contiguous {tuple(shape)} tensor, got {tuple(x.shape)}")


def _cpu_refused(x: torch.Tensor, who: str) -> None:
    if not x.is_cuda:
        raise ValueError(f"{who} takes CUDA tensors; CPU tensors go through the plain version")


def dia_spmv_cuda(dia: DIAMatrix, x: torch.Tensor, alpha=1.0) -> torch.Tensor:
    """y = alpha * A @ x through K5 (CUDA tensors only)."""
    who = "dia_spmv_cuda"
    _cpu_refused(x, who)
    _, _, entry, _, dev, args = _plan(dia, who)
    _check_x(x, dev, (dia.n,), who)
    xa = x if alpha == 1.0 else x * alpha
    y = torch.empty(dia.m, dtype=torch.float32, device=dev)
    args = (args[0], args[1], xa.data_ptr(), y.data_ptr(), *args[2:])
    cuda_build.launch(cuda_build.bind("dia_spmv"), entry, dev, args, who, "dia_spmv")
    return y


def dia_spmm_cuda(dia: DIAMatrix, xm: torch.Tensor, alpha=1.0) -> torch.Tensor:
    """Y = alpha * A @ X for X (n, R) row-major through K6 (CUDA tensors
    only); Y is (m, R), as the JAX package returns it."""
    who = "dia_spmm_cuda"
    _cpu_refused(xm, who)
    if xm.dim() != 2:
        raise ValueError(f"{who}: X must be (n, R), got shape {tuple(xm.shape)}")
    R = xm.shape[1]
    _, _, _, entry, dev, args = _plan(dia, who)
    _check_x(xm, dev, (dia.n, R), who)
    if not _rhs_fit(dia, R):
        raise ValueError(f"{who}: R={R} exceeds K6's limits (R >= 1, int32 indices)")
    xa = xm if alpha == 1.0 else xm * alpha
    y = torch.empty((dia.m, R), dtype=torch.float32, device=dev)
    vec = int(R % 4 == 0 and xa.data_ptr() % 16 == 0 and y.data_ptr() % 16 == 0)
    args = (args[0], args[1], xa.data_ptr(), y.data_ptr(), *args[2:], R, vec)
    cuda_build.launch(cuda_build.bind("dia_spmv"), entry, dev, args, who, "dia_spmm")
    return y
