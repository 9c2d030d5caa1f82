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
kept on the matrix; each call checks only x.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import cuda_build
from .dia import LANES, DIAMatrix, _rhs_fit, dia_supported

#: K5 launches so far in this process (the wrapper adds one per launch)
spmv_launches = 0
#: K6 launches so far in this process
spmm_launches = 0

_bound = None


def _lib() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    global _bound
    if _bound is None:
        lib = cuda_build.load("dia_spmv")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.dia_spmv_f32, lib.dia_spmv_bf16):
            # data, offsets, x, y, m, n, nd, m_pad, interleaved, stream
            fn.argtypes = [ptr] * 4 + [i32] * 5 + [ptr]
            fn.restype = i32
        for fn in (lib.dia_spmm_f32, lib.dia_spmm_bf16):
            # data, offsets, x, y, m, n, nd, m_pad, interleaved, R, vec, stream
            fn.argtypes = [ptr] * 4 + [i32] * 7 + [ptr]
            fn.restype = i32
        lib.dia_cuda_error_string.argtypes = [i32]
        lib.dia_cuda_error_string.restype = ctypes.c_char_p
        _bound = lib
    return _bound


def _plan(dia: DIAMatrix, who: str) -> tuple:
    """``(data, offsets_t, spmv_fn, spmm_fn, device, args)`` for ``dia``:
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
    lib = _lib()
    bf16 = d.dtype == torch.bfloat16
    p = (
        d,
        offs,
        lib.dia_spmv_bf16 if bf16 else lib.dia_spmv_f32,
        lib.dia_spmm_bf16 if bf16 else lib.dia_spmm_f32,
        d.device,
        (d.data_ptr(), offs.data_ptr(), dia.m, dia.n, nd, dia.m_pad, int(dia.interleaved)),
    )
    dia.launch_plan = p
    return p


def _check_x(x: torch.Tensor, dev: torch.device, shape, who: str) -> None:
    """Raise unless ``x`` is a contiguous float32 ``shape`` tensor on
    ``dev``, the current device."""
    if x.device == dev and x.dtype == torch.float32 and x.shape == shape and x.is_contiguous():
        if dev.index == torch.cuda.current_device():
            return
        raise ValueError(f"{who}: x is on {dev}; launch under torch.cuda.device({dev})")
    if x.dtype != torch.float32:
        raise NotImplementedError(
            f"{who}: x dtype {x.dtype}; only float32 runs here "
            "(float64 is ROADMAP queue 1 item 7)"
        )
    if x.device != dev:
        raise ValueError(f"{who}: x is on {x.device}, the DIA planes on {dev}")
    raise ValueError(f"{who}: x must be a contiguous {tuple(shape)} tensor, got {tuple(x.shape)}")


def _cpu_refused(x: torch.Tensor, who: str) -> None:
    if not x.is_cuda:
        raise ValueError(f"{who} takes CUDA tensors; CPU tensors go through the plain version")


def _raise_on(rc: int, who: str) -> None:
    msg = _lib().dia_cuda_error_string(rc).decode(errors="replace")
    raise RuntimeError(f"{who}: kernel launch failed: {msg} ({rc})")


def dia_spmv_cuda(dia: DIAMatrix, x: torch.Tensor, alpha=1.0) -> torch.Tensor:
    """y = alpha * A @ x through K5 (CUDA tensors only)."""
    global spmv_launches
    _cpu_refused(x, "dia_spmv_cuda")
    _, _, fn, _, dev, args = _plan(dia, "dia_spmv_cuda")
    _check_x(x, dev, (dia.n,), "dia_spmv_cuda")
    xa = x if alpha == 1.0 else x * alpha
    y = torch.empty(dia.m, dtype=torch.float32, device=dev)
    stream = cuda_build.stream_handle(dev)
    rc = fn(args[0], args[1], xa.data_ptr(), y.data_ptr(), *args[2:], stream)
    if rc:
        _raise_on(rc, "dia_spmv_cuda")
    spmv_launches += 1
    return y


def dia_spmm_cuda(dia: DIAMatrix, xm: torch.Tensor, alpha=1.0) -> torch.Tensor:
    """Y = alpha * A @ X for X (n, R) row-major through K6 (CUDA tensors
    only); Y is (m, R), as the JAX package returns it."""
    global spmm_launches
    who = "dia_spmm_cuda"
    _cpu_refused(xm, who)
    if xm.dim() != 2:
        raise ValueError(f"{who}: X must be (n, R), got shape {tuple(xm.shape)}")
    R = xm.shape[1]
    _, _, _, fn, dev, args = _plan(dia, who)
    _check_x(xm, dev, (dia.n, R), who)
    if not _rhs_fit(dia, R):
        raise ValueError(f"{who}: R={R} exceeds K6's limits (R >= 1, int32 indices)")
    xa = xm if alpha == 1.0 else xm * alpha
    y = torch.empty((dia.m, R), dtype=torch.float32, device=dev)
    vec = int(R % 4 == 0 and xa.data_ptr() % 16 == 0 and y.data_ptr() % 16 == 0)
    stream = cuda_build.stream_handle(dev)
    rc = fn(args[0], args[1], xa.data_ptr(), y.data_ptr(), *args[2:], R, vec, stream)
    if rc:
        _raise_on(rc, who)
    spmm_launches += 1
    return y
