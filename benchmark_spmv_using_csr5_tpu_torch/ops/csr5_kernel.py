"""The Python wrapper of K1, the hand-written CUDA CSR5 SpMV kernel.

The kernel (``csrc/csr5_spmv.cu``) replaces the JAX package's Pallas
kernel ``ops/csr5_kernel.py::_spmv_kernel`` at R=1. It takes one
``(sigma, 128)`` tile per 128-thread block and adds each tile's row
partial sums into a zeroed ``m_pad`` float32 y with atomics; y is then
cut to ``[:m]``. alpha is folded into x first, as the Pallas wrapper does.

The wrapper checks device, dtypes, shapes and contiguity and raises on
anything the kernel does not take. It never falls back to the plain
version (:func:`..ops.csr5_spmv.csr5_spmv_torch`).
"""

from __future__ import annotations

import ctypes

import torch

from ..models.formats import CSR5Matrix
from ..utils import cuda_build

LANES = 128
#: the kernel keeps (sigma + 1) * 128 float32 in shared memory per block;
#: Hopper gives a block at most 227 KB (232,448 B), so sigma <= 452
MAX_SIGMA = 448

#: kernel launches so far in this process (the wrapper adds one per launch)
launches = 0

_bound = None


def _lib() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    global _bound
    if _bound is None:
        lib = cuda_build.load("csr5_spmv")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.csr5_spmv_f32, lib.csr5_spmv_bf16):
            # col, val, win_map, tile_ptr, x, y, p, sigma, capw, win_rel, stream
            fn.argtypes = [ptr] * 6 + [i32] * 4 + [ptr]
            fn.restype = i32
        lib.csr5_cuda_error_string.argtypes = [i32]
        lib.csr5_cuda_error_string.restype = ctypes.c_char_p
        _bound = lib
    return _bound


def _expect(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t is None:
        raise ValueError(f"csr5_spmv_cuda: {name} is missing")
    if t.device != device:
        raise ValueError(f"csr5_spmv_cuda: {name} is on {t.device}, x on {device}")
    if t.dtype not in dtype:
        raise ValueError(f"csr5_spmv_cuda: {name} has dtype {t.dtype}, wants {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"csr5_spmv_cuda: {name} has shape {tuple(t.shape)}, wants {shape}")
    if not t.is_contiguous():
        raise ValueError(f"csr5_spmv_cuda: {name} is not contiguous")


def csr5_spmv_cuda(a5: CSR5Matrix, x: torch.Tensor, alpha=1.0) -> torch.Tensor:
    """y = alpha * A @ x through the CUDA kernel (CUDA tensors only)."""
    global launches
    if not x.is_cuda:
        raise ValueError(
            "csr5_spmv_cuda takes CUDA tensors; CPU tensors go through "
            "csr5_spmv_torch"
        )
    if x.dtype != torch.float32:
        raise NotImplementedError(
            f"csr5_spmv_cuda: x dtype {x.dtype}; only float32 runs here "
            "(float64 is kernel K4, ROADMAP queue 1 item 7)"
        )
    if a5.omega != LANES:
        raise ValueError(f"csr5_spmv_cuda: omega={a5.omega}, the kernel takes {LANES}")
    p, sig, capw = a5.num_tiles, a5.sigma, a5.capw
    if sig > MAX_SIGMA:
        raise ValueError(
            f"csr5_spmv_cuda: sigma={sig} exceeds {MAX_SIGMA}, the shared-memory "
            "limit of one block"
        )
    if a5.n < 1:
        raise ValueError("csr5_spmv_cuda: the matrix has no columns")
    dev = x.device
    _expect(x, "x", (torch.float32,), (a5.n,), dev)
    _expect(a5.col_idx_tiles, "col_idx_tiles", (torch.int32,), (p, sig, LANES), dev)
    _expect(
        a5.val_tiles, "val_tiles", (torch.float32, torch.bfloat16), (p, sig, LANES), dev
    )
    _expect(a5.win_map, "win_map", (torch.int32,), (p, capw), dev)
    _expect(a5.tile_ptr, "tile_ptr", (torch.int32,), (p + 1,), dev)

    lib = _lib()
    fn = lib.csr5_spmv_bf16 if a5.val_tiles.dtype == torch.bfloat16 else lib.csr5_spmv_f32
    xa = x if alpha == 1.0 else x * alpha
    y = torch.zeros(a5.m_pad, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = fn(
            a5.col_idx_tiles.data_ptr(),
            a5.val_tiles.data_ptr(),
            a5.win_map.data_ptr(),
            a5.tile_ptr.data_ptr(),
            xa.data_ptr(),
            y.data_ptr(),
            p,
            sig,
            capw,
            int(a5.win_rel),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        msg = lib.csr5_cuda_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"csr5_spmv_cuda: kernel launch failed: {msg} ({rc})")
    launches += 1
    return y[: a5.m]
