"""The Python wrapper of K4, the hand-written float64 CSR5 SpMV kernel.

The counterpart of ``benchmark_spmv_using_csr5_tpu/ops/csr5_df64.py``.
The JAX package computes float64 SpMV on a TPU, which has no float64
arithmetic, as double-single (hi, lo) float32 pairs
(``_df64_kernel``): a ``DF64CSR5`` carries the float32 hi plane and a lo
plane, and every add and product is an error-free transformation, about
2^-48 relative each. Hopper has native fp64, so the port keeps one
float64 value plane (``build_csr5(..., value_dtype=torch.float64)``,
whose float32 rounding is the JAX hi plane) and K4
(``csrc/csr5_spmv_f64.cu``) runs K1's tile algorithm on doubles, at
2^-53, keeping the tile prefix only at the row ends the window maps name
and loading a lane's rows eight at a time, one group ahead.
``csr5_from_df64`` (``models/formats.py``) builds that plane from a JAX
``DF64CSR5``.

The wrapper checks device, dtypes, shapes and contiguity and raises on
anything the kernel does not take. It never falls back to the plain
version, :func:`..ops.csr5_spmv.csr5_spmv_torch`, which is dtype-generic
and is K4's plain version on float64 tensors.
"""

from __future__ import annotations

import ctypes

import torch

from ..models.formats import CSR5Matrix
from ..utils import cuda_build
from .csr5_kernel import LANES, SMEM_MAX, STATIC_SMEM, _expect, row_end_bytes

#: the largest sigma K4 takes: the bound of the first port, which kept the
#: whole (sigma + 1) * 128 float64 prefix in shared memory; the row-end
#: layout (:func:`f64_smem_bytes`) fits sigma 224 up to 28,248 row ends
#: per tile, that is min(capw, sigma * 128) <= 28,248
MAX_SIGMA = 224

#: K4 launches so far in this process (the wrapper adds one per launch)
launches = 0

_bound = None


def _lib() -> ctypes.CDLL:
    """The built K4 library with its C signature declared."""
    global _bound
    if _bound is None:
        lib = cuda_build.load("csr5_spmv_f64")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        # col, val, win_map, tile_ptr, x, y, p, sigma, capw, win_rel, stream
        lib.csr5_spmv_f64.argtypes = [ptr] * 6 + [i32] * 4 + [ptr]
        lib.csr5_spmv_f64.restype = i32
        lib.csr5_f64_error_string.argtypes = [i32]
        lib.csr5_f64_error_string.restype = ctypes.c_char_p
        _bound = lib
    return _bound


def f64_smem_bytes(sigma: int, nends: int) -> int:
    """K4's dynamic shared memory per block
    (``csrc/csr5_spmv_f64.cu::smem_bytes``): the float64 prefixes at the
    ``nends = min(capw, sigma * 128)`` row ends, the 128 lane carries and
    the row-end planes."""
    return nends * 8 + LANES * 8 + row_end_bytes(sigma)


def f64_supported(a5: CSR5Matrix) -> bool:
    """True when K4 takes ``a5``: a float64 value plane, omega = 128, at
    least one column, sigma <= :data:`MAX_SIGMA`, and the shared memory of
    one block (:func:`f64_smem_bytes`) within what Hopper gives a block."""
    return (
        a5.val_tiles.dtype == torch.float64
        and a5.omega == LANES
        and a5.n >= 1
        and a5.sigma <= MAX_SIGMA
        and f64_smem_bytes(a5.sigma, min(a5.capw, a5.sigma * LANES)) <= SMEM_MAX - STATIC_SMEM
    )


def csr5_spmv_f64_cuda(a5: CSR5Matrix, x: torch.Tensor, alpha=1.0) -> torch.Tensor:
    """y = alpha * A @ x in float64 through K4 (CUDA tensors only). alpha
    is folded into x in float64, as ``df64_spmv`` folds it on the host."""
    global launches
    who = "csr5_spmv_f64_cuda"
    if not x.is_cuda:
        raise ValueError(f"{who} takes CUDA tensors; CPU tensors go through csr5_spmv_torch")
    if x.dtype != torch.float64 or a5.val_tiles.dtype != torch.float64:
        raise ValueError(
            f"{who}: x is {x.dtype} and the value plane {a5.val_tiles.dtype}; K4 takes "
            "float64 for both (build_csr5(..., value_dtype=torch.float64))"
        )
    if not f64_supported(a5):
        raise ValueError(
            f"{who}: sigma={a5.sigma}, capw={a5.capw}, omega={a5.omega}, n={a5.n} exceed "
            f"the kernel's limits (omega 128, n >= 1, sigma <= {MAX_SIGMA}, one block's "
            "shared memory)"
        )
    dev = x.device
    p, sig, capw = a5.num_tiles, a5.sigma, a5.capw
    _expect(x, "x", (torch.float64,), (a5.n,), dev, who)
    _expect(a5.col_idx_tiles, "col_idx_tiles", (torch.int32,), (p, sig, LANES), dev, who)
    _expect(a5.val_tiles, "val_tiles", (torch.float64,), (p, sig, LANES), dev, who)
    _expect(a5.win_map, "win_map", (torch.int32,), (p, capw), dev, who)
    _expect(a5.tile_ptr, "tile_ptr", (torch.int32,), (p + 1,), dev, who)

    lib = _lib()
    xa = x if alpha == 1.0 else x * alpha
    y = torch.zeros(a5.m_pad, dtype=torch.float64, device=dev)
    with torch.cuda.device(dev):
        rc = lib.csr5_spmv_f64(
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
            cuda_build.stream_handle(dev),
        )
    if rc != 0:
        msg = lib.csr5_f64_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"{who}: kernel launch failed: {msg} ({rc})")
    launches += 1
    return y[: a5.m]
