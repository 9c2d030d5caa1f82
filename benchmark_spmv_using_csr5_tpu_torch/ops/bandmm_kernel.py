"""The Python wrapper of K7, the hand-written CUDA band-block SpMM kernel.

The kernel (``csrc/bandmm.cu``) replaces the JAX package's Pallas kernel
``ops/bandmm.py::_bandmm_kernel`` (launched by ``_bandmm_jit``): one
four-warp block per 128-row block of the dense plane, the plane streamed
through a ring of shared-memory slots, tensor cores (bf16 operands, float32
sums) in ``"default"`` and exact float32 products on the CUDA cores in
``"highest"``, up to 32 right-hand sides per launch chunk (16 on a float32
plane). The kernel sets its own dynamic shared memory. Y is written whole,
so it is allocated with ``torch.empty``. alpha is folded into X first, as
``_bandmm_jit`` does; the window of X is read in place through strides,
masked to 0 past n.

The wrapper raises on anything the kernel does not take and never falls
back to the plain version (:func:`.bandmm.bandmm_spmm_torch`).
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import cuda_build
from .bandmm import LANES, BandBlockMatrix, bandmm_supported, resolve_precision

#: K7 launches so far in this process (the wrapper adds one per launch)
launches = 0
#: right-hand sides per launch chunk: one pass over a bfloat16 plane for
#: R <= 32
MAX_CHUNK = 32
#: the same on a float32 plane: its ring at 32 right-hand sides (126 KB)
#: would leave one CTA per SM, and "highest" 32 accumulators per thread
MAX_CHUNK_F32 = 16

_bound = None


def _lib() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    global _bound
    if _bound is None:
        lib = cuda_build.load("bandmm")
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        for fn in (lib.bandmm_f32, lib.bandmm_bf16):
            # dense, c0, x, y, m, n, K, nblk, R, xs_c, xs_r, ys_row, ys_r,
            # rc, bf16_ops, stream
            fn.argtypes = [ptr] * 4 + [i32] * 5 + [i64] * 4 + [i32] * 2 + [ptr]
            fn.restype = i32
        lib.bandmm_error_string.argtypes = [i32]
        lib.bandmm_error_string.restype = ctypes.c_char_p
        _bound = lib
    return _bound


def chunk_width(num_rhs: int, plane_dtype: torch.dtype) -> int:
    """The right-hand sides of one launch chunk (``rc``) for R = ``num_rhs``
    on a plane of ``plane_dtype``: the power of two at or above
    min(R, MAX_CHUNK), at most MAX_CHUNK_F32 on a float32 plane. The kernel
    pads it to a multiple of 8 on the tensor cores."""
    cap = MAX_CHUNK if plane_dtype == torch.bfloat16 else MAX_CHUNK_F32
    rc = 1
    while rc < min(num_rhs, cap):
        rc *= 2
    return rc


def bandmm_spmm_cuda(
    bb: BandBlockMatrix,
    x: torch.Tensor,
    alpha=1.0,
    precision: str = "auto",
    layout: str = "nr",
) -> torch.Tensor:
    """Y = alpha * A @ X through K7 (CUDA tensors only); the arguments as
    :func:`.bandmm.bandmm_spmm`."""
    global launches
    who = "bandmm_spmm_cuda"
    if not x.is_cuda:
        raise ValueError(f"{who} takes CUDA tensors; CPU tensors go through bandmm_spmm_torch")
    prec = resolve_precision(bb, precision)
    if layout not in ("nr", "rn"):
        raise ValueError(f"{who}: unknown layout {layout!r} (nr|rn)")
    if x.dtype != torch.float32:
        raise NotImplementedError(f"{who}: x dtype {x.dtype}; only float32 runs here")
    if x.dim() != 2:
        raise ValueError(f"{who}: X must be 2-D, got shape {tuple(x.shape)}")
    rn = layout == "rn"
    R = x.shape[0] if rn else x.shape[1]
    m, n, K, nblk = bb.m, bb.n, bb.K, bb.num_blocks
    want = (R, n) if rn else (n, R)
    if tuple(x.shape) != want or not x.is_contiguous():
        raise ValueError(f"{who}: X must be a contiguous {want} tensor, got {tuple(x.shape)}")
    if not bandmm_supported(bb, R):
        raise ValueError(f"{who}: the plane (dtype {bb.dense.dtype}, K={K}) or R={R} is not taken")
    dev = x.device
    d, c0 = bb.dense, bb.c0
    if d.device != dev or c0.device != dev:
        raise ValueError(f"{who}: the plane is on {d.device}, X on {dev}")
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"{who}: X is on {dev}; launch under torch.cuda.device({dev})")
    if tuple(d.shape) != (nblk * LANES, K) or not d.is_contiguous() or d.data_ptr() % 16:
        raise ValueError(f"{who}: dense must be a contiguous 16 B aligned (m_pad, K) plane")
    if c0.dtype != torch.int32 or tuple(c0.shape) != (1, nblk) or not c0.is_contiguous():
        raise ValueError(f"{who}: c0 must be a contiguous (1, {nblk}) int32 tensor")

    lib = _lib()
    fn = lib.bandmm_bf16 if d.dtype == torch.bfloat16 else lib.bandmm_f32
    xa = x if alpha == 1.0 else x * alpha
    y = torch.empty((R, m) if rn else (m, R), dtype=torch.float32, device=dev)
    rc = chunk_width(R, d.dtype)
    xs_c, xs_r = (1, n) if rn else (R, 1)
    ys_row, ys_r = (1, m) if rn else (R, 1)
    rcode = fn(
        d.data_ptr(), c0.data_ptr(), xa.data_ptr(), y.data_ptr(),
        m, n, K, nblk, R, xs_c, xs_r, ys_row, ys_r, rc, int(prec == "default"),
        cuda_build.stream_handle(dev),
    )
    if rcode != 0:
        msg = lib.bandmm_error_string(rcode).decode(errors="replace")
        raise RuntimeError(f"{who}: kernel launch failed: {msg} ({rcode})")
    if nblk > 0 and m > 0:
        launches += 1
    return y
