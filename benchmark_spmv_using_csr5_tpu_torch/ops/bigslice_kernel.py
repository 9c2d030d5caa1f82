"""The Python wrapper of K3, the hand-written CUDA row-sliced CSR5 SpMV.

K3 (``csrc/csr5_sliced.cu``) replaces the JAX package's Pallas kernel
``ops/csr5_kernel.py::_spmv_kernel`` in ``xwin`` mode, which
``ops/bigslice.py::_sliced_spmv_jit`` launches once per slice. K3 is ONE
launch over the tiles of every slice: a table on the card holds one
descriptor per slice (:data:`DESC_FIELDS`), and each block finds its slice,
reads x at the slice's column offset and adds its row partial sums into
one zeroed y at the slice's row offset. Slices with ``col_packed`` take
K1p's decode.

The table holds the slices' plane addresses, so it is made once per
sliced matrix, at its first launch, and kept on it
(``SlicedCSR5.kernel_table``) with the planes it points at. The wrapper
checks every slice once, raises on anything the kernel does not take, and
never falls back to the plain version (:func:`.bigslice.sliced_spmv_torch`).
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import cuda_build
from .bigslice import SlicedCSR5
from .csr5_kernel import LANES, MAX_SIGMA, _expect, _expect_planes

#: K3 launches so far in this process (the wrapper adds one per launch)
launches = 0

#: the int64 words of one slice descriptor (``csrc/csr5_sliced.cu::SliceDesc``)
DESC_FIELDS = (
    "col", "val", "win_map", "tile_ptr", "pages", "tile0", "p", "capw", "win_rel",
    "packed", "bf16", "pmax", "r0", "c0", "pad0", "pad1",
)
_INT32_MAX = 2**31 - 1

_bound = None


def _lib() -> ctypes.CDLL:
    """The built K3 library with its C signature declared."""
    global _bound
    if _bound is None:
        lib = cuda_build.load("csr5_sliced")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        # table, nslices, total_tiles, x, y, sigma, stream
        lib.csr5_sliced_spmv.argtypes = [ptr, i32, i32, ptr, ptr, i32, ptr]
        lib.csr5_sliced_spmv.restype = i32
        lib.csr5_sliced_error_string.argtypes = [i32]
        lib.csr5_sliced_error_string.restype = ctypes.c_char_p
        _bound = lib
    return _bound


def _table(sl: SlicedCSR5, device) -> tuple:
    """``(table, total_tiles, out_rows, planes)`` for ``sl``: the
    slices checked once and their descriptors on ``device``, kept on the
    matrix while its slices are the same tensors (``planes`` holds their
    addresses)."""
    who = "sliced_spmv_cuda"
    planes = tuple(
        t.data_ptr()
        for a5 in sl.slices
        for t in (a5.col_packed if a5.col_packed is not None else a5.col_idx_tiles,
                  a5.val_tiles, a5.win_map, a5.tile_ptr, a5.pages)
        if t is not None
    )
    cached = sl.kernel_table
    if cached is not None and cached[3] == planes and cached[0].device == device:
        return cached
    if not sl.slices:
        raise ValueError(f"{who}: the sliced matrix has no slices")
    sigma = sl.sigma
    rows, tile0, out_rows = [], 0, 0
    for k, a5 in enumerate(sl.slices):
        if a5.omega != LANES or a5.sigma != sigma or sigma > MAX_SIGMA:
            raise ValueError(
                f"{who}: slice {k} has omega={a5.omega}, sigma={a5.sigma}; K3 takes omega 128 "
                f"and one sigma <= {MAX_SIGMA} for every slice (slice 0: {sigma})"
            )
        _expect_planes(a5, device, who)
        packed = a5.col_packed is not None
        col = a5.col_packed if packed else a5.col_idx_tiles
        r0, c0 = sl.row_starts[k], sl.col_starts[k]
        rows.append([
            col.data_ptr(), a5.val_tiles.data_ptr(), a5.win_map.data_ptr(),
            a5.tile_ptr.data_ptr(), a5.pages.data_ptr() if packed else 0, tile0,
            a5.num_tiles, a5.capw, int(a5.win_rel), int(packed),
            int(a5.val_tiles.dtype == torch.bfloat16), a5.pmax if packed else 0, r0, c0, 0, 0,
        ])
        tile0 += a5.num_tiles
        out_rows = max(out_rows, r0 + a5.m_pad)
    if tile0 > _INT32_MAX or out_rows > _INT32_MAX:
        raise ValueError(
            f"{who}: {tile0} tiles and {out_rows} output rows; K3 takes fewer than 2**31 of each"
        )
    table = torch.tensor(rows, dtype=torch.int64).to(device)
    sl.kernel_table = (table, tile0, out_rows, planes)
    return sl.kernel_table


def sliced_spmv_cuda(sl: SlicedCSR5, x: torch.Tensor, alpha=1.0) -> torch.Tensor:
    """y = alpha * A @ x through K3, one launch over every slice (CUDA
    tensors only)."""
    global launches
    who = "sliced_spmv_cuda"
    if not x.is_cuda:
        raise ValueError(f"{who} takes CUDA tensors; CPU tensors go through sliced_spmv_torch")
    if x.dtype != torch.float32:
        raise ValueError(f"{who}: x dtype {x.dtype}; K3 takes float32")
    dev = x.device
    _expect(x, "x", (torch.float32,), (sl.n,), dev, who)
    table, total, out_rows, _ = _table(sl, dev)
    lib = _lib()
    xa = x if alpha == 1.0 else x * alpha
    y = torch.zeros(out_rows, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.csr5_sliced_spmv(
            table.data_ptr(), table.shape[0], total, xa.data_ptr(), y.data_ptr(), sl.sigma,
            cuda_build.stream_handle(dev),
        )
    if rc != 0:
        msg = lib.csr5_sliced_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"{who}: kernel launch failed: {msg} ({rc})")
    launches += 1
    return y[: sl.m]
