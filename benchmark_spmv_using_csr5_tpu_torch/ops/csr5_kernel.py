"""The Python wrappers of K1, K1p, K2 and K2p, the hand-written CUDA CSR5
kernels.

K1 (``csrc/csr5_spmv.cu``) replaces the JAX package's Pallas kernel
``ops/csr5_kernel.py::_spmv_kernel`` at R=1. It takes one ``(sigma, 128)``
tile per 128-thread block and adds each tile's row partial sums into a
zeroed ``m_pad`` float32 y with atomics; y is then cut to ``[:m]``.

K1p and K2p are K1 and K2 streaming the packed column plane
``col_packed`` (two uint16 codes ``lane | local_page << 7`` per int32
word) with the page lists ``pages``: 2 B of columns per nonzero instead
of 4. As ``_csr5_spmv_pallas_jit`` and ``_csr5_spmm_pallas_jit`` do
(``csr5_kernel.py:816-820``, ``:870-874``), :func:`csr5_spmv_cuda` and
:func:`csr5_spmm_cuda` stream the packed plane whenever the matrix has
one (sigma % 16 == 0 and pmax <= 512); the raw plane is then not read.
Each of the four kernels has its own launch counter.

K2 (``csrc/csr5_spmm.cu``) is the same kernel at R > 1
(``_csr5_spmm_pallas_jit``, ``csr5_spmm_pallas``): each tile's column and
value planes are read once per chunk of up to 16 right-hand sides, and the
partial sums go into a zeroed Y. Both layouts of the JAX API are taken,
``"nr"`` (X (n, R), Y (m, R)) and ``"rn"`` (X^T (R, n), Y^T (R, m)),
through strides: X is never copied except to fold alpha in, as the Pallas
wrappers do. A launch reads X in one of two modes (:func:`spmm_mode`):
``"staged"`` copies the X rows of each tile's pages into shared memory
once per chunk (packed launches and ``pages_contig`` matrices, when the
window fits :data:`SPMM_SMEM_BUDGET`), ``"gathered"`` reads each
nonzero's X row from global memory.

The wrappers check device, dtypes, shapes and contiguity and raise on
anything the kernels do not take. They never fall back to the plain
versions (:func:`..ops.csr5_spmv.csr5_spmv_torch`,
:func:`..ops.csr5_spmv.csr5_spmm_torch`).
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

#: K1 launches so far in this process (the wrapper adds one per launch)
launches = 0
#: K1p launches so far in this process
packed_launches = 0
#: K2 launches so far in this process
spmm_launches = 0
#: K2p launches so far in this process
spmm_packed_launches = 0
#: the largest page list the packed codes can address (9 bits)
MAX_PACKED_PAGES = 512

#: K2's right-hand sides per chunk: at most 16 accumulators per thread
SPMM_MAX_CHUNK = 16
#: K2's shared-memory budget per block when it picks the chunk: 64 KB
#: keeps three blocks on an SM; a chunk of 1 may use all a block can have
SPMM_SMEM_BUDGET = 64 * 1024
#: the most shared memory one block can have on Hopper
SMEM_MAX = 232_448
#: room kept in a block's shared memory for a kernel's static arrays (K2:
#: 16 B, K4: 48 B); the rest is dynamic
STATIC_SMEM = 64
_INT32_MAX = 2**31 - 1

_bound = None
_bound_spmm = None


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
        for fn in (lib.csr5_spmv_packed_f32, lib.csr5_spmv_packed_bf16):
            # colp, val, win_map, tile_ptr, pages, x, y, p, sigma, capw,
            # win_rel, pmax, stream
            fn.argtypes = [ptr] * 7 + [i32] * 5 + [ptr]
            fn.restype = i32
        lib.csr5_cuda_error_string.argtypes = [i32]
        lib.csr5_cuda_error_string.restype = ctypes.c_char_p
        _bound = lib
    return _bound


def _lib_spmm() -> ctypes.CDLL:
    """The built K2 library with its C signatures declared."""
    global _bound_spmm
    if _bound_spmm is None:
        lib = cuda_build.load("csr5_spmm")
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        for fn in (lib.csr5_spmm_f32, lib.csr5_spmm_bf16):
            # col, val, win_map, tile_ptr, pages, pmax, packed, staged, x, y,
            # p, sigma, capw, win_rel, nends, m, n, R, xs_c, xs_r, ys_row,
            # ys_r, rc, vec, stream
            fn.argtypes = [ptr] * 5 + [i32] * 3 + [ptr] * 2 + [i32] * 8 + [i64] * 4 + [i32] * 2 + [ptr]
            fn.restype = i32
        lib.csr5_spmm_error_string.argtypes = [i32]
        lib.csr5_spmm_error_string.restype = ctypes.c_char_p
        _bound_spmm = lib
    return _bound_spmm


def _expect(t: torch.Tensor, name: str, dtype, shape, device, who="csr5_spmv_cuda") -> None:
    if t is None:
        raise ValueError(f"{who}: {name} is missing")
    if t.device != device:
        raise ValueError(f"{who}: {name} is on {t.device}, x on {device}")
    if t.dtype not in dtype:
        raise ValueError(f"{who}: {name} has dtype {t.dtype}, wants {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{who}: {name} has shape {tuple(t.shape)}, wants {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{who}: {name} is not contiguous")


def _expect_planes(a5: CSR5Matrix, device, who: str) -> None:
    """The planes the kernels read, checked; the column plane is
    ``col_packed`` with its ``pages`` when the matrix has one, else
    ``col_idx_tiles``. Raises where an index would pass int32."""
    p, sig, capw = a5.num_tiles, a5.sigma, a5.capw
    if p * sig * LANES > _INT32_MAX or a5.m_pad > _INT32_MAX:
        raise ValueError(
            f"{who}: p * sigma * 128 = {p * sig * LANES} and m_pad = {a5.m_pad} must stay "
            "below 2**31 (int32 tile positions and rows): slice the matrix "
            "(ops/bigslice.py)"
        )
    if a5.col_packed is not None:
        if sig % 16 or a5.pmax > MAX_PACKED_PAGES:
            raise ValueError(
                f"{who}: col_packed with sigma={sig}, pmax={a5.pmax}; the packed kernels "
                f"take sigma % 16 == 0 and pmax <= {MAX_PACKED_PAGES}"
            )
        _expect(a5.col_packed, "col_packed", (torch.int32,), (p, sig // 2, LANES), device, who)
        _expect(a5.pages, "pages", (torch.int32,), (p, a5.pmax), device, who)
    else:
        _expect(a5.col_idx_tiles, "col_idx_tiles", (torch.int32,), (p, sig, LANES), device, who)
    _expect(
        a5.val_tiles, "val_tiles", (torch.float32, torch.bfloat16), (p, sig, LANES), device, who
    )
    _expect(a5.win_map, "win_map", (torch.int32,), (p, capw), device, who)
    _expect(a5.tile_ptr, "tile_ptr", (torch.int32,), (p + 1,), device, who)


def csr5_spmv_cuda(a5: CSR5Matrix, x: torch.Tensor, alpha=1.0) -> torch.Tensor:
    """y = alpha * A @ x through K1p when the matrix has ``col_packed``,
    else K1 (CUDA tensors only)."""
    global launches, packed_launches
    if not x.is_cuda:
        raise ValueError(
            "csr5_spmv_cuda takes CUDA tensors; CPU tensors go through "
            "csr5_spmv_torch"
        )
    if x.dtype != torch.float32:
        raise ValueError(
            f"csr5_spmv_cuda: x dtype {x.dtype}; K1 takes float32 (float64 on a "
            "float64 plane runs on K4, csr5_spmv_f64_cuda)"
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
    _expect_planes(a5, dev, "csr5_spmv_cuda")

    lib = _lib()
    bf16 = a5.val_tiles.dtype == torch.bfloat16
    packed = a5.col_packed is not None
    xa = x if alpha == 1.0 else x * alpha
    y = torch.zeros(a5.m_pad, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if packed:
            fn = lib.csr5_spmv_packed_bf16 if bf16 else lib.csr5_spmv_packed_f32
            rc = fn(
                a5.col_packed.data_ptr(), a5.val_tiles.data_ptr(), a5.win_map.data_ptr(),
                a5.tile_ptr.data_ptr(), a5.pages.data_ptr(), xa.data_ptr(), y.data_ptr(),
                p, sig, capw, int(a5.win_rel), a5.pmax, stream,
            )
        else:
            fn = lib.csr5_spmv_bf16 if bf16 else lib.csr5_spmv_f32
            rc = fn(
                a5.col_idx_tiles.data_ptr(), a5.val_tiles.data_ptr(), a5.win_map.data_ptr(),
                a5.tile_ptr.data_ptr(), xa.data_ptr(), y.data_ptr(),
                p, sig, capw, int(a5.win_rel), stream,
            )
    if rc != 0:
        msg = lib.csr5_cuda_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"csr5_spmv_cuda: kernel launch failed: {msg} ({rc})")
    if packed:
        packed_launches += 1
    else:
        launches += 1
    return y[: a5.m]


def row_end_bytes(sigma: int) -> int:
    """Bytes of the row-end planes of a (sigma, 128) tile
    (``csrc/csr5_rowends.cuh``): per lane and 32-bit word of sigma, a
    uint32 mask and a uint16 count."""
    return -(-sigma // 32) * LANES * 6


def spmm_window_stride(rc: int) -> int:
    """Floats per slot of K2's row-end sums and lane carries
    (``csrc/csr5_spmm.cu::win_stride``): rc, padded at rc >= 8 to rc + 4
    so the slot stride is an odd number of 16 B units (the float4 accesses
    of slots that differ mod 8 fall on distinct banks)."""
    return rc + 4 if rc >= 8 else rc


def spmm_plane_floats(pages: int) -> int:
    """Floats per rhs plane of K2's staged X window of ``pages`` pages
    (``csrc/csr5_spmm.cu::plane_floats``): 128 slots a page and a float of
    pad after every 32."""
    return pages * (LANES + 4)


def spmm_smem_bytes(
    sigma: int, nends: int, rc: int, packed: bool = False, window_pages: int = 0
) -> int:
    """K2's shared memory per block (``csrc/csr5_spmm.cu::smem_bytes``):
    the staged X window (rc planes of :func:`spmm_plane_floats`
    (``window_pages``) float32s; 0 pages when gathered), the row-end sums
    (nends slots) and lane carries (128 slots) of
    :func:`spmm_window_stride` float32s, the warp totals (4, rc) and the
    row-end planes; K2p adds the high codes of the (sigma/2, 128) packed
    words (uint16)."""
    stride = spmm_window_stride(rc)
    b = spmm_plane_floats(window_pages) * rc * 4
    b += (nends * stride + LANES * stride + 4 * rc) * 4 + row_end_bytes(sigma)
    if packed:
        b += (sigma // 2) * LANES * 2
    return b


def spmm_chunk(a5: CSR5Matrix, num_rhs: int) -> int:
    """K2's right-hand sides per chunk for ``a5`` and ``num_rhs``: the
    power of two that covers min(R, 16), halved until the block's shared
    memory without a window fits :data:`SPMM_SMEM_BUDGET`; 1 when only a
    single rhs fits the whole of a block's shared memory; 0 when not even
    that fits."""
    if num_rhs < 1:
        return 0
    nends = min(a5.capw, a5.sigma * LANES)
    packed = a5.col_packed is not None
    rc = 1
    while rc < min(num_rhs, SPMM_MAX_CHUNK):
        rc *= 2
    while rc > 1 and spmm_smem_bytes(a5.sigma, nends, rc, packed) > SPMM_SMEM_BUDGET:
        rc //= 2
    return rc if spmm_smem_bytes(a5.sigma, nends, rc, packed) <= SMEM_MAX - STATIC_SMEM else 0


def spmm_mode(a5: CSR5Matrix, num_rhs: int) -> str:
    """How K2/K2p reads X for ``a5`` and ``num_rhs``: ``"staged"`` (each
    tile's pages of X copied into shared memory once per chunk) when the
    launch is packed or the pages are contiguous (``pages_contig``) and the
    window of ``pmax`` pages fits :data:`SPMM_SMEM_BUDGET` at the chunk of
    :func:`spmm_chunk`; else ``"gathered"`` (raw columns on a page list,
    or a window too large). Both are the hand-written kernel."""
    rc = spmm_chunk(a5, num_rhs)
    packed = a5.col_packed is not None
    if rc and (packed or a5.pages_contig):
        need = spmm_smem_bytes(a5.sigma, min(a5.capw, a5.sigma * LANES), rc, packed, a5.pmax)
        if need <= SPMM_SMEM_BUDGET:
            return "staged"
    return "gathered"


def spmm_supported(a5: CSR5Matrix, num_rhs: int) -> bool:
    """True when K2 takes ``a5`` with ``num_rhs`` right-hand sides (the
    counterpart of ``pallas_spmm_supported``): omega = 128, R >= 1, the
    row-end counts fit uint16 (sigma * 128 < 65536), the shared memory of
    one block fits at a chunk of 1, and (n, R), (m, R) fit int32 indices."""
    if a5.omega != LANES or num_rhs < 1 or a5.sigma * LANES >= 65536:
        return False
    if max(a5.m_pad, a5.n) * num_rhs > _INT32_MAX:
        return False
    return spmm_chunk(a5, num_rhs) > 0


def csr5_spmm_cuda(
    a5: CSR5Matrix, x: torch.Tensor, alpha=1.0, layout: str = "nr"
) -> torch.Tensor:
    """Y = alpha * A @ X through K2p when the matrix has ``col_packed``,
    else K2 (CUDA tensors only). ``layout="nr"``: X (n, R) in, Y (m, R)
    out; ``layout="rn"``: X^T (R, n) in, Y^T (R, m) out (the JAX
    ``csr5_spmm_pallas`` layouts)."""
    global spmm_launches, spmm_packed_launches
    who = "csr5_spmm_cuda"
    if not x.is_cuda:
        raise ValueError(f"{who} takes CUDA tensors; CPU tensors go through csr5_spmm_torch")
    if layout not in ("nr", "rn"):
        raise ValueError(f"{who}: unknown layout {layout!r} (nr|rn)")
    if x.dtype != torch.float32:
        raise ValueError(
            f"{who}: x dtype {x.dtype}; K2 takes float32 (no float64 SpMM exists, "
            "in the JAX package or the reference)"
        )
    if x.dim() != 2:
        raise ValueError(f"{who}: X must be 2-D, got shape {tuple(x.shape)}")
    rn = layout == "rn"
    R = x.shape[0] if rn else x.shape[1]
    m, n = a5.m, a5.n
    if n < 1:
        raise ValueError(f"{who}: the matrix has no columns")
    if not spmm_supported(a5, R):
        raise ValueError(
            f"{who}: sigma={a5.sigma}, capw={a5.capw}, omega={a5.omega}, R={R} exceed "
            "the kernel's limits (omega 128, R >= 1, sigma * 128 < 65536, one block's "
            "shared memory at a chunk of 1)"
        )
    dev = x.device
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"{who}: x is on {dev}; launch under torch.cuda.device({dev})")
    _expect(x, "X", (torch.float32,), (R, n) if rn else (n, R), dev, who)
    _expect_planes(a5, dev, who)
    packed = a5.col_packed is not None
    staged = spmm_mode(a5, R) == "staged"
    if staged and not packed:
        _expect(a5.pages, "pages", (torch.int32,), (a5.num_tiles, a5.pmax), dev, who)

    lib = _lib_spmm()
    fn = lib.csr5_spmm_bf16 if a5.val_tiles.dtype == torch.bfloat16 else lib.csr5_spmm_f32
    xa = x if alpha == 1.0 else x * alpha
    y = torch.zeros((R, m) if rn else (m, R), dtype=torch.float32, device=dev)
    xs_c, xs_r = (1, n) if rn else (R, 1)
    ys_row, ys_r = (1, m) if rn else (R, 1)
    vec = int(not rn and R % 4 == 0 and xa.data_ptr() % 16 == 0)
    rc = spmm_chunk(a5, R)
    uses_pages = packed or staged
    rcode = fn(
        (a5.col_packed if packed else a5.col_idx_tiles).data_ptr(),
        a5.val_tiles.data_ptr(),
        a5.win_map.data_ptr(),
        a5.tile_ptr.data_ptr(),
        a5.pages.data_ptr() if uses_pages else 0,
        a5.pmax if uses_pages else 0,
        int(packed),
        int(staged),
        xa.data_ptr(),
        y.data_ptr(),
        a5.num_tiles,
        a5.sigma,
        a5.capw,
        int(a5.win_rel),
        min(a5.capw, a5.sigma * LANES),
        m,
        n,
        R,
        xs_c,
        xs_r,
        ys_row,
        ys_r,
        rc,
        vec,
        cuda_build.stream_handle(dev),
    )
    if rcode != 0:
        msg = lib.csr5_spmm_error_string(rcode).decode(errors="replace")
        raise RuntimeError(f"{who}: kernel launch failed: {msg} ({rcode})")
    if a5.num_tiles > 0:
        if packed:
            spmm_packed_launches += 1
        else:
            spmm_launches += 1
    return y
