"""ctypes bindings for the native host library (native/csr5_native.cpp).

A copy of the conversion entry points of
``benchmark_spmv_using_csr5_tpu/utils/nativelib.py``: the JAX package
cannot be imported without jax and flax, which the port does not depend
on. It loads the same ``native/libcsr5native.so``, built from the same
``native/`` sources with ``make -C native`` the first time it is needed.

Every entry point returns None when the library is unavailable, and the
conversion then takes its numpy fallback: these are host preprocessing
stages, not the device path.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

from .hostmem import arena_take, prefaulted


def _out_buf(shape, dtype, arena: Optional[str], zero: bool = True):
    """Output buffer: arena-backed (reused, deterministic speed) when the
    caller passes an arena tag, else a fresh prefaulted allocation. Arena
    callers must copy the result out before their next same-tag call."""
    if arena is not None:
        return arena_take(shape, dtype, arena, zero=zero)
    return prefaulted(shape, dtype)


_REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
_NATIVE_DIR = os.path.join(_REPO_ROOT, "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libcsr5native.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def _needs_build() -> bool:
    """True when the .so is missing or older than any native source file
    (a stale prebuilt library would silently serve outdated results)."""
    if not os.path.exists(_LIB_PATH):
        return True
    so_mtime = os.path.getmtime(_LIB_PATH)
    for fn in os.listdir(_NATIVE_DIR):
        if fn.endswith((".cpp", ".cc", ".h")):
            if os.path.getmtime(os.path.join(_NATIVE_DIR, fn)) > so_mtime:
                return True
    return False


def _try_load() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _build_failed:
            return None
        if _needs_build():
            if not os.path.exists(os.path.join(_NATIVE_DIR, "Makefile")):
                _build_failed = True
                return None
            try:
                subprocess.run(
                    ["make", "-C", _NATIVE_DIR, "-s", "-B"],
                    check=True,
                    capture_output=True,
                    timeout=120,
                )
            except (OSError, subprocess.SubprocessError):
                if not os.path.exists(_LIB_PATH):
                    _build_failed = True
                    return None
                # no toolchain but a prebuilt .so exists: use it as-is
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError:
            _build_failed = True
            return None

        try:
            lib.mm_write_csr.restype = ctypes.c_int32
            lib.csr5_page_stats.restype = None
            lib.csr5_page_lists.restype = None
            lib.csr5_col_local.restype = None
            lib.csr5_tile_transpose.restype = ctypes.c_int32
            lib.csr5_pack_col16.restype = None
            lib.csr5_descriptor.restype = None
            lib.csr5_empty_offsets.restype = None
            lib.dia_plan.restype = ctypes.c_int64
            lib.dia_fill.restype = None
            lib.bandblock_fill.restype = None
        except AttributeError:
            # a symbol is missing (stale .so without a toolchain to
            # rebuild): treat the library as unavailable so every caller
            # takes its pure-numpy fallback instead of raising mid-call
            _build_failed = True
            return None
        _lib = lib
        return _lib


def page_plan(col_flat: np.ndarray, p: int, tile_nnz: int, n_pages: int):
    """Per-tile x-page stats (+ lists builder closure) for the conversion.

    Returns (page_lo, page_cnt, span_max, cnt_max, make_lists) or None
    when the native library is unavailable. ``make_lists(pmax, sentinel)``
    fills the (p, pmax) sorted distinct-page lists.
    """
    lib = _try_load()
    if lib is None:
        return None
    col_flat = np.ascontiguousarray(col_flat, np.int32)
    page_lo = prefaulted(p, np.int32)
    page_cnt = prefaulted(p, np.int32)
    span_max = ctypes.c_int32()
    cnt_max = ctypes.c_int32()
    lib.csr5_page_stats(
        ctypes.c_int64(p),
        ctypes.c_int64(tile_nnz),
        col_flat.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int64(n_pages),
        page_lo.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        page_cnt.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.byref(span_max),
        ctypes.byref(cnt_max),
    )

    def make_lists(pmax: int, sentinel: int, arena: Optional[str] = None) -> np.ndarray:
        pages = _out_buf((p, pmax), np.int32, arena)
        lib.csr5_page_lists(
            ctypes.c_int64(p),
            ctypes.c_int64(tile_nnz),
            col_flat.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            ctypes.c_int64(n_pages),
            ctypes.c_int64(pmax),
            ctypes.c_int32(sentinel),
            pages.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
        return pages

    return page_lo, page_cnt, int(span_max.value), int(cnt_max.value), make_lists


def col_local_packed(
    col_flat: np.ndarray, p: int, tile_nnz: int, n_pages: int,
    arena: Optional[str] = None,
) -> Optional[np.ndarray]:
    """Per-element ``lane | local_page<<7`` uint16 plane (list gather mode).

    ``local_page`` is the rank of the element's page in its tile's sorted
    distinct-page list (valid while pmax <= 512). None if the lib is
    missing.
    """
    lib = _try_load()
    if lib is None:
        return None
    col_flat = np.ascontiguousarray(col_flat, np.int32)
    out = _out_buf(p * tile_nnz, np.uint16, arena)
    lib.csr5_col_local(
        ctypes.c_int64(p),
        ctypes.c_int64(tile_nnz),
        col_flat.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int64(n_pages),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
    )
    return out


def write_matrix_market(
    path: str,
    row_ptr: np.ndarray,
    col_idx: np.ndarray,
    values: np.ndarray,
    shape,
) -> bool:
    """CSR -> coordinate-real-general .mtx via the native writer.

    Returns False when the native library is unavailable (callers fall
    back to utils.mmio.write_mtx); raises OSError on write failure.
    """
    lib = _try_load()
    if lib is None:
        return False
    m, n = shape
    row_ptr = np.ascontiguousarray(row_ptr, np.int64)
    col_idx = np.ascontiguousarray(col_idx, np.int32)
    values = np.ascontiguousarray(values, np.float64)
    rc = lib.mm_write_csr(
        os.fspath(path).encode(),
        ctypes.c_int64(m),
        ctypes.c_int64(n),
        ctypes.c_int64(len(values)),
        row_ptr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        col_idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        values.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    if rc != 0:
        raise OSError(f"mm_write_csr({path}) failed")
    return True


def descriptor(
    row_ptr: np.ndarray, p: int, sigma: int, omega: int
) -> Optional[tuple]:
    """Native CSR5 partition descriptor (format_cuda.h:129-267 parity):
    (bit_flag (p,nw,omega) u32, y_offset, seg_offset (p,omega) i32,
    nseg (p,) i64), or None when the library is unavailable."""
    lib = _try_load()
    if lib is None:
        return None
    m = row_ptr.shape[0] - 1
    row_ptr = np.ascontiguousarray(row_ptr, np.int64)
    nwords = (sigma + 31) // 32
    bit_flag = prefaulted((p, nwords, omega), np.uint32)
    y_offset = prefaulted((p, omega), np.int32)
    seg_offset = prefaulted((p, omega), np.int32)
    nseg = prefaulted(p, np.int64)
    lib.csr5_descriptor(
        ctypes.c_int64(m),
        ctypes.c_int64(p),
        ctypes.c_int64(sigma),
        ctypes.c_int64(omega),
        row_ptr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        bit_flag.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        y_offset.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        seg_offset.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        nseg.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    return bit_flag, y_offset, seg_offset, nseg


def empty_offsets(
    row_ptr: np.ndarray,
    tile_ptr: np.ndarray,
    dirty: np.ndarray,
    nseg: np.ndarray,
    p: int,
    tile_nnz: int,
) -> Optional[tuple]:
    """Native empty-row indirection table (format_cuda.h:362-523 parity):
    (eo_ptr (p+1,) i32, eo (total,) i32), or None when unavailable."""
    lib = _try_load()
    if lib is None:
        return None
    m = row_ptr.shape[0] - 1
    row_ptr = np.ascontiguousarray(row_ptr, np.int64)
    tile_ptr = np.ascontiguousarray(tile_ptr, np.int32)
    dirty8 = np.ascontiguousarray(dirty, np.uint8)
    counts = np.where(dirty, nseg, 0).astype(np.int64)
    eo_ptr = np.zeros(p + 1, dtype=np.int64)
    np.cumsum(counts, out=eo_ptr[1:])
    total = int(eo_ptr[-1])
    eo = prefaulted(total, np.int32)
    if total:
        lib.csr5_empty_offsets(
            ctypes.c_int64(m),
            ctypes.c_int64(p),
            ctypes.c_int64(tile_nnz),
            row_ptr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            tile_ptr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            dirty8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            eo_ptr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            eo.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
    return eo_ptr.astype(np.int32), eo


def tile_transpose(
    flat: np.ndarray, p: int, sigma: int, omega: int,
    arena: Optional[str] = None,
) -> Optional[np.ndarray]:
    """AoS->SoA tile transpose on host: flat ``(p*omega*sigma,)`` element-
    order array -> ``(p, sigma, omega)`` (format_cuda.h:525-744 parity).

    Returns None when the native library is unavailable or the dtype
    width is unsupported; callers then transpose with torch.
    """
    lib = _try_load()
    if lib is None:
        return None
    esize = flat.dtype.itemsize
    if esize not in (2, 4, 8):
        return None
    flat = np.ascontiguousarray(flat)
    out = _out_buf((p, sigma, omega), flat.dtype, arena, zero=False)
    rc = lib.csr5_tile_transpose(
        ctypes.c_int64(p),
        ctypes.c_int64(omega),
        ctypes.c_int64(sigma),
        ctypes.c_int64(esize),
        flat.ctypes.data_as(ctypes.c_void_p),
        out.ctypes.data_as(ctypes.c_void_p),
    )
    return out if rc == 0 else None


def pack_col16(
    col16: np.ndarray, p: int, sigma: int, omega: int,
    arena: Optional[str] = None,
) -> Optional[np.ndarray]:
    """uint16 lane|local codes (flat element order) -> packed int32
    ``(p, sigma/2, omega)`` plane pairing sigma-rows (s, s + sigma/2).

    None when the native library is unavailable (callers then combine
    the pairs with torch).
    """
    lib = _try_load()
    if lib is None:
        return None
    col16 = np.ascontiguousarray(col16, np.uint16)
    out = _out_buf((p, sigma // 2, omega), np.int32, arena, zero=False)
    lib.csr5_pack_col16(
        ctypes.c_int64(p),
        ctypes.c_int64(omega),
        ctypes.c_int64(sigma),
        col16.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return out


def bandblock_fill(
    row_ptr: np.ndarray,
    col_idx: np.ndarray,
    values: np.ndarray,
    c0_pages: np.ndarray,
    m: int,
    m_pad: int,
    K: int,
    arena: Optional[str] = None,
) -> Optional[np.ndarray]:
    """Zero + scatter-fill the (m_pad, K) float32 dense band-block plane
    (ops/bandmm.py); None when the native library is unavailable."""
    lib = _try_load()
    if lib is None:
        return None
    row_ptr = np.ascontiguousarray(row_ptr, np.int64)
    col_idx = np.ascontiguousarray(col_idx, np.int32)
    c0_pages = np.ascontiguousarray(c0_pages, np.int32)
    dense = _out_buf((m_pad, K), np.float32, arena, zero=False)
    if values.dtype == np.float32:
        v32 = np.ascontiguousarray(values, np.float32)
        v64p, v32p = None, v32.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    else:
        v64 = np.ascontiguousarray(values, np.float64)
        v64p = v64.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
        v32p = None
    lib.bandblock_fill(
        ctypes.c_int64(m),
        ctypes.c_int64(m_pad),
        ctypes.c_int64(K),
        row_ptr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        col_idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        v64p,
        v32p,
        c0_pages.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        dense.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return dense


def dia_plan(
    row_ptr: np.ndarray, col_idx: np.ndarray, m: int, n: int, cap: int
):
    """Distinct diagonal offsets (ascending int64 array), -1 when more
    than ``cap`` exist (the max_diags gate — bails early), or None when
    the native library is unavailable (callers take the numpy route)."""
    lib = _try_load()
    if lib is None:
        return None
    row_ptr = np.ascontiguousarray(row_ptr, np.int64)
    col_idx = np.ascontiguousarray(col_idx, np.int32)
    marks = prefaulted(m + n - 1, np.uint8)  # zeroed
    uniq = prefaulted(max(cap, 1), np.int64)
    cnt = lib.dia_plan(
        ctypes.c_int64(m),
        ctypes.c_int64(n),
        row_ptr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        col_idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        marks.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        uniq.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(cap),
    )
    if cnt < 0:
        return -1
    return uniq[:cnt].copy()


def dia_fill(
    row_ptr: np.ndarray,
    col_idx: np.ndarray,
    values: np.ndarray,
    uniq: np.ndarray,
    m: int,
    n: int,
    m_pad: int,
    arena: Optional[str] = None,
) -> Optional[np.ndarray]:
    """Zero + scatter-fill the interleaved (m_pad/128, nd, 128) f32 DIA
    plane, summing duplicates; None when the lib is unavailable."""
    lib = _try_load()
    if lib is None:
        return None
    nd = len(uniq)
    row_ptr = np.ascontiguousarray(row_ptr, np.int64)
    col_idx = np.ascontiguousarray(col_idx, np.int32)
    diag_index = prefaulted(m + n - 1, np.int32)
    diag_index[np.asarray(uniq, np.int64) + (m - 1)] = np.arange(
        nd, dtype=np.int32
    )
    data = _out_buf((m_pad // 128, nd, 128), np.float32, arena, zero=False)
    if values.dtype == np.float32:
        v32 = np.ascontiguousarray(values, np.float32)
        v64p, v32p = None, v32.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    else:
        v64 = np.ascontiguousarray(values, np.float64)
        v64p = v64.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
        v32p = None
    lib.dia_fill(
        ctypes.c_int64(m),
        ctypes.c_int64(m_pad),
        ctypes.c_int64(nd),
        row_ptr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        col_idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        v64p,
        v32p,
        diag_index.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return data
