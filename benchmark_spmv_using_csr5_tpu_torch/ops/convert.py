"""CSR <-> CSR5 conversion (the asCSR5 / asCSR analogue).

The counterpart of ``benchmark_spmv_using_csr5_tpu/ops/convert.py``. The
host stages (``convert.py:246-520``: partition pointer, dirty bits,
descriptor, empty-row offsets, page plan, packed column codes, window
maps, tile transpose) are the JAX package's numpy and native code,
copied as they are, so every plane matches the JAX one element for
element. What differs is the value dtype and the upload:

- the raw int32 column plane is always kept (the JAX package's
  ``keep_raw_cols=True``): the port's kernel streams raw columns;
- float64 values narrow to float32 unless ``value_dtype=torch.float64``
  keeps the float64 plane that kernel K4 streams (the JAX x64 plane; its
  float32 rounding is the JAX df64 hi plane);
- ``value_dtype="auto"`` stores bfloat16 only when every value survives
  float32 -> bfloat16 -> float32 unchanged (results are then identical to
  float32 storage);
- every plane is copied onto ``device``: the host planes live in the
  reused arena of :mod:`..utils.hostmem`;
- :func:`build_csr5_autotuned` decides its sigma from the host plan, so
  a re-tune transposes and uploads once.
"""

from __future__ import annotations

import time
from types import SimpleNamespace
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import AUTO_TUNED_SIGMA, DEFAULT_DEVICE, CSR5Config, compute_sigma, resolve_device
from ..models.formats import CSR5Matrix, CSRMatrix, col_tiles_of
from ..utils import nativelib, progress
from ..utils.hostmem import arena_take

#: columns per x-page of the JAX package's gather plan
PAGE_COLS = 128
#: max page span for the JAX kernel's contiguous-slab gather mode
CONTIG_PAGE_CAP = 8

#: phase timings (ms) of the most recent build_csr5 call -- the
#: malloc/tile_ptr/tile_desc/transpose breakdown the reference prints
#: (anonymouslib_cuda.h:211-214), plus plan and upload
last_convert_phases: dict = {}


def _pow2_at_least(x: int, lo: int) -> int:
    v = lo
    while v < x:
        v *= 2
    return v


def _descriptor(
    heads: np.ndarray, p: int, sigma: int, omega: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """bit_flag words + y_offset + seg_offset + per-tile segment counts.

    heads: (p*sigma*omega,) bool, True where a nonzero begins a row, with
    the tile-leading bit forced (format_cuda.h:161-267 semantics).
    Element (t, s, l) = flat t*T + l*sigma + s, so reshape to (p, omega,
    sigma): lane-major element order.
    """
    fl = heads.reshape(p, omega, sigma)
    # pack along sigma into ceil(sigma/32) uint32 words per lane
    nwords = (sigma + 31) // 32
    pad = nwords * 32 - sigma
    bits = np.ascontiguousarray(np.pad(fl, ((0, 0), (0, 0), (0, pad))))
    words = np.packbits(bits, axis=-1, bitorder="little")  # (p,om,nwords*4) u8
    words = words.view(np.uint32)  # (p, omega, nwords), little-endian host
    bit_flag = words.transpose(0, 2, 1)  # (p, nwords, omega)

    lane_cnt = fl.sum(axis=2, dtype=np.int32)  # (p, omega)
    y_offset = np.zeros_like(lane_cnt)
    np.cumsum(lane_cnt[:, :-1], axis=1, out=y_offset[:, 1:])

    # seg_offset: distance-1 to the next lane (to the right) holding any
    # flag; omega-l-1 if none (scansum semantics, format_cuda.h:200-240)
    has = lane_cnt > 0  # (p, omega)
    nxt = np.full((p, omega + 1), omega, dtype=np.int32)
    for l in range(omega - 1, -1, -1):  # noqa: E741
        nxt[:, l] = np.where(has[:, l], l, nxt[:, l + 1])
    next_flagged = np.minimum(np.roll(nxt[:, :-1], -1, axis=1), omega)
    next_flagged[:, omega - 1] = omega
    seg_offset = np.clip(
        next_flagged - np.arange(omega, dtype=np.int32)[None, :] - 1, 0, omega
    )
    nseg = lane_cnt.sum(axis=1, dtype=np.int64)  # (p,)
    return bit_flag, y_offset.astype(np.int32), seg_offset.astype(np.int32), nseg


def _empty_offsets(
    row_ptr: np.ndarray,
    heads: np.ndarray,
    dirty: np.ndarray,
    tile_ptr: np.ndarray,
    nseg: np.ndarray,
    p: int,
    tile_nnz: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Ragged ordinal->row-offset table for dirty tiles.

    Parity with generate_partition_descriptor_offset_kernel
    (format_cuda.h:362-523): for the k-th segment head of a dirty tile, the
    actual row offset from tile_ptr[t], found by binary search.
    """
    counts = np.where(dirty, nseg, 0).astype(np.int64)
    eo_ptr = np.zeros(p + 1, dtype=np.int64)
    np.cumsum(counts, out=eo_ptr[1:])
    total = int(eo_ptr[-1])
    if total == 0:
        return eo_ptr.astype(np.int32), np.zeros(0, np.int32)
    # heads is in (t, l, s) flat layout = global element order
    head_pos = np.nonzero(heads)[0]
    head_tile = head_pos // tile_nnz
    keep = dirty[head_tile]
    hp = head_pos[keep]
    rows = np.searchsorted(row_ptr, hp, side="right") - 1
    offs = rows - tile_ptr[head_tile[keep]]
    return eo_ptr.astype(np.int32), offs.astype(np.int32)


def _as_host_csr(csr) -> Tuple[np.ndarray, np.ndarray, np.ndarray, Tuple[int, int]]:
    """Extract host (row_ptr, col_idx, values, shape) from a CSRMatrix,
    scipy.sparse matrix, or (row_ptr, col_idx, values, shape) tuple."""
    if isinstance(csr, tuple):
        row_ptr, col_idx, values, shape = csr
    elif hasattr(csr, "indptr"):  # scipy.sparse csr_matrix / csr_array
        row_ptr, col_idx, values, shape = csr.indptr, csr.indices, csr.data, csr.shape
    else:  # the port's CSRMatrix
        row_ptr, col_idx, values = (
            t.cpu().numpy() for t in (csr.row_ptr, csr.col_idx, csr.values)
        )
        shape = csr.shape
    return (
        np.asarray(row_ptr, dtype=np.int64),
        np.ascontiguousarray(col_idx, dtype=np.int32),
        np.asarray(values),
        tuple(shape),
    )


def _bf16_roundtrip_exact(values: np.ndarray) -> bool:
    """True iff every value survives float32 -> bfloat16 -> float32
    unchanged (the JAX package's ``bandmm._bf16_roundtrip_exact`` gate,
    in torch instead of ``ml_dtypes``; both round to nearest even)."""
    if values.shape[0] == 0:
        return True
    v32 = torch.from_numpy(np.asarray(values, np.float32))
    return bool(torch.equal(v32.to(torch.bfloat16).to(torch.float32), v32))


def _upload(arr: np.ndarray, device, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A copy of a host plane on ``device``. Always a copy: the planes live
    in the reused host arena, and a zero-copy ``torch.from_numpy`` view on
    the CPU would be rewritten by the next conversion."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    return t.to(device=device, dtype=dtype, copy=True)


class _Phases:
    """Phase timings (ms) of one conversion, summed by phase name."""

    def __init__(self):
        self.ms: dict = {}
        self._t0 = time.perf_counter()

    def mark(self, name: str) -> None:
        now = time.perf_counter()
        self.ms[name] = self.ms.get(name, 0.0) + (now - self._t0) * 1e3
        self._t0 = now
        progress.emit(f"convert:{name}")


def _config_for(m: int, nnz: int, config: Optional[CSR5Config], sigma: int) -> CSR5Config:
    if config is None:
        return CSR5Config(sigma=compute_sigma(m, nnz, sigma))
    if sigma != AUTO_TUNED_SIGMA and sigma != config.sigma:
        return CSR5Config(omega=config.omega, sigma=sigma, tiles_per_block=config.tiles_per_block)
    return config


def _host_plan(row_ptr, col_idx, values, m: int, n: int, config: CSR5Config, win_mode: str,
               ph: _Phases) -> SimpleNamespace:
    """The host stages of the conversion, before the tile transpose and
    the upload: tile pointers, dirty bits, descriptor, empty-row offsets,
    the JAX gather plan, packed column codes and window maps. The planes
    live in the host arena until the next conversion."""
    nnz = int(values.shape[0])
    omega, sig = config.omega, config.sigma
    T = config.tile_nnz
    p = max(1, -(-nnz // T))  # every tile padded; tail is the last tile
    # pad the tile count to a multiple of the JAX kernel's block size
    # (the quantum shrinks to the next pow2 >= p for small matrices)
    quantum = min(config.tiles_per_block, _pow2_at_least(p, 1))
    p_pad = -(-p // quantum) * quantum
    nnz_pad = p_pad * T

    # nnz-scale scratch comes from the process-lifetime arena
    col_flat = arena_take(nnz_pad, np.int32, "cv:col_flat", zero=False)
    val_flat = arena_take(nnz_pad, values.dtype, "cv:val_flat", zero=False)
    col_flat[:nnz] = col_idx
    val_flat[:nnz] = values
    val_flat[nnz:] = 0
    if nnz:
        # pad columns repeat the last real column (values stay zero), so
        # every column of the plane is a valid x index
        col_flat[nnz:] = col_idx[-1] if len(col_idx) else 0
    else:
        col_flat[:] = 0

    ph.mark("malloc")
    # --- partition pointer + dirty bits (format_cuda.h:21-95) ----------
    bounds = np.arange(p_pad + 1, dtype=np.int64) * T
    tile_ptr = np.clip(np.searchsorted(row_ptr, bounds, side="right") - 1, 0, m)
    empty = arena_take(m, np.int64, "cv:empty", zero=False)
    emp_b = arena_take(m, np.bool_, "cv:emptyb", zero=False)
    np.equal(row_ptr[1:], row_ptr[:-1], out=emp_b)
    # widen bool->int64 before the cumsum (bool cumsum is far slower)
    np.copyto(empty, emp_b, casting="unsafe")
    e_prefix = arena_take(m + 1, np.int64, "cv:eprefix", zero=False)
    e_prefix[0] = 0
    np.cumsum(empty, out=e_prefix[1:])
    start, stop = tile_ptr[:-1], np.minimum(tile_ptr[1:], m - 1)
    dirty = (e_prefix[stop + 1] - e_prefix[np.minimum(start + 1, m)]) > 0
    tail_row_start = int(tile_ptr[p - 1])

    ph.mark("tile_ptr")
    # --- bit flags + descriptor (format_cuda.h:129-267) -----------------
    # element order in a tile is lane-major: flat index t*T + l*sig + s
    nd = nativelib.descriptor(row_ptr, p_pad, sig, omega)
    if nd is not None:
        bit_flag, y_offset, seg_offset, nseg = nd
        eo_ptr, eo = nativelib.empty_offsets(
            row_ptr, tile_ptr[:-1], dirty, nseg, p_pad, T
        )
    else:
        heads = np.zeros(nnz_pad, dtype=bool)
        nonempty = np.diff(row_ptr) > 0
        heads[row_ptr[:-1][nonempty]] = True
        # forced tile-leading bit (format_cuda.h:171-175)
        heads_forced = heads.copy()
        heads_forced[np.arange(p_pad) * T] = True
        bit_flag, y_offset, seg_offset, nseg = _descriptor(
            heads_forced, p_pad, sig, omega
        )
        # --- empty-row indirection (format_cuda.h:269-523) --------------
        eo_ptr, eo = _empty_offsets(
            row_ptr, heads_forced, dirty, tile_ptr[:-1], nseg, p_pad, T
        )

    ph.mark("tile_desc")
    # --- the JAX kernel's gather plan (convert.py:340-449) --------------
    # per-tile distinct x-page lists; dead slots hold the sentinel page
    # n_pad//128. The port's kernel reads x directly, but the planes are
    # kept so the matrix carries across to the JAX package unchanged.
    n_pad = -(-max(n, 1) // PAGE_COLS) * PAGE_COLS
    page_sentinel = n_pad // PAGE_COLS

    plan = nativelib.page_plan(col_flat, p_pad, T, page_sentinel + 1)
    if plan is not None:
        page_lo, page_cnt, span_max, cnt_max, make_lists = plan
        pages_sorted = None
    else:
        pages_sorted = (col_flat >> 7).reshape(p_pad, T)
        pages_sorted.sort(axis=1)
        first = np.ones((p_pad, T), dtype=bool)
        first[:, 1:] = pages_sorted[:, 1:] != pages_sorted[:, :-1]
        page_cnt = first.sum(axis=1, dtype=np.int32)
        page_lo = pages_sorted[:, 0].astype(np.int32)
        span_max = int((pages_sorted[:, -1] - pages_sorted[:, 0]).max()) + 1
        cnt_max = int(page_cnt.max())

    if span_max <= CONTIG_PAGE_CAP and max(span_max, 2) <= page_sentinel + 1:
        # contiguous-pages mode: pages[t] = [lo, lo + pmax)
        pmax = max(span_max, 2)
        lo = np.minimum(page_lo, page_sentinel + 1 - pmax)
        pages = lo[:, None] + np.arange(pmax, dtype=np.int32)[None, :]
        pages_contig = True
    else:
        pmax = max(-(-cnt_max // 8) * 8, 2)
        pages_contig = False
        if plan is not None:
            pages = make_lists(pmax, page_sentinel, arena="cv:pages")
        else:
            pages = np.full((p_pad, pmax), page_sentinel, dtype=np.int32)
            # cast before the cumsum (bool cumsum is far slower)
            pos = np.cumsum(first.astype(np.int32), axis=1, dtype=np.int32) - 1
            tsel, esel = np.nonzero(first)
            pages[tsel, pos[tsel, esel]] = pages_sorted[tsel, esel]

    # --- stream-compressed column plane (JAX kernel; sigma % 16 == 0) ---
    # uint16 code "lane(7b) | local_page(<=9b)" per element, pairs of
    # sigma-rows combined into one int32 word. Valid while pmax <= 512.
    stream_packed = sig % 16 == 0
    col16 = None
    if pmax <= 512 and stream_packed:
        if pages_contig:
            cf2 = col_flat.reshape(p_pad, T)
            t1 = arena_take((p_pad, T), np.int32, "cv:c16a", zero=False)
            t2 = arena_take((p_pad, T), np.int32, "cv:c16b", zero=False)
            np.right_shift(cf2, 7, out=t1)
            np.subtract(t1, lo[:, None], out=t1)  # local page index
            np.left_shift(t1, 7, out=t1)
            np.bitwise_and(cf2, 127, out=t2)
            np.bitwise_or(t1, t2, out=t1)
            col16 = arena_take(nnz_pad, np.uint16, "cv:col16", zero=False)
            np.copyto(col16, t1.reshape(-1), casting="unsafe")
        else:
            col16 = nativelib.col_local_packed(
                col_flat, p_pad, T, page_sentinel + 1, arena="cv:col16"
            )
            if col16 is None:
                # numpy fallback: rank pages within each tile via argsort
                pg2 = (col_flat >> 7).reshape(p_pad, T)
                order = np.argsort(pg2, axis=1, kind="stable")
                ps = np.take_along_axis(pg2, order, axis=1)
                fst = np.ones_like(ps, dtype=bool)
                fst[:, 1:] = ps[:, 1:] != ps[:, :-1]
                loc_sorted = np.cumsum(fst.astype(np.int32), axis=1) - 1
                local = np.empty_like(loc_sorted)
                np.put_along_axis(local, order, loc_sorted, axis=1)
                cf2 = col_flat.reshape(p_pad, T)
                col16 = ((cf2 & 127) | (local << 7)).astype(np.uint16).reshape(-1)

    # monotone row-end window maps: win_end[t,d] = in-tile position of the
    # last element of the row at window slot d:
    # clip(row_ptr[min(row0+d+1, m)]-1 - t*T, 0, T-1). Monotone with
    # repeats => empty rows and beyond-span slots produce zero diffs.
    # - wrapped (``win_rel``, the default): capw = ceil((span_max+1)/128)
    #   *128 slots. Slot d maps to row base+d for d >= rs%128 and WRAPS
    #   to row base+capw+d for d < rs%128 (base = rs rounded down to 128).
    # - aligned: slot d = row base+d; slots d < rs-base are masked.
    span = tile_ptr[1:] - tile_ptr[:-1]  # rows spanned (excl. carry row)
    win_rel = win_mode != "aligned"
    rs = tile_ptr[:-1][:, None]  # (p,1)
    if win_rel:
        capw = -(-(int(span.max()) + 1) // 128) * 128
        off = rs & 127
        d = np.arange(capw)[None, :]
        ridx = arena_take((p_pad, capw), np.int64, "cv:ridx", zero=False)
        np.add(rs - off, d + 1, out=ridx)
        wmask = arena_take((p_pad, capw), np.bool_, "cv:wmask", zero=False)
        np.less(d, off, out=wmask)
        np.add(ridx, capw, out=ridx, where=wmask)
        np.minimum(ridx, m, out=ridx)
    else:
        capw = _pow2_at_least(int(span.max()) + 1 + 128, 128)
        d = np.arange(capw)[None, :]
        ridx = arena_take((p_pad, capw), np.int64, "cv:ridx", zero=False)
        np.add((rs // 128) * 128, d + 1, out=ridx)
        np.minimum(ridx, m, out=ridx)
    wq = arena_take((p_pad, capw), np.int64, "cv:wq", zero=False)
    np.take(row_ptr, ridx, out=wq)
    np.subtract(wq, 1, out=wq)
    np.subtract(wq, (np.arange(p_pad, dtype=np.int64) * T)[:, None], out=wq)
    np.clip(wq, 0, T - 1, out=wq)
    np.floor_divide(wq, sig, out=ridx)  # ridx reused as the slot-row plane
    np.left_shift(ridx, 16, out=ridx)
    np.remainder(wq, sig, out=wq)
    np.bitwise_or(wq, ridx, out=wq)
    win_map = arena_take((p_pad, capw), np.int32, "cv:winmap", zero=False)
    np.copyto(win_map, wq, casting="unsafe")
    # flag bits next to sub|lane<<16 (bits 0-9 sub, 16-22 lane): bit 23 =
    # this slot is the tile's FIRST row (d == rs%128), bit 24 =
    # d >= rs%128. Set for both anchorings; readers mask the lane with
    # (wm >> 16) & 127.
    off_all = rs & 127
    fmask = arena_take((p_pad, capw), np.bool_, "cv:wmask", zero=False)
    np.greater_equal(d, off_all, out=fmask)
    np.add(win_map, 1 << 24, out=win_map, where=fmask)
    np.equal(d, off_all, out=fmask)
    np.add(win_map, 1 << 23, out=win_map, where=fmask)

    ph.mark("plan")
    return SimpleNamespace(
        m=m, n=n, nnz=nnz, config=config, p_pad=p_pad, nnz_pad=nnz_pad,
        col_flat=col_flat, val_flat=val_flat, row_ptr=row_ptr, tile_ptr=tile_ptr,
        dirty=dirty, tail_row_start=tail_row_start, bit_flag=bit_flag,
        y_offset=y_offset, seg_offset=seg_offset, eo_ptr=eo_ptr, eo=eo,
        pages=pages, page_cnt=page_cnt, pages_contig=pages_contig, pmax=pmax,
        col16=col16, win_map=win_map, win_rel=win_rel, capw=capw, n_pad=n_pad,
    )


def _transpose_upload(hp: SimpleNamespace, values, value_dtype, device, ph: _Phases) -> CSR5Matrix:
    """The AoS->SoA tile transpose of a host plan and the copy of every
    plane onto ``device``; records the phases in
    :data:`last_convert_phases`."""
    p_pad, nnz_pad, sig, omega = hp.p_pad, hp.nnz_pad, hp.config.sigma, hp.config.omega
    col_flat, val_flat, col16 = hp.col_flat, hp.val_flat, hp.col16
    # --- AoS->SoA tile transpose (format_cuda.h:525-744) ----------------
    if value_dtype == "auto":
        value_dtype = (
            torch.bfloat16
            if val_flat.dtype in (np.float32, np.float64)
            and _bf16_roundtrip_exact(values)
            else None
        )
    # numpy has no bfloat16: transpose the float32 plane, cast on upload.
    # float64 stays float64 only when value_dtype asks for it (K4's plane)
    keep64 = value_dtype == torch.float64
    val_host = val_flat
    if (val_flat.dtype == np.float64) != keep64:
        host_dt = np.float64 if keep64 else np.float32
        val_host = arena_take(nnz_pad, host_dt, "cv:valcast", zero=False)
        np.copyto(val_host, val_flat, casting="unsafe")
    vdt = value_dtype if value_dtype is not None else torch.from_numpy(val_host[:0]).dtype

    col_tr = nativelib.tile_transpose(col_flat, p_pad, sig, omega, arena="cv:coltr")
    val_tr = nativelib.tile_transpose(val_host, p_pad, sig, omega, arena="cv:valtr")
    pk_tr = (
        nativelib.pack_col16(col16, p_pad, sig, omega, arena="cv:pktr")
        if col16 is not None
        else None
    )
    ph.mark("transpose")  # host work only; the copies to device time as "upload"

    def _tiles(flat_tr, flat, dtype=None):
        if flat_tr is not None:
            return _upload(flat_tr, device, dtype)
        # no native library: transpose with torch on the host
        t = torch.from_numpy(flat.reshape(p_pad, omega, sig)).transpose(1, 2)
        return t.to(device=device, dtype=dtype, copy=True).contiguous()

    col_tiles = _tiles(col_tr, col_flat)
    val_tiles = _tiles(val_tr, val_host, vdt)
    col_packed = None
    if col16 is not None:
        if pk_tr is not None:
            col_packed = _upload(pk_tr, device)
        else:
            # combine sigma-row pairs (s, s + sigma/2) into int32
            c32 = torch.from_numpy(col16.astype(np.int32).reshape(p_pad, omega, sig))
            s2 = sig // 2
            col_packed = (
                (c32[:, :, :s2] | (c32[:, :, s2:] << 16))
                .transpose(1, 2)
                .to(device=device, copy=True)
                .contiguous()
            )
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    ph.mark("upload")
    up_bytes = sum(
        t.numel() * t.element_size()
        for t in (col_tiles, val_tiles, col_packed)
        if t is not None
    )
    ph.ms["upload_mb"] = up_bytes / 1e6
    if ph.ms.get("upload", 0.0) > 0:
        ph.ms["upload_gbps"] = up_bytes / 1e6 / ph.ms["upload"]
    last_convert_phases.clear()
    last_convert_phases.update(ph.ms)
    i32 = torch.int32
    return CSR5Matrix(
        shape=(hp.m, hp.n),
        config=hp.config,
        num_tiles=p_pad,
        nnz_stored=hp.nnz,
        row_ptr=_upload(hp.row_ptr, device, i32),
        tile_ptr=_upload(hp.tile_ptr, device, i32),
        tile_dirty=_upload(hp.dirty, device),
        y_offset=_upload(hp.y_offset, device, i32),
        seg_offset=_upload(hp.seg_offset, device, i32),
        bit_flag=_upload(hp.bit_flag, device),
        empty_offset_ptr=_upload(hp.eo_ptr, device, i32),
        empty_offset=_upload(hp.eo, device, i32),
        col_idx_tiles=col_tiles,
        val_tiles=val_tiles,
        pages=_upload(hp.pages, device, i32),
        page_cnt=_upload(hp.page_cnt, device, i32),
        win_map=_upload(hp.win_map, device, i32),
        col_packed=col_packed,
        win_rel=hp.win_rel,
        tail_row_start=hp.tail_row_start,
        capw=hp.capw,
        pmax=hp.pmax,
        pages_contig=hp.pages_contig,
        # +128 headroom: wrapped slots write rows up to base+capw+127
        m_pad=-(-(hp.m + hp.capw + 128) // 1024) * 1024,
        n_pad=hp.n_pad,
    )




def build_csr5(
    csr,
    config: Optional[CSR5Config] = None,
    sigma: int = AUTO_TUNED_SIGMA,
    value_dtype=None,
    win_mode: str = "auto",
    device=DEFAULT_DEVICE,
) -> CSR5Matrix:
    """CSR -> CSR5: the asCSR5() analogue (anonymouslib_cuda.h:106-220).

    ``csr`` may be a CSRMatrix, a scipy.sparse CSR matrix, or a host tuple
    ``(row_ptr, col_idx, values, shape)``. ``value_dtype`` is None (the
    input dtype, float64 narrowed to float32), ``torch.float32``,
    ``torch.bfloat16``, ``torch.float64`` (the plane of kernel K4: the
    JAX ``build_csr5`` under x64, ``convert.py:548-553``), or ``"auto"``:
    bfloat16 only when it is lossless. ``win_mode="aligned"`` builds
    128-aligned window maps instead of the wrapped ones. Every plane is
    placed on ``device`` (default: the card).
    """
    device = resolve_device(device, "build_csr5")
    row_ptr, col_idx, values, (m, n) = _as_host_csr(csr)
    config = _config_for(m, int(values.shape[0]), config, sigma)
    ph = _Phases()
    hp = _host_plan(row_ptr, col_idx, values, m, n, config, win_mode, ph)
    return _transpose_upload(hp, values, value_dtype, device, ph)


def build_csr5_autotuned(
    csr,
    config: Optional[CSR5Config] = None,
    value_dtype=None,
    win_mode: str = "auto",
    device=DEFAULT_DEVICE,
) -> CSR5Matrix:
    """CSR -> CSR5 with the JAX package's structure-aware sigma re-tune
    (``convert.py:700-732``): when the heuristic sigma lands in the
    scattered gather tiers (pages not contiguous), sigma 8 (heuristic
    sigma <= 16: short scattered rows) or 16 (longer rows) replaces it.

    Same sigma and planes as the JAX function, which converts and
    uploads twice. Here the regime is read from the host plan's
    ``pages_contig``, before the transpose and the upload, so a re-tune
    plans again but transposes and uploads once.
    """
    device = resolve_device(device, "build_csr5_autotuned")
    row_ptr, col_idx, values, (m, n) = _as_host_csr(csr)
    config = _config_for(m, int(values.shape[0]), config, AUTO_TUNED_SIGMA)
    ph = _Phases()
    hp = _host_plan(row_ptr, col_idx, values, m, n, config, win_mode, ph)
    if not hp.pages_contig:
        target = 8 if config.sigma <= 16 else 16
        if config.sigma != target:
            config = CSR5Config(
                omega=config.omega, sigma=target, tiles_per_block=config.tiles_per_block
            )
            hp = _host_plan(row_ptr, col_idx, values, m, n, config, win_mode, ph)
    return _transpose_upload(hp, values, value_dtype, device, ph)


def csr5_to_csr(a5: CSR5Matrix) -> CSRMatrix:
    """CSR5 -> CSR: the asCSR() analogue (anonymouslib_cuda.h:79-103).

    Inverts the AoS->SoA transpose and drops padding; exact round-trip.
    """
    p, sig, omega = a5.num_tiles, a5.sigma, a5.omega
    col_flat = col_tiles_of(a5).transpose(1, 2).reshape(p * sig * omega)
    val_flat = a5.val_tiles.transpose(1, 2).reshape(p * sig * omega)
    return CSRMatrix(
        row_ptr=a5.row_ptr,
        col_idx=col_flat[: a5.nnz_stored],
        values=val_flat[: a5.nnz_stored],
        shape=a5.shape,
    )
