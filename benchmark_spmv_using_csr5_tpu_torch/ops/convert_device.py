"""CSR -> CSR5 conversion on the card, from CSR tensors already there.

The counterpart of ``benchmark_spmv_using_csr5_tpu/ops/convert_device.py``.
The reference converts on the device (``format_cuda.h:97-744``); the host
pipeline of :mod:`.convert` uploads finished planes instead. Here every
stage is a function of torch tensors that runs where its inputs lie (the
card, or the CPU in the tests), composed by :func:`build_csr5_device`.
No stage is a kernel of its own: the JAX package computes them with
``jnp`` outside any Pallas kernel, and the port with torch ops.

The data-dependent plan sizes (tile count, window width ``capw``, page
list width ``pmax``, ...) come from a small host pre-pass,
:func:`plan_statics`, the reference's own reduce-before-build split
(``format_cuda.h:362-523`` sizes the offset table with a scan before
filling it). Given the same statics every plane equals the host
conversion's (``build_csr5(..., keep_raw_cols=True)``) element for
element, except ``empty_offset``, which is ``eo_width`` slots per dirty
tile here (the same values, zero-padded) and ragged there.

==========================================  ===============================
reference kernel                            here
==========================================  ===============================
generate_partition_pointer_s1               ``convert.tile_partition_pointer``
generate_partition_pointer_s2               ``convert.tile_dirty_flags``
generate_partition_descriptor_s1/_s2        :func:`tile_heads`,
(format_cuda.h:129-267)                     :func:`tile_descriptor`
generate_partition_descriptor_s3+_offset    :func:`tile_empty_offsets`
(format_cuda.h:269-523)                     (dirty tiles only)
aosoa_transpose (format_cuda.h:525-744)     :func:`tile_payload`
(the JAX gather plan)                       :func:`tile_page_lists`,
                                            :func:`tile_window_maps`,
                                            :func:`packed_columns`
==========================================  ===============================

Where the JAX stages scatter with ``mode="drop"`` (indices out of range
are dropped), these mask the indices first: torch raises on the CPU, and
asserts on the card. The stages over every nonzero that need an int64
temporary (sorting pages, ranking them, locating rows) walk a bounded
number of tiles at a time, so the 560M-nonzero banded20M converts
without an nnz-sized int64 plane.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import DEFAULT_DEVICE, CSR5Config, compute_sigma, resolve_device
from ..models.formats import CSR5Matrix
from ..utils import nativelib
from .convert import (
    CONTIG_PAGE_CAP,
    PAGE_COLS,
    _pow2_at_least,
    tile_dirty_flags,
    tile_partition_pointer,
)

#: elements per step of the stages that walk the tiles a slab at a time
_STEP_ELEMS = 2**24


class PlanStatics(NamedTuple):
    """The host-known plan sizes (the JAX ``PlanStatics``,
    ``convert_device.py:61-74``), from :func:`plan_statics`."""

    config: CSR5Config
    p_pad: int  # padded tile count
    capw: int  # window-map width (slots per tile)
    pmax: int  # page-list width
    pages_contig: bool
    win_rel: bool
    tail_row_start: int
    eo_width: int  # per-tile empty-offset table width (max nseg, dirty)
    m: int
    n: int


def _slabs(p: int, per_tile: int):
    """(t0, t1) ranges of tiles holding about ``_STEP_ELEMS`` elements."""
    step = max(1, _STEP_ELEMS // max(per_tile, 1))
    for t0 in range(0, p, step):
        yield t0, min(t0 + step, p)


# ---------------------------------------------------------------------------
# stages
# ---------------------------------------------------------------------------


def tile_heads(row_ptr: torch.Tensor, p: int, tile_nnz: int) -> torch.Tensor:
    """(p * tile_nnz,) bool: the nonzero begins a row, with each tile's
    leading bit forced (``format_cuda.h:171-175``; JAX :82-92). Index =
    global element order; padding past nnz never starts a row."""
    nnz_pad = p * tile_nnz
    rp = row_ptr.long()
    starts = rp[:-1][rp[1:] > rp[:-1]]  # the starts of the non-empty rows
    heads = torch.zeros(nnz_pad, dtype=torch.bool, device=rp.device)
    heads[starts[starts < nnz_pad]] = True
    heads[torch.arange(p, device=rp.device) * tile_nnz] = True
    return heads


def tile_descriptor(heads: torch.Tensor, p: int, sigma: int, omega: int):
    """(bit_flag (p, ceil(sigma/32), omega) uint32, y_offset (p, omega)
    int32, seg_offset (p, omega) int32, nseg (p,) int32): the host
    ``convert._descriptor`` (``format_cuda.h:129-267``; JAX :95-144).
    ``heads`` is flat in element order, t*T + l*sigma + s. The words are
    built in int64 one bit row at a time and cast once."""
    fl = heads.reshape(p, omega, sigma)
    dev = heads.device
    nwords = (sigma + 31) // 32
    words = torch.zeros((p, omega, nwords), dtype=torch.int64, device=dev)
    for s in range(sigma):  # bit s % 32 of word s // 32: the head at row s
        words[:, :, s // 32] |= fl[:, :, s].long() << (s % 32)
    # uint32 has few torch ops: reinterpret the int32 bit pattern
    words = torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)
    bit_flag = words.transpose(1, 2).contiguous().view(torch.uint32)

    lane_cnt = fl.sum(dim=2, dtype=torch.int32)  # (p, omega)
    y_offset = torch.zeros_like(lane_cnt)
    y_offset[:, 1:] = torch.cumsum(lane_cnt[:, :-1], dim=1)

    # seg_offset: distance - 1 to the next flagged lane strictly right
    # (omega - l - 1 if none; scansum semantics, format_cuda.h:200-240)
    lanes = torch.arange(omega, dtype=torch.int32, device=dev)
    lane_or_inf = torch.where(lane_cnt > 0, lanes, omega)
    # nxt[l] = min over l' >= l: a reversed inclusive cummin
    nxt = torch.flip(torch.cummin(torch.flip(lane_or_inf, [1]), dim=1).values, [1])
    next_flagged = torch.cat([nxt[:, 1:], torch.full_like(nxt[:, :1], omega)], dim=1)
    seg_offset = torch.clamp(next_flagged - lanes - 1, 0, omega).to(torch.int32)
    nseg = lane_cnt.sum(dim=1, dtype=torch.int32)
    return bit_flag, y_offset, seg_offset, nseg


def tile_empty_offsets(
    row_ptr: torch.Tensor,
    heads: torch.Tensor,
    dirty: torch.Tensor,
    tile_ptr: torch.Tensor,
    p: int,
    tile_nnz: int,
    eo_width: int,
) -> torch.Tensor:
    """(p, eo_width) int32: entry (t, k) is the row offset from
    ``tile_ptr[t]`` of the k-th segment head of dirty tile t
    (``format_cuda.h:362-523``; JAX :147-180); 0 past a tile's segment
    count and in clean tiles. The JAX stage locates the row of every
    element of every tile; the table only needs the dirty tiles', so only
    they are searched."""
    dev = heads.device
    out = torch.zeros((p, eo_width), dtype=torch.int32, device=dev)
    dt = torch.nonzero(dirty[:p]).flatten()
    if dt.numel() == 0 or eo_width == 0:
        return out
    fl_all = heads.reshape(p, tile_nnz)
    rp = row_ptr.long()
    within = torch.arange(tile_nnz, dtype=torch.int64, device=dev)
    for i0, i1 in _slabs(dt.numel(), tile_nnz):
        t = dt[i0:i1]
        fl = fl_all[t]  # element order within each tile
        rows = torch.searchsorted(rp, t[:, None] * tile_nnz + within, right=True) - 1
        offs = rows - tile_ptr[t].long()[:, None]
        k = torch.cumsum(fl, dim=1, dtype=torch.int64) - 1  # ordinal per head
        keep = fl & (k < eo_width)
        out[t[:, None].expand_as(k)[keep], k[keep]] = offs[keep].to(torch.int32)
    return out


def tile_window_maps(
    row_ptr: torch.Tensor,
    tile_ptr: torch.Tensor,
    p: int,
    tile_nnz: int,
    m: int,
    sigma: int,
    capw: int,
    win_rel: bool,
) -> torch.Tensor:
    """(p, capw) int32 monotone row-end maps, ``sub | lane << 16`` with
    flag bits 23 (first-row slot) and 24 (d >= tile_ptr % 128), wrapped
    or aligned (JAX :183-224; the host block in ``convert._host_plan``)."""
    dev = tile_ptr.device
    rs = tile_ptr[:p, None].long()
    d = torch.arange(capw, dtype=torch.int64, device=dev)[None, :]
    off = rs & 127
    if win_rel:
        ridx = (rs - off) + d + torch.where(d < off, capw, 0) + 1
    else:
        ridx = (rs // 128) * 128 + d + 1
    ridx = torch.clamp(ridx, max=m)
    base = torch.arange(p, dtype=torch.int64, device=dev)[:, None] * tile_nnz
    win_end = torch.clamp(row_ptr.long()[ridx] - 1 - base, 0, tile_nnz - 1)
    out = (win_end % sigma) | ((win_end // sigma) << 16)
    out |= torch.where(d >= off, 1 << 24, 0) | torch.where(d == off, 1 << 23, 0)
    return out.to(torch.int32)


def tile_page_lists(col2d: torch.Tensor, pmax: int, page_sentinel: int, contig: bool):
    """(pages (p, pmax) int32, page_cnt (p,) int32): each tile's distinct
    x pages from its (p, tile_nnz) padded columns (JAX :227-258). Contig
    mode gives the range ``[lo, lo + pmax)``; list mode the sorted
    distinct pages, the sentinel page past them."""
    p, T = col2d.shape
    dev = col2d.device
    slots = torch.arange(pmax, dtype=torch.int64, device=dev)
    page_cnt = torch.empty(p, dtype=torch.int32, device=dev)
    pages = torch.full((p, pmax), page_sentinel, dtype=torch.int32, device=dev)
    for t0, t1 in _slabs(p, T):
        ps = torch.sort(col2d[t0:t1] >> 7, dim=1).values
        first = torch.ones_like(ps, dtype=torch.bool)
        first[:, 1:] = ps[:, 1:] != ps[:, :-1]
        page_cnt[t0:t1] = first.sum(dim=1, dtype=torch.int32)
        if contig:
            lo = torch.clamp(ps[:, 0].long(), max=page_sentinel + 1 - pmax)
            pages[t0:t1] = (lo[:, None] + slots).to(torch.int32)
            continue
        pos = torch.cumsum(first, dim=1, dtype=torch.int64) - 1
        keep = first & (pos < pmax)  # JAX drops the slots past pmax
        rows = torch.arange(t0, t1, device=dev)[:, None].expand_as(pos)
        pages[rows[keep], pos[keep]] = ps[keep]
    return pages, page_cnt


def packed_columns(
    col2d: torch.Tensor, pages: torch.Tensor, sigma: int, omega: int, contig: bool
) -> torch.Tensor:
    """(p, sigma/2, omega) int32: the ``lane | local_page << 7`` codes of
    the row pairs (s, s + sigma/2) in one word, the host ``col_packed``
    (JAX :261-284). A page's local index is its rank in the tile's list:
    the batched ``torch.searchsorted`` over the sorted lists."""
    p, T = col2d.shape
    s2 = sigma // 2
    out = torch.empty((p, s2, omega), dtype=torch.int32, device=col2d.device)
    for t0, t1 in _slabs(p, T):
        c2 = col2d[t0:t1]
        pg = c2 >> 7
        lst = pages[t0:t1]
        if contig:
            local = pg - lst[:, 0:1]
        else:
            local = torch.searchsorted(lst, pg).to(torch.int32)
        c = ((c2 & 127) | (local << 7)).reshape(t1 - t0, omega, sigma)
        out[t0:t1] = (c[:, :, :s2] | (c[:, :, s2:] << 16)).transpose(1, 2)
    return out


def tile_payload(flat: torch.Tensor, sigma: int, omega: int) -> torch.Tensor:
    """The AoS -> SoA tile transpose: flat (p * omega * sigma,) element
    order -> contiguous (p, sigma, omega) (``format_cuda.h:525-744``)."""
    p = flat.shape[0] // (omega * sigma)
    return flat.reshape(p, omega, sigma).transpose(1, 2).contiguous()


# ---------------------------------------------------------------------------
# host pre-pass + orchestrator
# ---------------------------------------------------------------------------


def plan_statics(
    row_ptr: np.ndarray,
    col_idx: np.ndarray,
    shape,
    config: Optional[CSR5Config] = None,
    win_mode: str = "auto",
) -> PlanStatics:
    """The host pre-pass sizing the plan (JAX :300-388): reads ``row_ptr``
    and the column plane once, with the host conversion's rules, so the
    sizes match it. For a distribution, every shard is planned and the
    sizes are unified to the largest."""
    m, n = shape
    nnz = int(len(col_idx))
    if config is None:
        config = CSR5Config(sigma=compute_sigma(m, nnz))
    T = config.tile_nnz
    p = max(1, -(-nnz // T))
    quantum = min(config.tiles_per_block, _pow2_at_least(p, 1))
    p_pad = -(-p // quantum) * quantum

    row_ptr = np.asarray(row_ptr, np.int64)
    bounds = np.arange(p_pad + 1, dtype=np.int64) * T
    tile_ptr = np.clip(np.searchsorted(row_ptr, bounds, side="right") - 1, 0, m)
    span_max = int((tile_ptr[1:] - tile_ptr[:-1]).max())
    win_rel = win_mode != "aligned"
    if win_rel:
        capw = -(-(span_max + 1) // 128) * 128
    else:  # aligned maps (the distributed layer's mode)
        capw = _pow2_at_least(span_max + 1 + 128, 128)

    n_pad = -(-max(n, 1) // PAGE_COLS) * PAGE_COLS
    page_sentinel = n_pad // PAGE_COLS
    # per-tile page span and distinct count, as the host conversion finds
    # them (the padding repeats the last real column: no new page)
    col_flat = np.zeros(p_pad * T, dtype=np.int32)
    col_flat[:nnz] = col_idx
    if nnz:
        col_flat[nnz:] = col_flat[nnz - 1]
    plan = nativelib.page_plan(col_flat, p_pad, T, page_sentinel + 1)
    if plan is not None:
        _lo, _cnt, pspan, cnt_max, _ = plan
    else:
        ps = np.sort(col_flat.reshape(p_pad, T) >> 7, axis=1)
        first = np.ones((p_pad, T), dtype=bool)
        first[:, 1:] = ps[:, 1:] != ps[:, :-1]
        pspan = int((ps[:, -1] - ps[:, 0]).max()) + 1
        cnt_max = int(first.sum(axis=1).max())
    contig = pspan <= CONTIG_PAGE_CAP and max(pspan, 2) <= page_sentinel + 1
    pmax = max(pspan, 2) if contig else max(-(-cnt_max // 8) * 8, 2)

    # eo_width: the most segments of any dirty tile (0 when none is dirty)
    empty = (np.diff(row_ptr) == 0).astype(np.int64)
    e_prefix = np.zeros(m + 1, dtype=np.int64)
    np.cumsum(empty, out=e_prefix[1:])
    start, stop = tile_ptr[:-1], np.minimum(tile_ptr[1:], m - 1)
    dirty = (e_prefix[stop + 1] - e_prefix[np.minimum(start + 1, m)]) > 0
    eo_width = int(_segments(row_ptr, p_pad, T)[dirty].max()) if dirty.any() else 0

    return PlanStatics(
        config=config,
        p_pad=p_pad,
        capw=capw,
        pmax=pmax,
        pages_contig=contig,
        win_rel=win_rel,
        tail_row_start=int(tile_ptr[p - 1]),
        eo_width=eo_width,
        m=m,
        n=n,
    )


def _segments(row_ptr: np.ndarray, p_pad: int, tile_nnz: int) -> np.ndarray:
    """(p_pad,) segment heads per tile: row starts plus the forced tile
    heads (the host conversion's ``nseg``)."""
    heads = np.zeros(p_pad * tile_nnz, dtype=bool)
    heads[row_ptr[:-1][np.diff(row_ptr) > 0]] = True
    heads[np.arange(p_pad) * tile_nnz] = True
    return heads.reshape(p_pad, tile_nnz).sum(axis=1)


def build_csr5_device(
    row_ptr,
    col_idx,
    values,
    statics: PlanStatics,
    device=DEFAULT_DEVICE,
) -> CSR5Matrix:
    """CSR -> CSR5 on ``device`` (default: the card; raises without one)
    (JAX :391-476). ``row_ptr``, ``col_idx`` and ``values`` are tensors on
    ``device`` (or host arrays, which are copied there first). The value
    plane keeps ``values``' dtype; the raw column plane is always built.
    Every plane equals the host ``build_csr5(..., keep_raw_cols=True)``'s
    given the same statics (:func:`plan_statics`), except
    ``empty_offset``: ``eo_width`` slots per dirty tile, counted so in
    ``empty_offset_ptr``."""
    device = resolve_device(device, "build_csr5_device")
    cfg = statics.config
    omega, sig = cfg.omega, cfg.sigma
    T = cfg.tile_nnz
    p_pad, m, n = statics.p_pad, statics.m, statics.n
    row_ptr = torch.as_tensor(row_ptr).to(device=device, dtype=torch.int64)
    col_idx = torch.as_tensor(col_idx).to(device=device, dtype=torch.int32)
    values = torch.as_tensor(values).to(device=device)
    nnz = int(col_idx.shape[0])
    nnz_pad = p_pad * T

    col_flat = torch.empty(nnz_pad, dtype=torch.int32, device=device)
    col_flat[:nnz] = col_idx
    col_flat[nnz:] = col_idx[-1] if nnz else 0  # pad columns repeat the last
    val_flat = torch.zeros(nnz_pad, dtype=values.dtype, device=device)
    val_flat[:nnz] = values

    tile_ptr = tile_partition_pointer(row_ptr, p_pad, T)
    dirty = tile_dirty_flags(row_ptr, tile_ptr)
    heads = tile_heads(row_ptr, p_pad, T)
    bit_flag, y_offset, seg_offset, _ = tile_descriptor(heads, p_pad, sig, omega)
    eo_w = max(statics.eo_width, 1)
    eo_pad = tile_empty_offsets(row_ptr, heads, dirty, tile_ptr, p_pad, T, eo_w)
    del heads

    n_pad = -(-max(n, 1) // PAGE_COLS) * PAGE_COLS
    col2d = col_flat.view(p_pad, T)
    pages, page_cnt = tile_page_lists(col2d, statics.pmax, n_pad // PAGE_COLS, statics.pages_contig)
    win_map = tile_window_maps(row_ptr, tile_ptr, p_pad, T, m, sig, statics.capw, statics.win_rel)
    col_packed = None
    if statics.pmax <= 512 and sig % 16 == 0:
        col_packed = packed_columns(col2d, pages, sig, omega, statics.pages_contig)

    eo_ptr = torch.zeros(p_pad + 1, dtype=torch.int32, device=device)
    eo_ptr[1:] = torch.cumsum(dirty.to(torch.int32) * eo_w, dim=0)
    return CSR5Matrix(
        shape=(m, n),
        config=cfg,
        num_tiles=p_pad,
        nnz_stored=nnz,
        row_ptr=row_ptr.to(torch.int32),
        tile_ptr=tile_ptr,
        tile_dirty=dirty,
        y_offset=y_offset,
        seg_offset=seg_offset,
        bit_flag=bit_flag,
        empty_offset_ptr=eo_ptr,
        empty_offset=eo_pad.reshape(-1),
        col_idx_tiles=tile_payload(col_flat, sig, omega),
        val_tiles=tile_payload(val_flat, sig, omega),
        pages=pages,
        pages_contig=statics.pages_contig,
        page_cnt=page_cnt,
        win_map=win_map,
        col_packed=col_packed,
        win_rel=statics.win_rel,
        tail_row_start=statics.tail_row_start,
        capw=statics.capw,
        pmax=statics.pmax,
        m_pad=-(-(m + statics.capw + 128) // 1024) * 1024,
        n_pad=n_pad,
    )
