"""A CPU model of K7's tiling (``csrc/bandmm.cu``), held exactly against
the plain version (``bandmm_spmm_torch``) and the JAX package's
``bandmm_spmm`` in interpret mode.

K7 cannot run here, so what it stages, fetches and writes is modelled in
torch, index for index, with the kernel's own mappings. The model mirrors
the source by hand: its constants ``kRows`` (ROWS), ``KC``, ``XP`` and
``kYPitch`` (YPITCH), ``swz``, the copy loops of ``load_slot``,
``zero_pad_rows`` and ``store_y``, the fragment addressing of ``load_a``
and of the B and C fragments in ``bandmm_mma_kernel``, and the float4 loop
of ``bandmm_fma_kernel``; a change to one of them in the kernel is made
here too. The chunk width is the wrapper's own ``chunk_width``.

- a ring slot holds 64 plane columns of the block's 128 rows in the
  plane's type, each 16 B chunk c of a row at chunk ``swz(row, c)``, copied
  by the loop of ``load_slot``;
- the slot's X window ``Xs[r][k]`` (pitch 72 floats), zero past n and for
  the rows past R up to the padded width, copied along k (layout "rn") or
  along r and transposed (layout "nr");
- "default": the A fragments of ``mma.m16n8k16`` from ``ldmatrix.x4`` (bf16
  plane) or as float2 pairs rounded to bf16 (f32 plane), the B fragments as
  float2 pairs of ``Xs`` rounded to bf16, each placed where PTX defines the
  fragment's elements; 16-deep k steps, each MMA's sum rounded to float32;
- "highest": one row per thread, float32 products and sums in k order;
- the chunks of the launch (R > 32 on a bf16 plane, R > 16 on a float32
  plane), R padded to a multiple of 8;
- the epilogue through ``Ys[c][row]`` and the stores of each layout.

Slots, windows and Y start as NaN, so a read of a place no copy wrote, or
an element of Y no store reached, shows. On integer data every product and
sum is exact, so the model must equal both references bit for bit; a
fragment or swizzle mapping that moved one value would not. The bank
claims of the source note are checked on the same mappings.
"""

import functools

import numpy as np
import pytest
import torch

import benchmark_spmv_using_csr5_tpu.ops.bandmm as jbb
import benchmark_spmv_using_csr5_tpu_torch as P
from benchmark_spmv_using_csr5_tpu_torch.ops.bandmm import resolve_precision
from benchmark_spmv_using_csr5_tpu_torch.ops.bandmm_kernel import (
    MAX_CHUNK,
    MAX_CHUNK_F32,
    chunk_width,
)

from test_torch_bandmm import ALPHA, MATRICES, _both, _x

ROWS = 128  # plane rows per block = threads per CTA
KC = 64  # plane columns per ring slot
XP = KC + 8  # floats per rhs row of a slot's X window
YPITCH = ROWS + 4  # floats per rhs row of the epilogue tile
TID = np.arange(ROWS)
NAN = float("nan")


def swz(row, c):
    """The physical 16 B chunk of logical chunk ``c`` in plane row ``row``."""
    return c ^ (((row & 3) << 1) | ((row >> 2) & 1))


def _round_bf16(t):
    return t.to(torch.bfloat16).to(torch.float32)


def _once(pairs, shape):
    """Assert the index pairs hit every place of ``shape`` exactly once."""
    hits = np.zeros(shape, np.int64)
    np.add.at(hits, pairs, 1)
    assert (hits == 1).all(), "a mapping misses a place or hits one twice"


# ---- the ring slot ----------------------------------------------------------


def plane_copies(esize):
    """(row, logical chunk) of each 16 B copy of a slot, over load_slot's
    loop (i, tid): v = tid + i * 128."""
    chunks = KC * esize // 16
    v = (TID[None, :] + np.arange(chunks)[:, None] * ROWS).ravel()
    return v // chunks, v % chunks


def stage_plane(a, k0, esize):
    """Slot (nblk, 128, chunks, 16 / esize) of plane columns k0..k0+64."""
    chunks, vec = KC * esize // 16, 16 // esize
    row, c = plane_copies(esize)
    _once((row, swz(row, c)), (ROWS, chunks))
    tile = a[:, :, k0:k0 + KC].reshape(a.shape[0], ROWS, chunks, vec)
    slot = torch.full_like(tile, NAN)
    row, c, phys = (torch.from_numpy(v) for v in (row, c, swz(row, c)))
    slot[:, row, phys] = tile[:, row, c]
    return slot


def x_copies(k_contig, nx, rcw):
    """(r, k) of each 4 B copy of a slot's X window, over load_slot's loops."""
    pairs = []
    if k_contig:  # xs_c == 1: a warp reads along k
        for tid in TID:
            pairs += [(r, tid % KC) for r in range(tid // KC, rcw, ROWS // KC)]
    else:  # along r: nx lanes per k, transposed into Xs
        for tid in TID:
            if tid % nx < rcw:
                pairs += [(tid % nx, k) for k in range(tid // nx, KC, ROWS // nx)]
    r, k = np.array(pairs, np.int64).T
    _once((r, k), (rcw, KC))
    return r, k


def stage_x(xflat, n, cbase, k0, r0, rcw, nx, xs_c, xs_r):
    """Xs (nblk, nx, XP): X[cbase + k0 + k, r0 + r] for r < rcw, 0 past n;
    rows rcw..nx zeroed (zero_pad_rows); the pitch's tail never written."""
    xs = torch.full((cbase.shape[0], nx, XP), NAN)
    xs[:, rcw:, :] = 0.0
    r, k = x_copies(xs_c == 1, nx, rcw)
    col = cbase[:, None] + k0 + torch.from_numpy(k)[None, :]
    idx = col * xs_c + (r0 + torch.from_numpy(r))[None, :] * xs_r
    vals = torch.where(col < n, xflat[idx.clamp(0, xflat.numel() - 1)], torch.zeros(()))
    xs[:, r, k] = vals
    return xs


# ---- the fragments of mma.m16n8k16 (PTX's layouts) ---------------------------


def a_fragment_map(esize):
    """Per (warp, m tile, k step, lane, register, half): the slot place an
    A element is read from (row, physical chunk, element) and where PTX puts
    it in the block's 128 x 64 slot tile (row, column)."""
    w, mt, ks, lane, q, h = np.meshgrid(
        np.arange(4), np.arange(2), np.arange(KC // 16), np.arange(32), np.arange(4),
        np.arange(2), indexing="ij")
    g, t = lane // 4, lane % 4
    # PTX: a0 (g, 2t), a1 (g + 8, 2t), a2 (g, 2t + 8), a3 (g + 8, 2t + 8)
    dst_row = w * 32 + mt * 16 + g + 8 * (q & 1)
    dst_col = ks * 16 + 2 * t + 8 * (q >> 1) + h
    if esize == 2:
        # ldmatrix.x4: matrix q's row g comes from the address of lane
        # 8 q + g, which points at row L % 16, chunk 2 ks + L / 16
        src_lane = 8 * q + g
        row = w * 32 + mt * 16 + src_lane % 16
        chunk, elem = ks * 2 + src_lane // 16, 2 * t + h
    else:
        # float2 pairs at (row, kk), kk = 16 ks + 2 t (+ 8)
        row = dst_row
        kk = ks * 16 + 2 * t + 8 * (q >> 1)
        chunk, elem = kk // 4, kk % 4 + h
    return (row, swz(row, chunk), elem), (dst_row, dst_col)


def b_fragment_map(nt_count):
    """Per (n tile, k step, lane, register, half): the Xs place a B element
    is read from and where PTX puts it in the slot's 64 x NX tile (k, n):
    b0 (k 2t, 2t + 1; n g), b1 (k 2t + 8, 2t + 9; n g)."""
    nt, ks, lane, j, h = np.meshgrid(
        np.arange(nt_count), np.arange(KC // 16), np.arange(32), np.arange(2), np.arange(2),
        indexing="ij")
    g, t = lane // 4, lane % 4
    k = ks * 16 + 2 * t + 8 * j + h
    return (nt * 8 + g, k), (k, nt * 8 + g)


def c_fragment_map(nt_count):
    """Per (warp, m tile, n tile, lane, register): the accumulator's place
    in the block's 128 x NX tile: c0, c1 (g, 2t, 2t + 1), c2, c3 (g + 8)."""
    w, mt, nt, lane, q = np.meshgrid(
        np.arange(4), np.arange(2), np.arange(nt_count), np.arange(32), np.arange(4),
        indexing="ij")
    g, t = lane // 4, lane % 4
    return w * 32 + mt * 16 + g + 8 * (q // 2), nt * 8 + 2 * t + q % 2


def mma_slot(acc, slot, xs, esize, bf16_a):
    """The products of one slot on the tensor cores, one float32 rounding of
    each MMA's sum (16-deep k step) per accumulator."""
    nblk, nx = acc.shape[0], acc.shape[2]
    (row, pch, elem), (drow, dcol) = a_fragment_map(esize)
    _once((drow.ravel(), dcol.ravel()), (ROWS, KC))
    a = torch.full((nblk, ROWS, KC), NAN)
    a[:, drow.ravel(), dcol.ravel()] = slot[:, row.ravel(), pch.ravel(), elem.ravel()]
    if bf16_a:
        a = _round_bf16(a)
    (xr, xk), (bk, bn) = b_fragment_map(nx // 8)
    _once((bk.ravel(), bn.ravel()), (KC, nx))
    b = torch.full((nblk, KC, nx), NAN)
    b[:, bk.ravel(), bn.ravel()] = _round_bf16(xs[:, xr.ravel(), xk.ravel()])
    for ks in range(KC // 16):
        step = a[:, :, ks * 16:(ks + 1) * 16].double() @ b[:, ks * 16:(ks + 1) * 16].double()
        acc = (acc.double() + step).float()
    return acc


def fma_slot(acc, slot, xs, rc):
    """The products of one slot in "highest": thread tid holds row tid, reads
    its chunks as float4 and X as float4 broadcasts, one float32 product and
    one float32 sum per element, in k order."""
    for c in range(slot.shape[2]):
        a4 = slot[:, TID, swz(TID, c)]  # (nblk, 128, 4)
        xv = xs[:, :rc, c * 4:c * 4 + 4]  # (nblk, rc, 4)
        for e in range(4):
            acc = acc + a4[:, :, e, None] * xv[:, None, :, e]
    return acc


def y_stores(ys_row, nx, rcw):
    """(rhs c, row i) of each store of store_y, over its loop."""
    if ys_row == 1:  # Y^T rows: e = tid + 128 s
        e = np.arange(rcw * ROWS)
        c, i = e // ROWS, e % ROWS
    else:  # nx lanes per row
        pairs = [(tid % nx, i) for tid in TID if tid % nx < rcw
                 for i in range(tid // nx, ROWS, ROWS // nx)]
        c, i = np.array(pairs, np.int64).T
    _once((c, i), (rcw, ROWS))
    return c, i


def k7_model(bb, x, alpha, precision, layout):
    """Y as K7 computes it, for the plane ``bb`` and X in ``layout`` on the
    CPU (the wrapper's strides and chunks, the kernel's tiling)."""
    prec = resolve_precision(bb, precision)
    rn = layout == "rn"
    R = x.shape[0] if rn else x.shape[1]
    m, n, K, nblk = bb.m, bb.n, bb.K, bb.num_blocks
    xflat = (x if alpha == 1.0 else x * alpha).reshape(-1)
    xs_c, xs_r = (1, n) if rn else (R, 1)
    ys_row, ys_r = (1, m) if rn else (R, 1)
    esize = bb.dense.element_size()
    plane = bb.dense.float().reshape(nblk, ROWS, K)
    cbase = bb.c0.reshape(-1).long() * ROWS
    rc = chunk_width(R, bb.dense.dtype)
    nx = max(8, rc)  # the tensor cores' NT * 8; "highest" pads to 8 as well
    y = torch.full((R * m,), NAN)
    for r0 in range(0, R, rc):
        rcw = min(rc, R - r0)
        acc = torch.zeros(nblk, ROWS, nx if prec == "default" else rc)
        for k0 in range(0, K, KC):
            slot = stage_plane(plane, k0, esize)
            xs = stage_x(xflat, n, cbase, k0, r0, rcw, nx, xs_c, xs_r)
            if prec == "default":
                acc = mma_slot(acc, slot, xs, esize, bf16_a=esize == 4)
            else:
                acc = fma_slot(acc, slot, xs, rc)
        ys = torch.full((nblk, nx, YPITCH), NAN)
        if prec == "default":
            crow, ccol = c_fragment_map(nx // 8)
            _once((crow.ravel(), ccol.ravel()), (ROWS, nx))
            ys[:, ccol.ravel(), crow.ravel()] = acc[:, crow.ravel(), ccol.ravel()]
        else:
            ys[:, :rc, :ROWS] = acc.transpose(1, 2)
        c, i = y_stores(ys_row, nx, rcw)
        rows = torch.arange(nblk)[:, None] * ROWS + torch.from_numpy(i)[None, :]
        keep = rows < m
        dst = rows * ys_row + (r0 + torch.from_numpy(c))[None, :] * ys_r
        y[dst[keep]] = ys[:, c, i][keep]
    assert not torch.isnan(y).any(), "an element of Y was never stored"
    return y.reshape((R, m) if rn else (m, R))


# ---- the model against the plain version and the JAX package ---------------

#: (plane dtype, precision) of every K7 mode
MODES = {
    "f32-highest": (torch.float32, "highest"),
    "f32-default": (torch.float32, "default"),
    "bf16-default": (torch.bfloat16, "default"),
}


@functools.lru_cache(maxsize=None)
def _planes(name, value_dtype):
    return _both(name, value_dtype)


@functools.lru_cache(maxsize=None)
def _jax_y(name, value_dtype, R):
    """The JAX package's Y (layout "nr") for the operands a mode's products
    take: the float32 plane in "highest"; the bfloat16 plane in "default",
    whose values are a float32 plane's rounded to bf16 (XLA on the CPU runs
    DEFAULT in full float32, so it is not the reference for "default" on a
    float32 plane)."""
    a, bj, _ = _planes(name, value_dtype)
    prec = "highest" if value_dtype == torch.float32 else "default"
    return np.array(jbb.bandmm_spmm(bj, _x(a.shape[1], R), ALPHA, precision=prec, interpret=True))


#: (matrix, R): every R on the past-n and the confined-window shapes (one
#: n tile, a ragged one, two, one pass at 32 on bf16, chunks past 16 on
#: float32 and past 32 on bf16), every other matrix at R = 17
CASES = [(name, R) for name in ("rect", "confined") for R in (1, 3, 8, 16, 17, 32, 33)] + [
    (name, 17) for name in MATRICES if name not in ("rect", "confined")]


@pytest.mark.parametrize("layout", ["nr", "rn"])
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("name, R", CASES)
def test_tiling_model_matches_plain_and_jax_exactly(name, R, mode, layout):
    value_dtype, precision = MODES[mode]
    a, _, bp = _planes(name, value_dtype)
    X = torch.from_numpy(_x(a.shape[1], R))
    xin = X.T.contiguous() if layout == "rn" else X
    y = k7_model(bp, xin, ALPHA, precision, layout)
    y_plain = P.bandmm_spmm_torch(bp, xin, ALPHA, precision, layout)
    assert torch.equal(y, y_plain)
    jax_dtype = torch.float32 if mode == "f32-highest" else torch.bfloat16
    y_jax = torch.from_numpy(_jax_y(name, jax_dtype, R))
    assert torch.equal(y.T if layout == "rn" else y, y_jax)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("R", [1, 8, 16, 17, 32, 33, 64, 65])
def test_chunks_cover_every_rhs_once(R, dtype):
    """The launch's chunks: rc a power of two up to the plane's cap (one
    pass over a bf16 plane for R <= 32, over a float32 plane for R <= 16),
    the last one ragged, padded to NX."""
    cap = MAX_CHUNK if dtype == torch.bfloat16 else MAX_CHUNK_F32
    assert (MAX_CHUNK, MAX_CHUNK_F32) == (32, 16)
    rc = chunk_width(R, dtype)
    assert rc == min(cap, 1 << (R - 1).bit_length())
    starts = list(range(0, R, rc))
    assert len(starts) == -(-R // rc) and sum(min(rc, R - r0) for r0 in starts) == R
    assert (len(starts) == 1) == (R <= cap)
    assert max(8, rc) % 8 == 0


# ---- shared-memory banks of the mappings --------------------------------------


def _banks(byte_addr, width):
    """The 4 B banks an access of ``width`` bytes at each address covers."""
    return (byte_addr[..., None] // 4 + np.arange(width // 4)) % 32


def _conflict_free(byte_addr, width):
    """A warp's access, split into the phases the hardware serves at once
    (32 lanes for 4 B, 16 for 8 B, 8 for 16 B), hits distinct banks in
    each phase, or one address (a broadcast)."""
    per_phase = 128 // width
    for ph in range(0, 32, per_phase):
        addr = byte_addr[ph:ph + per_phase]
        if len(set(addr.tolist())) == 1:
            continue
        banks = _banks(addr, width).ravel()
        if len(set(banks.tolist())) != banks.size:
            return False
    return True


@pytest.mark.parametrize("esize", [2, 4], ids=["bf16", "f32"])
def test_swizzle_permutes_chunks_within_128_bytes(esize):
    chunks = KC * esize // 16
    rows = np.arange(ROWS)[:, None]
    phys = swz(rows, np.arange(chunks)[None, :])
    assert (np.sort(phys, axis=1) == np.arange(chunks)).all()
    assert (phys // 8 == np.arange(chunks)[None, :] // 8).all()


def test_ldmatrix_phases_conflict_free():
    """Each 8-lane phase of ldmatrix.x4 reads 8 rows' 16 B at one logical
    chunk (bf16 slot: 128 B per row)."""
    lane = np.arange(32)
    for w in range(4):
        for mt in range(2):
            for ks in range(KC // 16):
                row = w * 32 + mt * 16 + lane % 16
                assert _conflict_free(row * 128 + swz(row, ks * 2 + lane // 16) * 16, 16)


def test_f32_a_fragments_conflict_free():
    """The f32 "default" path reads float2 pairs (256 B per slot row)."""
    lane = np.arange(32)
    g, t = lane // 4, lane % 4
    for w in range(4):
        for mt in range(2):
            for ks in range(KC // 16):
                for q in range(4):
                    row = w * 32 + mt * 16 + g + 8 * (q & 1)
                    kk = ks * 16 + 2 * t + 8 * (q >> 1)
                    assert _conflict_free(row * 256 + swz(row, kk // 4) * 16 + (kk % 4) * 4, 8)


@pytest.mark.parametrize("esize", [2, 4], ids=["bf16", "f32"])
def test_plane_copies_and_highest_reads_conflict_free(esize):
    """The 16 B copies into a slot, and "highest"'s per-row float4 reads."""
    rowb = KC * esize
    row, c = plane_copies(esize)
    dst = row * rowb + swz(row, c) * 16
    for wbase in range(0, dst.size, 32):
        assert _conflict_free(dst[wbase:wbase + 32], 16)
    if esize == 4:
        for w in range(4):
            tid = w * 32 + np.arange(32)
            for cc in range(rowb // 16):
                assert _conflict_free(tid * rowb + swz(tid, cc) * 16, 16)


def test_b_fragments_and_epilogue_conflict_free():
    """B fragments: float2 of Xs (pitch 72 floats); the accumulators into
    Ys (pitch 132 floats)."""
    lane = np.arange(32)
    g, t = lane // 4, lane % 4
    for nt in range(4):
        for ks in range(KC // 16):
            for j in range(2):
                assert _conflict_free(((nt * 8 + g) * XP + ks * 16 + 2 * t + 8 * j) * 4, 8)
    for q in range(4):
        assert _conflict_free(((2 * t + q % 2) * YPITCH + g + 8 * (q // 2)) * 4, 4)
