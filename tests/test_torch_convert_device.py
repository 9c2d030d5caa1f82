"""The port's on-card conversion (``ops/convert_device.py``) and the raw
column plane's two upload savings (``ops/convert.py``: ``keep_raw_cols``
and the 2 B/nnz upload), on the CPU, against the JAX package.

- every stage against its JAX twin (``convert_device.py``, and the two
  ``jnp`` stages of JAX ``convert.py``), element for element;
- ``plan_statics`` field by field, and ``build_csr5_device`` against the
  JAX ``build_csr5_device`` and the port's host ``build_csr5(...,
  keep_raw_cols=True)`` exactly, on the JAX test's five matrices
  (``tests/test_convert_device.py:38-46``), sigma 8/16/24, aligned maps,
  the padded empty offsets;
- y through the plain executor and the other consumers of a device-built
  matrix, exact on integer data;
- the decode of the 2 B/nnz codes on CPU tensors, bit-equal to the raw
  plane, and the ``sigma % 2`` gate refusing an odd sigma;
- ``keep_raw_cols=False`` planes through every plain consumer, exact
  against ``keep_raw_cols=True``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import benchmark_spmv_using_csr5_tpu as J
from benchmark_spmv_using_csr5_tpu.ops import convert as jconvert
from benchmark_spmv_using_csr5_tpu.ops import convert_device as jcd
from benchmark_spmv_using_csr5_tpu_torch import CSR5Config, build_csr5, build_csr5_autotuned
from benchmark_spmv_using_csr5_tpu_torch.models.formats import (
    PLANE_FIELDS,
    STATIC_FIELDS,
    col_tiles_of,
    decode_packed_codes,
)
from benchmark_spmv_using_csr5_tpu_torch.ops import convert, convert_device as cd
from benchmark_spmv_using_csr5_tpu_torch.ops.csr5_spmv import (
    csr5_spmm_torch,
    csr5_spmv_packed_torch,
    csr5_spmv_torch,
)
from benchmark_spmv_using_csr5_tpu_torch.utils import debug, nativelib, perf, synth

#: the JAX test's matrices (tests/test_convert_device.py:38-46)
CASES = {
    "banded": lambda: synth.banded(900, 9),
    "scattered": lambda: synth.scattered_band(800, 6, 500, seed=2),
    "powerlaw_empty_rows": lambda: synth.power_law(700, 600, 8.0, seed=11),
    "random": lambda: synth.random_csr(500, 400, 0.03, seed=3),
    "single_dense_row": lambda: sp.csr_matrix(np.ones((1, 700), np.float32)),
}


def _ints(a_sp, seed=0):
    a = sp.csr_matrix(a_sp).astype(np.float32)
    a.data = np.random.default_rng(seed).integers(1, 10, a.nnz).astype(np.float32)
    return a


def _np(t):
    """A tensor as numpy (uint32 read through its int32 bit pattern)."""
    if t.dtype == torch.uint32:
        return t.view(torch.int32).numpy().view(np.uint32)
    return t.numpy()


def _device(a, config=None, win_mode="auto"):
    st = cd.plan_statics(a.indptr, a.indices, a.shape, config, win_mode=win_mode)
    return st, cd.build_csr5_device(
        torch.from_numpy(a.indptr.astype(np.int64)), torch.from_numpy(a.indices.astype(np.int32)),
        torch.from_numpy(a.data), st, device="cpu",
    )


def _jax_device(a, config=None, win_mode="auto"):
    jcfg = None if config is None else J.CSR5Config(
        omega=config.omega, sigma=config.sigma, tiles_per_block=config.tiles_per_block)
    st = jcd.plan_statics(a.indptr, a.indices, a.shape, jcfg, win_mode=win_mode)
    return st, jcd.build_csr5_device(
        jnp.asarray(a.indptr, jnp.int64), jnp.asarray(a.indices, jnp.int32), jnp.asarray(a.data), st
    )


def _same_as_host(dev, host):
    """Every plane and static field equal; ``empty_offset`` as the padded
    table holding the host's ragged one, tile by tile."""
    for f in STATIC_FIELDS:
        assert getattr(dev, f) == getattr(host, f), f
    for f in PLANE_FIELDS:
        d, h = getattr(dev, f), getattr(host, f)
        if f in ("empty_offset", "empty_offset_ptr"):
            continue
        assert (d is None) == (h is None), f
        if d is not None:
            assert d.dtype == h.dtype, f
            np.testing.assert_array_equal(_np(d), _np(h), err_msg=f)
    dirty = host.tile_dirty.numpy()
    h_ptr, h_eo = host.empty_offset_ptr.numpy(), host.empty_offset.numpy()
    w = dev.empty_offset.shape[0] // dev.num_tiles
    d_eo = dev.empty_offset.numpy().reshape(dev.num_tiles, w)
    np.testing.assert_array_equal(dev.empty_offset_ptr.numpy(), np.cumsum(np.r_[0, dirty * w]))
    for t in range(dev.num_tiles):
        vals = h_eo[h_ptr[t]: h_ptr[t + 1]]
        np.testing.assert_array_equal(d_eo[t, : len(vals)], vals, err_msg=str(t))
        assert not d_eo[t, len(vals):].any()


def _same_as_jax(dev, jdev):
    for f in STATIC_FIELDS:
        if f == "config":
            c = jdev.config
            assert (c.omega, c.sigma, c.tiles_per_block) == (
                dev.config.omega, dev.config.sigma, dev.config.tiles_per_block)
        else:
            assert getattr(dev, f) == getattr(jdev, f), f
    for f in PLANE_FIELDS:
        d, j = getattr(dev, f), getattr(jdev, f)
        assert (d is None) == (j is None), f
        if d is not None:
            np.testing.assert_array_equal(_np(d), np.asarray(j), err_msg=f)


# ---------------------------------------------------------------------------
# the stages against their JAX twins
# ---------------------------------------------------------------------------


@pytest.fixture(params=sorted(CASES))
def case(request):
    return request.param, _ints(CASES[request.param]())


def _stage_inputs(a, sigma):
    cfg = CSR5Config(sigma=sigma, tiles_per_block=8)
    st = cd.plan_statics(a.indptr, a.indices, a.shape, cfg)
    rp = torch.from_numpy(a.indptr.astype(np.int64))
    return cfg, st, rp, jnp.asarray(a.indptr, jnp.int64)


@pytest.mark.parametrize("sigma", [8, 16, 24])
def test_pointer_dirty_heads_descriptor_match_jax(case, sigma):
    _, a = case
    cfg, st, rp, jrp = _stage_inputs(a, sigma)
    p, T = st.p_pad, cfg.tile_nnz
    tp = convert.tile_partition_pointer(rp, p, T)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jconvert.tile_partition_pointer(jrp, p, T)))
    dirty = convert.tile_dirty_flags(rp, tp)
    jdirty = jconvert.tile_dirty_flags(jrp.astype(jnp.int32), jnp.asarray(tp.numpy()))
    np.testing.assert_array_equal(dirty.numpy(), np.asarray(jdirty))
    heads = cd.tile_heads(rp, p, T)
    np.testing.assert_array_equal(heads.numpy(), np.asarray(jcd.tile_heads(jrp, p, T)))
    got = cd.tile_descriptor(heads, p, sigma, 128)
    want = jcd.tile_descriptor(jnp.asarray(heads.numpy()), p, sigma, 128)
    for g, w, name in zip(got, want, ("bit_flag", "y_offset", "seg_offset", "nseg")):
        np.testing.assert_array_equal(_np(g), np.asarray(w), err_msg=name)
    assert got[0].dtype == torch.uint32


def test_empty_offsets_match_jax(case):
    name, a = case
    cfg, st, rp, jrp = _stage_inputs(a, 8)
    p, T = st.p_pad, cfg.tile_nnz
    tp = convert.tile_partition_pointer(rp, p, T)
    dirty = convert.tile_dirty_flags(rp, tp)
    heads = cd.tile_heads(rp, p, T)
    w = max(st.eo_width, 1)
    got = cd.tile_empty_offsets(rp, heads, dirty, tp, p, T, w)
    want = jcd.tile_empty_offsets(jrp, jnp.asarray(heads.numpy()), jnp.asarray(dirty.numpy()),
                                  jnp.asarray(tp.numpy()), p, T, w)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if name == "powerlaw_empty_rows":
        assert dirty.any() and got.any()


@pytest.mark.parametrize("win_rel", [True, False], ids=["wrapped", "aligned"])
def test_window_maps_match_jax(case, win_rel):
    _, a = case
    cfg, st, rp, jrp = _stage_inputs(a, 16)
    p, T, m = st.p_pad, cfg.tile_nnz, a.shape[0]
    tp = convert.tile_partition_pointer(rp, p, T)
    capw = st.capw if win_rel else cd.plan_statics(
        a.indptr, a.indices, a.shape, cfg, win_mode="aligned").capw
    got = cd.tile_window_maps(rp, tp, p, T, m, 16, capw, win_rel)
    want = jcd.tile_window_maps(jrp, jnp.asarray(tp.numpy()), p, T, m, 16, capw, win_rel)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _col2d(a, p, T):
    flat = np.zeros(p * T, np.int32)
    flat[: a.nnz] = a.indices
    flat[a.nnz:] = a.indices[-1]
    return flat.reshape(p, T)


@pytest.mark.parametrize("contig", [True, False], ids=["contig", "list"])
def test_page_lists_and_packed_columns_match_jax(case, contig):
    name, a = case
    cfg, st, _, _ = _stage_inputs(a, 16)
    p, T = st.p_pad, cfg.tile_nnz
    n_pad = -(-a.shape[1] // 128) * 128
    sentinel = n_pad // 128
    # the lists of every tile, in either mode (contig takes the span's width)
    pmax = st.pmax if st.pages_contig == contig else (
        max(st.pmax, 2) if contig else 8 * (-(-(sentinel + 1) // 8)))
    if contig and pmax > sentinel + 1:
        pytest.skip(f"{name}: its page span does not fit a contiguous slab")
    c2 = _col2d(a, p, T)
    pages, cnt = cd.tile_page_lists(torch.from_numpy(c2), pmax, sentinel, contig)
    jpages, jcnt = jcd.tile_page_lists(jnp.asarray(c2), pmax, sentinel, contig)
    np.testing.assert_array_equal(pages.numpy(), np.asarray(jpages))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(jcnt))
    if contig and st.pages_contig != contig:
        return  # a slab narrower than the span: not a valid packing
    got = cd.packed_columns(torch.from_numpy(c2), pages, 16, 128, contig)
    want = jcd.packed_columns(jnp.asarray(c2), jpages, 16, 128, contig)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_payload_matches_jax():
    flat = np.arange(4 * 128 * 8, dtype=np.int32)
    np.testing.assert_array_equal(
        cd.tile_payload(torch.from_numpy(flat), 8, 128).numpy(),
        np.asarray(jcd.tile_payload(jnp.asarray(flat), 8, 128)),
    )


@pytest.mark.parametrize("win_mode", ["auto", "aligned"])
@pytest.mark.parametrize("sigma", [None, 8, 16, 24])
def test_plan_statics_match_jax(case, sigma, win_mode):
    _, a = case
    cfg = None if sigma is None else CSR5Config(sigma=sigma, tiles_per_block=8)
    jcfg = None if sigma is None else J.CSR5Config(sigma=sigma, tiles_per_block=8)
    got = cd.plan_statics(a.indptr, a.indices, a.shape, cfg, win_mode=win_mode)
    want = jcd.plan_statics(a.indptr, a.indices, a.shape, jcfg, win_mode=win_mode)
    assert got._fields == want._fields
    for f in got._fields:
        if f == "config":
            assert (got.config.sigma, got.config.tiles_per_block) == (
                want.config.sigma, want.config.tiles_per_block)
        else:
            assert getattr(got, f) == getattr(want, f), f


# ---------------------------------------------------------------------------
# the orchestrator against the JAX one and the host build
# ---------------------------------------------------------------------------


def test_device_build_matches_host_and_jax(case):
    _, a = case
    _, dev = _device(a)
    _same_as_host(dev, build_csr5(a, keep_raw_cols=True, device="cpu"))
    _same_as_jax(dev, _jax_device(a)[1])


@pytest.mark.parametrize("sigma", [8, 16, 24])
def test_device_build_sigmas(sigma):
    a = _ints(synth.power_law(600, 500, 7.0, seed=5))
    cfg = CSR5Config(sigma=sigma, tiles_per_block=8)
    _, dev = _device(a, cfg)
    _same_as_host(dev, build_csr5(a, cfg, keep_raw_cols=True, device="cpu"))
    _same_as_jax(dev, _jax_device(a, cfg)[1])
    assert (dev.col_packed is not None) == (sigma == 16)


def test_device_empty_offsets_are_padded_per_dirty_tile():
    a = _ints(CASES["powerlaw_empty_rows"]())
    st, dev = _device(a)
    assert dev.tile_dirty.any() and st.eo_width > 0
    assert dev.empty_offset.shape[0] == dev.num_tiles * st.eo_width
    assert int(dev.empty_offset_ptr[-1]) == int(dev.tile_dirty.sum()) * st.eo_width
    _same_as_host(dev, build_csr5(a, keep_raw_cols=True, device="cpu"))


def test_device_build_aligned_mode():
    a = _ints(CASES["banded"]())
    _, dev = _device(a, win_mode="aligned")
    host = build_csr5(a, win_mode="aligned", keep_raw_cols=True, device="cpu")
    assert not dev.win_rel and dev.capw == host.capw
    _same_as_host(dev, host)
    _same_as_jax(dev, _jax_device(a, win_mode="aligned")[1])


def test_device_build_keeps_the_value_dtype():
    a = sp.csr_matrix(synth.banded(700, 9))  # float64 values
    st = cd.plan_statics(a.indptr, a.indices, a.shape)
    dev = cd.build_csr5_device(a.indptr, a.indices, a.data, st, device="cpu")
    assert dev.val_tiles.dtype == torch.float64 and dev.col_idx_tiles is not None
    x = torch.from_numpy(synth.dense_x(700, dtype=np.float64))
    np.testing.assert_array_equal(csr5_spmv_torch(dev, x).numpy(), a @ x.numpy())


def test_device_build_needs_a_device():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    a = _ints(CASES["banded"]())
    st = cd.plan_statics(a.indptr, a.indices, a.shape)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cd.build_csr5_device(a.indptr, a.indices, a.data, st)


@pytest.mark.parametrize("sigma", [8, 16, 24])
def test_device_built_matrix_through_the_consumers(case, sigma):
    """y exact through the plain executors (K1/K1p's and K2's), the round
    trip to CSR, the byte model and the tile printer, all as on the host
    build of the same matrix."""
    name, a = case
    cfg = CSR5Config(sigma=sigma, tiles_per_block=8)
    _, dev = _device(a, cfg)
    host = build_csr5(a, cfg, keep_raw_cols=True, device="cpu")
    x = torch.from_numpy(synth.dense_x(a.shape[1], dtype=np.float32))
    y = csr5_spmv_torch(dev, x)
    np.testing.assert_array_equal(y.numpy(), (a @ x.numpy()).astype(np.float32))
    if dev.col_packed is not None:
        assert torch.equal(csr5_spmv_packed_torch(dev, x), y)
    xm = torch.from_numpy(np.random.default_rng(1).integers(1, 10, (a.shape[1], 3)).astype(np.float32))
    np.testing.assert_array_equal(csr5_spmm_torch(dev, xm, -1.5).numpy(), -1.5 * (a @ xm.numpy()))
    back = convert.csr5_to_csr(dev)
    for f, want in (("row_ptr", a.indptr), ("col_idx", a.indices), ("values", a.data)):
        np.testing.assert_array_equal(getattr(back, f).numpy(), want, err_msg=f)
    assert perf.streamed_bytes(dev, x) == perf.streamed_bytes(host, x)
    for t in sorted({0, dev.num_tiles - 1}):
        assert debug.tile_to_string(dev, t) == debug.tile_to_string(host, t), name


# ---------------------------------------------------------------------------
# the raw column plane: keep_raw_cols and the 2 B/nnz upload
# ---------------------------------------------------------------------------


def _scattered_wide():
    """Columns over 32 x pages: the page lists are not contiguous."""
    return _ints(synth.random_csr(400, 4000, 0.01, seed=4))


@pytest.mark.parametrize("sigma", [8, 24])
@pytest.mark.parametrize("name", ["banded", "scattered", "wide"])
def test_decode_route_rebuilds_the_raw_plane(monkeypatch, name, sigma):
    """The 2 B/nnz route, run on CPU tensors with its threshold lowered:
    the host plan builds the codes the card would receive, and the decode
    gives the raw plane bit for bit, every other plane unchanged."""
    if not nativelib.available():
        pytest.skip("the route needs the native packer")
    monkeypatch.setattr(convert, "DEVICE_DECODE_MIN_NNZ", 0)
    a = _scattered_wide() if name == "wide" else _ints(CASES[name]())
    cfg = CSR5Config(sigma=sigma, tiles_per_block=8)
    ph = convert._Phases()
    hp = convert._host_plan(a.indptr.astype(np.int64), a.indices, a.data, *a.shape, cfg,
                            "auto", ph, keep_raw_cols=False, device="cuda")
    assert hp.decode and hp.col16 is not None and hp.pages_contig == (name != "wide")
    routed = convert._transpose_upload(hp, a.data, None, torch.device("cpu"), ph, keep_raw_cols=False)
    assert "decode" in convert.last_convert_phases
    up = convert.last_convert_phases["upload_mb"] * 1e6
    raw = build_csr5(a, cfg, keep_raw_cols=True, device="cpu")
    assert "decode" not in convert.last_convert_phases
    assert routed.col_packed is None and torch.equal(routed.col_idx_tiles, raw.col_idx_tiles)
    for f in PLANE_FIELDS:
        g, h = getattr(routed, f), getattr(raw, f)
        assert (g is None and h is None) or torch.equal(_as_i32(g), _as_i32(h)), f
    # the codes rode the upload in place of the 4 B/nnz columns
    assert up == routed.val_tiles.numel() * 4 + routed.col_idx_tiles.numel() * 2


def test_odd_sigma_refused_by_the_decode_gate(monkeypatch):
    """An odd sigma pairs rows (s, s + sigma // 2) and has no word for row
    sigma - 1: the gate refuses it, where the JAX gate (``convert.py:415``)
    lets it through at 30M nonzeros and more."""
    big = convert.DEVICE_DECODE_MIN_NNZ
    assert convert.decode_on_card(big, 24, False, "cuda")
    assert not convert.decode_on_card(big, 25, False, "cuda")
    assert not convert.decode_on_card(big, 9, False, "cuda")
    assert not convert.decode_on_card(big, 16, False, "cuda")  # col_packed instead
    assert not convert.decode_on_card(big, 24, True, "cuda")
    assert not convert.decode_on_card(big - 1, 24, False, "cuda")
    assert not convert.decode_on_card(big, 24, False, "cpu")
    if not nativelib.available():
        return
    monkeypatch.setattr(convert, "DEVICE_DECODE_MIN_NNZ", 0)
    a = _scattered_wide()
    cfg = CSR5Config(sigma=9, tiles_per_block=8)
    hp = convert._host_plan(a.indptr.astype(np.int64), a.indices, a.data, *a.shape, cfg,
                            "auto", convert._Phases(), keep_raw_cols=False, device="cuda")
    assert not hp.decode and hp.col16 is None
    raw = build_csr5(a, cfg, keep_raw_cols=False, device="cpu")
    assert raw.col_idx_tiles is not None and raw.col_packed is None
    # what the JAX gate would have uploaded: 4 words for 9 rows
    col16 = nativelib.col_local_packed(hp.col_flat, hp.p_pad, cfg.tile_nnz, hp.n_pad // 128 + 1)
    pk = torch.from_numpy(nativelib.pack_col16(col16, hp.p_pad, 9, 128).copy())
    dec = decode_packed_codes(pk, raw.pages)
    assert pk.shape[1] == 4 and dec.shape[1] == 8 and raw.col_idx_tiles.shape[1] == 9
    assert torch.equal(dec, raw.col_idx_tiles[:, :8])  # row 8 is lost


@pytest.mark.parametrize("value_dtype", [None, "auto"])
@pytest.mark.parametrize("name", ["banded", "scattered", "random"])
def test_dropped_raw_plane_through_every_plain_consumer(name, value_dtype):
    a = _ints(CASES[name]())
    cfg = CSR5Config(sigma=16, tiles_per_block=8)
    lean = build_csr5(a, cfg, value_dtype=value_dtype, device="cpu")
    full = build_csr5(a, cfg, value_dtype=value_dtype, keep_raw_cols=True, device="cpu")
    assert lean.col_packed is not None and lean.col_idx_tiles is None
    assert torch.equal(col_tiles_of(lean), full.col_idx_tiles)
    x = torch.from_numpy(synth.dense_x(a.shape[1], dtype=np.float32))
    xm = torch.from_numpy(np.random.default_rng(2).integers(1, 10, (a.shape[1], 4)).astype(np.float32))
    assert torch.equal(csr5_spmv_torch(lean, x, -1.75), csr5_spmv_torch(full, x, -1.75))
    assert torch.equal(csr5_spmv_packed_torch(lean, x), csr5_spmv_torch(full, x))
    for layout in ("nr", "rn"):
        xin = xm.T.contiguous() if layout == "rn" else xm
        assert torch.equal(csr5_spmm_torch(lean, xin, 2.0, layout), csr5_spmm_torch(full, xin, 2.0, layout))
    for f in ("row_ptr", "col_idx", "values"):
        assert torch.equal(getattr(convert.csr5_to_csr(lean), f), getattr(convert.csr5_to_csr(full), f))
    assert debug.tile_to_string(lean, 0) == debug.tile_to_string(full, 0)
    assert perf.streamed_bytes(lean, x) == perf.streamed_bytes(full, x)  # K1p reads no raw plane
    for f in PLANE_FIELDS:
        if f != "col_idx_tiles":
            g, h = getattr(lean, f), getattr(full, f)
            assert (g is None and h is None) or torch.equal(_as_i32(g), _as_i32(h)), f


def _as_i32(t):
    return t.view(torch.int32) if t.dtype == torch.uint32 else t


def test_raw_plane_kept_where_it_is_read():
    """float64 planes (K4), sigma % 16 != 0 (no col_packed) and the
    autotuned build at sigma 16 follow the same rule as the JAX package."""
    a = _ints(synth.banded(900, 27))
    assert build_csr5(a, CSR5Config(sigma=16), value_dtype=torch.float64,
                      device="cpu").col_idx_tiles is not None
    assert build_csr5(a, CSR5Config(sigma=24), device="cpu").col_idx_tiles is not None
    fem = sp.csr_matrix(synth.fem_blocks(3000)).astype(np.float32)
    tuned = build_csr5_autotuned(fem, device="cpu")
    jt = J.build_csr5_autotuned(J.csr_from_scipy(fem))
    assert tuned.sigma == jt.config.sigma == 16
    assert (tuned.col_idx_tiles is None) == (jt.col_idx_tiles is None) == (tuned.col_packed is not None)
