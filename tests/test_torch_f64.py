"""The port's float64 path against the JAX package's.

The JAX package runs float64 two ways: ``build_csr5`` keeps a float64
value plane under x64 (``csr5_spmv_xla`` then sums in float64), and
``build_df64`` splits the values into float32 (hi, lo) planes for the
double-single TPU kernel ``_df64_kernel`` (K4). The port keeps one
float64 plane (``build_csr5(..., value_dtype=torch.float64)``) and runs
K4 as native fp64 on the card; here, on the CPU, its plain version
``csr5_spmv_torch`` runs on that plane.

Tolerances:

- planes: equal element for element (the hi and lo planes are the float32
  roundings of the port's plane and of its remainder);
- integer-valued data (values and x in 1-9): every partial sum is an
  integer below 2**53, so the plain K4 and the JAX x64 executor agree
  exactly;
- random floats: the two sum each tile's prefix in another order, so a
  row's difference is bounded by a few units of 2**-53 times the mass of
  the tiles it spans: ``FLOAT_RTOL`` = 1e-13 of ``_tile_scale`` (the row's
  |A||x| or, when larger, its tiles' mass, as ``tests/test_df64.py``
  measures the df64 kernel);
- against scipy float64 on ``tests/test_df64.py``'s matrices: below 1e-12
  of ``_tile_scale`` and no larger than the JAX df64 kernel's own error.
"""

import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import benchmark_spmv_using_csr5_tpu as J
import benchmark_spmv_using_csr5_tpu_torch as P
from benchmark_spmv_using_csr5_tpu.ops.csr5_df64 import build_df64, df64_combine, df64_spmv
from benchmark_spmv_using_csr5_tpu_torch.models.formats import PLANE_FIELDS, STATIC_FIELDS
from benchmark_spmv_using_csr5_tpu_torch.ops import csr5_f64
from benchmark_spmv_using_csr5_tpu_torch.utils import cuda_build, synth

FLOAT_RTOL = 1e-13
DF64_BOUND = 1e-12


def _host64(a_sp):
    a = sp.csr_matrix(a_sp).astype(np.float64)
    return a, (a.indptr, a.indices, a.data, a.shape)


def _f64_values(a_sp, seed=0):
    """``tests/test_df64.py``'s values: non-dyadic, 7 decades."""
    rng = np.random.default_rng(seed)
    a = sp.csr_matrix(a_sp).astype(np.float64)
    a.data = rng.uniform(0.1, 1.0, a.nnz) * 10.0 ** rng.integers(-3, 4, a.nnz)
    return a


def _tile_scale(a_sp, x, sigma):
    """max(row |A||x|, the largest |A||x| mass of the tiles the row
    spans): the structural denominator of ``tests/test_df64.py``."""
    T = sigma * 128
    prods = np.abs(a_sp.data) * np.abs(x)[a_sp.indices]
    nt = max(1, -(-len(prods) // T))
    pad = np.zeros(nt * T)
    pad[: len(prods)] = prods
    tile_mass = pad.reshape(nt, T).sum(axis=1)
    rp = a_sp.indptr
    t0 = np.minimum(rp[:-1] // T, nt - 1)
    t1 = np.minimum(np.maximum(rp[1:] - 1, rp[:-1]) // T, nt - 1)
    row = np.abs(a_sp).dot(np.abs(x))
    return np.maximum(np.maximum(row, np.maximum(tile_mass[t0], tile_mass[t1])), 1e-300)


def _port64(host, cfg, **kw):
    return P.build_csr5(host, cfg, value_dtype=torch.float64, device="cpu", **kw)


@pytest.mark.parametrize("win_mode", ["auto", "aligned"])
@pytest.mark.parametrize("sigma", [8, 24])
def test_f64_planes_match_jax_x64_and_df64(edge_matrix, sigma, win_mode):
    """Every plane equals the JAX x64 build's; the float32 rounding of
    the value plane is the df64 hi plane, and that of the remainder the
    lo plane."""
    name, a_sp = edge_matrix
    a, host = _host64(a_sp)
    a.data = _f64_values(a, seed=4).data
    host = (a.indptr, a.indices, a.data, a.shape)
    a5p = _port64(host, P.CSR5Config(sigma=sigma), win_mode=win_mode)
    a5j = J.build_csr5(host, J.CSR5Config(sigma=sigma), win_mode=win_mode, keep_raw_cols=True)
    planes, static = P.csr5_to_numpy(a5p)
    assert static["value_dtype"] == "float64"
    for f in PLANE_FIELDS:
        ref = getattr(a5j, f)
        if ref is None:
            assert planes[f] is None, f
            continue
        ref = np.asarray(ref)
        assert planes[f].dtype == ref.dtype, (name, f)
        np.testing.assert_array_equal(planes[f], ref, err_msg=f"{name} {f}")
    for f in STATIC_FIELDS:
        if f != "config":
            assert static[f] == getattr(a5j, f), (name, f)
    if win_mode == "auto":  # build_df64 builds the wrapped maps
        d = build_df64(host, J.CSR5Config(sigma=sigma))
        v = planes["val_tiles"]
        hi = v.astype(np.float32)
        np.testing.assert_array_equal(hi, np.asarray(d.a5.val_tiles), err_msg=name)
        lo = (v - hi.astype(np.float64)).astype(np.float32)
        np.testing.assert_array_equal(lo, np.asarray(d.val_lo_tiles), err_msg=name)
        for f in ("col_idx_tiles", "win_map", "tile_ptr"):
            np.testing.assert_array_equal(planes[f], np.asarray(getattr(d.a5, f)), err_msg=f)


@pytest.mark.parametrize("win_mode", ["auto", "aligned"])
def test_plain_k4_exact_on_integer_data(edge_matrix, win_mode):
    """Integer values and x: the plain K4 equals the JAX x64 executor and
    scipy float64 exactly, at alpha 1 and -1.75."""
    name, a_sp = edge_matrix
    a, host = _host64(a_sp)
    x = synth.dense_x(a.shape[1], dtype=np.float64)
    a5p = _port64(host, None, win_mode=win_mode)
    a5j = J.build_csr5(host, win_mode=win_mode)
    assert np.asarray(a5j.val_tiles).dtype == np.float64
    for alpha in (1.0, -1.75):
        y = P.csr5_spmv(a5p, torch.from_numpy(x), alpha)
        assert y.dtype == torch.float64
        np.testing.assert_array_equal(
            y.numpy(), np.asarray(J.csr5_spmv_xla(a5j, x, alpha=alpha)), err_msg=name
        )
        np.testing.assert_array_equal(y.numpy(), alpha * (a @ x), err_msg=name)


@pytest.mark.parametrize("sigma", [8, 16, 24, 32])
def test_plain_k4_floats_match_jax_x64(sigma):
    """Random mixed-sign floats: the plain K4 and the JAX x64 executor
    within FLOAT_RTOL of each row's tile scale, and both against scipy."""
    rng = np.random.default_rng(sigma)
    a = sp.csr_matrix(synth.banded(4000, 27, dtype=np.float64))
    a.data = rng.uniform(-1, 1, a.nnz) * 10.0 ** rng.integers(-3, 4, a.nnz)
    x = rng.uniform(-1, 1, a.shape[1])
    host = (a.indptr, a.indices, a.data, a.shape)
    y = P.csr5_spmv(_port64(host, P.CSR5Config(sigma=sigma)), torch.from_numpy(x)).numpy()
    y_j = np.asarray(J.csr5_spmv_xla(J.build_csr5(host, J.CSR5Config(sigma=sigma)), x))
    scale = _tile_scale(a, x, sigma)
    assert (np.abs(y - y_j) / scale).max() < FLOAT_RTOL
    assert (np.abs(y - a @ x) / scale).max() < FLOAT_RTOL


@pytest.mark.parametrize(
    "make,alpha",
    [
        (lambda: _f64_values(synth.banded(3000, 9)), 1.0),
        (lambda: _f64_values(synth.banded(1200, 5), seed=3), 2.5),
        (lambda: _f64_values(synth.power_law(900, 900, 6.0), seed=5), 1.0),
        (lambda: _f64_values(synth.scattered_band(1500, 8, 700), seed=7), 1.0),
    ],
    ids=["banded3000", "banded1200-alpha", "powerlaw900", "scatband1500"],
)
def test_plain_k4_beats_jax_df64(make, alpha):
    """On ``tests/test_df64.py``'s matrices and alpha, the float64 plane's
    error against scipy is below DF64_BOUND of the tile scale and no
    larger than the JAX double-single kernel's (interpret mode)."""
    a = make()
    host = (a.indptr, a.indices, a.data, a.shape)
    x = np.random.default_rng(1).uniform(-1.0, 1.0, a.shape[1])
    y_ref = alpha * (a @ x)
    a5p = _port64(host, None)
    y = P.csr5_spmv(a5p, torch.from_numpy(x), alpha).numpy()
    d = build_df64(host)
    y_df = df64_combine(*df64_spmv(d, x, alpha=alpha, interpret=True))
    scale = _tile_scale(a, x, a5p.sigma) * abs(alpha)
    err, err_df = np.abs(y - y_ref) / scale, np.abs(y_df - y_ref) / scale
    assert err.max() < DF64_BOUND
    assert err.max() <= err_df.max()


def test_csr5_from_df64_carries_a_df64_matrix():
    """A JAX DF64CSR5 crosses as f64(hi) + f64(lo): the structure planes
    unchanged, the values within 2**-48 of the original float64 (the
    double-single representation), and y as the df64 kernel's."""
    a = _f64_values(synth.banded(2000, 27), seed=9)
    host = (a.indptr, a.indices, a.data, a.shape)
    d = build_df64(host)
    planes = {f: None if getattr(d.a5, f) is None else np.asarray(getattr(d.a5, f))
              for f in PLANE_FIELDS}
    static = {f: getattr(d.a5, f) for f in STATIC_FIELDS}
    a5 = P.csr5_from_df64(planes, np.asarray(d.val_lo_tiles), static, device="cpu")
    assert a5.val_tiles.dtype == torch.float64
    ref = _port64(host, J.CSR5Config(sigma=d.sigma))
    for f in ("col_idx_tiles", "win_map", "tile_ptr", "row_ptr"):
        assert torch.equal(getattr(a5, f), getattr(ref, f)), f
    v, v_ref = a5.val_tiles.numpy(), ref.val_tiles.numpy()
    assert (np.abs(v - v_ref) <= np.abs(v_ref) * 2.0**-48).all()
    x = np.random.default_rng(2).uniform(-1, 1, a.shape[1])
    y = P.csr5_spmv(a5, torch.from_numpy(x)).numpy()
    y_df = df64_combine(*df64_spmv(d, x, interpret=True))
    assert (np.abs(y - y_df) / _tile_scale(a, x, d.sigma)).max() < DF64_BOUND


def _a5_pair():
    a = sp.csr_matrix(synth.banded(300, 9, dtype=np.float64))
    host = (a.indptr, a.indices, a.data, a.shape)
    return P.build_csr5(host, device="cpu"), _port64(host, None)


@pytest.mark.parametrize(
    "plane,x_dtype",
    [("f32", torch.float64), ("bf16", torch.float64), ("f64", torch.float32)],
)
def test_dispatcher_refuses_mixed_dtypes(plane, x_dtype):
    """float64 x meets only a float64 plane, float32 x only a float32 or
    bfloat16 one: nothing is cast."""
    a32, a64 = _a5_pair()
    a5 = {"f32": a32, "f64": a64}.get(plane)
    if plane == "bf16":
        a5 = P.build_csr5(synth.banded(300, 9), value_dtype="auto", device="cpu")
        assert a5.val_tiles.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="nothing is cast"):
        P.csr5_spmv(a5, torch.ones(300, dtype=x_dtype))


def test_dispatcher_refuses_f64_spmm():
    a32, a64 = _a5_pair()
    for a5, dt in ((a64, torch.float64), (a32, torch.float64), (a64, torch.float32)):
        with pytest.raises(ValueError, match="no float64 SpMM"):
            P.csr5_spmm(a5, torch.ones(300, 2, dtype=dt))


def test_k4_wrapper_refuses_cpu_tensors_and_builds_nothing():
    _, a64 = _a5_pair()
    before = csr5_f64.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        P.csr5_spmv_f64_cuda(a64, torch.ones(300, dtype=torch.float64))
    with pytest.raises(ValueError, match="CUDA tensors"):
        P.csr5_spmv(a64, torch.ones(300, dtype=torch.float64), backend="cuda")
    assert csr5_f64.launches == before
    assert "csr5_spmv_f64" not in cuda_build.loaded()


def test_f64_supported_gate():
    a32, a64 = _a5_pair()
    assert P.f64_supported(a64) and not P.f64_supported(a32)
    a = sp.csr_matrix(synth.banded(3000, 27, dtype=np.float64))
    wide = _port64((a.indptr, a.indices, a.data, a.shape), P.CSR5Config(sigma=232))
    assert not P.f64_supported(wide)
    assert P.f64_supported(_port64((a.indptr, a.indices, a.data, a.shape),
                                   P.CSR5Config(sigma=csr5_f64.MAX_SIGMA)))


def test_k4_shared_memory_mirror_and_gate():
    """K4 keeps the float64 prefix only at the row ends (csrc/csr5_spmv_f64.cu
    ::smem_bytes): nends * 8 B with nends = min(capw, sigma * 128), the 128
    lane carries, and the row-end planes (a uint32 mask and a uint16 count
    per lane and 32 rows). The gate refuses a block that would not fit
    Hopper's 232,448 B beside the static arrays, which at sigma 224 is more
    than 28,248 row ends."""
    assert csr5_f64.f64_smem_bytes(24, 128) == 128 * 8 + 128 * 8 + 768
    assert csr5_f64.f64_smem_bytes(224, 28_672) == 28_672 * 8 + 1024 + 7 * 768
    # at df64_banded500k's shape (sigma 24, capw 128): 2.8 KB, where the whole
    # prefix took (24 + 1) * 128 * 8 = 25.6 KB
    assert csr5_f64.f64_smem_bytes(24, 128) < (24 + 1) * 128 * 8 // 9
    a = sp.csr_matrix(synth.banded(3000, 27, dtype=np.float64))
    a5 = _port64((a.indptr, a.indices, a.data, a.shape), P.CSR5Config(sigma=csr5_f64.MAX_SIGMA))
    assert P.f64_supported(a5)
    assert P.f64_supported(dataclasses.replace(a5, capw=28_248))
    assert not P.f64_supported(dataclasses.replace(a5, capw=28_249))
