"""The packed column stream (K1p, K2p) of the port against the JAX package.

Where sigma % 16 == 0 and every tile addresses at most 512 x pages, the
conversion builds ``col_packed`` (two uint16 codes ``lane | local_page <<
7`` per int32 word, rows s and s + sigma/2) with the page lists ``pages``,
and the JAX kernel streams it (``csr5_kernel.py:816-820``); the port's
kernels K1p and K2p do the same. Here, on the CPU:

- the port's packed planes and page lists equal the JAX
  ``build_csr5(..., keep_raw_cols=True)`` ones, at sigma 16 and 32, with
  contiguous and scattered page lists, pmax up to 512, a ragged tail tile
  and both window modes;
- the plain versions of K1p and K2p, which decode the columns from
  ``col_packed`` even where the raw plane is present, equal the raw-plane
  plain versions, the JAX Pallas kernel in interpret mode
  (``tiles_per_block=8``) and scipy, exactly on integer data;
- the wrappers' checks of the packed planes, and K2p's shared memory.

Tolerances: integer data (values and x in 1-9) is exact in every
executor; random floats are held to 1e-5 of each row's |A| @ |x|.
"""

import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import benchmark_spmv_using_csr5_tpu as J
import benchmark_spmv_using_csr5_tpu_torch as P
from benchmark_spmv_using_csr5_tpu.ops.csr5_kernel import csr5_spmm_pallas, csr5_spmv_pallas
from benchmark_spmv_using_csr5_tpu.ops.csr5_spmv import csr5_spmm_xla
from benchmark_spmv_using_csr5_tpu_torch.bench import harness
from benchmark_spmv_using_csr5_tpu_torch.ops import csr5_kernel
from benchmark_spmv_using_csr5_tpu_torch.utils import cuda_build, synth

FLOAT_RTOL = 1e-5


def _ints(a_sp, seed=0):
    """``a_sp`` as float32 CSR with integer values 1-9."""
    a = sp.csr_matrix(a_sp).astype(np.float32)
    a.data = np.random.default_rng(seed).integers(1, 10, a.nnz).astype(np.float32)
    return a


def _page512():
    """1000 rows of 16 random columns over 512 x pages (65,536 columns):
    every tile touches up to 512 distinct pages, so pmax reaches 512."""
    rng = np.random.default_rng(5)
    rows = np.repeat(np.arange(1000), 16)
    cols = rng.integers(0, 512 * 128, rows.size)
    return sp.csr_matrix((np.ones(rows.size), (rows, cols)), shape=(1000, 512 * 128))


#: name -> scipy matrix; every one ends in a ragged tail tile
MATRICES = {
    "banded": lambda: synth.banded(3001, 27),  # contiguous pages
    "scatband": lambda: synth.scattered_band(3000, 12, 1800),  # scattered lists
    "powerlaw": lambda: synth.power_law(2000, 2000, 9.0),  # empty rows, scattered
    "page512": _page512,
}


def _pair(a, sigma, win_mode="auto", value_dtype=None):
    host = (a.indptr, a.indices, a.data, a.shape)
    a5j = J.build_csr5(
        host, J.CSR5Config(sigma=sigma, tiles_per_block=8), value_dtype=value_dtype,
        win_mode=win_mode, keep_raw_cols=True,
    )
    a5p = P.build_csr5(
        host, P.CSR5Config(sigma=sigma, tiles_per_block=8), value_dtype=value_dtype,
        win_mode=win_mode, device="cpu",
    )
    return a5j, a5p


@pytest.mark.parametrize("win_mode", ["auto", "aligned"])
@pytest.mark.parametrize("sigma", [16, 32])
@pytest.mark.parametrize("name", list(MATRICES))
def test_packed_planes_match_jax(name, sigma, win_mode):
    a = _ints(MATRICES[name]())
    a5j, a5p = _pair(a, sigma, win_mode)
    assert a5p.col_packed is not None and a5j.col_packed is not None
    assert a5p.nnz_stored % (sigma * 128) != 0  # a ragged tail tile
    for f in ("col_packed", "pages", "page_cnt", "col_idx_tiles", "win_map"):
        np.testing.assert_array_equal(getattr(a5p, f).numpy(), np.asarray(getattr(a5j, f)), f)
    assert (a5p.pmax, a5p.pages_contig, a5p.capw) == (a5j.pmax, a5j.pages_contig, a5j.capw)
    assert a5p.pages_contig == (name == "banded")
    if name == "page512":
        assert a5p.pmax == 512
    # the decode is an exact inverse of the packing
    assert torch.equal(P.col_tiles_from_packed(a5p), a5p.col_idx_tiles)


@pytest.mark.parametrize("sigma", [8, 24])
def test_no_packed_plane_off_sigma16(sigma):
    """sigma % 16 != 0: neither package builds col_packed, so K1 runs."""
    a5j, a5p = _pair(_ints(synth.banded(2000, 27)), sigma)
    assert a5p.col_packed is None and a5j.col_packed is None
    with pytest.raises(ValueError, match="no col_packed"):
        P.col_tiles_from_packed(a5p)


def test_no_packed_plane_beyond_512_pages():
    """More than 512 distinct pages in a tile: no packed plane in either."""
    rng = np.random.default_rng(2)
    rows = np.repeat(np.arange(600), 16)
    a = _ints(sp.csr_matrix(
        (np.ones(rows.size), (rows, rng.integers(0, 4096 * 128, rows.size))),
        shape=(600, 4096 * 128)))
    a5j, a5p = _pair(a, 16)
    assert a5p.pmax > 512 and a5p.col_packed is None and a5j.col_packed is None


@pytest.mark.parametrize("alpha", [1.0, -1.75])
@pytest.mark.parametrize("sigma", [16, 32])
@pytest.mark.parametrize("name", list(MATRICES))
def test_packed_plain_spmv_matches_jax(name, sigma, alpha):
    a = _ints(MATRICES[name]())
    a5j, a5p = _pair(a, sigma)
    x = synth.dense_x(a.shape[1], dtype=np.float32)
    xt = torch.from_numpy(x)
    y = P.csr5_spmv_packed_torch(a5p, xt, alpha).numpy()
    np.testing.assert_array_equal(y, P.csr5_spmv_torch(a5p, xt, alpha).numpy())
    np.testing.assert_array_equal(y, (alpha * (a @ x)).astype(np.float32))
    # the JAX kernel streams col_packed whenever it exists
    a5j_packed = J.build_csr5(
        (a.indptr, a.indices, a.data, a.shape), J.CSR5Config(sigma=sigma, tiles_per_block=8)
    )
    assert a5j_packed.col_idx_tiles is None and a5j_packed.col_packed is not None
    np.testing.assert_array_equal(
        y, np.asarray(csr5_spmv_pallas(a5j_packed, x, alpha=alpha, interpret=True))
    )


@pytest.mark.parametrize("layout", ["nr", "rn"])
@pytest.mark.parametrize("name", ["banded", "scatband", "page512"])
def test_packed_plain_spmm_matches_jax(name, layout):
    a = _ints(MATRICES[name]())
    a5j, a5p = _pair(a, 16)
    xm = np.random.default_rng(3).integers(1, 10, (a.shape[1], 4)).astype(np.float32)
    xin = torch.from_numpy(xm.T.copy() if layout == "rn" else xm)
    y = P.csr5_spmm_packed_torch(a5p, xin, -1.75, layout).numpy()
    if layout == "rn":
        y = y.T
    np.testing.assert_array_equal(y, (-1.75 * (a @ xm)).astype(np.float32))
    np.testing.assert_array_equal(y, P.csr5_spmm_torch(a5p, torch.from_numpy(xm), -1.75).numpy())
    np.testing.assert_array_equal(y, np.asarray(csr5_spmm_xla(a5j, xm, alpha=-1.75)))


def test_packed_spmm_matches_jax_pallas():
    """K2p's plain version against the JAX multi-rhs kernel on its packed
    stream (interpret mode; the slow one, so one case)."""
    a = _ints(synth.scattered_band(1500, 12, 900))
    host = (a.indptr, a.indices, a.data, a.shape)
    a5j = J.build_csr5(host, J.CSR5Config(sigma=16, tiles_per_block=8))
    a5p = P.build_csr5(host, P.CSR5Config(sigma=16, tiles_per_block=8), device="cpu")
    assert a5j.col_packed is not None
    xm = np.random.default_rng(4).integers(1, 10, (a.shape[1], 2)).astype(np.float32)
    y = P.csr5_spmm_packed_torch(a5p, torch.from_numpy(xm), 0.5).numpy()
    np.testing.assert_array_equal(y, np.asarray(csr5_spmm_pallas(a5j, xm, alpha=0.5, interpret=True)))


@pytest.mark.parametrize("sigma", [16, 32])
def test_packed_random_floats(sigma):
    """Random floats: the packed and raw plain versions run the same
    arithmetic (bit-equal); scipy in float64 within the stated rtol."""
    a = sp.csr_matrix(synth.scattered_band(4000, 20, 2000)).astype(np.float32)
    rng = np.random.default_rng(9)
    a.data = rng.uniform(-1, 1, a.nnz).astype(np.float32)
    x = rng.uniform(-1, 1, a.shape[1]).astype(np.float32)
    a5p = P.build_csr5(a, P.CSR5Config(sigma=sigma), device="cpu")
    assert a5p.col_packed is not None
    y = P.csr5_spmv_packed_torch(a5p, torch.from_numpy(x)).double().numpy()
    assert np.array_equal(y, P.csr5_spmv_torch(a5p, torch.from_numpy(x)).double().numpy())
    y64 = a.astype(np.float64) @ x.astype(np.float64)
    row_abs = abs(a).astype(np.float64) @ np.abs(x).astype(np.float64)
    assert (np.abs(y - y64) <= FLOAT_RTOL * row_abs + 1e-30).all()


def test_carried_packed_matrix_decodes():
    """A JAX matrix without the raw plane carries across: the port decodes
    the raw plane from col_packed and keeps col_packed for K1p."""
    a = _ints(synth.scattered_band(2000, 16, 1500))
    a5j = J.build_csr5((a.indptr, a.indices, a.data, a.shape), J.CSR5Config(sigma=16))
    planes = {f: None if getattr(a5j, f) is None else np.asarray(getattr(a5j, f))
              for f in P.models.formats.PLANE_FIELDS}
    static = {f: getattr(a5j, f) for f in P.models.formats.STATIC_FIELDS}
    a5p = P.csr5_from_numpy(planes, static, device="cpu")
    assert a5j.col_idx_tiles is None and a5p.col_packed is not None
    x = synth.dense_x(a.shape[1], dtype=np.float32)
    y = P.csr5_spmv_packed_torch(a5p, torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(y, (a @ x).astype(np.float32))


def _packed_matrix():
    return P.build_csr5(_ints(synth.scattered_band(2000, 16, 1500)), P.CSR5Config(sigma=16), device="cpu")


@pytest.mark.parametrize(
    "change,match",
    [
        (lambda a5: dict(pmax=600), "pmax <= 512"),
        (lambda a5: dict(pages=a5.pages.long()), "pages has dtype"),
        (lambda a5: dict(col_packed=a5.col_packed[:, :4].contiguous()), "col_packed has shape"),
        (lambda a5: dict(num_tiles=2**26), "below 2\\*\\*31"),
    ],
    ids=["pmax", "pages-dtype", "packed-shape", "int32"],
)
def test_packed_plane_checks_raise(change, match):
    a5 = _packed_matrix()
    csr5_kernel._expect_planes(a5, a5.device, "t")  # the matrix as built passes
    with pytest.raises(ValueError, match=match):
        csr5_kernel._expect_planes(dataclasses.replace(a5, **change(a5)), a5.device, "t")


@pytest.mark.parametrize("call", ["spmv", "spmm"])
def test_packed_kernels_refuse_cpu_tensors(call):
    """The wrappers raise on CPU tensors before any build, and the CPU
    dispatch runs the plain versions without counting a launch."""
    a5 = _packed_matrix()
    before = (csr5_kernel.packed_launches, csr5_kernel.spmm_packed_launches)
    x = torch.ones(a5.n) if call == "spmv" else torch.ones(a5.n, 3)
    with pytest.raises(ValueError, match="CUDA tensors"):
        (csr5_kernel.csr5_spmv_cuda if call == "spmv" else csr5_kernel.csr5_spmm_cuda)(a5, x)
    y = (P.csr5_spmv if call == "spmv" else P.csr5_spmm)(a5, x)
    assert y.shape[0] == a5.m
    assert (csr5_kernel.packed_launches, csr5_kernel.spmm_packed_launches) == before
    assert "csr5_spmv" not in cuda_build.loaded() and "csr5_spmm" not in cuda_build.loaded()


def test_k2p_shared_memory():
    """K2p's shared memory adds the high codes of the packed words, and the
    chunk still fits the budget."""
    a5 = _packed_matrix()
    nends = min(a5.capw, a5.sigma * 128)
    raw = csr5_kernel.spmm_smem_bytes(a5.sigma, nends, 8)
    assert csr5_kernel.spmm_smem_bytes(a5.sigma, nends, 8, packed=True) == (
        raw + a5.sigma // 2 * 128 * 2
    )
    for R in (1, 8, 16, 17):
        rc = csr5_kernel.spmm_chunk(a5, R)
        assert csr5_kernel.spmm_smem_bytes(a5.sigma, nends, rc, True) <= csr5_kernel.SPMM_SMEM_BUDGET
        # a staged launch adds the window of pmax pages; K2p stages whenever
        # that still fits the budget (its codes are already window slots)
        staged = csr5_kernel.spmm_smem_bytes(a5.sigma, nends, rc, True, a5.pmax)
        assert staged == csr5_kernel.spmm_smem_bytes(a5.sigma, nends, rc, True) + (
            rc * csr5_kernel.spmm_plane_floats(a5.pmax) * 4
        )
        want = "staged" if staged <= csr5_kernel.SPMM_SMEM_BUDGET else "gathered"
        assert csr5_kernel.spmm_mode(a5, R) == want
    # this scattered band's 16 pages stage one rhs, not eight
    assert (csr5_kernel.spmm_mode(a5, 1), csr5_kernel.spmm_mode(a5, 8)) == ("staged", "gathered")


def test_harness_counts_every_kernel():
    keys = harness.kernel_launches()
    for k in ("csr5_spmv", "csr5_spmv_packed", "csr5_spmm", "csr5_spmm_packed", "csr5_sliced"):
        assert k in keys
