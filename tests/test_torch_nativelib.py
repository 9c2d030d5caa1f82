"""The port's native host runtime against its Python twins and the JAX
package: the Matrix Market parser (``load_matrix_market``), the serial
golden-model SpMV (``csr_spmv_serial``) and the tile partition pointer
(``tile_partition_pointer``), mirroring ``tests/test_nativelib.py``.
Parses are exact; the golden model is exact on integer data and within
1e-6 relative of scipy on floats."""

import numpy as np
import pytest
import scipy.io as sio
import scipy.sparse as sp

from benchmark_spmv_using_csr5_tpu.utils import nativelib as jnative
from benchmark_spmv_using_csr5_tpu_torch import build_csr5
from benchmark_spmv_using_csr5_tpu_torch.utils import mmio, nativelib, synth


def _assert_same_load(path):
    rp, ci, v, shape = nativelib.load_matrix_market(str(path))
    assert (rp.dtype, ci.dtype, v.dtype) == (np.int64, np.int32, np.float64)
    rp_p, ci_p, v_p, shape_p = mmio.read_mtx_csr(str(path))
    assert shape == tuple(shape_p)
    np.testing.assert_array_equal(rp, np.asarray(rp_p, np.int64))
    np.testing.assert_array_equal(ci, ci_p)
    np.testing.assert_array_equal(v, v_p)
    rp_j, ci_j, v_j, shape_j = jnative.load_matrix_market(str(path))
    assert shape == tuple(shape_j)
    for got, want in ((rp, rp_j), (ci, ci_j), (v, v_j)):
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype


def _general(tmp_path):
    sio.mmwrite(str(tmp_path / "g"), synth.random_csr(60, 45, 0.08, seed=3).tocoo())
    return tmp_path / "g.mtx"


def _symmetric(tmp_path):
    d = synth.random_csr(40, 40, 0.1, seed=4)
    sio.mmwrite(str(tmp_path / "s"), (d + d.T).tocoo(), symmetry="symmetric")
    return tmp_path / "s.mtx"


def _pattern(tmp_path):
    path = tmp_path / "p.mtx"
    path.write_text("%%MatrixMarket matrix coordinate pattern general\n% comment\n3 4 3\n1 3\n2 1\n3 2\n")
    return path


def _written(tmp_path):
    """A file written by the port's native writer, as the suite's mtx_*
    cases write theirs."""
    a = sp.csr_matrix(synth.power_law(500, 400, 6.0, seed=2))
    a.data[:] = np.random.default_rng(0).integers(1, 10, a.nnz)
    path = tmp_path / "w.mtx"
    assert nativelib.write_matrix_market(str(path), a.indptr, a.indices, a.data, a.shape)
    return path


@pytest.mark.parametrize("make", [_general, _symmetric, _pattern, _written])
def test_load_matrix_market_matches_mmio_and_jax(tmp_path, make):
    _assert_same_load(make(tmp_path))


def test_load_matrix_market_skew_integer(tmp_path):
    path = tmp_path / "k.mtx"
    path.write_text("%%MatrixMarket matrix coordinate integer skew-symmetric\n3 3 2\n2 1 5\n3 2 -7\n")
    rp, ci, v, shape = nativelib.load_matrix_market(str(path))
    got = sp.csr_matrix((v, ci, rp), shape=shape).toarray()
    np.testing.assert_array_equal(got, [[0, -5, 0], [5, 0, 7], [0, -7, 0]])
    _assert_same_load(path)


def test_load_matrix_market_errors(tmp_path):
    bad = tmp_path / "bad.mtx"
    bad.write_text("%%MatrixMarket matrix coordinate complex general\n1 1 1\n1 1 1 1\n")
    with pytest.raises(ValueError, match="complex"):
        nativelib.load_matrix_market(str(bad))
    with pytest.raises(ValueError, match="cannot open"):
        nativelib.load_matrix_market(str(tmp_path / "missing.mtx"))


def test_load_matrix_market_without_the_library(tmp_path, monkeypatch):
    """No native library: the same arrays through mmio."""
    path = _general(tmp_path)
    want = nativelib.load_matrix_market(str(path))
    monkeypatch.setattr(nativelib, "_try_load", lambda: None)
    got = nativelib.load_matrix_market(str(path))
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype
    assert got[3] == want[3]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("native", [True, False])
def test_csr_spmv_serial(dtype, native, monkeypatch):
    if not native:
        monkeypatch.setattr(nativelib, "_try_load", lambda: None)
    a = synth.random_csr(300, 250, 0.03, seed=5).astype(dtype)
    x = np.random.default_rng(1).integers(1, 10, 250).astype(dtype)
    y = nativelib.csr_spmv_serial(a.indptr.astype(np.int64), a.indices, a.data, x, alpha=1.5)
    assert y.dtype == dtype
    # integer data: every partial sum is exact, in any order
    a_int = a.copy()
    a_int.data = np.round(a_int.data * 8)
    y_int = nativelib.csr_spmv_serial(a_int.indptr, a_int.indices, a_int.data, x, alpha=1.5)
    np.testing.assert_array_equal(y_int, (1.5 * (a_int @ x)).astype(dtype))
    np.testing.assert_array_equal(
        y_int, jnative.csr_spmv_serial(a_int.indptr.astype(np.int64), a_int.indices, a_int.data, x, 1.5)
    )
    # float data: within 1e-6 relative of scipy in float64
    ref = 1.5 * (a.astype(np.float64) @ x.astype(np.float64))
    np.testing.assert_allclose(y, ref, rtol=1e-6, atol=1e-6 * np.abs(ref).max())


def test_csr_spmv_serial_rejects_a_short_x():
    a = synth.random_csr(30, 25, 0.2, seed=5).astype(np.float32)
    with pytest.raises(ValueError, match="x has 10"):
        nativelib.csr_spmv_serial(a.indptr, a.indices, a.data, np.ones(10, np.float32))


@pytest.mark.parametrize("sigma", [8, 16])
def test_tile_partition_pointer_matches_jax_and_the_build(sigma):
    a = synth.power_law(800, 700, 7.0, seed=9).astype(np.float32)
    a5 = build_csr5(a, sigma=sigma, device="cpu")
    T, p = a5.config.tile_nnz, a5.num_tiles
    rp = a.indptr.astype(np.int64)
    tp = nativelib.tile_partition_pointer(rp, p, T)
    assert tp is not None and tp.dtype == np.int32
    np.testing.assert_array_equal(tp, a5.tile_ptr.numpy())
    np.testing.assert_array_equal(tp, jnative.tile_partition_pointer(rp, p, T))


def test_available_and_missing_library(monkeypatch):
    assert nativelib.available()
    monkeypatch.setattr(nativelib, "_try_load", lambda: None)
    assert not nativelib.available()
    assert nativelib.tile_partition_pointer(np.array([0, 1], np.int64), 1, 128) is None
