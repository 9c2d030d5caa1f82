"""The port's CSR builders (``models/formats.py``: ``csr_from_numpy``,
``csr_from_scipy``) against the JAX package's.

Both take host arrays or a scipy matrix and give a CSR matrix with int32
indices, values in ``dtype`` (else their own dtype) and ``tuple(shape)``.
The port's lands on ``device`` (the card unless the caller asks for the
CPU, as these tests do). Arrays are compared exactly: the builders only
cast.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import benchmark_spmv_using_csr5_tpu as J
import benchmark_spmv_using_csr5_tpu_torch as P
from benchmark_spmv_using_csr5_tpu_torch import models
from benchmark_spmv_using_csr5_tpu_torch.utils import synth


def _empty_rows():
    """A band with rows 100-149 and the last 20 rows empty."""
    a = sp.csr_matrix(synth.banded(400, 7)).tolil()
    a[100:150, :] = 0
    a[380:, :] = 0
    a = a.tocsr()
    a.eliminate_zeros()
    return a


def _matrix(name):
    rng = np.random.default_rng(3)
    if name == "empty_rows":
        a = _empty_rows()
    elif name == "rect":
        a = sp.random(300, 700, density=0.02, random_state=4, format="csr")
    else:
        a = sp.csr_matrix(synth.power_law(500, 500, 6.0))
    a = a.astype(np.float64)
    a.data = rng.uniform(-1.0, 1.0, a.nnz)  # not float32-exact
    return a


def _same(cp, cj, dtype):
    """The port's CSRMatrix equals the JAX one array for array."""
    assert cp.shape == cj.shape and isinstance(cp.shape, tuple)
    assert cp.row_ptr.dtype == torch.int32 and cp.col_idx.dtype == torch.int32
    assert cp.values.dtype == dtype
    np.testing.assert_array_equal(cp.row_ptr.numpy(), np.asarray(cj.row_ptr))
    np.testing.assert_array_equal(cp.col_idx.numpy(), np.asarray(cj.col_idx))
    np.testing.assert_array_equal(cp.values.numpy(), np.asarray(cj.values))
    assert cp.values.device.type == "cpu"


@pytest.mark.parametrize("name", ["empty_rows", "rect", "powerlaw"])
@pytest.mark.parametrize(
    "src_dtype,dtype,want",
    [
        (np.float32, None, torch.float32),
        (np.float64, None, torch.float64),
        (np.float64, np.float32, torch.float32),
        (np.float32, np.float64, torch.float64),
    ],
    ids=["f32", "f64", "f64-as-f32", "f32-as-f64"],
)
def test_csr_from_numpy_matches_jax(name, src_dtype, dtype, want):
    a = _matrix(name).astype(src_dtype)
    args = (a.indptr.astype(np.int64), a.indices.astype(np.int64), a.data, list(a.shape))
    cp = P.csr_from_numpy(*args, dtype=dtype, device="cpu")
    cj = J.csr_from_numpy(*args, dtype=dtype)
    _same(cp, cj, want)


@pytest.mark.parametrize("name", ["empty_rows", "rect", "powerlaw"])
@pytest.mark.parametrize("dtype", [None, np.float32])
def test_csr_from_scipy_matches_jax(name, dtype):
    a = _matrix(name)
    for mat in (a, a.tocoo(), a.tocsc()):  # tocsr() first, as the JAX one does
        _same(P.csr_from_scipy(mat, dtype, device="cpu"), J.csr_from_scipy(mat, dtype),
              torch.float64 if dtype is None else torch.float32)


def test_csr_builders_take_a_torch_dtype_and_copy():
    a = _matrix("empty_rows")
    c = P.csr_from_numpy(a.indptr, a.indices, a.data, a.shape, dtype=torch.float32, device="cpu")
    assert c.values.dtype == torch.float32
    np.testing.assert_array_equal(c.values.numpy(), a.data.astype(np.float32))
    c64 = P.csr_from_scipy(a, device="cpu")
    a.data[:] = 0.0  # the matrix owns copies, never views of the caller's arrays
    assert float(c64.values.abs().sum()) > 0.0
    assert (c.m, c.n, c.nnz) == (a.shape[0], a.shape[1], a.nnz)


def test_csr_builders_are_exported_and_default_to_the_card():
    assert P.csr_from_numpy is models.csr_from_numpy is models.formats.csr_from_numpy
    assert P.csr_from_scipy is models.csr_from_scipy
    assert "csr_from_numpy" in P.__all__ and "csr_from_scipy" in P.__all__
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            P.csr_from_scipy(_matrix("rect"))


def test_csr_from_scipy_feeds_the_port():
    """The built matrix converts and multiplies like the scipy one."""
    a = _matrix("empty_rows").astype(np.float32)
    a.data = np.random.default_rng(5).integers(1, 10, a.nnz).astype(np.float32)
    c = P.csr_from_scipy(a, device="cpu")
    a5 = P.build_csr5(c, device="cpu")
    x = np.random.default_rng(6).integers(1, 10, a.shape[1]).astype(np.float32)
    np.testing.assert_array_equal(P.csr5_spmv(a5, torch.from_numpy(x)).numpy(), a @ x)
