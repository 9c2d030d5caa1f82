"""The port's CSR -> CSR5 conversion against the JAX package's.

The port (``benchmark_spmv_using_csr5_tpu_torch``) copies the JAX
package's host stages, so every plane must match the JAX
``build_csr5(..., keep_raw_cols=True)`` element for element, and every
static field must be equal. Inputs are float32: conftest turns x64 on,
under which the JAX package would keep float64 values.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import benchmark_spmv_using_csr5_tpu as J
import benchmark_spmv_using_csr5_tpu_torch as P
from benchmark_spmv_using_csr5_tpu_torch.models.formats import PLANE_FIELDS, STATIC_FIELDS
from benchmark_spmv_using_csr5_tpu_torch.utils import synth


def _host(a_sp):
    a = sp.csr_matrix(a_sp).astype(np.float32)
    return a, (a.indptr, a.indices, a.data, a.shape)


def _jax_planes(a5j):
    """The JAX matrix's planes as numpy, bf16 widened to float32 (exact)."""
    out = {}
    for f in PLANE_FIELDS:
        v = getattr(a5j, f)
        if v is None:
            out[f] = None
            continue
        v = np.asarray(v)
        out[f] = v.astype(np.float32) if v.dtype.name == "bfloat16" else v
    return out


def assert_same_matrix(a5p, a5j):
    planes, static = P.csr5_to_numpy(a5p)
    for f, ref in _jax_planes(a5j).items():
        got = planes[f]
        if ref is None:
            assert got is None, f
            continue
        assert got.shape == ref.shape, (f, got.shape, ref.shape)
        assert got.dtype == ref.dtype, (f, got.dtype, ref.dtype)
        np.testing.assert_array_equal(got, ref, err_msg=f)
    for f in STATIC_FIELDS:
        if f == "config":
            cj = a5j.config
            assert (cj.omega, cj.sigma, cj.tiles_per_block) == (
                static["config"]["omega"],
                static["config"]["sigma"],
                static["config"]["tiles_per_block"],
            )
        else:
            assert static[f] == getattr(a5j, f), f
    jdt = str(np.asarray(a5j.val_tiles).dtype)
    assert static["value_dtype"] == jdt


@pytest.mark.parametrize("value_dtype", [None, "auto"])
@pytest.mark.parametrize("win_mode", ["auto", "aligned"])
@pytest.mark.parametrize("sigma", [8, 16, 24, 32])
def test_convert_planes_match_jax(edge_matrix, sigma, win_mode, value_dtype):
    name, a_sp = edge_matrix
    _, host = _host(a_sp)
    a5j = J.build_csr5(
        host, J.CSR5Config(sigma=sigma), value_dtype=value_dtype,
        win_mode=win_mode, keep_raw_cols=True,
    )
    a5p = P.build_csr5(
        host, P.CSR5Config(sigma=sigma), value_dtype=value_dtype, win_mode=win_mode, device="cpu"
    )
    assert_same_matrix(a5p, a5j)
    # integer values 1-9: the lossless gate stores bfloat16
    want = torch.bfloat16 if value_dtype == "auto" else torch.float32
    assert a5p.val_tiles.dtype == want, name


@pytest.mark.parametrize("value_dtype", [None, "auto"])
def test_csr5_to_csr_roundtrip_exact(edge_matrix, value_dtype):
    name, a_sp = edge_matrix
    a, host = _host(a_sp)
    back = P.csr5_to_csr(P.build_csr5(host, value_dtype=value_dtype, device="cpu"))
    np.testing.assert_array_equal(back.row_ptr.numpy(), a.indptr, err_msg=name)
    np.testing.assert_array_equal(back.col_idx.numpy(), a.indices, err_msg=name)
    np.testing.assert_array_equal(back.values.float().numpy(), a.data, err_msg=name)


def test_carry_across_roundtrip():
    """A JAX matrix carried into the port and back keeps every plane;
    with the raw column plane dropped, the port decodes col_packed."""
    _, host = _host(synth.banded(3000, 27, dtype=np.float32))
    a5j = J.build_csr5(host, J.CSR5Config(sigma=16), value_dtype="auto")
    assert a5j.col_idx_tiles is None and a5j.col_packed is not None
    static = {f: getattr(a5j, f) for f in STATIC_FIELDS}
    static["value_dtype"] = "bfloat16"
    a5p = P.csr5_from_numpy(_jax_planes(a5j), static, device="cpu")
    ref = _jax_planes(J.build_csr5(host, J.CSR5Config(sigma=16), keep_raw_cols=True))
    np.testing.assert_array_equal(a5p.col_idx_tiles.numpy(), ref["col_idx_tiles"])
    assert a5p.val_tiles.dtype == torch.bfloat16
    planes, _ = P.csr5_to_numpy(a5p)
    for f in ("win_map", "tile_ptr", "val_tiles", "col_packed", "bit_flag"):
        np.testing.assert_array_equal(planes[f], _jax_planes(a5j)[f], err_msg=f)


def test_host_arena_does_not_alias_planes():
    """The host planes live in a reused arena: a second conversion must
    leave the first matrix's tensors untouched."""
    _, h1 = _host(synth.banded(2000, 9, dtype=np.float32))
    _, h2 = _host(synth.power_law(2000, 2000, 12.0, dtype=np.float32, seed=3))
    a = P.build_csr5(h1, P.CSR5Config(sigma=16), device="cpu")
    before = {f: getattr(a, f).clone() for f in ("col_idx_tiles", "val_tiles", "win_map")}
    P.build_csr5(h2, P.CSR5Config(sigma=16), device="cpu")
    for f, t in before.items():
        assert torch.equal(getattr(a, f), t), f


def test_float64_values_narrow_to_float32():
    _, host = _host(synth.banded(500, 9))
    a5 = P.build_csr5((host[0], host[1], host[2].astype(np.float64), host[3]), device="cpu")
    assert a5.val_tiles.dtype == torch.float32


@pytest.mark.parametrize(
    "m,nnz,sigma",
    [(100, 100, -1), (100, 1200, -1), (100, 2000, -1), (100, 40000, -1), (10, 5, 24)],
)
def test_compute_sigma_matches_jax(m, nnz, sigma):
    assert P.compute_sigma(m, nnz, sigma) == J.compute_sigma(m, nnz, sigma)
