"""The port's CSR5 SpMM (the plain version of kernel K2) against the JAX
package's, and the torch SpMM and COO oracles.

``csr5_spmm_torch`` runs here (no GPU). It is held against the JAX
multi-rhs Pallas kernel in interpret mode (``csr5_spmm_pallas``, as
``tests/test_spmm.py`` runs it), the JAX XLA executor ``csr5_spmm_xla``
and scipy, for R in {1, 2, 5, 8, 16, 17}, both layouts (``"nr"``: X (n, R);
``"rn"``: X^T (R, n)), alpha = -1.75, float32 and bfloat16 value planes,
wrapped and aligned window maps, and the edge matrices of
``tests/conftest.py``. The interpret-mode kernel is slow (about 0.65 s per
right-hand side), so each R runs it once, in one layout.

Tolerances: on the integer-valued data (values and X in 1-9, alpha
-1.75) every partial sum is exact in float32, so all executors agree
exactly. On random floats the executors sum the tile prefix in another
order: rtol 1e-5 against each row's absolute sum |A| @ |X|.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import benchmark_spmv_using_csr5_tpu as J
import benchmark_spmv_using_csr5_tpu_torch as P
from benchmark_spmv_using_csr5_tpu.models.formats import COOMatrix as JCOO
from benchmark_spmv_using_csr5_tpu.ops import reference as jref
from benchmark_spmv_using_csr5_tpu.ops.csr5_kernel import csr5_spmm_pallas
from benchmark_spmv_using_csr5_tpu_torch.ops import csr5_kernel
from benchmark_spmv_using_csr5_tpu_torch.utils import cuda_build, synth

FLOAT_RTOL = 1e-5
ALPHA = -1.75
RHS = [1, 2, 5, 8, 16, 17]


def _x(n, R, seed=2):
    return np.random.default_rng(seed).integers(1, 10, size=(n, R)).astype(np.float32)


def _pair(a_sp, sigma=16, win_mode="auto", value_dtype=None):
    """The JAX and the port conversion of ``a_sp`` (float32 values)."""
    a = sp.csr_matrix(a_sp).astype(np.float32)
    host = (a.indptr, a.indices, a.data, a.shape)
    a5j = J.build_csr5(
        host, J.CSR5Config(sigma=sigma, tiles_per_block=8), value_dtype=value_dtype,
        win_mode=win_mode,
    )
    a5p = P.build_csr5(
        host, P.CSR5Config(sigma=sigma, tiles_per_block=8), value_dtype=value_dtype,
        win_mode=win_mode,
    )
    return a, a5j, a5p


def _port(a5p, X, layout, alpha=ALPHA):
    """Y (m, R) from the port's plain version in ``layout``."""
    if layout == "rn":
        return P.csr5_spmm_torch(a5p, torch.from_numpy(np.ascontiguousarray(X.T)), alpha, "rn").numpy().T
    return P.csr5_spmm_torch(a5p, torch.from_numpy(X), alpha).numpy()


@pytest.mark.parametrize("R", RHS)
def test_spmm_matches_pallas_and_xla_exactly(R):
    """Against the interpret-mode Pallas kernel (one layout per R, both
    layouts over the set), the XLA executor and scipy."""
    a, a5j, a5p = _pair(synth.banded(700, 9))
    X = _x(a.shape[1], R)
    layout = "rn" if R in (2, 8, 17) else "nr"
    xin = np.ascontiguousarray(X.T) if layout == "rn" else X
    y_pl = np.asarray(csr5_spmm_pallas(a5j, xin, alpha=ALPHA, interpret=True, layout=layout))
    if layout == "rn":
        y_pl = y_pl.T
    y_port = _port(a5p, X, layout)
    np.testing.assert_array_equal(y_port, y_pl)
    np.testing.assert_array_equal(y_port, np.asarray(J.csr5_spmm_xla(a5j, X, alpha=ALPHA)))
    np.testing.assert_array_equal(y_port, (ALPHA * (a @ X)).astype(np.float32))


@pytest.mark.parametrize("R", RHS)
@pytest.mark.parametrize("layout", ["nr", "rn"])
@pytest.mark.parametrize("value_dtype", [None, "auto"], ids=["f32", "bf16"])
@pytest.mark.parametrize("win_mode", ["auto", "aligned"])
def test_spmm_planes_layouts_maps_exact(R, layout, value_dtype, win_mode):
    """Every R, layout, value plane and map kind against the XLA executor
    on the JAX conversion, and scipy."""
    a, a5j, a5p = _pair(synth.power_law(700, 600, 8.0, seed=11), sigma=8,
                        win_mode=win_mode, value_dtype=value_dtype)
    if value_dtype == "auto":
        assert a5p.val_tiles.dtype == torch.bfloat16
    X = _x(a.shape[1], R)
    y_port = _port(a5p, X, layout)
    np.testing.assert_array_equal(y_port, np.asarray(J.csr5_spmm_xla(a5j, X, alpha=ALPHA)))
    np.testing.assert_array_equal(y_port, (ALPHA * (a @ X)).astype(np.float32))


def test_spmm_edge_cases_exact(edge_matrix):
    name, a_sp = edge_matrix
    a, a5j, a5p = _pair(a_sp, sigma=8)
    X = _x(a.shape[1], 2)
    y_port = _port(a5p, X, "nr", 1.0)
    y_pl = np.asarray(csr5_spmm_pallas(a5j, X, interpret=True))
    np.testing.assert_array_equal(y_port, y_pl, err_msg=name)
    np.testing.assert_array_equal(y_port, np.asarray(J.csr5_spmm_xla(a5j, X)), err_msg=name)
    np.testing.assert_array_equal(y_port, (a @ X).astype(np.float32), err_msg=name)


def test_spmm_edge_cases_aligned_many_rhs_exact(edge_matrix):
    name, a_sp = edge_matrix
    a, a5j, a5p = _pair(a_sp, sigma=8, win_mode="aligned")
    X = _x(a.shape[1], 17)
    for layout in ("nr", "rn"):
        y_port = _port(a5p, X, layout)
        np.testing.assert_array_equal(
            y_port, np.asarray(J.csr5_spmm_xla(a5j, X, alpha=ALPHA)), err_msg=name
        )


def test_spmm_columns_equal_spmv():
    """Column r of the SpMM equals the SpMV of X[:, r], bit for bit."""
    a, _, a5p = _pair(synth.banded(1500, 27), sigma=24)
    X = _x(a.shape[1], 5)
    Y = P.csr5_spmm_torch(a5p, torch.from_numpy(X), ALPHA)
    for r in range(5):
        assert torch.equal(Y[:, r], P.csr5_spmv_torch(a5p, torch.from_numpy(X[:, r].copy()), ALPHA))


@pytest.mark.parametrize("win_mode", ["auto", "aligned"])
def test_spmm_random_floats_within_rtol(win_mode):
    rng = np.random.default_rng(5)
    a = sp.csr_matrix(synth.banded(2000, 27)).astype(np.float32)
    a.data = rng.uniform(-1, 1, a.nnz).astype(np.float32)
    a, a5j, a5p = _pair(a, sigma=24, win_mode=win_mode)
    X = rng.uniform(-1, 1, (a.shape[1], 5)).astype(np.float32)
    y_port = _port(a5p, X, "nr", 1.0)
    y64 = a.astype(np.float64) @ X.astype(np.float64)
    lim = FLOAT_RTOL * (abs(a).astype(np.float64) @ np.abs(X).astype(np.float64))
    assert (np.abs(y_port - y64) <= lim).all()
    assert (np.abs(y_port - np.asarray(J.csr5_spmm_xla(a5j, X))) <= lim).all()


def test_spmm_oracles_match_jax(edge_matrix):
    """The torch CSR SpMM and COO SpMV oracles against the JAX ones and
    scipy."""
    name, a_sp = edge_matrix
    a = sp.csr_matrix(a_sp).astype(np.float32)
    X = _x(a.shape[1], 3)
    csr = P.CSRMatrix(
        row_ptr=torch.from_numpy(a.indptr.astype(np.int32)),
        col_idx=torch.from_numpy(a.indices.astype(np.int32)),
        values=torch.from_numpy(a.data),
        shape=a.shape,
    )
    y = P.csr_spmm(csr, torch.from_numpy(X), ALPHA).numpy()
    np.testing.assert_array_equal(y, np.asarray(jref.csr_spmm(J.csr_from_scipy(a), X, ALPHA)))
    np.testing.assert_array_equal(y, (ALPHA * (a @ X)).astype(np.float32), err_msg=name)
    c = a.tocoo()
    coo = P.COOMatrix(
        row=torch.from_numpy(c.row.astype(np.int32)),
        col=torch.from_numpy(c.col.astype(np.int32)),
        values=torch.from_numpy(c.data),
        shape=a.shape,
    )
    jcoo = JCOO(row=c.row.astype(np.int32), col=c.col.astype(np.int32), values=c.data, shape=a.shape)
    y1 = P.coo_spmv(coo, torch.from_numpy(X[:, 0].copy())).numpy()
    np.testing.assert_array_equal(y1, np.asarray(jref.coo_spmv(jcoo, X[:, 0])))
    assert coo.nnz == a.nnz and coo.dtype == torch.float32


def test_dispatcher_runs_plain_version_on_cpu():
    a, _, a5p = _pair(synth.banded(500, 9))
    X = torch.from_numpy(_x(500, 4))
    before = csr5_kernel.spmm_launches
    assert torch.equal(P.csr5_spmm(a5p, X), P.csr5_spmm_torch(a5p, X))
    assert torch.equal(P.csr5_spmm(a5p, X.T.contiguous(), layout="rn", backend="torch"),
                       P.csr5_spmm_torch(a5p, X).T)
    assert csr5_kernel.spmm_launches == before


@pytest.mark.parametrize("call", ["dispatch", "wrapper"])
def test_cuda_path_on_cpu_tensors_raises(call):
    """Asking for K2 with CPU tensors raises before any build: nothing
    falls back to the plain version."""
    _, _, a5p = _pair(synth.banded(200, 9))
    X = torch.ones(200, 4)
    with pytest.raises(ValueError, match="CUDA tensors"):
        if call == "dispatch":
            P.csr5_spmm(a5p, X, backend="cuda")
        else:
            csr5_kernel.csr5_spmm_cuda(a5p, X)
    assert "csr5_spmm" not in cuda_build.loaded()


def test_unknown_layout_raises():
    _, _, a5p = _pair(synth.banded(200, 9))
    with pytest.raises(ValueError, match="unknown layout"):
        P.csr5_spmm_torch(a5p, torch.ones(200, 2), layout="nn")


def test_spmm_chunk_and_gate():
    """K2's chunk: the power of two covering min(R, 16), halved to fit the
    shared-memory budget; the gate refuses R < 1 and sigma * 128 >= 65536."""
    _, _, a5 = _pair(synth.banded(3000, 27), sigma=24)
    assert [csr5_kernel.spmm_chunk(a5, R) for R in (1, 2, 5, 8, 16, 17, 64)] == [
        1, 2, 8, 8, 16, 16, 16,
    ]
    assert csr5_kernel.spmm_supported(a5, 8) and not csr5_kernel.spmm_supported(a5, 0)
    nends = min(a5.capw, a5.sigma * 128)
    for R in (1, 8, 16):
        rc = csr5_kernel.spmm_chunk(a5, R)
        assert csr5_kernel.spmm_smem_bytes(a5.sigma, nends, rc) <= csr5_kernel.SPMM_SMEM_BUDGET
    wide = P.build_csr5(sp.csr_matrix(synth.banded(3000, 27)).astype(np.float32), P.CSR5Config(sigma=512))
    assert not csr5_kernel.spmm_supported(wide, 8)
