"""The generators against their published definitions, at small sizes."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from csr5_bench.generators import kronecker, stencil27


def _scipy(csr):
    m, n = csr["shape"]
    return sp.csr_matrix((csr["val"].numpy(), csr["col"].numpy(), csr["row_ptr"].numpy()),
                         shape=(m, n))


@pytest.mark.parametrize("g", [3, 5, 8])
def test_stencil27_cube(g):
    csr = stencil27.generate({"nx": g, "ny": g, "nz": g}, 7, "cpu")
    a = _scipy(csr)
    assert a.shape == (g**3, g**3)
    assert a.nnz == (3 * g - 2) ** 3
    assert abs(a - a.T).max() == 0.0
    assert np.linalg.eigvalsh(a.toarray()).min() > 0
    for i in range(a.shape[0]):  # ascending columns, one diagonal
        cols = a.indices[a.indptr[i]:a.indptr[i + 1]]
        assert (np.diff(cols) > 0).all() and i in cols
    off = a - sp.diags(a.diagonal())
    assert (off.data < 0).all() and (-off.data >= 0.5).all() and (-off.data < 1.5).all()


def test_stencil27_rows_sum_as_hpcg():
    """Interior rows sum to 0 and boundary rows are strictly dominant
    (b = A 1 is zero inside and positive on the boundary)."""
    nx, ny, nz = 6, 5, 4
    a = _scipy(stencil27.generate({"nx": nx, "ny": ny, "nz": nz}, 3, "cpu"))
    b = a @ np.ones(a.shape[0])
    r = np.arange(a.shape[0])
    ix, iy, iz = r % nx, (r // nx) % ny, r // (nx * ny)
    inside = (ix > 0) & (ix < nx - 1) & (iy > 0) & (iy < ny - 1) & (iz > 0) & (iz < nz - 1)
    assert np.abs(b[inside]).max() < 1e-12
    assert b[~inside].min() > 0.5


def test_stencil27_seeded():
    a = stencil27.generate({"nx": 4, "ny": 4, "nz": 4}, 11, "cpu")
    b = stencil27.generate({"nx": 4, "ny": 4, "nz": 4}, 11, "cpu")
    c = stencil27.generate({"nx": 4, "ny": 4, "nz": 4}, 12, "cpu")
    assert torch.equal(a["val"], b["val"]) and not torch.equal(a["val"], c["val"])
    assert torch.equal(a["col"], c["col"])  # the pattern is the grid's


KRON = {"scale": 10, "edge_factor": 16, "A": 0.57, "B": 0.19, "C": 0.19}


def test_kronecker_same_graph_for_same_seed():
    a, b = (kronecker.generate(KRON, 2**31 + 5, "cpu") for _ in range(2))
    c = kronecker.generate(KRON, 2**31 + 6, "cpu")
    for k in ("row_ptr", "col", "val"):
        assert torch.equal(a[k], b[k])
    assert not torch.equal(a["row_ptr"], c["row_ptr"])


def test_kronecker_graph():
    csr = kronecker.generate(KRON, 99, "cpu")
    pt = _scipy(csr)
    n = 1 << KRON["scale"]
    assert pt.shape == (n, n) and csr["val"].dtype == torch.float32
    pattern = pt.copy()
    pattern.data[:] = 1.0
    assert abs(pattern - pattern.T).max() == 0.0  # undirected
    assert pt.diagonal().max() == 0.0  # no self-loops
    for i in range(n):  # no duplicates: strictly ascending columns
        assert (np.diff(pt.indices[pt.indptr[i]:pt.indptr[i + 1]]) > 0).all()
    deg = np.diff(pt.indptr)
    col_sums = np.asarray(pt.astype(np.float64).sum(axis=0)).ravel()
    assert np.allclose(col_sums[deg > 0], 1.0, rtol=1e-6)  # column-stochastic
    assert (deg == 0).any() and deg.max() > 5 * deg[deg > 0].mean()  # skewed
    # about edge_factor * n undirected edges, less duplicates and self-loops
    assert 0.5 * 2 * KRON["edge_factor"] * n < pt.nnz <= 2 * KRON["edge_factor"] * n
