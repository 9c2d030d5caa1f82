"""The plain reference against scipy and numpy, and the byte models'
arithmetic."""

import ast
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from csr5_bench import reference, yardstick


def _random_csr(m, n, density, seed):
    a = sp.random(m, n, density=density, format="csr", random_state=seed)
    a.data = a.data - 0.5
    return a


def _ref(a):
    return reference.CSR(a.indptr, a.indices, a.data, a.shape, "cpu")


@pytest.mark.parametrize("rhs", [None, 1, 16])
def test_matmul_against_scipy(rhs, monkeypatch):
    monkeypatch.setattr(reference, "BLOCK_NNZ", 37)  # many blocks
    a = _random_csr(300, 200, 0.05, 1)
    rng = np.random.default_rng(2)
    x = rng.uniform(-1, 1, (200,) if rhs is None else (200, rhs))
    y = _ref(a).matmul(torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), a @ x, rtol=1e-13, atol=1e-13)


def test_matmul_empty_rows():
    a = sp.csr_matrix(np.array([[0.0, 0, 0], [1, 2, 0], [0, 0, 0]]))
    y = _ref(a).matmul(torch.ones(3, dtype=torch.float64))
    assert y.tolist() == [0.0, 3.0, 0.0]


def _numpy_cg(a, b, iters):
    x = np.zeros_like(b)
    r = b.copy()
    p = r.copy()
    rs = r @ r
    for _ in range(iters):
        ap = a @ p
        alpha = rs / (p @ ap)
        x += alpha * p
        r -= alpha * ap
        rs_new = r @ r
        p = r + rs_new / rs * p
        rs = rs_new
    return x


def test_conjugate_gradient_against_numpy():
    m = 400
    lap = sp.diags([-1.0, 2.5, -1.0], [-1, 0, 1], shape=(m, m), format="csr")
    b = np.random.default_rng(0).uniform(-1, 1, m)
    got = reference.conjugate_gradient(_ref(lap), torch.from_numpy(b), 30).numpy()
    np.testing.assert_allclose(got, _numpy_cg(lap, b, 30), rtol=1e-10, atol=1e-12)


def test_pagerank_against_numpy():
    g = sp.random(500, 500, density=0.02, format="csr", random_state=3)
    g = ((g + g.T) > 0).astype(np.float64)
    g.setdiag(0)
    g.eliminate_zeros()
    deg = np.asarray(g.sum(axis=0)).ravel()
    pt = sp.csr_matrix(g @ sp.diags(np.where(deg > 0, 1.0 / np.maximum(deg, 1), 0.0)))
    r = np.full(500, 1 / 500)
    for _ in range(20):
        r = 0.85 * (pt @ r) + 0.15 / 500
        r /= r.sum()
    got = reference.pagerank(_ref(pt), 0.85, 20).numpy()
    np.testing.assert_allclose(got, r, rtol=1e-12)


def test_reference_imports_nothing_of_the_program():
    src = Path(reference.__file__).read_text()
    names = set()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add((node.module or "").split(".")[0] if node.level == 0 else ".")
    assert names <= {"__future__", "torch"}, names


def test_byte_model_hpcg192():
    g = 192
    m, nnz = g**3, (3 * g - 2) ** 3
    assert (m, nnz) == (7_077_888, 189_119_224)
    b = yardstick.symmetric_stencil_bytes(m, m, nnz, 1, 8)
    assert b == (nnz + m) / 2 * 8 + 2 * m * 8
    assert round(b / 1e6, 1) == 898.0
    assert round(b / 3350e9 * 1e6) == 268  # us at 3350 GB/s
    assert yardstick.symmetric_stencil_bytes(m, m, nnz, 16, 8) == b + 15 * 2 * m * 8


def test_byte_model_pattern_only():
    n, nnz = 1 << 23, 250_000_000
    assert yardstick.pattern_only_bytes(n, n, nnz, 1, 4) == nnz * 4 + 2 * n * 4
    assert yardstick.pattern_only_bytes(n, n, nnz, 16, 4) == nnz * 4 + 2 * n * 4 * 16


def test_hbm_table():
    assert yardstick.hbm_gbps("NVIDIA H100 80GB HBM3") == 3350.0
    with pytest.raises(ValueError):
        yardstick.hbm_gbps("some other card")


def test_relative_error():
    x = torch.tensor([1.0, -2.0, 4.0])
    assert yardstick.relative_error(x, x.double(), float("inf")) == 0.0
    bad = x.clone()
    bad[0] = 1.4
    assert yardstick.relative_error(bad, x.double(), float("inf")) == pytest.approx(0.1)
    bad[1] = float("nan")
    assert yardstick.relative_error(bad, x.double(), 2) == float("inf")
