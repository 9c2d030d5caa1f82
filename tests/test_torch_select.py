"""The port's format selection and RCM planning against the JAX package's.

``ops/select.py`` and ``utils/reorder.py`` are host passes copied from
the JAX package with the same thresholds: on the same matrix both must
make the same decision, and the RCM permutation and the permuted CSR
arrays must be equal element for element. The shapes are small versions
of the bench's ``hybmix400k``, ``scrambled300k`` and ``mtx_lap2d_490k``
cases (``bench/case_runner.py:58-68,139-146,749-763``) and of
``tests/test_select.py``'s matrices.
"""

import numpy as np
import pytest
import scipy.sparse as sp

import benchmark_spmv_using_csr5_tpu.ops.select as jsel
import benchmark_spmv_using_csr5_tpu.utils.reorder as jreorder
from benchmark_spmv_using_csr5_tpu_torch.ops import select as psel
from benchmark_spmv_using_csr5_tpu_torch.utils import reorder as preorder
from benchmark_spmv_using_csr5_tpu_torch.utils import synth


def _scrambled(m, bw, span, seed=0):
    a = sp.csr_matrix(synth.scattered_band(m, bw, span, dtype=np.float32))
    perm = np.random.default_rng(seed).permutation(m)
    return a[perm][:, perm].tocsr()


def _lap2d(g):
    m = g * g
    offs = [-g - 1, -g, -g + 1, -1, 0, 1, g - 1, g, g + 1]
    diags = [np.full(m - abs(o), -1.0, np.float64) for o in offs]
    diags[4] = np.full(m, 8.0)
    return sp.csr_matrix(sp.diags(diags, offs, shape=(m, m)))


def _hybmix(m, seed=3):
    band = sp.csr_matrix(synth.banded(m, 27, dtype=np.float32))
    rng = np.random.default_rng(seed)
    nnz = m * 4
    noise = sp.csr_matrix(
        (np.ones(nnz, np.float32), (rng.integers(0, m, nnz), rng.integers(0, m, nnz))),
        shape=(m, m),
    )
    return (band + noise).tocsr()


MATRICES = {
    "banded5000_27": (lambda: synth.banded(5000, 27, dtype=np.float32), "dia"),
    "tridiag1000": (lambda: synth.banded(1000, 3, dtype=np.float32), "dia"),
    "lap2d_60": (lambda: _lap2d(60), "dia"),
    "hybmix4000": (lambda: _hybmix(4000), "hyb"),
    "powerlaw3000": (lambda: synth.power_law(3000, 3000, 6.0, dtype=np.float32), "csr5"),
    "scatband4000": (lambda: synth.scattered_band(4000, 10, 1500, dtype=np.float32), "csr5"),
    "scrambled8000": (lambda: _scrambled(8000, 8, 200), "csr5"),
    "scrambled3000": (lambda: _scrambled(3000, 10, 400), "csr5"),
    "rect": (lambda: sp.diags([np.ones(300)], [40], shape=(300, 400)), "dia"),
}


def _load(name):
    make, fmt = MATRICES[name]
    return sp.csr_matrix(make()), fmt


@pytest.mark.parametrize("name", list(MATRICES))
def test_select_format_matches_jax(name):
    a, want = _load(name)
    args = (a.indptr, a.indices, a.shape)
    assert psel.analyze_diagonals(*args) == jsel.analyze_diagonals(*args)
    assert psel.select_format(*args) == jsel.select_format(*args) == want


def test_empty_matrix_selects_csr5():
    rp, ci = np.zeros(11, np.int64), np.zeros(0, np.int64)
    assert psel.select_format(rp, ci, (10, 10)) == jsel.select_format(rp, ci, (10, 10)) == "csr5"
    assert psel._bandwidth(rp, ci) == 0


@pytest.mark.parametrize(
    "name", ["banded5000_27", "hybmix4000", "powerlaw3000", "scatband4000", "scrambled8000", "scrambled3000"]
)
def test_select_plan_and_apply_match_jax(name):
    a, _ = _load(name)
    args = (a.indptr, a.indices, a.shape)
    pp, pj = psel.select_plan(*args), jsel.select_plan(*args)
    assert pp._replace(plan_ms=0.0) == pj._replace(plan_ms=0.0)
    host = (a.indptr, a.indices, a.data, a.shape)
    (cp, perm_p), (cj, perm_j) = psel.apply_plan(host, pp), jsel.apply_plan(host, pj)
    if pj.reorder is None:
        assert perm_p is None and perm_j is None
        return
    np.testing.assert_array_equal(perm_p, perm_j)
    for got, ref in zip(cp[:3], cj[:3]):
        np.testing.assert_array_equal(got, ref)
    assert cp[3] == cj[3]


def test_scrambled_band_plans_rcm():
    a, _ = _load("scrambled8000")
    plan = psel.select_plan(a.indptr, a.indices, a.shape)
    assert plan.format == "csr5" and plan.reorder == "rcm"
    assert plan.bandwidth_after * psel.RCM_MIN_GAIN <= plan.bandwidth_before
    (rp, ci, v, shape), perm = psel.apply_plan((a.indptr, a.indices, a.data, a.shape), plan)
    x = np.random.default_rng(0).integers(1, 10, a.shape[1]).astype(np.float32)
    a2 = sp.csr_matrix((v, ci, rp), shape=shape)
    np.testing.assert_array_equal(a2 @ x[perm], (a @ x)[perm])


@pytest.mark.parametrize("name", ["scrambled3000", "lap2d_60", "powerlaw3000"])
def test_rcm_permutation_and_bandwidth_match_jax(name):
    a, _ = _load(name)
    perm = preorder.rcm_permutation(a)
    np.testing.assert_array_equal(perm, jreorder.rcm_permutation(a))
    assert preorder.bandwidth(a) == jreorder.bandwidth(a)
    a2, p2 = preorder.reorder_for_locality(a)
    j2, q2 = jreorder.reorder_for_locality(a)
    np.testing.assert_array_equal(p2, q2)
    assert (a2 != j2).nnz == 0


def test_unknown_reorder_method_raises():
    with pytest.raises(ValueError, match="unknown reorder method"):
        preorder.reorder_for_locality(sp.eye(4, format="csr"), method="amd")
