"""The port's solvers against the JAX package's, on the matrices of
``tests/test_solvers.py``.

Both sides run CSR5 SpMV (the port's plain version here, the JAX XLA
executor there) on the same matrix and right-hand side. The two sum in
another order, so iterates drift apart by rounding; each check states how
far:

- CG, BiCGSTAB, PageRank (float64): x within 1e-10 of the JAX x, relative
  to its largest entry;
- iterative refinement (float32 inner CG on K1's plain version, float64
  residual on K4's): residual <= 1e-10 and at least 10x below float32-only
  CG, x within 1e-10 of the JAX x;
- GMRES and Lanczos (float32): x within 1e-4, the extreme Ritz values
  within 1e-4 relative;
- power iteration: the start vectors differ (a torch.Generator against a
  JAX PRNGKey), so only the eigenvalue is compared, at rtol 1e-4 as the
  JAX test holds it against scipy (2e-4 against the JAX value). The top
  eigenvalues of that matrix lie close together and the port's start
  vector converges more slowly than the JAX one: 2000 iterations to the
  JAX test's 300 (measured: 5.7e-5 after 2000, 4.9e-4 after 300).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from scipy.sparse.linalg import eigsh

import benchmark_spmv_using_csr5_tpu as J
import benchmark_spmv_using_csr5_tpu.models.solvers as jsolvers
import benchmark_spmv_using_csr5_tpu_torch as P
from benchmark_spmv_using_csr5_tpu_torch.models import solvers
from benchmark_spmv_using_csr5_tpu_torch.utils import synth


def _spd(m=120, seed=0):
    """``tests/test_solvers.py::_spd``: (A + A^T)/2 plus a diagonal shift."""
    a = synth.banded(m, 5, dtype=np.float64, seed=seed)
    a = (a + a.T) * 0.5 + sp.eye(m) * (np.abs(a).sum(axis=1).max() + 1.0)
    return sp.csr_matrix(a)


def _ops(a_sp):
    """(port spmv, JAX spmv) on one matrix, float64 planes kept as such."""
    host = (a_sp.indptr, a_sp.indices, a_sp.data, a_sp.shape)
    vdt = torch.float64 if a_sp.dtype == np.float64 else None
    a5p = P.build_csr5(host, value_dtype=vdt, device="cpu")
    a5j = J.build_csr5(J.csr_from_scipy(a_sp))
    return (lambda v: P.csr5_spmv(a5p, v)), (lambda v: J.csr5_spmv_xla(a5j, v))


def _close(x, x_ref, rtol):
    x, x_ref = np.asarray(x, np.float64), np.asarray(x_ref, np.float64)
    assert np.abs(x - x_ref).max() <= rtol * np.abs(x_ref).max()


def test_cg_matches_jax():
    a = _spd()
    b = np.ones(a.shape[0])
    sp_p, sp_j = _ops(a)
    x, res = solvers.conjugate_gradient(sp_p, torch.from_numpy(b), iters=200)
    xj, _ = jsolvers.conjugate_gradient(sp_j, b, iters=200)
    assert float(res) < 1e-6
    np.testing.assert_allclose(a @ x.numpy(), b, atol=1e-5)
    _close(x, xj, 1e-10)


def test_bicgstab_matches_jax():
    a = _spd(seed=3)
    a = sp.csr_matrix(a + sp.diags(np.linspace(0, 0.5, a.shape[0])))
    b = np.ones(a.shape[0])
    sp_p, sp_j = _ops(a)
    x, _ = solvers.bicgstab(sp_p, torch.from_numpy(b), iters=200)
    xj, _ = jsolvers.bicgstab(sp_j, b, iters=200)
    np.testing.assert_allclose(a @ x.numpy(), b, atol=1e-5)
    _close(x, xj, 1e-10)


def test_iterative_refinement_reaches_f64_accuracy():
    a64 = _spd(m=150, seed=7)
    a32 = a64.astype(np.float32)
    b = np.ones(150)
    hi_p, hi_j = _ops(a64)
    lo_p, lo_j = _ops(a32)
    bt = torch.from_numpy(b)
    x32, _ = solvers.conjugate_gradient(lo_p, bt.float(), iters=300)
    assert x32.dtype == torch.float32
    res32 = np.linalg.norm(a64 @ x32.double().numpy() - b)
    x_ir, res_ir = solvers.iterative_refinement(lo_p, hi_p, bt, outer_iters=4, inner_iters=100)
    assert x_ir.dtype == torch.float64
    assert float(res_ir) < 1e-10 and float(res_ir) < res32 / 10
    assert np.linalg.norm(a64 @ x_ir.numpy() - b) < 1e-10
    xj, _ = jsolvers.iterative_refinement(lo_j, hi_j, jnp.asarray(b), outer_iters=4,
                                          inner_iters=100)
    _close(x_ir, xj, 1e-10)


def test_power_iteration_dominant_eig():
    a = _spd(m=80, seed=5)
    sp_p, sp_j = _ops(a)
    gen = torch.Generator().manual_seed(0)
    lam, v = solvers.power_iteration(sp_p, a.shape[0], iters=2000, generator=gen,
                                     dtype=torch.float64, device="cpu")
    lam_j, _ = jsolvers.power_iteration(sp_j, a.shape[0], iters=300, dtype=jnp.float64)
    lam_ref = eigsh(a, k=1, which="LM", return_eigenvectors=False)[0]
    np.testing.assert_allclose(float(lam), lam_ref, rtol=1e-4)
    np.testing.assert_allclose(float(lam), float(lam_j), rtol=2e-4)
    assert v.dtype == torch.float64 and abs(float(torch.linalg.vector_norm(v)) - 1) < 1e-12


def test_pagerank_matches_jax():
    m = 100
    a = sp.random(m, m, 0.05, random_state=7, format="csr")
    a.data[:] = 1.0
    out = np.asarray(a.sum(axis=1)).ravel()
    scale = np.divide(1.0, out, out=np.zeros_like(out), where=out > 0)
    t = sp.csr_matrix(sp.diags(scale) @ a).T.tocsr()
    sp_p, sp_j = _ops(t)
    pr = solvers.pagerank(sp_p, m, iters=100, dtype=torch.float64, device="cpu").numpy()
    pr_j = np.asarray(jsolvers.pagerank(sp_j, m, iters=100, dtype=jnp.float64))
    assert pr.shape == (m,) and (pr >= 0).all()
    np.testing.assert_allclose(pr.sum(), 1.0, atol=1e-4)
    _close(pr, pr_j, 1e-10)


def test_gmres_nonsymmetric():
    rng = np.random.default_rng(7)
    m = 200
    a = sp.csr_matrix(
        sp.diags(
            [rng.uniform(4, 5, m), rng.uniform(-1, 1, m - 1), rng.uniform(-1, 1, m - 3)],
            [0, 1, -3],
        )
    ).astype(np.float32)
    b = rng.uniform(-1, 1, m).astype(np.float32)
    sp_p, sp_j = _ops(a)
    x, res = solvers.gmres(sp_p, torch.from_numpy(b), restart=25, outer_iters=4)
    xj, _ = jsolvers.gmres(sp_j, b, restart=25, outer_iters=4)
    assert float(res) < 1e-3
    np.testing.assert_allclose(a @ x.numpy(), b, atol=1e-3)
    _close(x, xj, 1e-4)


def test_lanczos_extremal_eigs():
    m = 150
    a = sp.csr_matrix(
        sp.diags([2 * np.ones(m), -np.ones(m - 1), -np.ones(m - 1)], [0, 1, -1])
    ).astype(np.float32)
    v0 = np.random.default_rng(3).uniform(-1, 1, m).astype(np.float32)
    sp_p, sp_j = _ops(a)
    al, be, evals = solvers.lanczos(sp_p, torch.from_numpy(v0), iters=40)
    _, _, evals_j = jsolvers.lanczos(sp_j, jnp.asarray(v0), iters=40)
    lam_max = 2 - 2 * np.cos(np.pi * m / (m + 1))
    assert al.shape == be.shape == (40,)
    assert abs(float(evals[-1]) - lam_max) < 0.01 * lam_max
    evals_j = np.asarray(evals_j)
    for k in (0, -1):
        assert abs(float(evals[k]) - evals_j[k]) <= 1e-4 * lam_max


@pytest.mark.parametrize("solver", ["power_iteration", "pagerank"])
def test_solver_vectors_default_to_the_card(monkeypatch, solver):
    """Vectors a solver makes itself go to the card unless the caller
    names the CPU; without a card that raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(solvers, solver)(lambda v: v, 8)
