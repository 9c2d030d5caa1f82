"""The port's HYB5 format (DIA part + CSR5 part) against the JAX package's.

``build_hyb`` must split the nonzeros exactly as the JAX one does: the
same dense diagonals with the same plane, and a CSR5 remainder with the
same planes. ``hyb_spmv`` runs the plain versions of K5 and K1 here (no
GPU), ``hyb_spmm`` those of K6 and K2, and both must equal the JAX
``hyb_spmv``/``hyb_spmm`` (interpret-mode DIA kernels, XLA CSR5
executors) and scipy exactly: values, x (1-9) and alpha (1.25, -1.75) are
small integers or dyadic, so every partial sum is exact in float32.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import benchmark_spmv_using_csr5_tpu.ops.hyb as jhyb
import benchmark_spmv_using_csr5_tpu_torch as P
from benchmark_spmv_using_csr5_tpu_torch.models.formats import (
    DIA_STATIC_FIELDS,
    PLANE_FIELDS,
    STATIC_FIELDS,
)
from benchmark_spmv_using_csr5_tpu_torch.ops import hyb as phyb
from benchmark_spmv_using_csr5_tpu_torch.utils import synth


def _noise(m, nnz, seed):
    rng = np.random.default_rng(seed)
    return sp.csr_matrix(
        (np.ones(nnz, np.float32), (rng.integers(0, m, nnz), rng.integers(0, m, nnz))),
        shape=(m, m),
    )


def _mixed(m=1500, diags=5, density=0.002, seed=0):
    """Dense band + scattered noise (tests/test_hyb.py's shape)."""
    band = sp.csr_matrix(synth.banded(m, diags, dtype=np.float32))
    noise = sp.random(m, m, density, format="csr", dtype=np.float32, random_state=seed)
    noise.data[:] = np.round(noise.data * 8) + 1
    return sp.csr_matrix(band + noise)


MATRICES = {
    "mixed": _mixed,
    # hybmix400k's shape (bench/case_runner.py:749-763) at m = 4000
    "hybmix4k": lambda: (sp.csr_matrix(synth.banded(4000, 27, dtype=np.float32)) + _noise(4000, 16000, 3)).tocsr(),
    "hyb_tiny": lambda: (sp.csr_matrix(synth.banded(4000, 9, dtype=np.float32)) + _noise(4000, 8000, 3)).tocsr(),
    "pure_banded": lambda: sp.csr_matrix(synth.banded(1000, 7, dtype=np.float32)),
    "unstructured": lambda: sp.random(
        800, 800, 0.01, format="csr", dtype=np.float32, random_state=2
    ).multiply(9).ceil().tocsr(),
    "rect": lambda: sp.csr_matrix(
        sp.diags([np.full(600, 2.0), np.full(600, -3.0)], [0, 7], shape=(600, 900))
        + sp.random(600, 900, 0.003, format="csr", random_state=4).ceil()
    ).astype(np.float32),
}


def _host(a):
    return (a.indptr, a.indices, a.data, a.shape)


def _both(name):
    host = _host(MATRICES[name]())
    return host, jhyb.build_hyb(host), phyb.build_hyb(host)


@pytest.mark.parametrize("name", list(MATRICES))
def test_build_hyb_splits_like_jax(name):
    host, hj, hp = _both(name)
    assert (hp.shape, hp.nnz_stored) == (hj.shape, hj.nnz_stored)
    assert (hp.dia is None) == (hj.dia is None)
    assert (hp.csr5 is None) == (hj.csr5 is None)
    if hj.dia is not None:
        data, static = P.dia_to_numpy(hp.dia)
        for f in DIA_STATIC_FIELDS:
            assert static[f] == getattr(hj.dia, f), f
        np.testing.assert_array_equal(data, np.asarray(hj.dia.data))
    if hj.csr5 is not None:
        planes, static = P.csr5_to_numpy(hp.csr5)
        carried = _carry_csr5(hj.csr5)
        for f in PLANE_FIELDS:
            ref = getattr(hj.csr5, f)
            if f in ("col_idx_tiles", "col_packed") or ref is None:
                continue
            np.testing.assert_array_equal(planes[f], np.asarray(ref), err_msg=f)
        assert torch.equal(hp.csr5.col_idx_tiles, carried.col_idx_tiles)
        for f in STATIC_FIELDS:
            if f != "config":
                assert static[f] == getattr(hj.csr5, f), f
    nd = hp.dia.nnz_stored if hp.dia is not None else 0
    nc = hp.csr5.nnz_stored if hp.csr5 is not None else 0
    assert nd + nc == host[2].shape[0]


def _carry_csr5(a5j):
    planes = {f: None if getattr(a5j, f) is None else np.asarray(getattr(a5j, f)) for f in PLANE_FIELDS}
    return P.csr5_from_numpy(planes, {f: getattr(a5j, f) for f in STATIC_FIELDS})


@pytest.mark.parametrize("alpha", [1.0, 1.25])
@pytest.mark.parametrize("name", list(MATRICES))
def test_hyb_spmv_plain_matches_jax_exactly(name, alpha):
    host, hj, hp = _both(name)
    x = np.random.default_rng(1).integers(1, 10, host[3][1]).astype(np.float32)
    y = P.hyb_spmv(hp, torch.from_numpy(x), alpha).numpy()
    y_jax = np.asarray(jhyb.hyb_spmv(hj, x, alpha, csr5_backend="xla", interpret=True))
    np.testing.assert_array_equal(y, y_jax)
    a = sp.csr_matrix((host[2], host[1], host[0]), shape=host[3])
    np.testing.assert_array_equal(y, (alpha * (a @ x)).astype(np.float32))


def test_hyb_carried_across_gives_same_y():
    """A JAX HYBMatrix crosses as its two parts."""
    host, hj, hp = _both("hybmix4k")
    dia = P.dia_from_numpy(np.asarray(hj.dia.data), {f: getattr(hj.dia, f) for f in DIA_STATIC_FIELDS})
    h = phyb.HYBMatrix(shape=hj.shape, nnz_stored=hj.nnz_stored, dia=dia, csr5=_carry_csr5(hj.csr5))
    x = torch.from_numpy(np.random.default_rng(2).integers(1, 10, 4000).astype(np.float32))
    assert torch.equal(P.hyb_spmv(h, x), P.hyb_spmv(hp, x))


def test_hyb_empty_gives_zeros():
    e = sp.csr_matrix((16, 16), dtype=np.float32)
    hp = phyb.build_hyb(_host(e))
    assert hp.dia is None and hp.csr5 is None
    y = P.hyb_spmv(hp, torch.ones(16))
    assert y.shape == (16,) and not y.any()


def test_hyb_spmm_waits_for_k2():
    """hyb_spmm once raised until K2 was ported; its CSR5 part now runs
    K2's plain version here, beside K6's on the DIA part."""
    host, hj, hp = _both("mixed")
    X = np.random.default_rng(3).integers(1, 10, (1500, 4)).astype(np.float32)
    y = phyb.hyb_spmm(hp, torch.from_numpy(X)).numpy()
    np.testing.assert_array_equal(y, np.asarray(jhyb.hyb_spmm(hj, X, csr5_backend="xla", interpret=True)))


@pytest.mark.parametrize("R", [1, 5, 8])
@pytest.mark.parametrize("name", list(MATRICES))
def test_hyb_spmm_plain_matches_jax_exactly(name, R):
    """K6's and K2's plain versions, summed, against the JAX ``hyb_spmm``
    (interpret-mode DIA SpMM kernel, XLA CSR5 SpMM) and scipy, alpha
    -1.75: exact on these integer-valued inputs."""
    host, hj, hp = _both(name)
    X = np.random.default_rng(4).integers(1, 10, (host[3][1], R)).astype(np.float32)
    y = P.hyb_spmm(hp, torch.from_numpy(X), -1.75).numpy()
    y_jax = np.asarray(jhyb.hyb_spmm(hj, X, -1.75, csr5_backend="xla", interpret=True))
    np.testing.assert_array_equal(y, y_jax)
    a = sp.csr_matrix((host[2], host[1], host[0]), shape=host[3])
    np.testing.assert_array_equal(y, (-1.75 * (a @ X)).astype(np.float32))
    assert y.shape == (host[3][0], R)


def test_hyb_spmm_empty_gives_zeros():
    e = sp.csr_matrix((16, 16), dtype=np.float32)
    y = P.hyb_spmm(phyb.build_hyb(_host(e)), torch.ones(16, 3))
    assert y.shape == (16, 3) and not y.any()


def test_hyb_spmm_cuda_backend_on_cpu_tensors_raises():
    _, _, hp = _both("mixed")
    with pytest.raises(ValueError, match="CUDA tensors"):
        P.hyb_spmm(hp, torch.ones(1500, 2), backend="cuda")


def test_hyb_cuda_backend_on_cpu_tensors_raises():
    _, _, hp = _both("mixed")
    with pytest.raises(ValueError, match="CUDA tensors"):
        P.hyb_spmv(hp, torch.ones(1500), backend="cuda")
