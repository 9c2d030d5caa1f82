"""The port's row-block DIA distribution (``parallel/distributed_dia.py``)
against the JAX package's on its virtual CPU mesh, after
``tests/test_distributed_dia.py``: each rank's slab equals the JAX
``dd.data[d]`` with the same offsets, rows per shard, halo and
``x_bytes_exchanged`` at D in {2, 4, 5, 8}; then one spawn of 8 gloo
ranks runs banded SpMV over 2, 4, 5 and 8 ranks, uneven rows with alpha,
the tridiagonal halo, the wide-offset all-gather and SpMM at R = 4 and 6,
every rank's y equal to scipy's on the integer data and to the JAX
``distributed_dia_spmv``/``_spmm`` (its ``xla`` route)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_scenarios as S
from benchmark_spmv_using_csr5_tpu.parallel import distributed_dia as jdd
from benchmark_spmv_using_csr5_tpu.parallel.distributed import make_mesh as jmake_mesh
from benchmark_spmv_using_csr5_tpu_torch.parallel import distributed_dia as pdd
from benchmark_spmv_using_csr5_tpu_torch.parallel.launch import run_ranks

JOBS = [
    ("banded_2", 2, "dia_spmv", {"name": "banded1024_9"}),
    ("banded_4", 4, "dia_spmv", {"name": "banded1024_9"}),
    ("banded_5", 5, "dia_spmv", {"name": "banded1024_9"}),
    ("banded_8", 8, "dia_spmv", {"name": "banded1024_9"}),
    ("uneven_alpha_8", 8, "dia_spmv", {"name": "banded1000_7", "alpha": 2.5}),
    ("tridiag_4", 4, "dia_spmv", {"name": "banded2048_3"}),
    ("wide_4", 4, "dia_spmv", {"name": "wide_offsets"}),
    ("traffic_8", 8, "dia_spmv", {"name": "banded4096_9"}),
    ("spmm_4_4", 4, "dia_spmm", {"name": "banded1024_5", "R": 4}),
    ("spmm_4_6", 4, "dia_spmm", {"name": "banded1024_5", "R": 6}),
    ("spmm_5_3", 5, "dia_spmm", {"name": "banded1024_5", "R": 3}),
]
JOB = {key: (D, kind, kw) for key, D, kind, kw in JOBS}


@pytest.fixture(scope="module")
def ranks():
    return run_ranks(S.run, 8, JOBS)


def _jax_dd(name, D):
    a = S.matrix(name)
    mesh = jmake_mesh(D)
    return a, mesh, jdd.distribute_dia(a, mesh)


@pytest.mark.parametrize("name,D", [("banded1024_9", 2), ("banded1024_9", 4), ("banded1024_9", 5),
                                    ("banded1024_9", 8), ("banded1000_7", 8), ("banded2048_3", 4),
                                    ("wide_offsets", 4), ("banded4096_9", 8)])
def test_slabs_match_jax(name, D):
    a, _, dd = _jax_dd(name, D)
    ref = np.asarray(dd.data)
    for d in range(D):
        s = pdd.build_dia_shard(a, d, D, device="cpu")
        assert (s.offsets, s.rows_per_shard, s.halo, s.nnz_stored) == (
            dd.offsets, dd.rows_per_shard, dd.halo, dd.nnz_stored)
        assert s.x_bytes_exchanged() == dd.x_bytes_exchanged() and s.rank == d
        assert s.local.data.dtype == torch.float32 and s.local.interleaved
        np.testing.assert_array_equal(s.local.data.numpy(), ref[d], err_msg=str(d))
        # the slab's kernel view: offsets shifted by the left window
        w_l = dd.halo[0] if dd.halo is not None else jdd._halo_widths(dd)[0]
        assert s.local.offsets == tuple(o + w_l for o in dd.offsets)
    if name == "banded4096_9":
        assert s.x_bytes_exchanged() == (128 + 128) * 4
    if name == "wide_offsets":
        assert s.halo is None
    if name == "banded2048_3":
        assert s.halo == (128, 128)


def test_rejects_scattered():
    a = S.matrix("random1024")
    assert pdd.build_dia_shard(a, 0, 4, device="cpu") is None
    assert jdd.distribute_dia(a, jmake_mesh(4)) is None


def _agree(ranks, key):
    D = JOB[key][0]
    got = [ranks[r][key] for r in range(D)]
    assert all(key not in ranks[r] for r in range(D, 8))
    for g in got[1:]:
        np.testing.assert_array_equal(g["y"], got[0]["y"])
    return got[0]


@pytest.mark.parametrize("key", [k for k, _, kind, _ in JOBS if kind == "dia_spmv"])
def test_gloo_dia_spmv_matches_scipy_and_jax(ranks, key):
    D, _, kw = JOB[key]
    out = _agree(ranks, key)
    a, mesh, dd = _jax_dd(kw["name"], D)
    alpha = kw.get("alpha", 1.0)
    x = S.x_of(a)
    np.testing.assert_array_equal(out["y"], (alpha * (a @ x)).astype(np.float32))
    assert out["halo"] == dd.halo and out["bytes"] == dd.x_bytes_exchanged()
    yj = jax.jit(lambda xx: jdd.distributed_dia_spmv(dd, xx, mesh, alpha, "xla"))(jnp.asarray(x))
    np.testing.assert_array_equal(out["y"], np.asarray(yj))


@pytest.mark.parametrize("key", ["spmm_4_4", "spmm_4_6", "spmm_5_3"])
def test_gloo_dia_spmm_matches_scipy_and_jax(ranks, key):
    D, _, kw = JOB[key]
    out = _agree(ranks, key)
    a, mesh, dd = _jax_dd(kw["name"], D)
    xm = S.xm_of(a, kw["R"])
    np.testing.assert_array_equal(out["y"], a @ xm)
    yj = jax.jit(lambda xx: jdd.distributed_dia_spmm(dd, xx, mesh, 1.0, "xla"))(jnp.asarray(xm))
    np.testing.assert_array_equal(out["y"], np.asarray(yj))
