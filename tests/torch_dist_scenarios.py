"""The scenarios the distributed tests run in spawned gloo ranks
(``parallel.launch.run_ranks``): module-level functions, so the children
can import them, that build the same matrices as the tests from the same
seeds and return numpy results. All the scenarios of a test file run in
one spawn (:func:`run`), on meshes of the first D ranks."""

import numpy as np
import scipy.sparse as sp
import torch

from benchmark_spmv_using_csr5_tpu_torch.parallel import distributed as pd
from benchmark_spmv_using_csr5_tpu_torch.parallel import distributed_dia as pdd
from benchmark_spmv_using_csr5_tpu_torch.parallel import scaling
from benchmark_spmv_using_csr5_tpu_torch.utils import synth


def _halo_round():
    """A diagonal plus one entry 130 columns left of row 200: a halo that
    fits n_per = 128 before the lane rounding and not after it."""
    m = n = 1024
    extra = sp.csr_matrix((np.ones(1, np.float32), ([200], [200 - 130])), shape=(m, n))
    return (sp.eye(m, n, format="csr", dtype=np.float32) + extra).tocsr()


def _cg256():
    a = synth.banded(256, 5, dtype=np.float32)
    return sp.csr_matrix((a + a.T) * 0.5 + sp.eye(256) * 50.0).astype(np.float32)


def _wide_offsets():
    m, far = 1024, 16384 + 256
    return sp.diags([np.ones(m), np.ones(m)], [0, far], shape=(m, m + far),
                    format="csr").astype(np.float32)


#: name -> factory of a float32 scipy CSR matrix (the JAX tests' matrices)
MATRICES = {
    "banded1024_9": lambda: synth.banded(1024, 9, dtype=np.float32),
    "banded1001_7": lambda: synth.banded(1001, 7, dtype=np.float32),
    "powerlaw2000": lambda: synth.power_law(2000, 2000, 6.0, seed=3).astype(np.float32),
    "empty9": lambda: sp.csr_matrix((np.ones(3, np.float32), ([0, 1, 2], [0, 1, 2])), shape=(9, 9)),
    "banded4096_9": lambda: synth.banded(4096, 9, dtype=np.float32),
    "random1024": lambda: synth.random_csr(1024, 1024, 0.02, dtype=np.float32),
    "halo_round": _halo_round,
    "banded520_7": lambda: synth.banded(520, 7, dtype=np.float32),
    "powerlaw800": lambda: sp.csr_matrix(synth.power_law(800, 800, 6.0, dtype=np.float32)),
    "powerlaw600": lambda: synth.power_law(600, 600, 5.0, dtype=np.float32),
    "cg256": _cg256,
    "banded2048_3": lambda: synth.banded(2048, 3, dtype=np.float32),
    "banded1000_7": lambda: synth.banded(1000, 7, dtype=np.float32),
    "banded1024_5": lambda: synth.banded(1024, 5, dtype=np.float32),
    "wide_offsets": _wide_offsets,
}


def matrix(name):
    return sp.csr_matrix(MATRICES[name]())


def x_of(a):
    return synth.dense_x(a.shape[1], dtype=np.float32)


def xm_of(a, R, ragged=False):
    if ragged:
        return x_of(a)[:, None] * np.ones((1, R), np.float32)
    return np.random.default_rng(4).integers(1, 10, (a.shape[1], R)).astype(np.float32)


def _spmv(mesh, name, halo="none", convert="host", alpha=1.0):
    a = matrix(name)
    da = pd.distribute_csr(a.indptr, a.indices, a.data, a.shape, mesh, halo=halo, convert=convert)
    y = pd.distributed_spmv(da, torch.from_numpy(x_of(a)), mesh, alpha)
    return {"y": y.numpy(), "halo": da.halo, "bytes": da.x_bytes_exchanged(),
            "route": da.convert_route, "rows_per": da.rows_per_shard}


def _spmm(mesh, name, R, ragged=False):
    a = matrix(name)
    da = pd.distribute_csr(a.indptr, a.indices, a.data, a.shape, mesh)
    return {"y": pd.distributed_spmm(da, torch.from_numpy(xm_of(a, R, ragged)), mesh).numpy()}


def _cg(mesh, iters=100):
    """CG on the rank-local form: each rank holds its blocks of x, r and
    p, the products exchange x shards, the dot products are all-reduced."""
    a = matrix("cg256")
    da = pd.distribute_csr(a.indptr, a.indices, a.data, a.shape, mesh)
    n_per = -(-a.shape[0] // mesh.size)
    b = pd.shard_of(torch.ones(a.shape[0]), n_per, mesh)

    def dot(u, v):
        s = torch.dot(u, v).reshape(1)
        torch.distributed.all_reduce(s, group=mesh.group)
        return s[0]

    x = torch.zeros_like(b)
    r, p = b.clone(), b.clone()
    rs = dot(r, r)
    for _ in range(iters):
        ap = pd.distributed_spmv_local(da, p, mesh)
        den = dot(p, ap)
        alpha = rs / den if den != 0 else torch.zeros(())
        x, r = x + alpha * p, r - alpha * ap
        rs_new = dot(r, r)
        p = r + (rs_new / rs if rs != 0 else 0.0) * p
        rs = rs_new
    return {"x": pd.all_gather_cat(x, mesh)[: a.shape[0]].numpy()}


def _dia_spmv(mesh, name, alpha=1.0):
    a = matrix(name)
    dd = pdd.distribute_dia(a, mesh)
    y = pdd.distributed_dia_spmv(dd, torch.from_numpy(x_of(a)), mesh, alpha)
    return {"y": y.numpy(), "halo": dd.halo, "bytes": dd.x_bytes_exchanged(),
            "rows_per": dd.rows_per_shard}


def _dia_spmm(mesh, name, R):
    a = matrix(name)
    dd = pdd.distribute_dia(a, mesh)
    return {"y": pdd.distributed_dia_spmm(dd, torch.from_numpy(xm_of(a, R)), mesh, 1.0).numpy()}


def _weak(mesh):
    pts = scaling.weak_scaling([1, 2], rows_per_device=2048, iters=3, device="cpu")
    return {"points": [vars(p) for p in pts], "report": scaling.report(pts)}


SCENARIOS = {
    "spmv": _spmv,
    "spmm": _spmm,
    "cg": _cg,
    "dia_spmv": _dia_spmv,
    "dia_spmm": _dia_spmm,
    "weak": _weak,
}


def run(rank, world_size, jobs):
    """Rank ``rank``'s results of ``jobs``, a list of ``(key, D, scenario,
    kwargs)``: ``{key: result}`` for each job whose mesh (the first D
    ranks) holds this rank. Every rank makes every mesh, in job order."""
    meshes, out = {}, {}
    for key, D, kind, kw in jobs:
        if D not in meshes:
            meshes[D] = pd.make_mesh(D, device="cpu")
        if meshes[D].rank is not None:
            out[key] = SCENARIOS[kind](meshes[D], **kw)
    return out
