"""The port's row-block CSR5 distribution (``parallel/distributed.py``)
against the JAX package's on its 8-device virtual CPU mesh.

- Each rank's shard, built in this process by ``build_shard(rank, D)``
  (no process group), equals the JAX ``da.local[d]`` plane for plane and
  in every static field, at D in {2, 4, 5, 8}, halo none/auto, convert
  host/device; the chosen halo and ``x_bytes_exchanged`` equal JAX's,
  the scattered and the rounding cases of ``tests/test_distributed.py``
  included.
- Then one spawn of 8 gloo ranks (``parallel.launch.run_ranks``) runs
  the JAX file's cases on meshes of the first D ranks: banded, uneven
  rows (1001 over 8), power law, an empty shard, halo against
  all-gather, the device conversion (uneven at 5, scattered), SpMM at (4,
  8) and (8, 16), ragged R = 6 over 4, CG on the rank-local form. Every
  rank's y equals scipy's exactly on the integer data and JAX's
  ``distributed_spmv``/``distributed_spmm``.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_scenarios as S
from benchmark_spmv_using_csr5_tpu.parallel import distributed as jd
from benchmark_spmv_using_csr5_tpu_torch.models.formats import PLANE_FIELDS, STATIC_FIELDS
from benchmark_spmv_using_csr5_tpu_torch.parallel import distributed as pd
from benchmark_spmv_using_csr5_tpu_torch.parallel.launch import run_ranks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: (key, D, scenario, kwargs) run by the spawned ranks
JOBS = [
    ("banded_2", 2, "spmv", {"name": "banded1024_9"}),
    ("banded_4", 4, "spmv", {"name": "banded1024_9"}),
    ("banded_8", 8, "spmv", {"name": "banded1024_9"}),
    ("uneven_8", 8, "spmv", {"name": "banded1001_7"}),
    ("powerlaw_4", 4, "spmv", {"name": "powerlaw2000"}),
    ("empty_8", 8, "spmv", {"name": "empty9"}),
    ("full_8", 8, "spmv", {"name": "banded4096_9"}),
    ("halo_8", 8, "spmv", {"name": "banded4096_9", "halo": "auto"}),
    ("rounding_8", 8, "spmv", {"name": "halo_round", "halo": "auto"}),
    ("dev_none_4", 4, "spmv", {"name": "banded1024_9", "convert": "device"}),
    ("dev_auto_4", 4, "spmv", {"name": "banded1024_9", "halo": "auto", "convert": "device"}),
    ("host_auto_4", 4, "spmv", {"name": "banded1024_9", "halo": "auto"}),
    ("dev_uneven_5", 5, "spmv", {"name": "banded520_7", "convert": "device"}),
    ("dev_scattered_4", 4, "spmv", {"name": "powerlaw800", "convert": "device"}),
    ("host_scattered_4", 4, "spmv", {"name": "powerlaw800"}),
    ("alpha_5", 5, "spmv", {"name": "banded1024_9", "halo": "auto", "alpha": -1.75}),
    ("spmm_4_8", 4, "spmm", {"name": "banded1024_9", "R": 8}),
    ("spmm_8_16", 8, "spmm", {"name": "banded1024_9", "R": 16}),
    ("spmm_5_7", 5, "spmm", {"name": "banded520_7", "R": 7}),
    ("ragged_4_6", 4, "spmm", {"name": "powerlaw600", "R": 6, "ragged": True}),
    ("cg_4", 4, "cg", {}),
]
JOB = {key: (D, kind, kw) for key, D, kind, kw in JOBS}


@pytest.fixture(scope="module")
def ranks():
    """Every rank's results of JOBS, from one spawn of 8 gloo ranks."""
    return run_ranks(S.run, 8, JOBS)


def _jax_da(name, D, halo="none", convert="host"):
    a = S.matrix(name)
    mesh = jd.make_mesh(D)
    return a, mesh, jd.distribute_csr(a.indptr, a.indices, a.data, a.shape, mesh,
                                      halo=halo, convert=convert)


def _shards(name, D, halo="none", convert="host"):
    a = S.matrix(name)
    return [pd.build_shard(a.indptr, a.indices, a.data, a.shape, d, D, halo=halo,
                           convert=convert, device="cpu") for d in range(D)]


def _np(t):
    return t.view(torch.int32).numpy().view(np.uint32) if t.dtype == torch.uint32 else t.numpy()


@pytest.mark.parametrize("convert", ["host", "device"])
@pytest.mark.parametrize("halo", ["none", "auto"])
@pytest.mark.parametrize("name,D", [("banded1024_9", 2), ("banded1024_9", 4), ("banded1024_9", 8),
                                    ("banded520_7", 5), ("powerlaw2000", 4)])
def test_shard_planes_match_jax(name, D, halo, convert):
    _, _, da = _jax_da(name, D, halo, convert)
    shards = _shards(name, D, halo, convert)
    for d, s in enumerate(shards):
        assert s.halo == da.halo and s.rows_per_shard == da.rows_per_shard
        assert s.x_bytes_exchanged() == da.x_bytes_exchanged()
        assert s.config.sigma == da.config.sigma and s.num_devices == D and s.rank == d
        loc = s.local
        for f in STATIC_FIELDS:
            if f == "config":
                assert loc.config.sigma == da.local.config.sigma
            else:
                assert getattr(loc, f) == getattr(da.local, f), (d, f)
        for f in PLANE_FIELDS:
            got, ref = getattr(loc, f), getattr(da.local, f)
            assert (got is None) == (ref is None), (d, f)
            if got is not None:
                np.testing.assert_array_equal(_np(got), np.asarray(ref)[d], err_msg=f"{d} {f}")
    # the route: device wherever the JAX device conversion ran (uniform statics)
    routes = {s.convert_route for s in shards}
    assert len(routes) == 1
    if convert == "host":
        assert routes == {"host"}


@pytest.mark.parametrize("name,D,halo", [
    ("random1024", 8, "auto"),  # the halo would span the row of devices
    ("halo_round", 8, "auto"),  # fits before the lane rounding, not after
    ("banded4096_9", 8, "auto"),
    ("banded4096_9", 8, "none"),
    ("banded1024_9", 1, "auto"),  # one device: no halo
    ("banded1001_7", 8, "auto"),
])
def test_halo_choice_and_bytes_match_jax(name, D, halo):
    _, _, da = _jax_da(name, D, halo)
    s = _shards(name, D, halo)[0]
    assert s.halo == da.halo and s.x_bytes_exchanged() == da.x_bytes_exchanged()
    assert s.x_bytes_exchanged(8) == da.x_bytes_exchanged(8)
    if name == "random1024":
        assert s.halo is None
    if name == "banded4096_9" and halo == "auto":
        assert s.halo[0] <= 128 and s.halo[1] <= 128
        assert s.x_bytes_exchanged() < _shards(name, D)[0].x_bytes_exchanged() // 4


def _agree(ranks, key):
    """The key's result on rank 0, after checking that every rank of its
    mesh returned the same vector and no other rank ran it."""
    D = JOB[key][0]
    got = [ranks[r][key] for r in range(D)]
    assert all(key not in ranks[r] for r in range(D, 8))
    field = "x" if "x" in got[0] else "y"
    for g in got[1:]:
        np.testing.assert_array_equal(g[field], got[0][field])
    return got[0]


SPMV_KEYS = [k for k, _, kind, _ in JOBS if kind == "spmv"]


@pytest.mark.parametrize("key", SPMV_KEYS)
def test_gloo_spmv_matches_scipy_and_jax(ranks, key):
    D, _, kw = JOB[key]
    out = _agree(ranks, key)
    a = S.matrix(kw["name"])
    x = S.x_of(a)
    alpha = kw.get("alpha", 1.0)
    np.testing.assert_array_equal(out["y"], (alpha * (a @ x)).astype(np.float32))
    _, mesh, da = _jax_da(kw["name"], D, kw.get("halo", "none"), kw.get("convert", "host"))
    assert out["halo"] == da.halo and out["bytes"] == da.x_bytes_exchanged()
    yj = np.asarray(jax.jit(lambda xx: jd.distributed_spmv(da, xx, mesh, alpha))(jnp.asarray(x)))
    np.testing.assert_array_equal(out["y"], yj)
    if kw.get("convert") == "device" and kw["name"].startswith("banded"):
        assert out["route"] == "device"


@pytest.mark.parametrize("key", ["spmm_4_8", "spmm_8_16", "spmm_5_7", "ragged_4_6"])
def test_gloo_spmm_matches_scipy_and_jax(ranks, key):
    D, _, kw = JOB[key]
    out = _agree(ranks, key)
    a = S.matrix(kw["name"])
    xm = S.xm_of(a, kw["R"], kw.get("ragged", False))
    assert out["y"].shape == (a.shape[0], kw["R"])
    np.testing.assert_array_equal(out["y"], a @ xm)
    _, mesh, da = _jax_da(kw["name"], D)
    yj = np.asarray(jax.jit(lambda xx: jd.distributed_spmm(da, xx, mesh))(jnp.asarray(xm)))
    np.testing.assert_array_equal(out["y"], yj)


def test_gloo_device_and_host_routes_agree(ranks):
    for dev_key, host_key in (("dev_scattered_4", "host_scattered_4"), ("dev_auto_4", "host_auto_4"),
                              ("dev_none_4", "banded_4")):
        np.testing.assert_array_equal(_agree(ranks, dev_key)["y"], _agree(ranks, host_key)["y"])


def test_gloo_cg_on_the_rank_local_form(ranks):
    x = _agree(ranks, "cg_4")["x"]
    a = S.matrix("cg256")
    np.testing.assert_allclose(a @ x, np.ones(a.shape[0]), atol=1e-3)


def test_spmm_refuses_halo_shards():
    s = _shards("banded4096_9", 8, "auto")[0]
    mesh = pd.Mesh(group=None, size=8, rank=0, device=torch.device("cpu"), backend="gloo")
    with pytest.raises(ValueError, match="halo='none'"):
        pd.distributed_spmm(s, torch.ones(4096, 2), mesh)


def test_mesh_needs_a_process_group_and_nccl_on_the_card():
    with pytest.raises(RuntimeError, match="no process group"):
        pd.make_mesh(1, device="cpu")
    code = (
        "import torch.distributed as dist, torch; "
        "from benchmark_spmv_using_csr5_tpu_torch.parallel import distributed as pd, launch; "
        "import unittest.mock as um\n"
        "with launch.single_rank_group('cpu'):\n"
        "    m = pd.make_mesh(device='cpu'); print(m.size, m.rank, m.backend)\n"
        "    with um.patch('torch.cuda.is_available', lambda: True):\n"
        "        try:\n"
        "            pd.make_mesh(device='cuda')\n"
        "        except RuntimeError as e:\n"
        "            print('refused:', e)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0] == "1 0 gloo"
    assert lines[1].startswith("refused:") and "NCCL" in lines[1]
