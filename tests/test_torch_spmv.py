"""The port's CSR5 SpMV executors against the JAX package's.

``csr5_spmv_torch`` is the plain PyTorch version of kernel K1 and the
only executor that runs here (no GPU). It is held against the JAX Pallas
kernel in interpret mode (small ``tiles_per_block``, as
``tests/test_csr5_kernel.py`` runs it), the JAX XLA executor and scipy,
on a matrix the port converted and on one carried across from the JAX
package by ``csr5_from_numpy``.

Tolerances: on the integer-valued data (values and x in 1-9) every
partial sum is an integer below 2**24, so all executors agree exactly.
On random floats the executors sum the tile prefix in another order:
rtol 1e-5 against each row's absolute sum |A| @ |x|.
"""

import subprocess
import sys

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import benchmark_spmv_using_csr5_tpu as J
import benchmark_spmv_using_csr5_tpu_torch as P
from benchmark_spmv_using_csr5_tpu.ops.csr5_kernel import csr5_spmv_pallas
from benchmark_spmv_using_csr5_tpu.utils import perf as jperf
from benchmark_spmv_using_csr5_tpu_torch.models.formats import PLANE_FIELDS, STATIC_FIELDS
from benchmark_spmv_using_csr5_tpu_torch.ops import csr5_kernel
from benchmark_spmv_using_csr5_tpu_torch.utils import cuda_build, perf, synth

FLOAT_RTOL = 1e-5


def _carry(a5j):
    """The JAX matrix's planes and static fields, carried into the port."""
    planes = {}
    for f in PLANE_FIELDS:
        v = getattr(a5j, f)
        planes[f] = None if v is None else np.asarray(v)
    static = {f: getattr(a5j, f) for f in STATIC_FIELDS}
    return P.csr5_from_numpy(planes, static, device="cpu")


def _both(
    a_sp, sigma=None, win_mode="auto", value_dtype=None, alpha=1.0, x=None, pallas=True
):
    """y from the port (own conversion and carried across), the JAX
    interpret-mode kernel (when ``pallas``; it is the slow one), the JAX
    XLA executor, and scipy."""
    a = sp.csr_matrix(a_sp).astype(np.float32)
    host = (a.indptr, a.indices, a.data, a.shape)
    sig = sigma or J.compute_sigma(a.shape[0], a.nnz)
    if x is None:
        x = synth.dense_x(a.shape[1], dtype=np.float32)
    a5j = J.build_csr5(
        host, J.CSR5Config(sigma=sig, tiles_per_block=8), value_dtype=value_dtype,
        win_mode=win_mode,
    )
    a5p = P.build_csr5(
        host, P.CSR5Config(sigma=sig, tiles_per_block=8), value_dtype=value_dtype,
        win_mode=win_mode, device="cpu",
    )
    xt = torch.from_numpy(x)
    ys = {
        "port": P.csr5_spmv_torch(a5p, xt, alpha).numpy(),
        "carried": P.csr5_spmv_torch(_carry(a5j), xt, alpha).numpy(),
        "xla": np.asarray(J.csr5_spmv_xla(a5j, x, alpha=alpha)),
        "scipy": (alpha * (a @ x)).astype(np.float32),
    }
    if pallas:
        ys["pallas"] = np.asarray(csr5_spmv_pallas(a5j, x, alpha=alpha, interpret=True))
    return ys


def _assert_exact(ys, name=""):
    for k in ys.keys() - {"port"}:
        np.testing.assert_array_equal(ys["port"], ys[k], err_msg=f"{name} port vs {k}")


@pytest.mark.parametrize("win_mode", ["auto", "aligned"])
def test_spmv_edge_cases_exact(edge_matrix, win_mode):
    name, a_sp = edge_matrix
    # the interpret-mode Pallas kernel on the wrapped maps it runs by default
    _assert_exact(_both(a_sp, win_mode=win_mode, pallas=win_mode == "auto"), name)


@pytest.mark.parametrize("sigma", [8, 16, 24, 32])
def test_spmv_sigmas_exact(sigma):
    _assert_exact(_both(synth.power_law(700, 600, 8.0, seed=11), sigma=sigma))


def test_spmv_bf16_storage_exact():
    ys = _both(synth.banded(1500, 27), value_dtype="auto")
    _assert_exact(ys)


def test_spmv_alpha_exact():
    _assert_exact(_both(synth.banded(300, 9), alpha=-1.75))


def test_spmv_row_spanning_many_tiles_exact():
    a = synth.single_dense_row(64, 30000, row_nnz=20000)
    _assert_exact(_both(a, sigma=8, pallas=False))


@pytest.mark.parametrize("win_mode", ["auto", "aligned"])
def test_spmv_random_floats_within_rtol(win_mode):
    rng = np.random.default_rng(5)
    a = sp.csr_matrix(synth.banded(2000, 27)).astype(np.float32)
    a.data = rng.uniform(-1, 1, a.nnz).astype(np.float32)
    x = rng.uniform(-1, 1, a.shape[1]).astype(np.float32)
    ys = _both(a, win_mode=win_mode, x=x, pallas=win_mode == "auto")
    y64 = a.astype(np.float64) @ x.astype(np.float64)
    lim = FLOAT_RTOL * (abs(a).astype(np.float64) @ np.abs(x).astype(np.float64))
    for k in ys.keys() - {"scipy"}:
        assert (np.abs(ys[k] - y64) <= lim).all(), k
    assert (np.abs(ys["port"] - ys["xla"]) <= lim).all()


def test_csr_oracle_matches_scipy(edge_matrix):
    name, a_sp = edge_matrix
    a = sp.csr_matrix(a_sp).astype(np.float32)
    csr = P.CSRMatrix(
        row_ptr=torch.from_numpy(a.indptr.astype(np.int32)),
        col_idx=torch.from_numpy(a.indices.astype(np.int32)),
        values=torch.from_numpy(a.data),
        shape=a.shape,
    )
    x = synth.dense_x(a.shape[1], dtype=np.float32)
    np.testing.assert_array_equal(
        P.csr_spmv(csr, torch.from_numpy(x)).numpy(), a @ x, err_msg=name
    )
    np.testing.assert_array_equal(
        P.csr_spmv_numpy(a.indptr, a.indices, a.data, x), a @ x, err_msg=name
    )


def test_dispatcher_runs_plain_version_on_cpu():
    a = sp.csr_matrix(synth.banded(500, 9)).astype(np.float32)
    a5 = P.build_csr5((a.indptr, a.indices, a.data, a.shape), device="cpu")
    x = torch.from_numpy(synth.dense_x(500, dtype=np.float32))
    before = cuda_build.launches["csr5_spmv"]
    assert torch.equal(P.csr5_spmv(a5, x), P.csr5_spmv_torch(a5, x))
    assert torch.equal(P.csr5_spmv(a5, x, backend="torch"), P.csr5_spmv_torch(a5, x))
    assert cuda_build.launches["csr5_spmv"] == before


@pytest.mark.parametrize("call", ["dispatch", "wrapper"])
def test_cuda_path_on_cpu_tensors_raises(call):
    """Asking for the kernel with CPU tensors raises before any build:
    nothing falls back to the plain version."""
    a = sp.csr_matrix(synth.banded(200, 9)).astype(np.float32)
    a5 = P.build_csr5((a.indptr, a.indices, a.data, a.shape), device="cpu")
    x = torch.ones(200)
    with pytest.raises(ValueError, match="CUDA tensors"):
        if call == "dispatch":
            P.csr5_spmv(a5, x, backend="cuda")
        else:
            csr5_kernel.csr5_spmv_cuda(a5, x)
    assert "csr5_spmv" not in cuda_build.loaded()


def test_dispatcher_rejects_unknown_backend():
    a = sp.csr_matrix(synth.banded(200, 9)).astype(np.float32)
    a5 = P.build_csr5((a.indptr, a.indices, a.data, a.shape), device="cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        P.csr5_spmv(a5, torch.ones(200), backend="pallas")


@pytest.mark.parametrize(
    "bad,match",
    [
        (lambda p, w: torch.ones(p, w, dtype=torch.float64), "win_map has dtype"),
        (lambda p, w: torch.ones(p, w + 1, dtype=torch.int32), "win_map has shape"),
        (lambda p, w: torch.ones(w, p, dtype=torch.int32).t(), "win_map is not contiguous"),
    ],
)
def test_wrapper_plane_checks_raise(bad, match):
    """A wrong plane raises when the wrapper makes the matrix's launch plan."""
    a = sp.csr_matrix(synth.banded(600, 9)).astype(np.float32)
    a5 = P.build_csr5((a.indptr, a.indices, a.data, a.shape), device="cpu")
    a5.win_map = bad(a5.num_tiles, a5.capw)
    with pytest.raises(ValueError, match=match):
        csr5_kernel._plan(a5, a5.device, "csr5_spmv_cuda")


def test_perf_models_match_jax():
    for m, nnz in ((6, 11), (500000, 13999804)):
        for vb in (4, 8):
            assert perf.get_bytes(m, nnz, 4, vb) == jperf.get_bytes(m, nnz, 4, vb)
        assert perf.get_flops(nnz) == jperf.get_flops(nnz)


@pytest.mark.parametrize(
    "name,gbps",
    [
        ("NVIDIA H100 80GB HBM3", 3350.0),
        ("NVIDIA H100 PCIe", 2000.0),
        ("NVIDIA H100 NVL", 3900.0),
    ],
)
def test_roofline_table(name, gbps):
    assert perf.device_hbm_gbps(name) == gbps


def test_roofline_unknown_device_raises():
    with pytest.raises(ValueError, match="no HBM bandwidth"):
        perf.device_hbm_gbps("NVIDIA A100-SXM4-80GB")


def test_import_loads_no_jax_and_builds_nothing():
    """Importing the port and every submodule loads no jax, flax or
    ml_dtypes, and builds no CUDA library."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import benchmark_spmv_using_csr5_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "from benchmark_spmv_using_csr5_tpu_torch.utils import cuda_build\n"
        "bad = [m for m in ('jax', 'flax', 'ml_dtypes') if m in sys.modules]\n"
        "assert not bad, bad\n"
        "assert not cuda_build.loaded() and not cuda_build.build_seconds\n"
        "print('ok', len(sys.modules))\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")
