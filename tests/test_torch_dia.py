"""The port's DIA format and the plain versions of K5/K6 against the JAX
package's.

``build_dia`` must give the JAX plane element for element, on both build
routes (the native plan + fill, and the numpy route) and both layouts.
``dia_spmv_torch`` and ``dia_spmm_torch`` are the plain versions of the
CUDA kernels K5 and K6, the only DIA executors that run here (no GPU);
they are held against the JAX Pallas kernels in interpret mode, the JAX
XLA executors and scipy.

Tolerances: on integer-valued data (values in -4..4 or 1-9, x in 1-9,
alpha -1.75 or 0.5) every partial sum is exact in float32, so all
executors agree exactly. On random floats the JAX XLA executor may fuse
multiply-adds: rtol 1e-5 against each row's absolute sum |A| @ |x|.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import benchmark_spmv_using_csr5_tpu.ops.dia as jdia
import benchmark_spmv_using_csr5_tpu_torch as P
from benchmark_spmv_using_csr5_tpu.utils import nativelib as jnative
from benchmark_spmv_using_csr5_tpu_torch.models.formats import DIA_STATIC_FIELDS
from benchmark_spmv_using_csr5_tpu_torch.ops import dia as pdia
from benchmark_spmv_using_csr5_tpu_torch.ops import dia_kernel
from benchmark_spmv_using_csr5_tpu_torch.utils import cuda_build, synth
from benchmark_spmv_using_csr5_tpu_torch.utils import nativelib as pnative

FLOAT_RTOL = 1e-5
C = pdia.CHUNK_ROWS


def _ints(a_sp, seed=0):
    """float32 CSR with integer values in -4..4 (zeros kept as entries)."""
    a = sp.csr_matrix(a_sp).astype(np.float32)
    a.data = np.random.default_rng(seed).integers(-4, 5, a.nnz).astype(np.float32)
    return a


def _dup():
    """Duplicate (row, col) entries, kept unsummed in the CSR arrays."""
    ptr = np.array([0, 2, 3, 4, 6])
    cols = np.array([1, 1, 2, 3, 0, 0])
    vals = np.array([1.0, 2.0, 5.0, 7.0, 3.0, -4.0], np.float32)
    return ptr, cols, vals, (4, 4)


MATRICES = {
    "banded3000_7": lambda: _ints(synth.banded(3000, 7)),
    "m40": lambda: _ints(synth.banded(40, 9)),
    "m700": lambda: _ints(synth.banded(700, 9)),
    "m1500": lambda: _ints(synth.banded(1500, 27)),
    "rect_wide": lambda: _ints(sp.diags([np.ones(300)], [40], shape=(300, 400))),
    "rect_tall_neg": lambda: _ints(
        sp.diags([np.ones(700), np.ones(700)], [-300, 5], shape=(1000, 705))
    ),
    "far_offset": lambda: _ints(
        sp.diags([np.ones(600), np.ones(600)], [0, C + 256], shape=(600, C + 1000))
    ),
    "duplicates": _dup,
}


def _host(a):
    if isinstance(a, tuple):
        return a
    return (a.indptr, a.indices, a.data, a.shape)


def _scipy(host):
    rp, ci, v, shape = host
    return sp.csr_matrix((v, ci, rp), shape=shape)  # sums duplicates in @


@pytest.fixture
def numpy_route(monkeypatch):
    """Both packages without the native plan: the numpy build route."""
    monkeypatch.setattr(jnative, "dia_plan", lambda *a, **k: None)
    monkeypatch.setattr(pnative, "dia_plan", lambda *a, **k: None)


def _jax_plane(dj):
    d = np.asarray(dj.data)
    return d.astype(np.float32) if d.dtype.name == "bfloat16" else d


def assert_same_dia(dp, dj):
    data, static = P.dia_to_numpy(dp)
    for f in DIA_STATIC_FIELDS:
        assert static[f] == getattr(dj, f), f
    ref = _jax_plane(dj)
    assert data.shape == ref.shape and data.dtype == ref.dtype
    np.testing.assert_array_equal(data, ref)
    assert dp.offsets_t.tolist() == list(dj.offsets)


@pytest.mark.parametrize("route", ["native", "numpy"])
@pytest.mark.parametrize("layout", ["interleaved", "diag"])
@pytest.mark.parametrize("name", list(MATRICES))
def test_build_dia_planes_match_jax(name, layout, route, request):
    if route == "numpy":
        request.getfixturevalue("numpy_route")
    host = _host(MATRICES[name]())
    dj = jdia.build_dia(host, layout=layout)
    dp = P.build_dia(host, layout=layout)
    assert dj is not None and dp is not None
    assert_same_dia(dp, dj)


@pytest.mark.parametrize(
    "make",
    [
        lambda: sp.random(500, 500, 0.01, format="csr", dtype=np.float32, random_state=3),
        lambda: synth.random_csr(400, 400, 0.05, seed=1).tocsr().astype(np.float32),
        lambda: sp.csr_matrix((4, 4), dtype=np.float32),
    ],
    ids=["random", "scattered", "empty"],
)
def test_build_dia_gates_unstructured_like_jax(make):
    host = _host(make())
    assert jdia.build_dia(host) is None
    assert P.build_dia(host) is None


def test_float64_values_narrow_to_float32(numpy_route):
    a = sp.csr_matrix(synth.banded(700, 9, dtype=np.float64))
    dp = P.build_dia(_host(a))
    dj = jdia.build_dia(_host(a))
    assert dp.data.dtype == torch.float32
    np.testing.assert_array_equal(dp.data.numpy(), np.asarray(dj.data).astype(np.float32))


def _x(n, r=None, seed=1):
    shape = n if r is None else (n, r)
    return np.random.default_rng(seed).integers(1, 10, shape).astype(np.float32)


@pytest.mark.parametrize("alpha", [1.0, -1.75])
@pytest.mark.parametrize("vdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["interleaved", "diag"])
@pytest.mark.parametrize("name", ["m700", "rect_tall_neg", "far_offset", "duplicates"])
def test_dia_spmv_plain_matches_jax_exactly(name, layout, vdt, alpha):
    import ml_dtypes

    host = _host(MATRICES[name]())
    jvdt = ml_dtypes.bfloat16 if vdt == "bfloat16" else None
    dj = jdia.build_dia(host, layout=layout, value_dtype=jvdt)
    dp = P.build_dia(host, layout=layout, value_dtype=getattr(torch, vdt))
    x = _x(host[3][1])
    y = pdia.dia_spmv_torch(dp, torch.from_numpy(x), alpha).numpy()
    np.testing.assert_array_equal(y, np.asarray(jdia.dia_spmv(dj, x, alpha, interpret=True)))
    np.testing.assert_array_equal(y, (alpha * (_scipy(host) @ x)).astype(np.float32))


@pytest.mark.parametrize("R", [1, 3, 5])
@pytest.mark.parametrize("layout", ["interleaved", "diag"])
@pytest.mark.parametrize("name", ["m1500", "rect_wide", "far_offset"])
def test_dia_spmm_plain_matches_jax_exactly(name, layout, R):
    host = _host(MATRICES[name]())
    dj = jdia.build_dia(host, layout=layout)
    dp = P.build_dia(host, layout=layout)
    xm = _x(host[3][1], R)
    ym = pdia.dia_spmm_torch(dp, torch.from_numpy(xm), 0.5).numpy()
    assert ym.shape == (host[3][0], R)
    np.testing.assert_array_equal(ym, np.asarray(jdia.dia_spmm(dj, xm, 0.5, interpret=True)))
    np.testing.assert_array_equal(ym, np.asarray(jdia.dia_spmm_xla(dj, xm, 0.5)))
    np.testing.assert_array_equal(ym, (0.5 * (_scipy(host) @ xm)).astype(np.float32))


@pytest.mark.parametrize("layout", ["interleaved", "diag"])
def test_dia_spmv_random_floats_within_rtol(layout):
    rng = np.random.default_rng(5)
    a = sp.csr_matrix(synth.banded(2000, 27)).astype(np.float32)
    a.data = rng.uniform(-1, 1, a.nnz).astype(np.float32)
    x = rng.uniform(-1, 1, a.shape[1]).astype(np.float32)
    dp = P.build_dia(_host(a), layout=layout)
    dj = jdia.build_dia(_host(a), layout=layout)
    y = pdia.dia_spmv_torch(dp, torch.from_numpy(x), -1.75).numpy().astype(np.float64)
    y64 = -1.75 * (a.astype(np.float64) @ x.astype(np.float64))
    lim = FLOAT_RTOL * 1.75 * (abs(a).astype(np.float64) @ np.abs(x).astype(np.float64))
    assert (np.abs(y - y64) <= lim).all()
    assert (np.abs(y - np.asarray(jdia.dia_spmv_xla(dj, x, -1.75))) <= lim).all()


@pytest.mark.parametrize("layout", ["interleaved", "diag"])
@pytest.mark.parametrize("vdt", ["float32", "bfloat16"])
def test_dia_carried_across_gives_same_y(layout, vdt):
    import ml_dtypes

    host = _host(MATRICES["m1500"]())
    jvdt = ml_dtypes.bfloat16 if vdt == "bfloat16" else None
    dj = jdia.build_dia(host, layout=layout, value_dtype=jvdt)
    dp = P.dia_from_numpy(np.asarray(dj.data), {f: getattr(dj, f) for f in DIA_STATIC_FIELDS})
    assert dp.data.dtype == getattr(torch, vdt)
    assert_same_dia(dp, dj)
    x = _x(host[3][1])
    np.testing.assert_array_equal(
        P.dia_spmv(dp, torch.from_numpy(x), -1.75).numpy(),
        np.asarray(jdia.dia_spmv(dj, x, -1.75, interpret=True)),
    )
    xm = _x(host[3][1], 4)
    np.testing.assert_array_equal(
        P.dia_spmm(dp, torch.from_numpy(xm)).numpy(),
        np.asarray(jdia.dia_spmm(dj, xm, interpret=True)),
    )


def test_bf16_auto_gate_tests_the_summed_plane():
    """Two duplicate entries, 1.0 and 2**-8, are each exact in bfloat16;
    their sum 1.00390625 is not. The port tests the summed plane, so it
    keeps float32 and matches scipy exactly. The JAX package tests the
    values before they are summed (``ops/dia.py:162-173``), so it stores
    bfloat16 here and rounds the sum to 1.0."""
    ptr = np.array([0, 2, 3, 4])
    cols = np.array([0, 0, 1, 2])
    vals = np.array([1.0, 2.0**-8, 3.0, 5.0], np.float32)
    host = (ptr, cols, vals, (3, 3))
    x = np.array([1.0, 1.0, 1.0], np.float32)
    y_ref = _scipy(host) @ x
    assert y_ref[0] == np.float32(1.00390625)
    for route in ("native", "numpy"):
        if route == "numpy":
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(pnative, "dia_plan", lambda *a, **k: None)
                dp = P.build_dia(host, value_dtype="auto")
        else:
            dp = P.build_dia(host, value_dtype="auto")
        assert dp.data.dtype == torch.float32, route
        np.testing.assert_array_equal(pdia.dia_spmv_torch(dp, torch.from_numpy(x)).numpy(), y_ref)
    dj = jdia.build_dia(host, value_dtype="auto")
    assert np.asarray(dj.data).dtype.name == "bfloat16"
    assert np.asarray(jdia.dia_spmv(dj, x, interpret=True))[0] == 1.0 != y_ref[0]


@pytest.mark.parametrize(
    "vals,want",
    [([1.0, 2.0, 3.0, 5.0], torch.bfloat16), ([0.1, 2.0, 3.0, 5.0], torch.float32)],
)
def test_bf16_auto_gate_stores_bf16_only_when_lossless(vals, want):
    host = (np.array([0, 2, 3, 4]), np.array([0, 1, 1, 2]), np.array(vals, np.float32), (3, 3))
    assert P.build_dia(host, value_dtype="auto").data.dtype == want


def test_dispatchers_run_plain_versions_on_cpu():
    host = _host(MATRICES["m700"]())
    dp = P.build_dia(host)
    x = torch.from_numpy(_x(700))
    xm = torch.from_numpy(_x(700, 3))
    before = (dia_kernel.spmv_launches, dia_kernel.spmm_launches)
    assert torch.equal(P.dia_spmv(dp, x), pdia.dia_spmv_torch(dp, x))
    assert torch.equal(P.dia_spmv(dp, x, backend="torch"), pdia.dia_spmv_torch(dp, x))
    assert torch.equal(P.dia_spmm(dp, xm), pdia.dia_spmm_torch(dp, xm))
    assert (dia_kernel.spmv_launches, dia_kernel.spmm_launches) == before


@pytest.mark.parametrize(
    "call",
    [
        lambda d, x: P.dia_spmv(d, x, backend="cuda"),
        lambda d, x: dia_kernel.dia_spmv_cuda(d, x),
        lambda d, x: P.dia_spmm(d, x[:, None], backend="cuda"),
        lambda d, x: dia_kernel.dia_spmm_cuda(d, x[:, None]),
    ],
    ids=["spmv-dispatch", "spmv-wrapper", "spmm-dispatch", "spmm-wrapper"],
)
def test_cuda_path_on_cpu_tensors_raises(call):
    """Asking for K5/K6 with CPU tensors raises before any build: nothing
    falls back to the plain versions."""
    dp = P.build_dia(_host(MATRICES["m700"]()))
    with pytest.raises(ValueError, match="CUDA tensors"):
        call(dp, torch.ones(700))
    assert "dia_spmv" not in cuda_build.loaded()


def test_dispatcher_rejects_unknown_backend():
    dp = P.build_dia(_host(MATRICES["m700"]()))
    with pytest.raises(ValueError, match="unknown backend"):
        P.dia_spmv(dp, torch.ones(700), backend="pallas")


def _meta(offsets, m=100_000_000, dtype=torch.float32):
    """A metadata-only DIAMatrix (the gates read no plane)."""
    m_pad = -(-m // C) * C
    return pdia.DIAMatrix(
        shape=(m, m), offsets=tuple(offsets), nnz_stored=m,
        data=torch.zeros((1, len(offsets), 128), dtype=dtype), m_pad=m_pad,
        interleaved=True,
    )


def test_supported_gates():
    """The kernels' own limits: no VMEM budget, so a 100M-row matrix with
    a far offset passes (the JAX gate refuses it); float64 planes, more
    than MAX_DIAGS diagonals and int32 overflow do not."""
    assert not pdia.dia_supported(None)
    assert pdia.dia_supported(_meta((0, C)))
    assert not pdia.dia_supported(_meta((-1, 0, 1), dtype=torch.float64))
    assert pdia.dia_supported(_meta(range(pdia.MAX_DIAGS)))
    assert not pdia.dia_supported(_meta(range(pdia.MAX_DIAGS + 1)))
    assert not pdia.dia_supported(_meta((0,), m=2**31 - 100))
    d = _meta((-1, 0, 1))
    assert pdia.dia_spmm_supported(d, 1) and pdia.dia_spmm_supported(d, 17)
    assert not pdia.dia_spmm_supported(d, 0)
    assert not pdia.dia_spmm_supported(d, 64)  # 100M x 64 > int32


def test_dia_to_numpy_roundtrip():
    dp = P.build_dia(_host(MATRICES["rect_tall_neg"]()), value_dtype=torch.bfloat16)
    data, static = P.dia_to_numpy(dp)
    back = P.dia_from_numpy(data.astype(np.float32), static)
    assert back.offsets == dp.offsets and back.shape == dp.shape
    assert torch.equal(back.data, dp.data.float())
