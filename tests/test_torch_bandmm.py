"""The port's dense band-block format and SpMM (the plain version of
kernel K7) against the JAX package's ``ops/bandmm.py``.

``build_bandblock`` must return the JAX planes element for element
(``dense``, the ``c0`` page indices, ``K``, ``nx_pad`` and the auto dtype)
on banded, rectangular, ragged-tail, empty-row and confined-column
matrices, and None on the same rejects (scattered; the waste gate).
``bandmm_spmm_torch`` runs here (no GPU) and is held against the JAX
``bandmm_spmm`` in interpret mode, as ``tests/test_bandmm.py`` runs it:

- ``"highest"`` on a float32 plane and ``"default"`` on a bfloat16 plane:
  exact on integer data (values and X in 1-9, alpha -1.75, every product
  and partial sum exact in float32); on random floats, rtol 1e-5 of each
  row's |A| @ |X|, since the sums run in another order.
- ``"default"`` on a float32 plane rounds A and X to bfloat16 on the TPU,
  but XLA on the CPU runs it in full float32, so the JAX package run here
  is not the reference for it: the port is held instead against a numpy
  oracle that rounds A and X to bfloat16 and sums in float64, at rtol 1e-5
  of each row's |A| @ |X|.
"""

import ml_dtypes
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import benchmark_spmv_using_csr5_tpu.ops.bandmm as jbb
import benchmark_spmv_using_csr5_tpu_torch as P
from benchmark_spmv_using_csr5_tpu_torch.ops import bandmm as pbb
from benchmark_spmv_using_csr5_tpu_torch.ops import bandmm_kernel
from benchmark_spmv_using_csr5_tpu_torch.utils import cuda_build, synth

FLOAT_RTOL = 1e-5
ALPHA = -1.75


def _empty_rows():
    a = sp.csr_matrix(synth.banded(2000, 7, dtype=np.float32)).tolil()
    a[100:300] = 0
    return a.tocsr()


def _confined():
    m, n = 300, 10_000
    rows = np.arange(m)
    return sp.csr_matrix((np.arange(1, m + 1, dtype=np.float32), (rows, rows % 50)), shape=(m, n))


#: name -> (matrix, max_bytes_ratio), the shapes of tests/test_bandmm.py
MATRICES = {
    "banded": (lambda: synth.banded(3000, 27), 100.0),
    "rect": (lambda: sp.csr_matrix(synth.banded(1500, 11))[:, :600], 100.0),
    "ragged_tail": (lambda: synth.banded(1000, 5), 100.0),
    "empty_rows": (_empty_rows, 100.0),
    "confined": (_confined, 1000.0),
}


def _host(a):
    a = sp.csr_matrix(a).astype(np.float32)
    return a, (a.indptr, a.indices, a.data, a.shape)


def _decade_spread(a, rng):
    a = a.copy()
    a.data = (rng.uniform(0.1, 1.0, a.nnz) * 10.0 ** rng.integers(-1, 2, a.nnz)).astype(np.float32)
    return a


def _both(name, value_dtype=None):
    make, ratio = MATRICES[name]
    a, host = _host(make())
    jdt = {None: None, torch.float32: np.float32, torch.bfloat16: ml_dtypes.bfloat16}[value_dtype]
    bj = jbb.build_bandblock(host, max_bytes_ratio=ratio, value_dtype=jdt)
    bp = pbb.build_bandblock(host, max_bytes_ratio=ratio, value_dtype=value_dtype, device="cpu")
    return a, bj, bp


def _assert_same_planes(bj, bp):
    assert bp is not None and bj is not None
    assert (bp.K, bp.nx_pad, bp.shape, bp.nnz) == (bj.K, bj.nx_pad, bj.shape, bj.nnz)
    want = torch.bfloat16 if np.dtype(bj.dense.dtype) == ml_dtypes.bfloat16 else torch.float32
    assert bp.dtype == want
    np.testing.assert_array_equal(bp.dense.float().numpy(), np.asarray(bj.dense).astype(np.float32))
    np.testing.assert_array_equal(bp.c0.numpy(), np.asarray(bj.c0))
    assert bp.c0.dtype == torch.int32 and bp.num_blocks == bj.num_blocks


@pytest.mark.parametrize("value_dtype", [None, torch.float32, torch.bfloat16], ids=["auto", "f32", "bf16"])
@pytest.mark.parametrize("name", list(MATRICES))
def test_build_bandblock_planes_match_jax(name, value_dtype):
    _, bj, bp = _both(name, value_dtype)
    _assert_same_planes(bj, bp)


def test_confined_columns_window_below_n():
    _, bj, bp = _both("confined")
    assert bp.nx_pad == bj.nx_pad < bp.n


def test_scattered_rejects_like_jax():
    a, host = _host(synth.power_law(20_000, 20_000, 8.0))
    assert jbb.build_bandblock(host) is None
    assert pbb.build_bandblock(host, device="cpu") is None
    assert not pbb.bandblock_accepts(host)


def test_waste_gate_rejects_like_jax():
    m = 20_000
    rows = np.arange(m)
    cols = np.minimum((rows * 977) % 3000 + (rows // 128) * 128, m - 1)
    a, host = _host(sp.csr_matrix((np.ones(m, np.float32), (rows, cols)), shape=(m, m)))
    assert jbb.build_bandblock(host) is None
    assert pbb.build_bandblock(host, device="cpu") is None
    assert not pbb.bandblock_accepts(host)


def test_empty_matrix_rejects():
    a, host = _host(sp.csr_matrix((16, 16), dtype=np.float32))
    assert jbb.build_bandblock(host) is None and pbb.build_bandblock(host, device="cpu") is None


@pytest.mark.parametrize("values", ["integer", "decade_spread"])
def test_auto_dtype_gate_matches_jax(values):
    """Integer-class values round-trip bfloat16, so both store bf16;
    decade-spread floats do not, so both keep float32."""
    a, host = _host(synth.banded(2000, 9))
    if values == "decade_spread":
        a, host = _host(_decade_spread(a, np.random.default_rng(7)))
    bj = jbb.build_bandblock(host, max_bytes_ratio=100.0)
    bp = pbb.build_bandblock(host, max_bytes_ratio=100.0, device="cpu")
    _assert_same_planes(bj, bp)
    assert bp.dtype == (torch.bfloat16 if values == "integer" else torch.float32)
    assert pbb.bandblock_accepts(host, max_bytes_ratio=100.0)


def _x(n, R, seed=3):
    return np.random.default_rng(seed).integers(1, 10, (n, R)).astype(np.float32)


def _run_port(bp, X, precision, layout):
    if layout == "rn":
        xt = torch.from_numpy(np.ascontiguousarray(X.T))
        return P.bandmm_spmm_torch(bp, xt, ALPHA, precision, "rn").numpy().T
    return P.bandmm_spmm_torch(bp, torch.from_numpy(X), ALPHA, precision).numpy()


@pytest.mark.parametrize("layout", ["nr", "rn"])
@pytest.mark.parametrize("R", [1, 3, 8, 17])
@pytest.mark.parametrize(
    "value_dtype,precision",
    [(torch.float32, "highest"), (torch.bfloat16, "default"), (torch.bfloat16, "auto")],
    ids=["f32-highest", "bf16-default", "bf16-auto"],
)
@pytest.mark.parametrize("name", list(MATRICES))
def test_bandmm_spmm_matches_jax_exactly(name, value_dtype, precision, R, layout):
    a, bj, bp = _both(name, value_dtype)
    X = _x(a.shape[1], R)
    y = _run_port(bp, X, precision, layout)
    xin = np.ascontiguousarray(X.T) if layout == "rn" else X
    yj = np.asarray(jbb.bandmm_spmm(bj, xin, ALPHA, precision=precision, interpret=True, layout=layout))
    np.testing.assert_array_equal(y, yj.T if layout == "rn" else yj)
    if bp.dtype == torch.bfloat16:  # scipy on the values as stored (confined's go to 300)
        a = a.copy()
        a.data = a.data.astype(ml_dtypes.bfloat16).astype(np.float32)
    np.testing.assert_array_equal(y, (ALPHA * (a @ X)).astype(np.float32))


def _row_abs(a, X):
    return abs(a).astype(np.float64) @ np.abs(X).astype(np.float64)


def test_float_highest_matches_jax_within_rtol():
    rng = np.random.default_rng(5)
    a, host = _host(_decade_spread(sp.csr_matrix(synth.banded(3000, 27)), rng))
    bj = jbb.build_bandblock(host, max_bytes_ratio=100.0)
    bp = pbb.build_bandblock(host, max_bytes_ratio=100.0, device="cpu")
    assert bp.dtype == torch.float32  # the auto gate: "auto" runs "highest"
    X = rng.uniform(0.5, 1.5, (a.shape[1], 8)).astype(np.float32)
    y = P.bandmm_spmm_torch(bp, torch.from_numpy(X)).numpy()
    yj = np.asarray(jbb.bandmm_spmm(bj, X, interpret=True))
    y64 = a.astype(np.float64) @ X.astype(np.float64)
    lim = FLOAT_RTOL * _row_abs(a, X)
    assert (np.abs(y - yj) <= lim).all()
    assert (np.abs(y - y64) <= lim).all()
    assert (np.abs(y - y64) / np.abs(y64)).max() <= 1e-4  # spmmf8's gate


def test_float_default_on_f32_plane_rounds_both_operands_to_bf16():
    """The TPU's DEFAULT precision: A and X rounded to bfloat16, float32
    sums. XLA on the CPU does not round, so the reference is numpy."""
    rng = np.random.default_rng(6)
    a, host = _host(_decade_spread(sp.csr_matrix(synth.banded(3000, 27)), rng))
    bp = pbb.build_bandblock(host, max_bytes_ratio=100.0, value_dtype=torch.float32, device="cpu")
    X = rng.uniform(0.5, 1.5, (a.shape[1], 5)).astype(np.float32)
    y = P.bandmm_spmm_torch(bp, torch.from_numpy(X), ALPHA, precision="default").numpy()
    a16 = a.copy()
    a16.data = a16.data.astype(ml_dtypes.bfloat16).astype(np.float64)
    # alpha is folded into X before the rounding, as the JAX wrapper does
    x16 = (ALPHA * X).astype(np.float32).astype(ml_dtypes.bfloat16).astype(np.float64)
    y_oracle = a16 @ x16
    lim = FLOAT_RTOL * _row_abs(a, X) * abs(ALPHA)
    assert (np.abs(y - y_oracle) <= lim).all()
    # the rounding shows: full float32 products are measurably elsewhere
    y_hi = P.bandmm_spmm_torch(bp, torch.from_numpy(X), ALPHA, precision="highest").numpy()
    assert np.abs(y - y_hi).max() > 1e-3 * np.abs(y_hi).max() * 2**-8


def test_forced_bf16_plane_within_one_percent():
    """spmmf8's second check at small size: a forced bfloat16 plane on
    decade-spread values lands within 1 % of the float64 oracle, and is
    not exact."""
    rng = np.random.default_rng(7)
    a, host = _host(_decade_spread(sp.csr_matrix(synth.banded(2000, 9)), rng))
    bp = pbb.build_bandblock(host, max_bytes_ratio=100.0, value_dtype=torch.bfloat16, device="cpu")
    bj = jbb.build_bandblock(host, max_bytes_ratio=100.0, value_dtype=ml_dtypes.bfloat16)
    X = rng.uniform(0.5, 1.5, (a.shape[1], 3)).astype(np.float32)
    y = P.bandmm_spmm_torch(bp, torch.from_numpy(X), precision="default").numpy()
    yj = np.asarray(jbb.bandmm_spmm(bj, X, precision="default", interpret=True))
    y64 = a.astype(np.float64) @ X.astype(np.float64)
    rel = np.abs(y - y64) / np.abs(y64)
    assert 1e-5 < rel.max() <= 0.01
    assert (np.abs(y - yj) <= FLOAT_RTOL * _row_abs(a, X)).all()


def test_highest_on_bf16_plane_raises_like_jax():
    _, bj, bp = _both("banded", torch.bfloat16)
    X = _x(3000, 2)
    with pytest.raises(ValueError, match="f32 dense plane"):
        jbb.bandmm_spmm(bj, X, precision="highest", interpret=True)
    with pytest.raises(ValueError, match="f32 dense plane"):
        P.bandmm_spmm(bp, torch.from_numpy(X), precision="highest")


def test_unknown_precision_raises():
    _, _, bp = _both("banded")
    with pytest.raises(ValueError, match="unknown precision"):
        P.bandmm_spmm(bp, torch.ones(3000, 2), precision="high")


@pytest.mark.parametrize("name", ["banded", "empty_rows"])
def test_bandmm_spmv_matches_jax(name):
    a, bj, bp = _both(name, torch.float32)
    x = np.random.default_rng(1).integers(1, 10, a.shape[1]).astype(np.float32)
    y = P.bandmm_spmv(bp, torch.from_numpy(x), precision="highest").numpy()
    yj = np.asarray(jbb.bandmm_spmv(bj, x, precision="highest", interpret=True))
    np.testing.assert_array_equal(y, yj)
    np.testing.assert_array_equal(y, a @ x)


def test_supported_gate():
    _, bj, bp = _both("banded")
    assert P.bandmm_supported(bp, 8) == jbb.bandmm_supported(bj, 8) is True
    assert not P.bandmm_supported(bp, 0) and not P.bandmm_supported(None, 8)


def test_dispatcher_runs_plain_version_on_cpu():
    a, _, bp = _both("banded")
    X = torch.from_numpy(_x(a.shape[1], 4))
    before = bandmm_kernel.launches
    assert torch.equal(P.bandmm_spmm(bp, X), P.bandmm_spmm_torch(bp, X))
    assert torch.equal(P.bandmm_spmm(bp, X, backend="torch"), P.bandmm_spmm_torch(bp, X))
    assert bandmm_kernel.launches == before


@pytest.mark.parametrize("call", ["dispatch", "wrapper"])
def test_cuda_path_on_cpu_tensors_raises(call):
    """Asking for K7 with CPU tensors raises before any build: nothing
    falls back to the plain version."""
    _, _, bp = _both("banded")
    X = torch.ones(3000, 4)
    with pytest.raises(ValueError, match="CUDA tensors"):
        if call == "dispatch":
            P.bandmm_spmm(bp, X, backend="cuda")
        else:
            bandmm_kernel.bandmm_spmm_cuda(bp, X)
    assert "bandmm" not in cuda_build.loaded()


def test_build_phases_recorded():
    _, _, bp = _both("banded")
    assert set(pbb.last_build_phases) == {"plan", "fill", "gate", "cast", "upload"}
    assert bp.dense_bytes == bp.dense.numel() * bp.dense.element_size()
