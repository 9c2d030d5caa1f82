"""The port's ``SpMVHandle`` and ``build_csr5_autotuned`` against the JAX
package's.

The same call sequence goes through both handles (the JAX one on its CPU
backend, where it never slices): ``inputCSR -> asCSR5 -> setX -> spmv``,
``setSigma``, ``asCSR``, ``spmm`` and ``destroy``. The values and x are
integers 1-9, so every executor sums exactly and y must be equal, bit for
bit, in float32 and in float64 (the JAX package under x64); sigma and
every plane must be equal too.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import benchmark_spmv_using_csr5_tpu as J
import benchmark_spmv_using_csr5_tpu.models.formats as jformats
import benchmark_spmv_using_csr5_tpu_torch as P
from benchmark_spmv_using_csr5_tpu_torch.models.formats import PLANE_FIELDS, STATIC_FIELDS
from benchmark_spmv_using_csr5_tpu_torch.ops import convert
from benchmark_spmv_using_csr5_tpu_torch.utils import synth

MATRICES = {
    "banded": lambda: synth.banded(3000, 27),
    # scattered rows: the autotuned build re-tunes sigma (32 -> 16, 16 -> 8)
    "fem": lambda: synth.fem_blocks(3000),
    "powerlaw": lambda: synth.power_law(3000, 3000, 20.0),
}


def _planes_equal(a5p, a5j):
    """Every plane and static field equal. Both builds drop the raw column
    plane beside col_packed; a float64 plane keeps it in the port (K4
    reads it), and it equals the JAX plane's decode."""
    planes, static = P.csr5_to_numpy(a5p)
    for f in PLANE_FIELDS:
        ref = getattr(a5j, f)
        if ref is None and f == "col_idx_tiles" and planes[f] is not None:
            assert a5p.val_tiles.dtype == torch.float64
            ref = jformats.col_tiles_of(a5j)
        if ref is None:
            assert planes[f] is None, f
            continue
        np.testing.assert_array_equal(planes[f], np.asarray(ref), err_msg=f)
    for f in STATIC_FIELDS:
        if f != "config":
            assert static[f] == getattr(a5j, f), f
    assert a5p.sigma == a5j.sigma


def _handles(a, dtype):
    a = sp.csr_matrix(a).astype(dtype)
    hp = P.SpMVHandle(*a.shape, device="cpu")
    hj = J.SpMVHandle(*a.shape)
    for h in (hp, hj):
        h.inputCSR(a.nnz, a.indptr, a.indices, a.data)
    return a, hp, hj


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("sigma", [None, 16], ids=["auto-sigma", "sigma16"])
@pytest.mark.parametrize("name", list(MATRICES))
def test_handle_matches_jax(name, sigma, dtype):
    a, hp, hj = _handles(MATRICES[name](), dtype)
    x = synth.dense_x(a.shape[1], dtype=dtype)
    for h in (hp, hj):
        if sigma is not None:
            h.setSigma(sigma)
        h.asCSR5().setX(x)
    _planes_equal(hp.csr5, hj.csr5)
    assert hp.csr5.val_tiles.dtype == getattr(torch, np.dtype(dtype).name)
    for alpha in (1.0, -1.75):
        y = hp.spmv(alpha)
        assert y.dtype == hp.csr5.val_tiles.dtype
        np.testing.assert_array_equal(y.numpy(), np.asarray(hj.spmv(alpha)))
        np.testing.assert_array_equal(y.numpy(), alpha * (a @ x))
    # setSigma converts again at the new sigma, in both
    for h in (hp, hj):
        h.setSigma(8)
    assert hp.csr5.sigma == hj.csr5.sigma == 8
    _planes_equal(hp.csr5, hj.csr5)
    np.testing.assert_array_equal(hp.spmv(2.0).numpy(), np.asarray(hj.spmv(2.0)))
    assert hp.destroy() == hj.destroy() == 0
    assert hp.format is None and hp.csr5 is None and hp.csr is None


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
def test_as_csr_round_trip(dtype):
    a, hp, _ = _handles(MATRICES["powerlaw"](), dtype)
    hp.asCSR5()
    assert hp.format == P.Format.CSR5
    hp.asCSR()
    assert hp.format == P.Format.CSR and hp.csr5 is None
    np.testing.assert_array_equal(hp.csr.row_ptr.numpy(), a.indptr)
    np.testing.assert_array_equal(hp.csr.col_idx.numpy(), a.indices)
    np.testing.assert_array_equal(hp.csr.values.numpy(), a.data)
    assert hp.csr.values.dtype == getattr(torch, np.dtype(dtype).name)
    # in CSR format spmv runs the CSR oracle, as the JAX handle does
    x = synth.dense_x(a.shape[1], dtype=dtype)
    np.testing.assert_array_equal(hp.setX(x).spmv(1.0).numpy(), a @ x)


def test_spmm_matches_jax_f32_and_refuses_f64():
    a, hp, hj = _handles(MATRICES["banded"](), np.float32)
    X = np.random.default_rng(3).integers(1, 10, (a.shape[1], 5)).astype(np.float32)
    for h in (hp, hj):
        h.asCSR5()
    np.testing.assert_array_equal(hp.spmm(X, -1.75).numpy(), np.asarray(hj.spmm(X, -1.75)))
    _, hp64, _ = _handles(MATRICES["banded"](), np.float64)
    hp64.asCSR5()
    with pytest.raises(ValueError, match="no float64 SpMM"):
        hp64.spmm(X.astype(np.float64))


def test_spmv_into_y_out():
    a, hp, _ = _handles(MATRICES["banded"](), np.float64)
    x = synth.dense_x(a.shape[1], dtype=np.float64)
    y_out = torch.empty(a.shape[0], dtype=torch.float64)
    y = hp.asCSR5().setX(x).spmv(1.0, y_out)
    assert y is y_out
    np.testing.assert_array_equal(y_out.numpy(), a @ x)


def _bad_sequences(a):
    nnz, rp, ci, v = a.nnz, a.indptr, a.indices, a.data
    return {
        "as_csr5 before input": lambda h: h.asCSR5(),
        "spmv before setX": lambda h: h.inputCSR(nnz, rp, ci, v).asCSR5().spmv(1.0),
        "spmv with no matrix": lambda h: h.setX(np.ones(a.shape[1], v.dtype)).spmv(1.0),
        "setX of the wrong length": lambda h: h.setX(np.ones(a.shape[1] + 1, v.dtype)),
        "inconsistent nnz": lambda h: h.inputCSR(nnz + 1, rp, ci, v),
        "as_csr after destroy": lambda h: (h.inputCSR(nnz, rp, ci, v).destroy(), h.asCSR()),
        "spmm before asCSR5": lambda h: h.inputCSR(nnz, rp, ci, v).spmm(
            np.ones((a.shape[1], 2), v.dtype)),
        "spmm of a vector": lambda h: h.inputCSR(nnz, rp, ci, v).asCSR5().spmm(
            np.ones(a.shape[1], v.dtype)),
    }


@pytest.mark.parametrize("case", list(_bad_sequences(sp.csr_matrix(np.eye(3)))))
def test_handle_raises_where_jax_raises(case):
    a = sp.csr_matrix(synth.banded(300, 9, dtype=np.float32))
    go = _bad_sequences(a)[case]
    with pytest.raises(ValueError, match=r"Status.INVALID_HANDLE") as ep:
        go(P.SpMVHandle(*a.shape, device="cpu"))
    with pytest.raises(ValueError, match=r"Status.INVALID_HANDLE") as ej:
        go(J.SpMVHandle(*a.shape))
    assert str(ep.value) == str(ej.value)


def test_camel_case_aliases():
    H = P.SpMVHandle
    pairs = [("inputCSR", "input_csr"), ("asCSR5", "as_csr5"), ("asCSR", "as_csr"),
             ("setX", "set_x"), ("setSigma", "set_sigma"), ("computeSigma", "compute_sigma")]
    for camel, snake in pairs:
        assert getattr(H, camel) is getattr(H, snake)
        assert hasattr(J.SpMVHandle, camel)


@pytest.mark.parametrize("name", list(MATRICES))
@pytest.mark.parametrize("value_dtype", [None, "auto"])
def test_autotuned_build_matches_jax(name, value_dtype):
    a = sp.csr_matrix(MATRICES[name]()).astype(np.float32)
    host = (a.indptr, a.indices, a.data, a.shape)
    a5p = P.build_csr5_autotuned(host, value_dtype=value_dtype, device="cpu")
    a5j = J.build_csr5_autotuned(host, value_dtype=value_dtype)
    _planes_equal(a5p, a5j)


def test_autotuned_build_transposes_and_uploads_once(monkeypatch):
    """A re-tune plans twice on the host, but transposes and uploads as
    often as one build_csr5 does (the JAX function converts twice)."""
    a = sp.csr_matrix(MATRICES["fem"]()).astype(np.float32)
    host = (a.indptr, a.indices, a.data, a.shape)
    calls = {"transpose": 0, "upload": 0}
    transpose, upload = convert.nativelib.tile_transpose, convert._upload

    def count(key, fn):
        def wrapped(*args, **kw):
            calls[key] += 1
            return fn(*args, **kw)
        return wrapped

    monkeypatch.setattr(convert.nativelib, "tile_transpose", count("transpose", transpose))
    monkeypatch.setattr(convert, "_upload", count("upload", upload))
    a5 = convert.build_csr5_autotuned(host, device="cpu")
    tuned = dict(calls)
    assert a5.sigma == 16 and P.compute_sigma(*a.shape[:1], a.nnz) == 32
    assert set(convert.last_convert_phases) >= {"plan", "transpose", "upload"}
    calls.update(transpose=0, upload=0)
    convert.build_csr5(host, P.CSR5Config(sigma=16), device="cpu")
    # the values only: beside col_packed the raw columns are not transposed
    assert tuned == calls and calls["transpose"] == 1 and a5.col_idx_tiles is None


def test_sliced_handle_converts_at_most_once_per_rhs(monkeypatch):
    """With the JAX package's slicing cap cut to 3000 elements, a 4000-row
    band takes the row-sliced form. Re-slicing for R = 4 succeeds (cap //
    4) and is kept while R stays; for R = 8 and 16 one row quantum alone
    passes cap // R, so the build returns None: the held slices serve R
    (K2 takes any R on each slice) and the handle does not convert again.
    A new conversion (setSigma) forgets what it learnt."""
    from benchmark_spmv_using_csr5_tpu_torch.models import handle as handle_mod
    from benchmark_spmv_using_csr5_tpu_torch.ops import bigslice

    monkeypatch.setattr(bigslice, "_SLICE_ELEM_CAP", 3000)
    calls = []

    def counted(src, cfg=None, num_rhs=1, **kw):
        out = bigslice.build_csr5_sliced(src, cfg, num_rhs=num_rhs, **kw)
        calls.append((num_rhs, out is not None))
        return out

    monkeypatch.setattr(handle_mod, "build_csr5_sliced", counted)
    a = sp.csr_matrix(synth.banded(4000, 9)).astype(np.float32)
    a.data = np.random.default_rng(4).integers(1, 10, a.nnz).astype(np.float32)
    h = P.SpMVHandle(*a.shape, device="cpu").inputCSR(a.nnz, a.indptr, a.indices, a.data).asCSR5()
    assert h.csr5 is None and h.csr5_sliced is not None and calls == [(1, True)]
    rng = np.random.default_rng(5)
    for R in (8, 8, 16, 8, 1, 16, 4, 4, 8):
        X = rng.integers(1, 10, (a.shape[1], R)).astype(np.float32)
        np.testing.assert_array_equal(h.spmm(X, -1.75).numpy(), (-1.75 * (a @ X)).astype(np.float32))
    assert calls == [(1, True), (8, False), (16, False), (4, True)]
    assert h._sliced_rhs == 4 and h.csr5_sliced.num_slices > 4
    h.setSigma(16)
    X = rng.integers(1, 10, (a.shape[1], 8)).astype(np.float32)
    np.testing.assert_array_equal(h.spmm(X).numpy(), a @ X)
    assert calls[4:] == [(1, True), (8, False)] and h._sliced_rhs == 1
