"""The port's row-sliced CSR5 (``ops/bigslice.py``) against the JAX package's.

Small matrices with a tiny element cap (2000-8000) force builds of three
and more slices. On the CPU:

- the slice bounds, ``row_starts``, ``col_starts`` and every plane of
  every slice equal the JAX ``build_csr5_sliced`` ones (the JAX slices drop
  the raw column plane where ``col_packed`` exists; the port keeps it, and
  its decode is compared), with empty rows, a ragged tail, an empty slice,
  a window reaching past n, and an unsliceable matrix (None in both);
- ``sliced_spmv_torch`` (K3's plain version) equals the JAX ``sliced_spmv``
  in interpret mode and scipy exactly on integer data at alpha 1 and
  -1.75, and is within 1e-5 of each row's |A| @ |x| on random floats;
  ``sliced_spmm`` likewise at R = 4 against the JAX ``sliced_spmm``;
- a JAX ``SlicedCSR5`` carried across gives the same y;
- the handle and ``run_benchmark(..., device="cpu")`` take the sliced
  route when ``should_slice`` is patched to hold;
- K3's slice table, made on the host side of its wrapper.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from benchmark_spmv_using_csr5_tpu.ops import bigslice as jb
import benchmark_spmv_using_csr5_tpu_torch as P
from benchmark_spmv_using_csr5_tpu_torch.bench import harness
from benchmark_spmv_using_csr5_tpu_torch.models import handle as handle_mod
from benchmark_spmv_using_csr5_tpu_torch.models.formats import PLANE_FIELDS, STATIC_FIELDS
from benchmark_spmv_using_csr5_tpu_torch.ops import bigslice, bigslice_kernel
from benchmark_spmv_using_csr5_tpu_torch.utils import cuda_build, synth

FLOAT_RTOL = 1e-5


def _ints(a_sp, seed=0):
    a = sp.csr_matrix(a_sp).astype(np.float32)
    a.data = np.random.default_rng(seed).integers(1, 10, a.nnz).astype(np.float32)
    return a


def _empty_rows():
    """Rows 1000-1199 empty: a quantum boundary sees an empty range."""
    a = sp.csr_matrix(synth.banded(2600, 7)).tolil()
    a[1000:1200, :] = 0
    a = a.tocsr()
    a.eliminate_zeros()
    return a


def _narrow():
    """n = 100 < 128 columns, 700 rows whose first 300 are empty: the
    all-empty slice takes the window (0, 128), past n."""
    a = sp.lil_matrix((700, 100))
    rng = np.random.default_rng(1)
    for r in range(300, 700):
        for c in rng.choice(100, 5, replace=False):
            a[r, c] = 1.0
    return a.tocsr()


def _tail_window():
    """A band over rows 0-1999 and, below it, rows that touch only columns
    2950-2989 of n = 2990: the last slice's window is narrower than a page,
    so its 128 columns from the page-aligned c0 reach past n."""
    band = sp.csr_matrix(synth.banded(2000, 9))
    rng = np.random.default_rng(4)
    rows = np.repeat(np.arange(2000, 3000), 3)
    tail = sp.csr_matrix((np.ones(rows.size), (rows, rng.integers(2950, 2990, rows.size))),
                         shape=(3000, 2990))
    return (sp.vstack([sp.hstack([band, sp.csr_matrix((2000, 990))]),
                       sp.csr_matrix((1000, 2990))]) + tail).tocsr()


#: name -> (scipy matrix, elem_cap, sigma); each slices into >= 3 slices
MATRICES = {
    "banded": (lambda: synth.banded(4000, 9), 3000, None),
    "empty_rows": (_empty_rows, 2000, None),
    "scatband": (lambda: synth.scattered_band(3000, 4, 600), 2500, None),
    "packed16": (lambda: synth.banded(4000, 27), 3000, 16),
    "packed32": (lambda: synth.banded(6000, 33), 6000, 32),
    "narrow": (_narrow, 300, None),
    "tail_window": (_tail_window, 2000, None),
}


def _build(name, value_dtype=None, num_rhs=1):
    make, cap, sigma = MATRICES[name]
    a = _ints(make())
    host = (a.indptr, a.indices, a.data, a.shape)
    jcfg = None if sigma is None else jb.CSR5Config(sigma=sigma)
    pcfg = None if sigma is None else P.CSR5Config(sigma=sigma)
    slj = jb.build_csr5_sliced(host, jcfg, value_dtype=value_dtype, elem_cap=cap, num_rhs=num_rhs)
    slp = P.build_csr5_sliced(
        host, pcfg, value_dtype=value_dtype, elem_cap=cap, num_rhs=num_rhs, device="cpu"
    )
    return a, slj, slp


def _same_slice(a5p, a5j, tag):
    planes, static = P.csr5_to_numpy(a5p)
    for f in PLANE_FIELDS:
        ref = getattr(a5j, f)
        if f == "col_idx_tiles" and ref is None:
            # the JAX slice dropped its raw plane: compare the decode
            ref = P.col_tiles_of(P.csr5_from_numpy(
                {g: None if getattr(a5j, g) is None else np.asarray(getattr(a5j, g))
                 for g in PLANE_FIELDS},
                {g: getattr(a5j, g) for g in STATIC_FIELDS}, device="cpu")).numpy()
        if ref is None:
            assert planes[f] is None, (tag, f)
            continue
        ref = np.asarray(ref)
        if ref.dtype.name == "bfloat16":
            ref = ref.astype(np.float32)
        np.testing.assert_array_equal(planes[f], ref, err_msg=f"{tag} {f}")
    for f in STATIC_FIELDS:
        if f != "config":
            assert static[f] == getattr(a5j, f), (tag, f)
    assert a5p.sigma == a5j.config.sigma
    assert static["value_dtype"] == str(np.asarray(a5j.val_tiles).dtype), tag


@pytest.mark.parametrize("name", list(MATRICES))
def test_slice_bounds_match_jax(name):
    make, cap, _ = MATRICES[name]
    a = sp.csr_matrix(make())
    rp, ci = a.indptr.astype(np.int64), a.indices.astype(np.int32)
    want = jb._slice_bounds(rp, ci, a.shape[0], cap)
    assert bigslice._slice_bounds(rp, ci, a.shape[0], cap) == want
    assert len(want) >= 3


@pytest.mark.parametrize("value_dtype", [None, "auto"])
@pytest.mark.parametrize("name", list(MATRICES))
def test_sliced_planes_match_jax(name, value_dtype):
    a, slj, slp = _build(name, value_dtype)
    assert slp.num_slices == slj.num_slices >= 3
    assert (slp.shape, slp.row_starts, slp.col_starts) == (slj.shape, slj.row_starts, slj.col_starts)
    assert slp.nnz == slj.nnz == a.nnz and slp.sigma == slj.sigma
    for k, (a5p, a5j) in enumerate(zip(slp.slices, slj.slices)):
        _same_slice(a5p, a5j, f"{name} slice {k}")
    if name in ("packed16", "packed32"):
        assert all(s.col_packed is not None for s in slp.slices)
    if name == "narrow":
        assert (0, 128) in [(c0, s.n) for c0, s in zip(slp.col_starts, slp.slices)]
    if name == "tail_window":
        assert slp.col_starts[-1] + slp.slices[-1].n > a.shape[1]


def test_slices_do_not_alias_the_arena():
    """Every slice's planes are its own copies: a later slice, built from
    the same host arena, rewrote none of an earlier one's."""
    _, _, slp = _build("banded")
    ptrs = [t.data_ptr() for s in slp.slices for t in (s.row_ptr, s.col_idx_tiles, s.val_tiles)]
    assert len(set(ptrs)) == len(ptrs)
    again = P.build_csr5_sliced(
        _ints(MATRICES["banded"][0]()), elem_cap=3000, device="cpu"
    )
    for s, t in zip(slp.slices, again.slices):
        assert torch.equal(s.col_idx_tiles, t.col_idx_tiles) and torch.equal(s.row_ptr, t.row_ptr)


def test_unsliceable_returns_none_in_both():
    m = 256
    rows = np.repeat(np.arange(m), 2)
    cols = np.tile(np.array([0, 99_999]), m)
    a = sp.csr_matrix((np.ones(2 * m, np.float32), (rows, cols)), shape=(m, 100_000))
    host = (a.indptr, a.indices, a.data, a.shape)
    assert jb.build_csr5_sliced(host, elem_cap=50_000) is None
    assert P.build_csr5_sliced(host, elem_cap=50_000, device="cpu") is None


def test_kernel_refusal_returns_none():
    """A slice K1 and K3 would refuse (sigma > 448) makes the build return
    None, so callers take the whole-matrix form."""
    a = _ints(synth.banded(3000, 9))
    assert P.build_csr5_sliced(a, P.CSR5Config(sigma=512), elem_cap=3000, device="cpu") is None


@pytest.mark.parametrize(
    "m,n",
    [(500_000, 500_000), (9_000_000, 9_119_393), (9_000_000, 9_119_394),
     (20_000_000, 20_000_000), (18_119_393, 0)],
)
def test_should_slice_matches_jax(m, n):
    assert bigslice._SLICE_ELEM_CAP == jb._SLICE_ELEM_CAP == 18_119_393
    assert bigslice.SLICE_QUANTUM_ROWS == jb.SLICE_QUANTUM_ROWS
    assert P.should_slice(m, n) == jb.should_slice(m, n)


@pytest.mark.parametrize("alpha", [1.0, -1.75])
@pytest.mark.parametrize("name", list(MATRICES))
def test_sliced_spmv_matches_jax(name, alpha):
    a, slj, slp = _build(name)
    x = synth.dense_x(a.shape[1], dtype=np.float32)
    y = P.sliced_spmv(slp, torch.from_numpy(x), alpha).numpy()
    np.testing.assert_array_equal(y, P.sliced_spmv_torch(slp, torch.from_numpy(x), alpha).numpy())
    np.testing.assert_array_equal(y, (alpha * (a @ x)).astype(np.float32))
    np.testing.assert_array_equal(y, np.asarray(jb.sliced_spmv(slj, x, alpha=alpha, interpret=True)))


def test_sliced_spmv_random_floats():
    a = sp.csr_matrix(synth.banded(5000, 27)).astype(np.float32)
    rng = np.random.default_rng(3)
    a.data = rng.uniform(-1, 1, a.nnz).astype(np.float32)
    x = rng.uniform(-1, 1, a.shape[1]).astype(np.float32)
    slp = P.build_csr5_sliced(a, elem_cap=3000, device="cpu")
    assert slp.num_slices >= 3
    y = P.sliced_spmv(slp, torch.from_numpy(x), -1.75).double().numpy()
    y64 = -1.75 * (a.astype(np.float64) @ x.astype(np.float64))
    row_abs = 1.75 * (abs(a).astype(np.float64) @ np.abs(x).astype(np.float64))
    assert (np.abs(y - y64) <= FLOAT_RTOL * row_abs + 1e-30).all()


@pytest.mark.parametrize("name,num_rhs", [("banded", 4), ("packed16", 4), ("narrow", 1)])
def test_sliced_spmm_matches_jax(name, num_rhs):
    a, slj, slp = _build(name, num_rhs=num_rhs)
    xm = np.random.default_rng(1).integers(1, 10, (a.shape[1], 4)).astype(np.float32)
    y = P.sliced_spmm(slp, torch.from_numpy(xm), 1.5).numpy()
    np.testing.assert_array_equal(y, (1.5 * (a @ xm)).astype(np.float32))
    np.testing.assert_array_equal(y, np.asarray(jb.sliced_spmm(slj, xm, alpha=1.5, interpret=True)))


def test_num_rhs_sizes_the_slices_as_jax():
    a, slj, slp = _build("banded", num_rhs=4)
    _, slj1, slp1 = _build("banded")
    assert slp.row_starts == slj.row_starts and slp.num_slices > slp1.num_slices


@pytest.mark.parametrize("name", ["banded", "packed16", "narrow"])
def test_carried_sliced_matrix(name):
    """A JAX SlicedCSR5 carried across (each slice's planes, the raw plane
    decoded where the JAX slice dropped it) gives the same y, and the
    port's own form survives its round trip through numpy."""
    a, slj, slp = _build(name)
    slices = [
        ({f: None if getattr(s, f) is None else np.asarray(getattr(s, f)) for f in PLANE_FIELDS},
         {f: getattr(s, f) for f in STATIC_FIELDS})
        for s in slj.slices
    ]
    static = {f: getattr(slj, f) for f in ("shape", "row_starts", "col_starts", "nnz_stored")}
    carried = P.sliced_from_numpy(slices, static, device="cpu")
    x = torch.from_numpy(synth.dense_x(a.shape[1], dtype=np.float32))
    assert torch.equal(P.sliced_spmv(carried, x), P.sliced_spmv(slp, x))
    back = P.sliced_from_numpy(*P.sliced_to_numpy(slp), device="cpu")
    assert back.row_starts == slp.row_starts and torch.equal(P.sliced_spmv(back, x), P.sliced_spmv(slp, x))


def _patch_slicing(monkeypatch):
    """should_slice holds for every shape (it is the JAX package's m + n
    rule, met only by matrices far beyond a CPU test's size)."""
    monkeypatch.setattr(bigslice, "should_slice", lambda m, n: True)
    monkeypatch.setattr(handle_mod, "should_slice", lambda m, n: True)


def test_handle_takes_the_sliced_route(monkeypatch):
    _patch_slicing(monkeypatch)
    a = _ints(synth.banded(3000, 9))
    h = P.SpMVHandle(*a.shape, device="cpu")
    h.inputCSR(a.nnz, a.indptr, a.indices, a.data).asCSR5()
    assert h.csr5 is None and h.csr5_sliced is not None
    x = synth.dense_x(a.shape[1], dtype=np.float32)
    np.testing.assert_array_equal(h.setX(x).spmv(-1.75).numpy(), (-1.75 * (a @ x)).astype(np.float32))
    xm = np.random.default_rng(2).integers(1, 10, (a.shape[1], 4)).astype(np.float32)
    np.testing.assert_array_equal(h.spmm(xm).numpy(), a @ xm)
    assert h._sliced_rhs == 4  # re-sliced for R = 4, kept until R changes
    h.asCSR()
    assert h.csr5_sliced is None and h.csr is not None
    h.asCSR5()
    assert h.csr5_sliced is not None and h.destroy() == 0 and h.csr5_sliced is None


def test_handle_float64_never_slices(monkeypatch):
    _patch_slicing(monkeypatch)
    a = sp.csr_matrix(synth.banded(1000, 9))
    h = P.SpMVHandle(*a.shape, device="cpu").inputCSR(a.nnz, a.indptr, a.indices, a.data).asCSR5()
    assert h.csr5_sliced is None and h.csr5.val_tiles.dtype == torch.float64


def test_run_benchmark_takes_the_sliced_route(monkeypatch):
    _patch_slicing(monkeypatch)
    a = sp.csr_matrix(synth.banded(3000, 27)).astype(np.float32)
    res = harness.run_benchmark("b3000", a.indptr, a.indices, a.data, a.shape, num_run=2, device="cpu")
    assert res.check_ok and res.max_rel_err == 0.0
    assert res.backend == "torch-sliced" and isinstance(res.matrix, P.SlicedCSR5)
    assert res.storage == "bfloat16" and "row slices" in res.report()
    # the conversion phases are the slices' summed: every plane uploaded
    sl = res.matrix
    planes = sum(t.numel() * t.element_size() for s in sl.slices
                 for t in (s.col_idx_tiles, s.val_tiles, s.col_packed) if t is not None)
    assert res.convert_phases["upload_mb"] == pytest.approx(planes / 1e6)
    x = np.random.default_rng(0).integers(1, 10, a.shape[1]).astype(np.float32)
    np.testing.assert_array_equal(res.y.numpy(), a @ x)
    whole = harness.run_benchmark("b3000", a.indptr, a.indices, a.data, a.shape, num_run=2,
                                  device="cpu", backend="cuda")
    assert whole.backend == "torch" and isinstance(whole.matrix, P.CSR5Matrix)
    assert torch.equal(whole.y, res.y)


def test_run_benchmark_forced_and_refused_routes():
    a = sp.csr_matrix(synth.banded(3000, 27)).astype(np.float32)
    args = ("b3000", a.indptr, a.indices, a.data, a.shape)
    res = harness.run_benchmark(*args, num_run=2, device="cpu", backend="cuda-sliced")
    assert res.backend == "torch-sliced" and res.max_rel_err == 0.0
    auto = harness.run_benchmark(*args, num_run=2, device="cpu")
    assert auto.backend == "torch"  # below the cap: the whole form
    with pytest.raises(ValueError, match="float32 SpMV only"):
        harness.run_benchmark(*args, num_run=2, device="cpu", backend="cuda-sliced", num_rhs=4)
    with pytest.raises(ValueError, match="unknown backend"):
        harness.run_benchmark(*args, num_run=2, device="cpu", backend="pallas-sliced")


def test_k3_table_and_cpu_refusal():
    """K3's slice table (the host side of its wrapper): one descriptor per
    slice with its first tile, rows, columns and column mode. The kernel
    itself refuses CPU tensors before any build."""
    a, _, slp = _build("packed16")
    table, total, out_rows, _ = bigslice_kernel._table(slp, torch.device("cpu"))
    f = {k: i for i, k in enumerate(bigslice_kernel.DESC_FIELDS)}
    t = table.numpy()
    assert total == sum(s.num_tiles for s in slp.slices)
    assert list(t[:, f["tile0"]]) == list(np.cumsum([0] + [s.num_tiles for s in slp.slices])[:-1])
    assert list(t[:, f["r0"]]) == list(slp.row_starts[:-1])
    assert list(t[:, f["c0"]]) == list(slp.col_starts)
    assert (t[:, f["packed"]] == 1).all() and (t[:, f["bf16"]] == 0).all()
    assert list(t[:, f["pmax"]]) == [s.pmax for s in slp.slices]
    assert out_rows == max(r0 + s.m_pad for r0, s in zip(slp.row_starts, slp.slices))
    assert bigslice_kernel._table(slp, torch.device("cpu"))[0] is table  # kept on the matrix
    with pytest.raises(ValueError, match="CUDA tensors"):
        P.sliced_spmv(slp, torch.ones(a.shape[1]), backend="cuda")
    assert "csr5_sliced" not in cuda_build.loaded()
