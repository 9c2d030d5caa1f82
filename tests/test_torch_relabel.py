"""The column relabel of the port's conversion (``ops/convert.py``), on the
CPU: the rule as a pure function of the column counts, n, the plane's dtype
and packing; the rule left unfired on stencils, bands and the parity
matrices, whose planes stay the JAX build's; the relabelled plane and its
permutation on a power-law matrix; the plain product on (relabelled plane,
x') equal to it on (original plane, x); a checkpoint round trip. K1 on the
relabelled plane runs only on the card (``chip_smoke.py``)."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import benchmark_spmv_using_csr5_tpu as J
import chip_smoke
import benchmark_spmv_using_csr5_tpu_torch as P
from benchmark_spmv_using_csr5_tpu_torch.ops import bigslice, convert
from benchmark_spmv_using_csr5_tpu_torch.ops.csr5_spmv import csr5_spmv_torch
from benchmark_spmv_using_csr5_tpu_torch.utils import checkpoint, synth
from test_torch_convert import assert_same_matrix

#: the least n whose float32 x passes one SM's L1
N_PAST_L1 = convert.RELABEL_MIN_X_BYTES // 4 + 1


def _counts(kind: str, n: int) -> torch.Tensor:
    """Column counts of ``n`` columns: ``flat`` (a stencil's 27 each),
    ``skewed`` (a Zipf law: the top 1 % hold about 60 %), ``uniform``
    (Poisson, mean 16) or ``empty``."""
    rng = np.random.default_rng(0)
    if kind == "flat":
        c = np.full(n, 27)
    elif kind == "skewed":
        c = (1e6 / np.arange(1, n + 1)).astype(np.int64)
        rng.shuffle(c)
    elif kind == "uniform":
        c = rng.poisson(16, n)
    else:
        c = np.zeros(n, np.int64)
    return torch.from_numpy(c.astype(np.int64))


@pytest.mark.parametrize(
    "kind, n, dtype, packed, fires",
    [
        ("skewed", N_PAST_L1 * 2, torch.float32, False, True),
        ("skewed", N_PAST_L1 * 2, torch.bfloat16, False, True),
        ("flat", N_PAST_L1 * 2, torch.float32, False, False),
        ("uniform", N_PAST_L1 * 2, torch.float32, False, False),
        ("skewed", N_PAST_L1 * 2, torch.float64, False, False),
        ("skewed", N_PAST_L1 * 2, torch.float32, True, False),
        ("skewed", N_PAST_L1 - 1, torch.float32, False, False),
        ("skewed", N_PAST_L1, torch.float32, False, True),
        ("empty", N_PAST_L1 * 2, torch.float32, False, False),
    ],
    ids=["skewed_f32", "skewed_bf16", "flat", "uniform", "float64_plane", "col_packed",
         "x_in_l1", "x_just_past_l1", "no_nonzeros"],
)
def test_relabel_rule(kind, n, dtype, packed, fires):
    assert convert.relabel_rule(_counts(kind, n), n, dtype, packed) is fires


@pytest.mark.parametrize(
    "n, dtype, packed, fits",
    [
        (N_PAST_L1, torch.float32, False, True),
        (N_PAST_L1, torch.bfloat16, False, True),
        (N_PAST_L1 - 1, torch.float32, False, False),
        (N_PAST_L1, torch.float64, False, False),
        (N_PAST_L1, torch.float32, True, False),
    ],
    ids=["f32", "bf16", "x_in_l1", "float64_plane", "col_packed"],
)
def test_relabel_fits_is_the_structural_half(n, dtype, packed, fits):
    assert convert.relabel_fits(n, dtype, packed) is fits
    # where the structure fails, the rule never reads the counts
    if not fits:
        assert convert.relabel_rule(None, n, dtype, packed) is False


@pytest.mark.parametrize(
    "value_dtype, keep_raw_cols",
    [(torch.float64, True), (None, False)],
    ids=["float64_plane", "col_packed"],
)
def test_structurally_unfit_build_takes_no_column_counts(monkeypatch, value_dtype, keep_raw_cols):
    # a skewed matrix past L1 that K1 does not read raw: no bincount is paid
    a = _zipf_graph(N_PAST_L1 + 4000, 400_000)

    def counted(a5):
        raise AssertionError("column_counts ran on a matrix the rule cannot take")

    monkeypatch.setattr(convert, "column_counts", counted)
    a5 = P.build_csr5(_host(a), P.CSR5Config(sigma=16), value_dtype=value_dtype,
                      keep_raw_cols=keep_raw_cols, device="cpu")
    assert value_dtype == torch.float64 or a5.col_packed is not None
    assert a5.col_relabel_tiles is None and a5.relabel_perm is None
    assert "relabel" in convert.last_convert_phases


def _zipf_graph(n: int, nnz: int, seed: int = 0) -> sp.csr_matrix:
    """``nnz`` entries in random rows, their columns drawn by a Zipf law
    over randomly labelled columns (a few hub columns, many cold ones,
    some never drawn); integer values."""
    rng = np.random.default_rng(seed)
    w = 1.0 / np.arange(1, n + 1)
    cols = rng.permutation(n)[rng.choice(n, size=nnz, p=w / w.sum())]
    rows = rng.integers(0, n, nnz)
    a = sp.csr_matrix((rng.integers(1, 10, nnz).astype(np.float32), (rows, cols)), shape=(n, n))
    a.sum_duplicates()
    return a


def _stencil27(k: int) -> sp.csr_matrix:
    """The 27-point stencil on a k^3 grid (every neighbour slot in the grid)."""
    t = sp.diags([1.0, 2.0, 1.0], [-1, 0, 1], shape=(k, k))
    return sp.csr_matrix(sp.kron(sp.kron(t, t), t)).astype(np.float32)


def _host(a: sp.csr_matrix):
    return (a.indptr, a.indices, a.data, a.shape)


@pytest.mark.parametrize(
    "name, make",
    [("stencil27_42", lambda: _stencil27(42)),
     ("banded70k", lambda: sp.csr_matrix(synth.banded(70_000, 27)).astype(np.float32))],
)
def test_stencil_and_band_stay_unrelabelled_and_match_jax(name, make):
    a = make()
    assert a.shape[1] >= N_PAST_L1  # x passes L1: the counts decide
    a5 = P.build_csr5(_host(a), keep_raw_cols=True, device="cpu")
    assert a5.col_relabel_tiles is None and a5.relabel_perm is None
    assert "relabel" in convert.last_convert_phases
    assert_same_matrix(a5, J.build_csr5(_host(a), keep_raw_cols=True))


@pytest.mark.parametrize("value_dtype", [None, torch.bfloat16, torch.float64])
def test_parity_matrices_stay_unrelabelled(edge_matrix, value_dtype):
    name, a_sp = edge_matrix
    a = sp.csr_matrix(a_sp).astype(np.float32)
    a5 = P.build_csr5(_host(a), value_dtype=value_dtype, keep_raw_cols=True, device="cpu")
    assert a5.col_relabel_tiles is None and a5.relabel_perm is None, name


def test_power_law_build_relabels_and_keeps_the_jax_planes():
    a = _zipf_graph(N_PAST_L1 + 4000, 400_000)
    a5 = P.build_csr5(_host(a), device="cpu")
    assert a5.col_relabel_tiles is not None
    assert convert.last_convert_phases["relabel"] >= 0.0
    # the second plane is the port's own: every plane the JAX build makes is unchanged
    assert_same_matrix(a5, J.build_csr5(_host(a)))


@pytest.fixture(scope="module")
def relabelled():
    """A small power-law matrix (below the rule's L1 size) relabelled
    through the internal helper, with its column counts."""
    a = _zipf_graph(6000, 40_000, seed=3)
    a5 = P.build_csr5(_host(a), P.CSR5Config(sigma=24), device="cpu")
    assert a5.col_relabel_tiles is None  # x fits L1: the rule leaves it
    counts = convert.column_counts(a5)
    convert._relabel(a5, counts)
    return a, a5, counts


def test_column_counts_are_the_csr_column_counts(relabelled):
    a, a5, counts = relabelled
    want = np.bincount(a.indices, minlength=a.shape[1])
    np.testing.assert_array_equal(counts.numpy(), want)


def test_relabel_perm_is_a_permutation_of_the_gathered_ids(relabelled):
    a, a5, counts = relabelled
    perm = a5.relabel_perm
    assert perm.dtype == torch.int32
    gathered = torch.nonzero(counts > 0).flatten()
    assert perm.shape[0] == gathered.shape[0] < a.shape[1]  # some columns are never drawn
    assert torch.equal(torch.sort(perm.long()).values, gathered)
    # new ids in descending count, ties in ascending old id
    c = counts[perm.long()]
    assert bool((c[:-1] >= c[1:]).all())
    tie = c[:-1] == c[1:]
    assert bool((perm[:-1][tie] < perm[1:][tie]).all())


def test_relabelled_plane_is_newid_of_the_column_plane(relabelled):
    a, a5, counts = relabelled
    newid = torch.full((a5.n,), -1, dtype=torch.int32)
    newid[a5.relabel_perm.long()] = torch.arange(a5.relabel_perm.shape[0], dtype=torch.int32)
    want = newid[a5.col_idx_tiles.long()]
    assert a5.col_relabel_tiles.dtype == torch.int32
    assert torch.equal(a5.col_relabel_tiles, want)
    assert int(a5.col_relabel_tiles.min()) >= 0
    assert int(a5.col_relabel_tiles.max()) < a5.relabel_perm.shape[0]


@pytest.mark.parametrize("ids", [1, 100, chip_smoke.RELABEL_HOT_IDS])
def test_smoke_hot_share_is_the_nonzeros_below_the_new_ids(relabelled, ids):
    # the share chip_smoke.py prints: nonzeros whose new column id is below ids
    a, a5, _ = relabelled
    # element order is lane-major within a tile; the pads past nnz_stored drop out
    elems = a5.col_relabel_tiles.transpose(1, 2).reshape(-1)[: a5.nnz_stored]
    assert chip_smoke.hot_share(a5, ids) == int((elems < ids).sum()) / a.nnz


@pytest.mark.parametrize("alpha", [1.0, -1.75])
def test_plain_product_on_the_relabelled_plane_is_bit_equal(relabelled, alpha):
    a, a5, _ = relabelled
    x = torch.from_numpy(np.random.default_rng(5).uniform(-1, 1, a.shape[1]).astype(np.float32))
    xr = torch.index_select(x, 0, a5.relabel_perm)
    on_new = dataclasses.replace(a5, col_idx_tiles=a5.col_relabel_tiles,
                                 shape=(a5.m, xr.shape[0]))
    assert torch.equal(csr5_spmv_torch(on_new, xr, alpha), csr5_spmv_torch(a5, x, alpha))


def test_replace_drops_the_relabel(relabelled):
    _, a5, _ = relabelled
    b5 = dataclasses.replace(a5)
    assert b5.col_relabel_tiles is None and b5.relabel_perm is None


def test_row_slices_stay_unrelabelled():
    # the sliced kernel reads only col_idx_tiles: its slices get no second plane
    a = _zipf_graph(N_PAST_L1 + 4000, 400_000)
    sl = bigslice.build_csr5_sliced(_host(a), elem_cap=90_000, device="cpu")
    assert sl is not None and len(sl.slices) >= 3
    assert all(s.n >= N_PAST_L1 for s in sl.slices)  # each x window passes L1
    assert all(s.col_relabel_tiles is None and s.relabel_perm is None for s in sl.slices)
    assert P.build_csr5(_host(a), device="cpu").col_relabel_tiles is not None


def test_checkpoint_round_trip_rebuilds_the_relabel(tmp_path):
    a = _zipf_graph(N_PAST_L1 + 4000, 300_000, seed=1)
    a5 = P.build_csr5(_host(a), device="cpu")
    assert a5.col_relabel_tiles is not None
    p = str(tmp_path / "ck.npz")
    checkpoint.save_csr5(p, a5)
    with np.load(p) as z:
        assert "col_relabel_tiles" not in z.files and "relabel_perm" not in z.files
    back = checkpoint.load_csr5(p, device="cpu")
    assert torch.equal(back.col_relabel_tiles, a5.col_relabel_tiles)
    assert torch.equal(back.relabel_perm, a5.relabel_perm)
