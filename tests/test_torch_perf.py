"""The byte model of the roofline share (``utils/perf.py``):
``streamed_bytes`` counts each plane a format's kernel reads once, x once
and y once, by format (CSR5 raw or packed, float64, row-sliced, DIA, HYB5,
band-block), and ``spmv_metrics`` reports the streamed share beside
getB's. Counts are exact integers."""

import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from benchmark_spmv_using_csr5_tpu_torch import (
    CSR5Config,
    build_bandblock,
    build_csr5,
    build_csr5_sliced,
    build_dia,
    build_hyb,
)
from benchmark_spmv_using_csr5_tpu_torch.bench import harness
from benchmark_spmv_using_csr5_tpu_torch.utils import perf, synth


def nb(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def test_csr5_raw_plane():
    a = synth.banded(3000, 27, dtype=np.float32)
    a5 = build_csr5(a, CSR5Config(sigma=24), value_dtype=torch.bfloat16, device="cpu")
    assert a5.col_packed is None
    x = torch.ones(3000)
    want = nb(a5.col_idx_tiles, a5.val_tiles, a5.win_map, a5.tile_ptr) + 3000 * 4 + 3000 * 4
    assert perf.plane_bytes(a5) + 2 * 3000 * 4 == want == perf.streamed_bytes(a5, x)
    # SpMM: X (n, R) or X^T (R, n) read once, Y (m, R) written once
    X = torch.ones(3000, 8)
    assert perf.streamed_bytes(a5, X, 8) == want - 2 * 3000 * 4 + 2 * 3000 * 8 * 4
    assert perf.streamed_bytes(a5, X.T.contiguous(), 8) == perf.streamed_bytes(a5, X, 8)


def test_csr5_packed_plane_replaces_the_raw_columns():
    a = synth.banded(3000, 27, dtype=np.float32)
    a5 = build_csr5(a, CSR5Config(sigma=16), device="cpu")
    assert a5.col_packed is not None
    x = torch.ones(3000)
    want = nb(a5.col_packed, a5.pages, a5.val_tiles, a5.win_map, a5.tile_ptr) + 2 * 3000 * 4
    assert perf.streamed_bytes(a5, x) == want
    raw = dataclasses.replace(a5, col_packed=None)
    assert perf.streamed_bytes(raw, x) - want == nb(a5.col_idx_tiles) - nb(a5.col_packed, a5.pages)


def test_float64_plane_reads_raw_columns():
    """K4 streams the raw columns even where a packed plane exists."""
    a = synth.banded(3000, 27, dtype=np.float64)
    a5 = build_csr5(a, CSR5Config(sigma=16), value_dtype=torch.float64, device="cpu")
    x = torch.ones(3000, dtype=torch.float64)
    want = nb(a5.col_idx_tiles, a5.val_tiles, a5.win_map, a5.tile_ptr) + 2 * 3000 * 8
    assert perf.streamed_bytes(a5, x) == want


def test_sliced_sums_its_slices():
    a = sp.csr_matrix(synth.banded(4000, 9)).astype(np.float32)
    sl = build_csr5_sliced(a, elem_cap=3000, device="cpu")
    assert sl.num_slices >= 3
    x = torch.ones(4000)
    assert perf.streamed_bytes(sl, x) == sum(perf.plane_bytes(s) for s in sl.slices) + 2 * 4000 * 4


def test_dia_hyb_and_bandblock():
    a = sp.csr_matrix(synth.banded(3000, 9, dtype=np.float32))
    x = torch.ones(3000)
    d = build_dia(a, device="cpu")
    assert perf.streamed_bytes(d, x) == nb(d.data, d.offsets_t) + 2 * 3000 * 4
    rng = np.random.default_rng(3)
    noise = sp.csr_matrix(
        (np.ones(6000, np.float32), (rng.integers(0, 3000, 6000), rng.integers(0, 3000, 6000))),
        shape=(3000, 3000),
    )
    h = build_hyb((a + noise).tocsr(), device="cpu")
    assert h.dia is not None and h.csr5 is not None
    assert perf.streamed_bytes(h, x) == perf.plane_bytes(h.dia) + perf.plane_bytes(h.csr5) + 2 * 3000 * 4
    bb = build_bandblock(synth.banded(3000, 27, dtype=np.float32), device="cpu")
    X = torch.ones(3000, 8)
    assert perf.streamed_bytes(bb, X, 8) == nb(bb.dense, bb.c0) + 2 * 3000 * 8 * 4


def test_unknown_format_raises():
    with pytest.raises(TypeError, match="no byte model"):
        perf.plane_bytes(object())


def test_streamed_share_below_getb_on_a_bf16_band():
    """getB charges 12 B per nonzero; the bfloat16 plane streams 6 B plus
    the tile metadata, so its share of HBM is the smaller one."""
    a = synth.banded(20_000, 27, dtype=np.float32)
    a5 = build_csr5(a, value_dtype="auto", device="cpu")
    assert a5.val_tiles.dtype == torch.bfloat16
    x = torch.ones(20_000)
    met = perf.spmv_metrics(a.shape[0], a.nnz, 0.01, 4, roofline_gbps=3350.0,
                            streamed=perf.streamed_bytes(a5, x))
    assert 0 < met.pct_hbm_streamed < met.pct_getb_of_hbm
    assert met.pct_getb_of_hbm == pytest.approx(100 * perf.get_bytes(a.shape[0], a.nnz, 4, 4)
                                                / (0.01 * 1e6) / 3350.0)
    cpu = perf.spmv_metrics(a.shape[0], a.nnz, 0.01, 4, streamed=perf.streamed_bytes(a5, x))
    assert cpu.pct_hbm_streamed is None and cpu.pct_getb_of_hbm is None


def test_harness_reports_both_shares_and_no_roofline_on_the_cpu():
    a = synth.banded(3000, 27, dtype=np.float32)
    res = harness.run_benchmark("b", a.indptr, a.indices, a.data, a.shape, num_run=2, device="cpu")
    x = torch.from_numpy(np.random.default_rng(0).integers(1, 10, 3000).astype(np.float32))
    assert res.streamed_bytes == perf.streamed_bytes(res.matrix, x)
    assert res.pct_hbm_streamed is None and res.pct_getb_of_hbm is None
    assert res.getb_gbps == pytest.approx(perf.get_bytes(3000, a.nnz, 4, 4) / (1e6 * res.spmv_ms))
    assert "roofline not measured" in res.report()
    on_card = dataclasses.replace(res, pct_hbm_streamed=71.0, pct_getb_of_hbm=123.0)
    assert "71.0% of HBM roofline" in on_card.report() and "getB 123.0% of HBM" in on_card.report()
