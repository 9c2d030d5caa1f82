"""The port's benchmark cases (``bench/case_runner.py``) at small sizes on
the CPU (the plain versions), against the JAX package on the same
matrices. The factories are cut to m = 3,000-20,000 rows; each case must
land with ``check_ok`` and max rel err 0.0 on its integer data, carry
its byte models and no TPU-derived field, and give the JAX package's
structural answers: sigma, storage, the plan and bandwidths, the
band-block K, the DIA diagonals, the HYB split and the selected formats
(the JAX case function where it runs on the CPU, else the JAX functions
it calls). A candidate that fails its check fails the case."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import benchmark_spmv_using_csr5_tpu as J
import benchmark_spmv_using_csr5_tpu.ops.bandmm as jbb
import benchmark_spmv_using_csr5_tpu.ops.dia as jdia
import benchmark_spmv_using_csr5_tpu.ops.hyb as jhyb
import benchmark_spmv_using_csr5_tpu.ops.select as jsel
from benchmark_spmv_using_csr5_tpu.bench import case_runner as jcr
from benchmark_spmv_using_csr5_tpu_torch.bench import case_runner as cr
from benchmark_spmv_using_csr5_tpu_torch.bench import harness
from benchmark_spmv_using_csr5_tpu_torch.ops import bigslice
from benchmark_spmv_using_csr5_tpu_torch.parallel.distributed import build_shard
from benchmark_spmv_using_csr5_tpu_torch.utils import perf, synth

#: every case record carries these
FIELDS = {
    "name", "spmv_ms", "gflops", "nnz_per_sec", "pct_hbm_streamed", "pct_getb_of_hbm",
    "streamed_bytes", "bytes_model", "l2_resident", "l2_flushed", "storage", "check_ok",
    "max_rel_err", "launches",
}


def _small_suite():
    return {
        "banded500k": (lambda: synth.banded(5000, 27, dtype=np.float32), 1, 2, False, None),
        "scatband300k": (
            lambda: synth.scattered_band(6000, 16, 3000, dtype=np.float32), 1, 2, True, None,
        ),
        "powerlaw200k": (
            lambda: synth.power_law(4000, 4000, 8.0, dtype=np.float32), 1, 2, False, None,
        ),
        "spmm8_banded500k": (lambda: synth.banded(4000, 27, dtype=np.float32), 8, 2, False, None),
        "fem3block600k": (
            lambda: synth.fem_blocks(6000, neighbors=9, node_bandwidth=600), 1, 2, True, None,
        ),
        "banded2M": (lambda: synth.banded(8000, 27, dtype=np.float32), 1, 2, False, None),
        "banded20M": (lambda: synth.banded(8000, 27, dtype=np.float32), 1, 2, False, None),
        "df64_banded500k": (lambda: synth.f64_banded(4000, 27), 1, 2, False, None),
        "scrambled300k": (lambda: cr._scrambled_band(20_000, 10, 4000), 1, 2, True, "auto"),
        "scrambled300k_rcm": (lambda: cr._scrambled_band(20_000, 10, 4000), 1, 2, True, "rcm"),
    }


def _small_mtx():
    return {
        "mtx_lap2d_490k": ("lap2d_60.mtx", lambda: cr._lap2d(60), 1, 2),
        "mtx_powlaw300k": (
            "powlaw3k.mtx",
            lambda: sp.csr_matrix(synth.power_law(3000, 3000, 10.0, dtype=np.float64)),
            1,
            2,
        ),
    }


@pytest.fixture
def small(monkeypatch):
    monkeypatch.setattr(cr, "_suite", _small_suite)
    monkeypatch.setattr(cr, "_mtx_suite", _small_mtx)
    monkeypatch.setattr(harness, "WARMUP", 1)
    monkeypatch.setattr(jcr, "_suite", _small_suite)
    monkeypatch.setattr(jcr, "_mtx_suite", _small_mtx)


def _check_record(out, exact=True):
    assert FIELDS <= set(out), FIELDS - set(out)
    assert out["check_ok"] is True
    if exact:
        assert out["max_rel_err"] == 0.0
    # on the CPU a host time has no roofline; no field of the TPU's bench
    assert out["pct_hbm_streamed"] is None and out["pct_getb_of_hbm"] is None
    assert not {"pct_roofline", "pct_dia_stream_model"} & set(out)
    assert out["l2_flushed"] is False and out["l2_resident"] is True
    assert out["streamed_bytes"] > 0 and "getB: 4 B index" in out["bytes_model"]
    assert out["launches"] == {}  # no kernel runs on the CPU


@pytest.mark.parametrize(
    "name",
    ["banded500k", "scatband300k", "powerlaw200k", "fem3block600k", "df64_banded500k",
     "scrambled300k", "scrambled300k_rcm", "banded2M"],
)
def test_csr5_cases_match_the_jax_case(small, name):
    out = cr.run_one(name, "cpu")
    _check_record(out)
    assert out["name"] == name and out["backend"] == "torch" and out["format"] == "csr5"
    jout = jcr._run_csr5_case(name)
    assert jout["check_ok"] and jout["max_rel_err"] == 0.0
    assert out["sigma"] == jout["sigma"]
    if name == "df64_banded500k":
        assert out["storage"] == "float64" and "8 B value" in out["bytes_model"]
    else:
        assert out["storage"] == jout["storage"]
    for k in ("plan_format", "plan_reorder", "bandwidth_before", "bandwidth_after"):
        assert out.get(k) == jout.get(k), k
    if name == "scrambled300k":
        assert out["plan_reorder"] == "rcm" and out["bandwidth_after"] * 4 <= out["bandwidth_before"]


def test_banded20m_takes_the_sliced_form(small, monkeypatch):
    """At full size banded20M exceeds should_slice and runs on K3; here
    the threshold is forced."""
    monkeypatch.setattr(bigslice, "should_slice", lambda m, n: True)
    out = cr.run_one("banded20M", "cpu")
    _check_record(out)
    assert out["backend"] == "torch-sliced"
    a = synth.banded(8000, 27, dtype=np.float32)
    sl = bigslice.build_csr5_sliced(a, value_dtype="auto", device="cpu")
    x = torch.zeros(8000)
    assert out["streamed_bytes"] == perf.streamed_bytes(sl, x)


def _jax_bandblock(a, **kw):
    return jbb.build_bandblock((a.indptr, a.indices, a.data, a.shape), **kw)


def test_spmm8_auto_candidates(small):
    out = cr.run_one("spmm8_banded500k", "cpu")
    _check_record(out)
    a = synth.banded(4000, 27, dtype=np.float32)
    jbbm = _jax_bandblock(a)
    assert out["bandmm_K"] == jbbm.K
    assert out["bandmm_storage"] == str(np.dtype(jbbm.dense.dtype))
    assert out["csr5_rn_check_ok"] and out["bandmm_rn_check_ok"] and out["auto_check_ok"]
    assert out["csr5_rn_rel_err"] == 0.0 and out["bandmm_rn_rel_err"] == 0.0
    assert out["auto_format"] in ("csr5_rn", "bandmm_rn")
    assert out["auto_spmm_ms"] == min(out["csr5_rn_ms"], out["bandmm_rn_ms"])
    # the JAX case's SpMM candidates need the Pallas kernels: its build instead
    ja5 = J.build_csr5((a.indptr, a.indices, a.data, a.shape), value_dtype="auto")
    assert out["sigma"] == ja5.sigma and out["storage"] == str(np.dtype(ja5.val_tiles.dtype))


def test_failing_auto_candidate_fails_the_case(small, monkeypatch):
    real = cr.bandmm.bandmm_spmm
    monkeypatch.setattr(cr.bandmm, "bandmm_spmm", lambda *a, **k: real(*a, **k) * 2.0)
    out = cr.run_one("spmm8_banded500k", "cpu")
    assert out["bandmm_rn_check_ok"] is False and out["bandmm_rn_rel_err"] > 0.01
    assert "bandmm_rn_ms" not in out and out["auto_check_ok"] is False
    assert out["check_ok"] is False
    assert out["backend"] in ("torch", "auto:csr5_rn")


@pytest.mark.parametrize("name", ["mtx_lap2d_490k", "mtx_powlaw300k"])
def test_mtx_cases_write_and_load_their_file(small, tmp_path, monkeypatch, name):
    out = cr.run_one(name, "cpu", str(tmp_path))
    _check_record(out)
    fname = _small_mtx()[name][0]
    path = tmp_path / fname
    assert path.exists() and out["mtx_bytes"] == os.path.getsize(path) and out["mtx_gen_ms"] > 0
    assert not (tmp_path / (fname + ".tmp")).exists()
    again = cr.run_one(name, "cpu", str(tmp_path))
    assert again["mtx_gen_ms"] == 0.0 and again["check_ok"]  # written once
    monkeypatch.setattr(jcr, "_DATA_DIR", str(tmp_path / "jax"))
    jout = jcr._run_mtx_case(name)
    assert out["auto_format"] == jout["auto_format"] and out["sigma"] == jout["sigma"]
    if out["auto_format"] != "csr5":
        assert out["auto_check_ok"] is True and out["auto_rel_err"] == 0.0
        assert out["auto_spmv_ms"] > 0 and out["auto_streamed_bytes"] > 0


def test_failing_auto_format_fails_the_mtx_case(small, tmp_path, monkeypatch):
    monkeypatch.setattr(cr, "dia_spmv", lambda d, x: torch.zeros(d.m))
    out = cr.run_one("mtx_lap2d_490k", "cpu", str(tmp_path))
    assert out["auto_format"] == "dia" and out["auto_check_ok"] is False
    assert out["check_ok"] is False and "auto_spmv_ms" not in out


@pytest.mark.parametrize("fn, m, bw, name", [
    (cr._run_dia_case, 3000, 3, "dia_tridiag500k"),
    (cr._run_dia2m_case, 20_000, 27, "dia_banded2M"),
])
def test_dia_cases(small, fn, m, bw, name):
    out = fn("cpu", m=m, num_run=2)
    out["launches"] = {}
    _check_record(out)
    assert out["name"] == name and out["format"] == "dia" and out["storage"] == "float32"
    a = sp.csr_matrix(synth.banded(m, bw, dtype=np.float32))
    jd = jdia.build_dia((a.indptr, a.indices, a.data, a.shape))
    assert out["ndiag"] == jd.ndiag


def test_hyb_case_and_its_csr5_point(small, monkeypatch):
    out = cr._run_hyb_case("cpu", m=4000, num_run=2)
    out["launches"] = {}
    _check_record(out)
    a = cr.hybmix(4000)
    assert out["selected_format"] == jsel.select_format(a.indptr, a.indices, a.shape) == "hyb"
    jh = jhyb.build_hyb((a.indptr, a.indices, a.data, a.shape))
    assert out["dia_diags"] == jh.dia.ndiag and out["csr5_part_nnz"] == jh.csr5.nnz_stored
    assert out["csr5_check_ok"] is True and out["csr5_rel_err"] == 0.0
    assert out["speedup_vs_csr5"] == pytest.approx(out["csr5_ms"] / out["spmv_ms"])
    monkeypatch.setattr(cr, "csr5_spmv", lambda a5, x: torch.zeros(a5.m))
    bad = cr._run_hyb_case("cpu", m=4000, num_run=2)
    assert bad["csr5_check_ok"] is False and bad["check_ok"] is False


def test_spmm16_case(small):
    out = cr._run_spmm16_case("cpu", m=3000, num_run=2)
    out["launches"] = {}
    _check_record(out)
    a = synth.banded(3000, 27, dtype=np.float32)
    jbbm = _jax_bandblock(a)
    assert out["bandmm_K"] == jbbm.K and out["storage"] == str(np.dtype(jbbm.dense.dtype))
    assert out["ms_per_rhs"] == pytest.approx(out["spmv_ms"] / 16)


def test_spmmf8_case_gates_both_planes(small, monkeypatch):
    out = cr._run_spmmf8_case("cpu", m=3000, num_run=2)
    out["launches"] = {}
    _check_record(out, exact=False)
    assert out["max_rel_err"] <= 1e-4 and out["gate_escalated_to_f32"] is True
    assert out["bf16_forced_check_ok"] is True and 0 < out["bf16_forced_rel_err"] <= 0.01
    a = sp.csr_matrix(synth.banded(3000, 27, dtype=np.float32))
    rng = np.random.default_rng(7)
    a.data = (rng.uniform(0.1, 1.0, a.nnz) * 10.0 ** rng.integers(-1, 2, a.nnz)).astype(np.float32)
    jbbm = _jax_bandblock(a)
    assert out["storage"] == str(np.dtype(jbbm.dense.dtype)) == "float32"
    assert out["bandmm_K"] == jbbm.K
    assert str(np.dtype(_jax_bandblock(a, value_dtype=jnp.bfloat16).dense.dtype)) == "bfloat16"
    # the forced bfloat16 plane failing its 1 % fails the case
    real = cr.bandmm.bandmm_spmm

    def bad(b, x, *args, precision="auto", **kw):
        y = real(b, x, *args, precision=precision, **kw)
        return y * 1.5 if precision == "default" else y

    monkeypatch.setattr(cr.bandmm, "bandmm_spmm", bad)
    out = cr._run_spmmf8_case("cpu", m=3000, num_run=2)
    assert out["bf16_forced_check_ok"] is False and out["check_ok"] is False


def test_shares_on_a_card_come_from_the_streamed_bytes(small, monkeypatch):
    """With a card's bandwidth the case computes both shares from its own
    time and bytes (the card is simulated by its bandwidth only)."""
    monkeypatch.setattr(cr, "_gbps", lambda device: 3350.0)
    out = cr._run_spmm16_case("cpu", m=3000, num_run=2)
    ms = out["spmv_ms"]
    assert out["pct_hbm_streamed"] == pytest.approx(100 * out["streamed_bytes"] / (ms * 1e6) / 3350.0)
    a = synth.banded(3000, 27, dtype=np.float32)
    getb = perf.get_bytes(3000, a.nnz, 4, 4) + 15 * (3000 + 3000) * 4
    assert out["pct_getb_of_hbm"] == pytest.approx(100 * getb / (ms * 1e6) / 3350.0)


def test_run_one_defaults_to_the_card_and_knows_its_cases(small):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cr.run_one("banded500k")
    with pytest.raises(ValueError, match="unknown case"):
        cr.run_one("no_such_case", "cpu")


def test_dist1_case(small):
    """The distributed SpMV at D = 1 in its own gloo group on the CPU:
    exact, every field present, the group destroyed afterwards."""
    import torch.distributed as dist

    out = cr._run_dist1_case("cpu", m=5000, num_run=2)
    out["launches"] = {}
    _check_record(out)
    assert out["name"] == "dist1_banded500k" and out["backend"] == "dist1-gloo"
    assert out["aligned_check_ok"] is True and out["single_chip_check_ok"] is True
    assert out["spmv_ms"] > 0 and out["single_chip_ms"] > 0 and out["aligned_shard_ms"] > 0
    assert out["overhead_pct"] == pytest.approx(100 * (out["spmv_ms"] / out["single_chip_ms"] - 1))
    assert out["convert_route"] == "host" and out["x_bytes_exchanged"] == 0
    assert out["storage"] == "float32" and not dist.is_initialized()
    a = synth.banded(5000, 27, dtype=np.float32)
    shard = build_shard(a.indptr, a.indices, a.data, a.shape, 0, 1, device="cpu")
    assert out["streamed_bytes"] == perf.streamed_bytes(shard.local, torch.zeros(5000))


def test_dist1_case_fails_when_the_aligned_check_fails(small, monkeypatch):
    """The aligned-map check gates check_ok (the JAX case leaves it out,
    ``case_runner.py:630``)."""
    real = cr.build_csr5

    def broken(*args, win_mode="auto", **kw):
        a5 = real(*args, win_mode=win_mode, **kw)
        if win_mode == "aligned":
            a5.val_tiles = a5.val_tiles * 2
        return a5

    monkeypatch.setattr(cr, "build_csr5", broken)
    out = cr._run_dist1_case("cpu", m=5000, num_run=2)
    assert out["aligned_check_ok"] is False and out["aligned_rel_err"] > 0.01
    assert out["aligned_shard_ms"] is None and out["check_ok"] is False


def test_prewarm_arena_sizes(monkeypatch):
    taken = []
    monkeypatch.setattr(cr, "arena_take", lambda n, dt, tag, zero: taken.append((tag, n)))
    cr.prewarm_arena(["banded500k", "hybmix400k"])
    assert taken == []
    cr.prewarm_arena(["banded2M"])
    assert dict(taken)["cv:col_flat"] == 60_000_000 * 4 and dict(taken)["cv:col16"] == 60_000_000 * 2
    taken.clear()
    cr.prewarm_arena(["banded2M", "banded20M"])
    assert len(taken) == 7 and dict(taken)["cv:valtr"] == 260_000_000 * 4
