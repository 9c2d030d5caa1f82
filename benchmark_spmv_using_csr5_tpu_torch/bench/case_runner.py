"""The benchmark cases of the JAX package's suite, on the port.

The counterpart of ``benchmark_spmv_using_csr5_tpu/bench/case_runner.py``
(``:44-868``): the same case names, matrices, seeds and right-hand-side
counts, run through the port's harness (``run_benchmark``, ``run_dia``,
``run_hyb``, ``rel_err``, ``perf.benchmark``), builders and planners on
``device`` (the card by default; the harness raises without one, and
``"cpu"`` runs the plain versions). :mod:`.suite` runs them in order.

Case families:

- CSR5 synthetics (banded, scattered band, power law, FEM blocks, SpMM,
  float64, the 2M- and 20M-row bands): :func:`_run_csr5_case`;
- ``scrambled300k`` / ``scrambled300k_rcm``: a randomly permuted band,
  reordered by ``select_plan`` (auto) or by RCM (manual);
- ``mtx_*``: a Matrix Market file written once into ``data_dir`` with the
  native writer and read back with the native parser;
- DIA (``dia_tridiag500k``, ``dia_banded2M``), HYB5 (``hybmix400k``,
  against pure CSR5) and band-block SpMM (``spmm16_banded500k``,
  ``spmmf8_banded500k``).

Every case records its time, the share of the card's HBM bandwidth of the
bytes its kernel streams (``pct_hbm_streamed``, the roofline share) and of
getB (``pct_getb_of_hbm``, the reference's model), ``streamed_bytes``,
``storage``, ``bytes_model``, ``l2_resident`` (the streamed bytes fit in
the 50 MB L2, so the timed loop, which does not flush it, may read them
from there: ``l2_flushed`` is false), and the launches of each kernel.
Every number a case reports is checked, and each check gates
``check_ok``: a candidate that fails its check fails the case.

Left out: ``dist1_banded500k``, until distribution is ported.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import scipy.sparse as sp
import torch

from ..config import DEFAULT_DEVICE, CSR5Config, resolve_device
from ..models.formats import CSR5Matrix
from ..ops import bandmm
from ..ops.convert import build_csr5
from ..ops.csr5_kernel import spmm_supported
from ..ops.csr5_spmv import csr5_spmm, csr5_spmv
from ..ops.dia import build_dia, dia_spmv, dia_supported
from ..ops.hyb import build_hyb, hyb_spmv
from ..ops.select import apply_plan, select_format, select_plan
from ..utils import mmio, nativelib, perf, progress, reorder, synth
from ..utils.hostmem import arena_take
from . import harness

#: where the ``mtx_*`` cases keep their files (gitignored)
DATA_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "data"
)
#: the reference's validation gate (main.cu:361-384)
CHECK_RTOL = 0.01
#: spmmf8's gated float32 path against the float64 oracle (the JAX case)
F32_RTOL = 1e-4


def _scrambled_band(m, bw, span, seed=0):
    """A scattered band hidden behind a random symmetric permutation, the
    badly ordered matrix RCM is for (``case_runner.py:58-68``)."""
    a = sp.csr_matrix(synth.scattered_band(m, bw, span, dtype=np.float32))
    perm = np.random.default_rng(seed).permutation(m)
    return a[perm][:, perm].tocsr()


def _suite():
    """name -> (factory, num_rhs, num_run, autotune, reorder), as the JAX
    ``_suite`` (``case_runner.py:71-129``)."""
    return {
        "banded500k": (lambda: synth.banded(500_000, 27, dtype=np.float32), 1, 200, False, None),
        "scatband300k": (
            lambda: synth.scattered_band(300_000, 16, 6000, dtype=np.float32), 1, 100, True, None,
        ),
        "powerlaw200k": (
            lambda: synth.power_law(200_000, 200_000, 8.0, dtype=np.float32), 1, 50, False, None,
        ),
        "spmm8_banded500k": (lambda: synth.banded(500_000, 27, dtype=np.float32), 8, 50, False, None),
        "fem3block600k": (lambda: synth.fem_blocks(600_000), 1, 100, True, None),
        "banded2M": (lambda: synth.banded(2_000_000, 27, dtype=np.float32), 1, 100, False, None),
        "banded20M": (lambda: synth.banded(20_000_000, 27, dtype=np.float32), 1, 50, False, None),
        "df64_banded500k": (lambda: synth.f64_banded(500_000, 27), 1, 100, False, None),
        "scrambled300k": (lambda: _scrambled_band(300_000, 10, 4000), 1, 50, True, "auto"),
        "scrambled300k_rcm": (lambda: _scrambled_band(300_000, 10, 4000), 1, 100, True, "rcm"),
    }


def _lap2d(g=700):
    """The 9-point Laplacian on a g x g grid (``case_runner.py:139-146``)."""
    m = g * g
    offs = [-g - 1, -g, -g + 1, -1, 0, 1, g - 1, g, g + 1]
    diags = [np.full(m - abs(o), -1.0, np.float64) for o in offs]
    diags[4] = np.full(m, 8.0)
    return sp.csr_matrix(sp.diags(diags, offs, shape=(m, m)))


def _mtx_suite():
    """name -> (file name, factory, num_rhs, num_run)
    (``case_runner.py:134-158``)."""
    return {
        "mtx_lap2d_490k": ("lap2d_700.mtx", _lap2d, 1, 100),
        "mtx_powlaw300k": (
            "powlaw300k.mtx",
            lambda: sp.csr_matrix(synth.power_law(300_000, 300_000, 10.0, dtype=np.float64)),
            1,
            50,
        ),
    }


def _gbps(device: torch.device):
    """The card's HBM bandwidth, or None on the CPU (no roofline)."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return perf.device_hbm_gbps(torch.cuda.get_device_name(device))


def _shares(streamed: int, pct_streamed, pct_getb, value_bytes: int) -> dict:
    return {
        "pct_hbm_streamed": pct_streamed,
        "pct_getb_of_hbm": pct_getb,
        "streamed_bytes": int(streamed),
        "bytes_model": f"streamed: the planes the kernel reads + x + y; getB: 4 B index + "
        f"{value_bytes} B value per nonzero, as the reference counts",
        "l2_resident": bool(streamed <= perf.L2_BYTES),
        "l2_flushed": False,
    }


def _result_fields(res: harness.BenchResult) -> dict:
    """The fields of one harness run."""
    vb = 8 if res.dtype == "float64" else 4
    return {
        "spmv_ms": res.spmv_ms,
        "gflops": res.gflops,
        "nnz_per_sec": res.nnz_per_sec,
        **_shares(res.streamed_bytes, res.pct_hbm_streamed, res.pct_getb_of_hbm, vb),
        "storage": res.storage,
        "format": res.format,
        "backend": res.backend,
        "device": res.device,
        "check_ok": bool(res.check_ok),
        "max_rel_err": float(res.max_rel_err),
        "sigma": res.sigma,
        "convert_ms": res.convert_ms,
        "convert_phases_ms": res.convert_phases,
    }


def _metrics(device, mat, x: torch.Tensor, num_rhs: int, nnz: int, ms: float) -> dict:
    """The fields of one timed product ``mat @ x`` outside the harness
    (float32 values): time, GFLOPS and both shares."""
    met = perf.spmv_metrics(
        mat.m, nnz, ms, 4, roofline_gbps=_gbps(device), num_rhs=num_rhs, n=mat.n,
        streamed=perf.streamed_bytes(mat, x, num_rhs),
    )
    return {
        "spmv_ms": ms,
        "gflops": met.gflops,
        "nnz_per_sec": met.nnz_per_sec,
        **_shares(met.streamed_bytes, met.pct_hbm_streamed, met.pct_getb_of_hbm, 4),
    }


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _check_time(fn, mat, x: torch.Tensor, y_ref: np.ndarray, num_run: int, device):
    """(ms, rel): one product checked against ``y_ref`` at the 1 % gate,
    then timed as the harness times (warmup, ``num_run`` calls between
    events); ms is None, and nothing is timed, when the check fails."""
    rel = harness.rel_err(fn(mat, x), y_ref)
    if rel > CHECK_RTOL:
        return None, rel
    return perf.benchmark(fn, mat, x, device=device, warmup=harness.WARMUP, num_run=num_run), rel


def _run_csr5_case(name: str, device=DEFAULT_DEVICE) -> dict:
    make, rhs, num_run, autotune, reorder_ = _suite()[name]
    a = sp.csr_matrix(make())
    extra = {}
    if reorder_ == "auto":
        # the framework's front door: select_plan sees recoverable
        # locality and applies RCM itself
        t0 = time.perf_counter()
        plan = select_plan(a.indptr, a.indices, a.shape)
        csr2, _ = apply_plan((a.indptr, a.indices, a.data, a.shape), plan)
        extra = {
            "plan_format": plan.format,
            "plan_reorder": plan.reorder or "none",
            "plan_ms": plan.plan_ms,
            "reorder_ms": (time.perf_counter() - t0) * 1e3,
            "bandwidth_before": int(plan.bandwidth_before),
            "bandwidth_after": plan.bandwidth_after,
        }
        if plan.reorder is not None:
            a = sp.csr_matrix((csr2[2], csr2[1], csr2[0]), shape=csr2[3])
    elif reorder_ is not None:
        t0 = time.perf_counter()
        bw0 = reorder.bandwidth(a)
        a, _ = reorder.reorder_for_locality(a, method=reorder_)
        extra = {
            "reorder_ms": (time.perf_counter() - t0) * 1e3,
            "bandwidth_before": int(bw0),
            "bandwidth_after": int(reorder.bandwidth(a)),
        }
    res = harness.run_benchmark(
        name, a.indptr, a.indices, a.data, a.shape,
        num_run=num_run, num_rhs=rhs, autotune=autotune, device=device,
    )
    print(res.report(), file=sys.stderr)
    out = {"name": name, **_result_fields(res), **extra}
    if rhs > 1:
        auto, headline = _spmm_auto_extra(name, a, rhs, num_run, res, device)
        out.update(auto)
        out["check_ok"] = out["check_ok"] and auto["auto_check_ok"]
        if headline is not None and auto["auto_spmm_ms"] < res.spmv_ms:
            # the format selector is the front door: the faster checked
            # candidate is the headline, the harness's CSR5 time stays
            out["csr5_spmm_ms"] = res.spmv_ms
            out["csr5_pct_hbm_streamed"] = res.pct_hbm_streamed
            out.update(headline)
            out["backend"] = f"auto:{auto['auto_format']}"
    return out


def _spmm_auto_extra(name, a, rhs, num_run, csr5_res, device):
    """The SpMM candidates in the solver-loop layout (X^T in, Y^T out,
    ``layout="rn"``): the CSR5 kernel and the band-block kernel, each
    checked at the 1 % gate and timed; the faster is the auto pick
    (``case_runner.py:260-328``). Returns (extra fields, the winner's
    metric fields or None)."""
    xt = np.random.default_rng(0).integers(1, 10, (rhs, a.shape[1])).astype(np.float32)
    xtd = torch.from_numpy(xt).to(device)
    y_ref_t = (a @ xt.T).T
    extra, times, checks = {}, {}, []

    def _time(label, fn, mat):
        ms, rel = _check_time(fn, mat, xtd, y_ref_t, num_run, device)
        extra[f"{label}_rel_err"] = rel
        extra[f"{label}_check_ok"] = ms is not None
        checks.append(ms is not None)
        if ms is None:
            return
        times[label] = (ms, mat)
        extra[f"{label}_ms"] = ms
        print(f"[{name}] {label} (solver-loop layout): {ms:.5f} ms rel={rel:.1e}", file=sys.stderr)

    a5 = csr5_res.matrix
    if isinstance(a5, CSR5Matrix) and spmm_supported(a5, rhs):
        _time("csr5_rn", lambda a_, x_: csr5_spmm(a_, x_, layout="rn"), a5)
    t0 = time.perf_counter()
    bb = bandmm.build_bandblock((a.indptr, a.indices, a.data, a.shape), device=device)
    if bb is not None and bandmm.bandmm_supported(bb, rhs):
        extra["bandmm_build_ms"] = (time.perf_counter() - t0) * 1e3
        extra["bandmm_K"] = int(bb.K)
        extra["bandmm_dense_mb"] = bb.dense_bytes / 1e6
        extra["bandmm_storage"] = _dtype_name(bb.dense)
        _time("bandmm_rn", lambda b_, x_: bandmm.bandmm_spmm(b_, x_, layout="rn"), bb)
    extra["auto_check_ok"] = all(checks)
    if not times:
        return extra, None
    best = min(times, key=lambda k: times[k][0])
    ms, mat = times[best]
    extra.update(
        auto_format=best, auto_spmm_ms=ms, auto_speedup_vs_csr5=csr5_res.spmv_ms / ms
    )
    headline = _metrics(device, mat, xtd, rhs, a.nnz, ms)
    headline["storage"] = _dtype_name(mat.val_tiles if isinstance(mat, CSR5Matrix) else mat.dense)
    return extra, headline


def _run_mtx_case(name: str, device=DEFAULT_DEVICE, data_dir: str = DATA_DIR) -> dict:
    """The reference's usage shape (``./spmv matrix.mtx``): a .mtx file,
    written once into ``data_dir`` with integer values 1-9 by the native
    writer, then native parse -> CSR -> CSR5 -> SpMV on the card
    (``case_runner.py:331-374``)."""
    fname, factory, rhs, num_run = _mtx_suite()[name]
    path = os.path.join(data_dir, fname)
    gen_ms = 0.0
    if not os.path.exists(path):
        os.makedirs(data_dir, exist_ok=True)
        t0 = time.perf_counter()
        a = factory()
        # integer values in [1, 9] keep the float32 check exact (main.cu:317)
        a.data[:] = np.random.default_rng(0).integers(1, 10, a.nnz).astype(a.data.dtype)
        tmp = path + ".tmp"
        if not nativelib.write_matrix_market(tmp, a.indptr, a.indices, a.data, a.shape):
            mmio.write_mtx(tmp, a.indptr, a.indices, a.data, a.shape)  # no native library
        os.replace(tmp, path)
        gen_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    rp, ci, v, shape = nativelib.load_matrix_market(path)
    load_ms = (time.perf_counter() - t0) * 1e3
    res = harness.run_benchmark(
        name, rp, ci, v.astype(np.float32), shape,
        num_run=num_run, num_rhs=rhs, autotune=True, device=device,
    )
    print(res.report(), file=sys.stderr)
    out = {
        "name": name,
        "file": fname,
        "mtx_bytes": os.path.getsize(path),
        "mtx_load_ms": load_ms,
        "mtx_gen_ms": gen_ms,
        **_result_fields(res),
    }
    out.update(_auto_format_extra(name, rp, ci, v, shape, num_run, res, device))
    out["check_ok"] = out["check_ok"] and out.get("auto_check_ok", True)
    return out


def _auto_format_extra(name, rp, ci, v, shape, num_run, csr5_res, device) -> dict:
    """When the structural selector picks DIA or HYB5, that format checked
    at the 1 % gate and timed beside CSR5 (``case_runner.py:377-432``)."""
    fmt = select_format(rp, ci, shape)
    extra = {"auto_format": fmt}
    if fmt == "csr5":
        return extra
    v32 = v.astype(np.float32)
    x = np.random.default_rng(0).integers(1, 10, shape[1]).astype(np.float32)
    xd = torch.from_numpy(x).to(device)
    y_ref = sp.csr_matrix((v32, ci, rp), shape=shape) @ x
    if fmt == "dia":
        mat, fn = build_dia((rp, ci, v32, shape), device=device), dia_spmv
        if mat is None or not dia_supported(mat):
            return extra
    else:
        mat, fn = build_hyb((rp, ci, v32, shape), device=device), hyb_spmv
    ms, rel = _check_time(fn, mat, xd, y_ref, num_run, device)
    extra.update(auto_rel_err=rel, auto_check_ok=ms is not None)
    if ms is not None:
        m = _metrics(device, mat, xd, 1, len(v), ms)
        extra.update({f"auto_{k}": m[k] for k in ("spmv_ms", "pct_hbm_streamed", "pct_getb_of_hbm",
                                                  "streamed_bytes")})
        extra["auto_speedup_vs_csr5"] = csr5_res.spmv_ms / ms
        print(f"[{name}] auto-format {fmt}: {ms:.5f} ms ({csr5_res.spmv_ms / ms:.2f}x vs csr5) "
              f"rel={rel:.1e}", file=sys.stderr)
    return extra


def _run_spmm16_case(device=DEFAULT_DEVICE, m: int = 500_000, num_run: int = 50) -> dict:
    """R = 16 SpMM on the band-block path (K7), X^T in, Y^T out
    (``case_runner.py:435-482``)."""
    R = 16
    a = synth.banded(m, 27, dtype=np.float32)
    t0 = time.perf_counter()
    bb = bandmm.build_bandblock((a.indptr, a.indices, a.data, a.shape), device=device)
    build_ms = (time.perf_counter() - t0) * 1e3
    if bb is None or not bandmm.bandmm_supported(bb, R):
        raise RuntimeError("spmm16_banded500k: the band-block build refused the band")
    xt = np.random.default_rng(0).integers(1, 10, (R, m)).astype(np.float32)
    xtd = torch.from_numpy(xt).to(device)
    ms, rel = _check_time(
        lambda b_, x_: bandmm.bandmm_spmm(b_, x_, layout="rn"), bb, xtd, (a @ xt.T).T, num_run, device
    )
    out = {"name": "spmm16_banded500k"}
    if ms is not None:
        out.update(_metrics(device, bb, xtd, R, a.nnz, ms), ms_per_rhs=ms / R)
    out.update(
        check_ok=ms is not None,
        max_rel_err=rel,
        storage=_dtype_name(bb.dense),
        backend="bandmm",
        bandmm_K=int(bb.K),
        bandmm_dense_mb=bb.dense_bytes / 1e6,
        convert_ms=build_ms,
    )
    return out


def _run_spmmf8_case(device=DEFAULT_DEVICE, m: int = 500_000, num_run: int = 50) -> dict:
    """Float-valued R = 8 SpMM: the band-block precision gate on values
    that do not survive bfloat16 (``case_runner.py:485-561``). The auto
    plane must be float32 with ``precision="auto"`` (exact float32
    products) within 1e-4 of the float64 oracle; the forced bfloat16
    plane is held to the reference's 1 %."""
    R = 8
    a = sp.csr_matrix(synth.banded(m, 27, dtype=np.float32))
    rng = np.random.default_rng(7)
    a.data = (rng.uniform(0.1, 1.0, a.nnz) * 10.0 ** rng.integers(-1, 2, a.nnz)).astype(np.float32)
    csr = (a.indptr, a.indices, a.data, a.shape)
    xt = rng.uniform(0.5, 1.5, (R, m)).astype(np.float32)
    xtd = torch.from_numpy(xt).to(device)
    y_ref_t = (a.astype(np.float64) @ xt.T.astype(np.float64)).T  # the float64 oracle

    t0 = time.perf_counter()
    bb = bandmm.build_bandblock(csr, device=device)  # auto dtype: the gate under test
    build_ms = (time.perf_counter() - t0) * 1e3
    if bb is None or not bandmm.bandmm_supported(bb, R):
        raise RuntimeError("spmmf8_banded500k: the band-block build refused the band")
    gate_f32 = bb.dense.dtype == torch.float32
    ms, rel = _check_time(
        lambda b_, x_: bandmm.bandmm_spmm(b_, x_, layout="rn"), bb, xtd, y_ref_t, num_run, device
    )
    out = {"name": "spmmf8_banded500k"}
    if ms is not None:
        out.update(_metrics(device, bb, xtd, R, a.nnz, ms))
    out.update(
        storage=_dtype_name(bb.dense),
        bandmm_K=int(bb.K),
        convert_ms=build_ms,
        backend="bandmm-auto",
        max_rel_err=rel,
        gate_escalated_to_f32=bool(gate_f32),
    )
    del bb
    bb16 = bandmm.build_bandblock(csr, value_dtype=torch.bfloat16, device=device)
    ms16, rel16 = _check_time(
        lambda b_, x_: bandmm.bandmm_spmm(b_, x_, layout="rn", precision="default"),
        bb16, xtd, y_ref_t, num_run, device,
    )
    out.update(
        bf16_forced_ms=ms16,
        bf16_forced_rel_err=rel16,
        bf16_forced_check_ok=ms16 is not None,
        highest_cost_vs_bf16=ms / ms16 if ms and ms16 else None,
        check_ok=bool(gate_f32 and ms is not None and rel <= F32_RTOL and ms16 is not None),
    )
    print(f"[spmmf8_banded500k] auto gate -> {out['storage']}: rel {rel:.1e} (limit {F32_RTOL}); "
          f"forced bfloat16: rel {rel16:.1e} (limit {CHECK_RTOL})", file=sys.stderr)
    return out


def _run_dia_case(device=DEFAULT_DEVICE, m: int = 500_000, num_run: int = 400) -> dict:
    """DIA SpMV (K5) on a tridiagonal matrix (``case_runner.py:646-680``)."""
    a = sp.csr_matrix(synth.banded(m, 3, dtype=np.float32))
    res = harness.run_dia(
        "dia_tridiag500k", a.indptr, a.indices, a.data, a.shape, num_run=num_run, device=device
    )
    print(res.report(), file=sys.stderr)
    return {"name": "dia_tridiag500k", **_result_fields(res), "ndiag": res.matrix.ndiag}


def _run_dia2m_case(device=DEFAULT_DEVICE, m: int = 2_000_000, num_run: int = 100) -> dict:
    """DIA SpMV (K5) at 2M rows and 27 diagonals (``case_runner.py:683-731``);
    the streamed share is DIA's own stream model there."""
    a = sp.csr_matrix(synth.banded(m, 27, dtype=np.float32))
    res = harness.run_dia(
        "dia_banded2M", a.indptr, a.indices, a.data, a.shape, num_run=num_run, device=device
    )
    print(res.report(), file=sys.stderr)
    return {"name": "dia_banded2M", **_result_fields(res), "ndiag": res.matrix.ndiag}


def hybmix(m: int) -> sp.csr_matrix:
    """A dense 27-wide band plus 4 scattered ones per row
    (``case_runner.py:749-763``)."""
    band = sp.csr_matrix(synth.banded(m, 27, dtype=np.float32))
    rng = np.random.default_rng(3)
    nnz = m * 4
    noise = sp.csr_matrix(
        (np.ones(nnz, np.float32), (rng.integers(0, m, nnz), rng.integers(0, m, nnz))),
        shape=(m, m),
    )
    return (band + noise).tocsr()


def _run_hyb_case(device=DEFAULT_DEVICE, m: int = 400_000, num_run: int = 100) -> dict:
    """HYB5 (K5 on the dense diagonals + K1 on the rest) on a band plus
    noise, against pure CSR5 at sigma 8 on the same matrix and x
    (``case_runner.py:734-807``)."""
    a = hybmix(m)
    csr = (a.indptr, a.indices, a.data, a.shape)
    fmt = select_format(a.indptr, a.indices, a.shape)
    res = harness.run_hyb("hybmix400k", *csr, num_run=num_run, device=device)
    print(res.report(), file=sys.stderr)
    h = res.matrix
    x = np.random.default_rng(0).integers(1, 10, a.shape[1]).astype(np.float32)
    xd = torch.from_numpy(x).to(device)
    a5 = build_csr5(csr, CSR5Config(sigma=8), device=device)
    ms5, rel5 = _check_time(csr5_spmv, a5, xd, a @ x, max(num_run // 2, 1), device)
    out = {
        "name": "hybmix400k",
        **_result_fields(res),
        "selected_format": fmt,
        "dia_diags": h.dia.ndiag if h.dia is not None else 0,
        "csr5_part_nnz": h.csr5.nnz_stored if h.csr5 is not None else 0,
        "csr5_ms": ms5,
        "csr5_rel_err": rel5,
        "csr5_check_ok": ms5 is not None,
    }
    if ms5 is not None:
        out["csr5_pct_hbm_streamed"] = _metrics(device, a5, xd, 1, a.nnz, ms5)["pct_hbm_streamed"]
        out["speedup_vs_csr5"] = ms5 / res.spmv_ms
    out["check_ok"] = out["check_ok"] and ms5 is not None
    return out


def run_one(name: str, device=DEFAULT_DEVICE, data_dir: str = DATA_DIR) -> dict:
    """Run the case ``name`` on ``device`` (default: the card; raises
    without one) and return its record, with the launches of each kernel
    during it."""
    device = resolve_device(device, "run_one")
    before = harness.kernel_launches()
    special = {
        "dia_tridiag500k": _run_dia_case,
        "dia_banded2M": _run_dia2m_case,
        "spmm16_banded500k": _run_spmm16_case,
        "spmmf8_banded500k": _run_spmmf8_case,
        "hybmix400k": _run_hyb_case,
    }
    if name in special:
        out = special[name](device)
    elif name.startswith("mtx_"):
        out = _run_mtx_case(name, device, data_dir)
    elif name in _suite():
        out = _run_csr5_case(name, device)
    else:
        raise ValueError(f"unknown case {name!r}")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    out["launches"] = {
        k: v - before[k] for k, v in harness.kernel_launches().items() if v != before[k]
    }
    return out


def prewarm_arena(names) -> None:
    """Grow the conversion arena to the largest case up front (the
    reference's ``warmup()`` analogue, ``case_runner.py:843-868``), so no
    case pays the first touch of fresh host pages inside its conversion."""
    if "banded20M" in names:
        nnz_pad = 260_000_000  # the largest row slice of the 20M case
    elif "banded2M" in names:
        nnz_pad = 60_000_000
    else:
        return
    for tag in ("cv:col_flat", "cv:val_flat", "cv:coltr", "cv:valtr"):
        arena_take(nnz_pad * 4, np.uint8, tag, zero=False)
        progress.emit(f"prewarm:{tag}")
    for tag in ("cv:col16", "cv:pktr", "cv:valcast"):
        arena_take(nnz_pad * 2, np.uint8, tag, zero=False)
        progress.emit(f"prewarm:{tag}")
