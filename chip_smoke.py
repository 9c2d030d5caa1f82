#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's main paths once on one card: CSR5 SpMV,
the structural formats (DIA, HYB5, ``--format auto``) and the
multi-right-hand-side path (``--spmm K``: CSR5 SpMM, band-block SpMM).

Run from the root of the repository, with one NVIDIA GPU visible:

    python3 chip_smoke.py

Phases, each of which must pass:

1. the card (``nvidia-smi`` name and power limit) and the nvcc builds of
   every source under ``csrc/`` (``csr5_spmv.cu``, ``csr5_spmm.cu``,
   ``dia_spmv.cu``, ``bandmm.cu``) from the checkout, all started at once;
2. kernel K1 against its plain PyTorch version on the card and against
   scipy, on the odd shapes of the TPU sweep (``scripts/smoke_chip.py``):
   one tile, few tiles, every sigma, aligned maps, a scattered band, a
   power law, one dense row over many tiles, FEM blocks and the edge-case
   matrices, each with float32 and with bfloat16 value planes. On their
   integer-valued data the three agree exactly; one case of random floats
   holds the kernel to 1e-5 of each row's absolute sum;
3. the main path through the CLI and harness: ``example.mtx`` and
   ``--synthetic banded:500000:27``, with the launch count of K1 over
   that run, then K1 and the plain version timed at those shapes;
4. kernels K5 (DIA SpMV) and K6 (DIA SpMM) against their plain versions
   on the card and against scipy on odd shapes (the TPU sweep's
   ``dia_tiny`` and ``hyb_tiny``, m = 40, 700, 1500, rectangular, a far
   offset, negative offsets at row 0), both layouts, float32 and bfloat16
   planes, alpha = -1.75, R in {1, 2, 5, 8, 16}: exact on integer data;
   one case of random floats holds them to 1e-5 of each row's |A||x|;
5. the format path at full width through the CLI's own code:
   ``--format auto`` at banded500k (must pick dia), ``dia_tridiag500k``,
   ``hybmix400k`` (``--format auto`` must pick hyb: K5 + K1),
   ``--format dia --spmm 8`` at banded500k (K6) and ``--format dia`` at
   banded2M, each PASS with max rel err 0.0, with the launch counts of
   K5, K6 and K1 over that run;
6. K5 and K1 on the same banded500k matrix and x, in turns with their
   plain versions (the card's own DIA-vs-CSR5 crossover), K6 at R = 8,
   and the device time of each kernel by ``torch.profiler``;
7. kernels K2 (CSR5 SpMM) and K7 (band-block SpMM) against their plain
   versions on the card and against scipy, on the odd shapes of phases 2
   and 4: R in {1, 2, 5, 8, 16, 17}, both layouts, float32 and bfloat16
   planes (K7: "highest" and "default" on float32, "default" on bfloat16),
   alpha = -1.75, exact on integer data; one case of random floats each,
   held to 1e-5 of each row's |A||X|;
8. the SpMM path at full width through the CLI's own code and the API:
   ``--spmm 8`` at banded500k (csr5: K2), ``--format bandblock --spmm 8``
   and ``--spmm 16`` (K7, bfloat16 plane by the gate), ``--format auto
   --spmm 8`` at banded500k (must pick bandblock) and at hybmix400k (must
   pick csr5), and ``hyb_spmm`` at hybmix400k, R = 8 (K6 + K2), each PASS
   with max rel err 0.0 and the kernels' launch counts over that run; then
   spmmf8 (banded500k with decade-spread values, X on [0.5, 1.5]): the
   auto gate must pick a float32 plane and K7 land within 1e-4 of the
   float64 oracle, and a forced bfloat16 plane within 1 %;
9. K2, K6 and K7 at R = 8 on the same banded500k matrix and X, and K7 at
   R = 16, in turns with their plain versions, and their device times by
   ``torch.profiler``: the card's own SpMM crossover.

Exits non-zero, printing no result line, when there is no CUDA device or
any phase fails. The last line of standard output is
``{"ok": true, "device": {...}}``; the line before it lists each kernel.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
#: K1's TPU original, file:line of the kernel function
K1_REPLACES = "benchmark_spmv_using_csr5_tpu/ops/csr5_kernel.py:227"
K1_SOURCE = "benchmark_spmv_using_csr5_tpu_torch/csrc/csr5_spmv.cu"
#: K5's and K6's TPU originals, file:line of the kernel functions
K5_REPLACES = "benchmark_spmv_using_csr5_tpu/ops/dia.py:289"
K6_REPLACES = "benchmark_spmv_using_csr5_tpu/ops/dia.py:500"
DIA_SOURCE = "benchmark_spmv_using_csr5_tpu_torch/csrc/dia_spmv.cu"
#: K2's and K7's TPU originals and sources
K2_REPLACES = "benchmark_spmv_using_csr5_tpu/ops/csr5_kernel.py:227"
K2_SOURCE = "benchmark_spmv_using_csr5_tpu_torch/csrc/csr5_spmm.cu"
K7_REPLACES = "benchmark_spmv_using_csr5_tpu/ops/bandmm.py:243"
K7_SOURCE = "benchmark_spmv_using_csr5_tpu_torch/csrc/bandmm.cu"
#: every CUDA source of the port, built at once in phase 1
SOURCES = ("csr5_spmv", "csr5_spmm", "dia_spmv", "bandmm")
#: right-hand-side counts of the SpMM sweep
SWEEP_RHS = (1, 2, 5, 8, 16, 17)
#: rtol of the random-float case against the row's absolute sum: the
#: kernel and the plain version sum the tile prefix in another order
FLOAT_RTOL = 1e-5


def say(msg: str) -> None:
    print(msg, flush=True)


def sweep_cases(synth, CSR5Config):
    """(name, scipy matrix, config, win_mode) of the odd-shape sweep."""
    cases = []
    for m, tag in ((40, "B1"), (700, "B4"), (1500, "B8")):
        for sig in (8, 16, 24, 32):
            cases.append(
                (f"banded{tag}_s{sig}", synth.banded(m, 9), CSR5Config(sigma=sig), "auto")
            )
    cases += [
        ("alignedB4_s16", synth.banded(700, 9), CSR5Config(sigma=16), "aligned"),
        ("alignedB64_s24", synth.banded(60_000, 27), CSR5Config(sigma=24), "aligned"),
        ("scatband_s16", synth.scattered_band(2000, 12, 1800), CSR5Config(sigma=16), "auto"),
        ("powerlaw_s8", synth.power_law(3000, 3000, 8.0), CSR5Config(sigma=8), "auto"),
        ("fasttrack", synth.single_dense_row(64, 8192), None, "auto"),
        ("fem_small", synth.fem_blocks(6000, neighbors=9, node_bandwidth=600), None, "auto"),
    ]
    for name, make in synth.EDGE_CASE_MATRICES.items():
        cases.append((f"edge_{name}", make(), None, "auto"))
        cases.append((f"edge_{name}_aligned", make(), None, "aligned"))
    return cases


def dia_cases(synth, sp, np, chunk_rows):
    """(name, scipy matrix) of the DIA odd shapes, integer values -4..4."""
    ones = np.ones
    cases = [
        ("dia_tiny", synth.banded(3000, 3)),
        ("m40", synth.banded(40, 9)),
        ("m700", synth.banded(700, 9)),
        ("m1500", synth.banded(1500, 27)),
        ("rect_wide", sp.diags([ones(300)], [40], shape=(300, 400))),
        ("rect_tall_neg", sp.diags([ones(700), ones(700)], [-300, 5], shape=(1000, 705))),
        (
            "far_offset",
            sp.diags([ones(600), ones(600)], [0, chunk_rows + 256], shape=(600, chunk_rows + 1000)),
        ),
    ]
    rng = np.random.default_rng(7)
    out = []
    for name, a in cases:
        a = sp.csr_matrix(a).astype(np.float32)
        a.data = rng.integers(-4, 5, a.nnz).astype(np.float32)
        out.append((name, a))
    return out


def hybmix(synth, sp, np, m):
    """A dense 27-wide band plus 4 scattered ones per row: the JAX bench's
    hybmix400k (``bench/case_runner.py:749-763``) at m rows."""
    band = sp.csr_matrix(synth.banded(m, 27, dtype=np.float32))
    rng = np.random.default_rng(3)
    nnz = m * 4
    noise = sp.csr_matrix(
        (np.ones(nnz, np.float32), (rng.integers(0, m, nnz), rng.integers(0, m, nnz))),
        shape=(m, m),
    )
    return (band + noise).tocsr()


def dia_sweep(dev, rng) -> list:
    """K5 and K6 against their plain versions on the card and scipy on the
    odd shapes; HYB (K5 + K1) on the TPU sweep's hyb_tiny; random floats."""
    import numpy as np
    import scipy.sparse as sp
    import torch

    from benchmark_spmv_using_csr5_tpu_torch import build_dia, build_hyb
    from benchmark_spmv_using_csr5_tpu_torch.ops import dia_kernel
    from benchmark_spmv_using_csr5_tpu_torch.ops.csr5_spmv import csr5_spmv_torch
    from benchmark_spmv_using_csr5_tpu_torch.ops.dia import (
        CHUNK_ROWS, dia_spmm_torch, dia_spmv_torch,
    )
    from benchmark_spmv_using_csr5_tpu_torch.ops.hyb import hyb_spmv
    from benchmark_spmv_using_csr5_tpu_torch.utils import synth

    failed = []
    for name, a in dia_cases(synth, sp, np, CHUNK_ROWS):
        x = rng.integers(1, 10, a.shape[1]).astype(np.float32)
        xm = rng.integers(1, 10, (a.shape[1], 16)).astype(np.float32)
        xd, xmd = torch.from_numpy(x).to(dev), torch.from_numpy(xm).to(dev)
        for layout in ("interleaved", "diag"):
            for vdt in (torch.float32, torch.bfloat16):
                d = build_dia(a, layout=layout, value_dtype=vdt, device=dev)
                tag = f"{name}/{layout}/{str(vdt).removeprefix('torch.')}"
                errs = []
                for alpha in (1.0, -1.75):
                    y_k = dia_kernel.dia_spmv_cuda(d, xd, alpha).cpu()
                    y_p = dia_spmv_torch(d, xd, alpha).cpu()
                    y_s = torch.from_numpy((alpha * (a @ x)).astype(np.float32))
                    if not (torch.equal(y_k, y_p) and torch.equal(y_k, y_s)):
                        errs.append(f"K5 alpha={alpha}")
                for R in (1, 2, 5, 8, 16):
                    y_k = dia_kernel.dia_spmm_cuda(d, xmd[:, :R].contiguous(), -1.75).cpu()
                    y_p = dia_spmm_torch(d, xmd[:, :R], -1.75).cpu()
                    y_s = torch.from_numpy((-1.75 * (a @ xm[:, :R])).astype(np.float32))
                    if not (torch.equal(y_k, y_p) and torch.equal(y_k, y_s)):
                        errs.append(f"K6 R={R}")
                failed += [f"{tag} {e}" for e in errs]
                say(
                    f"[{tag}] {'PASS' if not errs else 'FAIL ' + ','.join(errs)} "
                    f"shape={a.shape} nnz={a.nnz} ndiag={d.ndiag} offsets {d.offsets[0]}..{d.offsets[-1]}"
                )
    # hyb_tiny (scripts/smoke_chip.py:148-161): K5 on the band, K1 on the rest
    band = sp.csr_matrix(synth.banded(4000, 9, dtype=np.float32))
    hrng = np.random.default_rng(3)
    noise = sp.csr_matrix(
        (np.ones(8000, np.float32), (hrng.integers(0, 4000, 8000), hrng.integers(0, 4000, 8000))),
        shape=(4000, 4000),
    )
    a = (band + noise).tocsr()
    h = build_hyb(a, device=dev)
    x = hrng.integers(1, 10, 4000).astype(np.float32)
    xd = torch.from_numpy(x).to(dev)
    for alpha in (1.0, -1.75):
        y_k = hyb_spmv(h, xd, alpha).cpu()
        y_p = (dia_spmv_torch(h.dia, xd, alpha) + csr5_spmv_torch(h.csr5, xd, alpha)).cpu()
        ok = torch.equal(y_k, y_p) and torch.equal(y_k, torch.from_numpy((alpha * (a @ x)).astype(np.float32)))
        failed += [] if ok else [f"hyb_tiny alpha={alpha}"]
        say(
            f"[hyb_tiny alpha={alpha}] {'PASS' if ok else 'FAIL'} {h.dia.ndiag} diagonals "
            f"+ {h.csr5.nnz} csr5 nnz"
        )
    # random floats: K5 and K6 sum in the plain version's order, so they
    # should agree bit for bit; scipy in float64 within the stated rtol
    a = sp.csr_matrix(synth.banded(20_000, 27)).astype(np.float32)
    a.data = rng.uniform(-1, 1, a.nnz).astype(np.float32)
    xm = rng.uniform(-1, 1, (a.shape[1], 5)).astype(np.float32)
    d = build_dia(a, device=dev)
    xmd = torch.from_numpy(xm).to(dev)
    y_k = torch.cat([dia_kernel.dia_spmv_cuda(d, xmd[:, 0].contiguous())[:, None],
                     dia_kernel.dia_spmm_cuda(d, xmd)], dim=1).double().cpu()
    y_p = torch.cat([dia_spmv_torch(d, xmd[:, 0])[:, None], dia_spmm_torch(d, xmd)], dim=1).double().cpu()
    xm6 = np.concatenate([xm[:, :1], xm], axis=1).astype(np.float64)
    y64 = torch.from_numpy(a.astype(np.float64) @ xm6)
    row_abs = torch.from_numpy(abs(a).astype(np.float64) @ np.abs(xm6))
    lim = FLOAT_RTOL * row_abs + 1e-30
    ok = bool(((y_k - y_p).abs() <= lim).all() and ((y_k - y64).abs() <= lim).all())
    failed += [] if ok else ["dia random_floats"]
    say(
        f"[dia random_floats rtol={FLOAT_RTOL} of row |A||x|] {'PASS' if ok else 'FAIL'} "
        f"bit-equal to plain: {torch.equal(y_k, y_p)} "
        f"max|k-f64|/rowabs={float(((y_k - y64).abs() / row_abs).max()):.3g}"
    )
    return failed


def format_path(dev, failed):
    """The structural-format path at full width through the CLI's own
    code, with every kernel count set to 0 just before and read just
    after. Returns (results by name, launches, max |kernel - plain|)."""
    import numpy as np
    import torch

    from benchmark_spmv_using_csr5_tpu_torch.bench import cli
    from benchmark_spmv_using_csr5_tpu_torch.ops import csr5_kernel, dia_kernel
    from benchmark_spmv_using_csr5_tpu_torch.ops.csr5_spmv import csr5_spmv_torch
    from benchmark_spmv_using_csr5_tpu_torch.ops.dia import dia_spmm_torch, dia_spmv_torch
    from benchmark_spmv_using_csr5_tpu_torch.utils import synth
    import scipy.sparse as sp

    tri = synth.banded(500_000, 3, dtype=np.float32)
    mix = hybmix(synth, sp, np, 400_000)
    runs = [  # name, format it must run, how
        ("auto_banded500k", "dia", lambda: cli.run(["--synthetic", "banded:500000:27", "--format", "auto"])),
        ("dia_tridiag500k", "dia", lambda: cli.run_matrix(
            cli.parse_args(["--format", "dia"]), "dia_tridiag500k",
            tri.indptr, tri.indices, tri.data, tri.shape)),
        ("hybmix400k", "hyb", lambda: cli.run_matrix(
            cli.parse_args(["--format", "auto"]), "hybmix400k",
            mix.indptr, mix.indices, mix.data, mix.shape)),
        ("dia_spmm8", "dia", lambda: cli.run(
            ["--synthetic", "banded:500000:27", "--format", "dia", "--spmm", "8"])),
        ("dia_banded2M", "dia", lambda: cli.run(["--synthetic", "banded:2000000:27", "--format", "dia"])),
    ]
    csr5_kernel.launches = 0
    dia_kernel.spmv_launches = dia_kernel.spmm_launches = 0
    results = {}
    for name, want, go in runs:
        results[name] = go()
    torch.cuda.synchronize()
    launches = {
        "csr5_spmv": csr5_kernel.launches,
        "dia_spmv": dia_kernel.spmv_launches,
        "dia_spmm": dia_kernel.spmm_launches,
    }
    err = {"csr5_spmv": 0.0, "dia_spmv": 0.0, "dia_spmm": 0.0}
    for name, want, _ in runs:
        r = results[name]
        say(r.report())
        good = (
            r.check_ok
            and r.max_rel_err == 0.0
            and r.backend == "cuda"
            and r.format == want
            and tuple(r.y.shape) == ((r.m,) if r.num_rhs == 1 else (r.m, r.num_rhs))
            and bool(torch.isfinite(r.y).all())
        )
        if name == "hybmix400k":
            good = good and r.launches["dia_spmv"] > 0 and r.launches["csr5_spmv"] > 0
        if not good:
            failed.append(name)
        # the kernels' y from the run against the plain versions, same x
        R = r.num_rhs
        x = np.random.default_rng(0).integers(1, 10, (r.n, R) if R > 1 else r.n)
        xd = torch.from_numpy(x.astype(np.float32)).to(dev)
        if r.format == "hyb":
            h = r.matrix
            y_p = dia_spmv_torch(h.dia, xd) + csr5_spmv_torch(h.csr5, xd)
            key = "dia_spmv"
            err["csr5_spmv"] = max(err["csr5_spmv"], float((r.y - y_p).abs().max()))
        elif R > 1:
            y_p, key = dia_spmm_torch(r.matrix, xd), "dia_spmm"
        else:
            y_p, key = dia_spmv_torch(r.matrix, xd), "dia_spmv"
        e = float((r.y - y_p).abs().max())
        err[key] = max(err[key], e)
        exact = torch.equal(r.y, y_p)
        say(f"[{name}] kernel y vs plain on the card: max abs err {e} {'PASS' if exact else 'FAIL'}")
        if not exact:
            failed.append(f"{name} vs plain")
    say(f"format path launches: K5 {launches['dia_spmv']}, K6 {launches['dia_spmm']}, "
        f"K1 {launches['csr5_spmv']}")
    for k, v in launches.items():
        if v == 0:
            failed.append(f"no {k} launch on the format path")
    return results, launches, err


def device_us(fn, *args, match: str, n: int = 50):
    """Mean device time (us) per launch of the kernels whose name holds
    ``match``, by torch.profiler over ``n`` calls; None when the profiler
    shows no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(5):
        fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn(*args)
        torch.cuda.synchronize()
    total, count = 0.0, 0
    for ev in prof.key_averages():
        if match in ev.key:
            total += ev.device_time_total
            count += ev.count
    return total / count if count and total else None


def crossover(dev, card, kind, a5, auto_res, spmm_res, x):
    """K5 and K1 (with their plain versions) on the same banded500k
    matrix and x, in turns; K6 at R = 8 likewise; device times."""
    import dataclasses

    import torch

    from benchmark_spmv_using_csr5_tpu_torch.ops import csr5_kernel, dia_kernel
    from benchmark_spmv_using_csr5_tpu_torch.ops.csr5_spmv import csr5_spmv_torch
    from benchmark_spmv_using_csr5_tpu_torch.ops.dia import dia_spmm_torch, dia_spmv_torch
    from benchmark_spmv_using_csr5_tpu_torch.utils import perf

    d32 = auto_res.matrix
    # the same plane in bfloat16 (lossless on these integer values), the
    # storage K1 streams at banded500k
    d16 = dataclasses.replace(d32, data=d32.data.to(torch.bfloat16))
    if not torch.equal(d16.data.float(), d32.data):
        raise RuntimeError("banded500k's DIA plane is not lossless in bfloat16")
    fns = {
        "k1_plain": (csr5_spmv_torch, a5),
        "k1": (csr5_kernel.csr5_spmv_cuda, a5),
        "k5": (dia_kernel.dia_spmv_cuda, d32),
        "k5_plain": (dia_spmv_torch, d32),
        "k5_bf16": (dia_kernel.dia_spmv_cuda, d16),
    }
    times = {k: [] for k in fns}
    for k in ("k1_plain", "k1", "k5", "k5_bf16", "k5_plain",
              "k5_plain", "k5_bf16", "k5", "k1", "k1_plain"):
        fn, mat = fns[k]
        times[k].append(perf.benchmark(fn, mat, x, device=dev, num_run=100))
    xm = torch.randint(1, 10, (spmm_res.n, 8), dtype=torch.float32, device=dev,
                       generator=torch.Generator(dev).manual_seed(0))
    for k, fn in (("k6", dia_kernel.dia_spmm_cuda), ("k6_plain", dia_spmm_torch),
                  ("k6_plain", dia_spmm_torch), ("k6", dia_kernel.dia_spmm_cuda)):
        times.setdefault(k, []).append(perf.benchmark(fn, spmm_res.matrix, xm, device=dev, num_run=100))
    t = {k: sum(v) / len(v) for k, v in times.items()}
    dev_us = {
        "k1": device_us(csr5_kernel.csr5_spmv_cuda, a5, x, match="csr5_spmv_tile_kernel"),
        "k5": device_us(dia_kernel.dia_spmv_cuda, d32, x, match="dia_spmv_kernel"),
        "k5_bf16": device_us(dia_kernel.dia_spmv_cuda, d16, x, match="dia_spmv_kernel"),
        "k6": device_us(dia_kernel.dia_spmm_cuda, spmm_res.matrix, xm, match="dia_spmm_kernel"),
    }
    plane_mb = d32.data.numel() * d32.data.element_size() / 1e6
    say(f"[banded500k crossover, {card}] turns (ms per call, event loop of 100): "
        + ", ".join(f"{k} {v}" for k, v in times.items()))
    say(
        f"[banded500k crossover] K1 (CSR5, {str(a5.val_tiles.dtype).removeprefix('torch.')} values) "
        f"{t['k1']:.5f} ms vs K5 (DIA, {str(d32.data.dtype).removeprefix('torch.')} plane of "
        f"{plane_mb:.1f} MB, {d32.ndiag} diagonals) {t['k5']:.5f} ms: K1/K5 = {t['k1'] / t['k5']:.3f}; "
        f"K5 with the bfloat16 plane {t['k5_bf16']:.5f} ms; "
        f"plain K1 {t['k1_plain']:.4f} ms, plain K5 {t['k5_plain']:.4f} ms; "
        f"K6 R=8 {t['k6']:.5f} ms, plain {t['k6_plain']:.4f} ms [{card}]"
    )
    say("[banded500k device time by torch.profiler, us per launch] " + ", ".join(
        f"{k} {'not measured' if v is None else f'{v:.2f}'}" for k, v in dev_us.items()))
    return t


def _exact(y_k, y_p, y_s) -> bool:
    """Kernel, plain version and scipy agree bit for bit (and in shape)."""
    import torch

    return torch.equal(y_k, y_p) and torch.equal(y_k, y_s)


def _both_layouts(fn, mat, xd, alpha, **kw):
    """Y (m, R) from ``fn`` in layout "nr" and from layout "rn" (X^T in,
    Y^T out, transposed back), on the host."""
    y_nr = fn(mat, xd, alpha, **kw).cpu()
    y_rn = fn(mat, xd.T.contiguous(), alpha, layout="rn", **kw).cpu().T
    return y_nr, y_rn


def spmm_sweep(dev, rng) -> list:
    """K2 and K7 against their plain versions on the card and scipy on
    the odd shapes of phases 2 and 4, every R of SWEEP_RHS, both layouts,
    both planes, alpha = -1.75; one random-float case each."""
    import numpy as np
    import scipy.sparse as sp
    import torch

    from benchmark_spmv_using_csr5_tpu_torch import CSR5Config, build_bandblock, build_csr5
    from benchmark_spmv_using_csr5_tpu_torch.ops import bandmm_kernel, csr5_kernel
    from benchmark_spmv_using_csr5_tpu_torch.ops.bandmm import bandmm_spmm_torch
    from benchmark_spmv_using_csr5_tpu_torch.ops.csr5_spmv import csr5_spmm_torch
    from benchmark_spmv_using_csr5_tpu_torch.ops.dia import CHUNK_ROWS
    from benchmark_spmv_using_csr5_tpu_torch.utils import synth

    alpha = -1.75
    rmax = max(SWEEP_RHS)
    failed = []
    # K2 on phase 2's shapes
    for name, a_sp, cfg, win_mode in sweep_cases(synth, CSR5Config):
        a = sp.csr_matrix(a_sp).astype(np.float32)
        xm = rng.integers(1, 10, (a.shape[1], rmax)).astype(np.float32)
        xmd = torch.from_numpy(xm).to(dev)
        for vdt in (torch.float32, torch.bfloat16):
            a5 = build_csr5((a.indptr, a.indices, a.data, a.shape), cfg, value_dtype=vdt,
                            win_mode=win_mode, device=dev)
            errs = []
            for R in SWEEP_RHS:
                xr = xmd[:, :R].contiguous()
                y_nr, y_rn = _both_layouts(csr5_kernel.csr5_spmm_cuda, a5, xr, alpha)
                y_p = csr5_spmm_torch(a5, xr, alpha).cpu()
                y_s = torch.from_numpy((alpha * (a @ xm[:, :R])).astype(np.float32))
                if not (_exact(y_nr, y_p, y_s) and torch.equal(y_rn, y_s)):
                    errs.append(f"R={R}")
            tag = f"K2 {name}/{str(vdt).removeprefix('torch.')}"
            failed += [f"{tag} {e}" for e in errs]
            say(f"[{tag}] {'PASS' if not errs else 'FAIL ' + ','.join(errs)} R {SWEEP_RHS} "
                f"nr+rn sigma={a5.sigma} capw={a5.capw} chunk(8)={csr5_kernel.spmm_chunk(a5, 8)}")
    # K7 on phase 4's shapes and the band-block test shapes
    bb_cases = list(dia_cases(synth, sp, np, CHUNK_ROWS))
    rows = np.arange(300)
    bb_cases += [
        ("bb_banded3000", sp.csr_matrix(synth.banded(3000, 27)).astype(np.float32)),
        ("bb_ragged1000", sp.csr_matrix(synth.banded(1000, 5)).astype(np.float32)),
        ("bb_confined", sp.csr_matrix(
            (rng.integers(1, 10, 300).astype(np.float32), (rows, rows % 50)), shape=(300, 10_000))),
    ]
    for name, a in bb_cases:
        xm = rng.integers(1, 10, (a.shape[1], rmax)).astype(np.float32)
        xmd = torch.from_numpy(xm).to(dev)
        for vdt, precs in ((torch.float32, ("highest", "default")), (torch.bfloat16, ("default",))):
            bb = build_bandblock(a, max_bytes_ratio=1000.0, value_dtype=vdt, device=dev)
            tag = f"K7 {name}/{str(vdt).removeprefix('torch.')}"
            if bb is None:
                say(f"[{tag}] gate: no bounded windows (build_bandblock -> None), not a K7 case")
                continue
            errs = []
            for prec in precs:
                for R in SWEEP_RHS:
                    xr = xmd[:, :R].contiguous()
                    y_nr, y_rn = _both_layouts(bandmm_kernel.bandmm_spmm_cuda, bb, xr, alpha,
                                               precision=prec)
                    y_p = bandmm_spmm_torch(bb, xr, alpha, prec).cpu()
                    y_s = torch.from_numpy((alpha * (a @ xm[:, :R])).astype(np.float32))
                    if not (_exact(y_nr, y_p, y_s) and torch.equal(y_rn, y_s)):
                        errs.append(f"{prec} R={R}")
            failed += [f"{tag} {e}" for e in errs]
            say(f"[{tag}] {'PASS' if not errs else 'FAIL ' + ','.join(errs)} {'/'.join(precs)} "
                f"R {SWEEP_RHS} nr+rn K={bb.K} blocks={bb.num_blocks} nx_pad={bb.nx_pad} n={a.shape[1]}")
    # random floats: K2 sums in K1's order, K7 in another than the plain bmm
    a = sp.csr_matrix(synth.banded(20_000, 27)).astype(np.float32)
    a.data = rng.uniform(-1, 1, a.nnz).astype(np.float32)
    xm = rng.uniform(-1, 1, (a.shape[1], 5)).astype(np.float32)
    xmd = torch.from_numpy(xm).to(dev)
    y64 = torch.from_numpy(a.astype(np.float64) @ xm.astype(np.float64))
    row_abs = torch.from_numpy(abs(a).astype(np.float64) @ np.abs(xm).astype(np.float64))
    lim = FLOAT_RTOL * row_abs + 1e-30
    a5 = build_csr5(a, device=dev)
    bb = build_bandblock(a, device=dev)  # the bfloat16 gate keeps these floats in float32
    runs = {
        "K2": (csr5_kernel.csr5_spmm_cuda(a5, xmd), csr5_spmm_torch(a5, xmd)),
        "K7": (bandmm_kernel.bandmm_spmm_cuda(bb, xmd), bandmm_spmm_torch(bb, xmd)),
    }
    for k, (y_k, y_p) in runs.items():
        y_k, y_p = y_k.double().cpu(), y_p.double().cpu()
        ok = bool(((y_k - y_p).abs() <= lim).all() and ((y_k - y64).abs() <= lim).all())
        if k == "K7":
            ok = ok and bb.dtype == torch.float32
        failed += [] if ok else [f"{k} random_floats"]
        say(f"[{k} random_floats rtol={FLOAT_RTOL} of row |A||X|] {'PASS' if ok else 'FAIL'} "
            f"max|k-plain|/rowabs={float(((y_k - y_p).abs() / row_abs).max()):.3g} "
            f"max|k-f64|/rowabs={float(((y_k - y64).abs() / row_abs).max()):.3g}")
    y1 = torch.stack([csr5_kernel.csr5_spmv_cuda(a5, xmd[:, r].contiguous()) for r in range(5)], 1)
    say(f"[K2 random_floats] columns bit-equal to K1 on each X[:, r]: "
        f"{torch.equal(y1, runs['K2'][0])}")
    return failed


def spmmf8(dev, failed) -> dict:
    """The JAX bench's spmmf8_banded500k (``case_runner.py:485-561``):
    decade-spread float values, X^T on [0.5, 1.5], layout "rn", against
    the float64 oracle."""
    import numpy as np
    import scipy.sparse as sp
    import torch

    from benchmark_spmv_using_csr5_tpu_torch import bandmm_spmm, build_bandblock
    from benchmark_spmv_using_csr5_tpu_torch.bench.harness import rel_err
    from benchmark_spmv_using_csr5_tpu_torch.ops import bandmm
    from benchmark_spmv_using_csr5_tpu_torch.utils import synth

    m, R = 500_000, 8
    a = sp.csr_matrix(synth.banded(m, 27, dtype=np.float32))
    rng = np.random.default_rng(7)
    a.data = (rng.uniform(0.1, 1.0, a.nnz) * 10.0 ** rng.integers(-1, 2, a.nnz)).astype(np.float32)
    xt = rng.uniform(0.5, 1.5, (R, m)).astype(np.float32)
    y_ref_t = (a.astype(np.float64) @ xt.T.astype(np.float64)).T
    xtd = torch.from_numpy(xt).to(dev)
    out = {}
    t0 = time.perf_counter()
    bb = build_bandblock(a, device=dev)
    out["build_ms"] = (time.perf_counter() - t0) * 1e3
    out["phases"] = dict(bandmm.last_build_phases)
    out["auto_dtype"] = str(bb.dtype).removeprefix("torch.")
    out["rel"] = rel_err(bandmm_spmm(bb, xtd, layout="rn"), y_ref_t)
    del bb
    bb16 = build_bandblock(a, value_dtype=torch.bfloat16, device=dev)
    out["rel_bf16"] = rel_err(bandmm_spmm(bb16, xtd, layout="rn", precision="default"), y_ref_t)
    ok_auto = out["auto_dtype"] == "float32" and out["rel"] <= 1e-4
    ok16 = out["rel_bf16"] <= 0.01
    failed += ([] if ok_auto else ["spmmf8 auto"]) + ([] if ok16 else ["spmmf8 bf16"])
    say(f"[spmmf8_banded500k] auto gate -> {out['auto_dtype']} plane + highest: max rel err "
        f"{out['rel']:.3e} vs float64 (limit 1e-4) {'PASS' if ok_auto else 'FAIL'}; forced "
        f"bfloat16 plane: {out['rel_bf16']:.3e} (limit 1e-2) {'PASS' if ok16 else 'FAIL'}; "
        f"build {out['build_ms']:.1f} ms ({out['phases']})")
    return out


def spmm_path(dev, failed, mix_hyb):
    """The SpMM path at full width through the CLI's own code and the
    API, with every kernel count set to 0 just before and read just
    after. Returns (results by name, launches, max |kernel - plain|)."""
    import numpy as np
    import scipy.sparse as sp
    import torch

    from benchmark_spmv_using_csr5_tpu_torch import hyb_spmm
    from benchmark_spmv_using_csr5_tpu_torch.bench import cli, harness
    from benchmark_spmv_using_csr5_tpu_torch.ops import bandmm_kernel, csr5_kernel, dia_kernel
    from benchmark_spmv_using_csr5_tpu_torch.ops.bandmm import bandmm_spmm_torch
    from benchmark_spmv_using_csr5_tpu_torch.ops.csr5_spmv import csr5_spmm_torch
    from benchmark_spmv_using_csr5_tpu_torch.ops.dia import dia_spmm_torch
    from benchmark_spmv_using_csr5_tpu_torch.utils import synth

    mix = hybmix(synth, sp, np, 400_000)
    band = ["--synthetic", "banded:500000:27"]
    runs = [  # name, format it must run, how
        ("spmm8_banded500k", "csr5", lambda: cli.run(band + ["--spmm", "8"])),
        ("bandblock_spmm8", "bandblock", lambda: cli.run(band + ["--format", "bandblock", "--spmm", "8"])),
        ("bandblock_spmm16", "bandblock", lambda: cli.run(band + ["--format", "bandblock", "--spmm", "16"])),
        ("auto_spmm8_banded500k", "bandblock", lambda: cli.run(band + ["--format", "auto", "--spmm", "8"])),
        ("auto_spmm8_hybmix400k", "csr5", lambda: cli.run_matrix(
            cli.parse_args(["--format", "auto", "--spmm", "8"]), "hybmix400k",
            mix.indptr, mix.indices, mix.data, mix.shape)),
    ]
    x_mix = torch.from_numpy(
        np.random.default_rng(0).integers(1, 10, (mix.shape[1], 8)).astype(np.float32)).to(dev)
    y_mix_ref = mix @ x_mix.cpu().numpy()
    keys = ("csr5_spmm", "dia_spmm", "bandmm_spmm")
    csr5_kernel.spmm_launches = dia_kernel.spmm_launches = bandmm_kernel.launches = 0
    results = {name: go() for name, _, go in runs}
    y_hyb = hyb_spmm(mix_hyb, x_mix)
    torch.cuda.synchronize()
    launches = {"csr5_spmm": csr5_kernel.spmm_launches, "dia_spmm": dia_kernel.spmm_launches,
                "bandmm_spmm": bandmm_kernel.launches}
    err = {k: 0.0 for k in keys}
    for name, want, _ in runs:
        r = results[name]
        say(r.report())
        good = (
            r.check_ok and r.max_rel_err == 0.0 and r.backend == "cuda" and r.format == want
            and tuple(r.y.shape) == (r.m, r.num_rhs) and bool(torch.isfinite(r.y).all())
        )
        if name.startswith("bandblock") or name.startswith("auto_spmm8_banded"):
            good = good and r.storage == "bfloat16"
        if not good:
            failed.append(name)
        x = np.random.default_rng(0).integers(1, 10, (r.n, r.num_rhs))
        xd = torch.from_numpy(x.astype(np.float32)).to(dev)
        if r.format == "bandblock":
            y_p, key = bandmm_spmm_torch(r.matrix, xd), "bandmm_spmm"
        else:
            y_p, key = csr5_spmm_torch(r.matrix, xd), "csr5_spmm"
        e = float((r.y - y_p).abs().max())
        err[key] = max(err[key], e)
        exact = torch.equal(r.y, y_p)
        say(f"[{name}] kernel Y vs plain on the card: max abs err {e} {'PASS' if exact else 'FAIL'}")
        if not exact:
            failed.append(f"{name} vs plain")
    rel = harness.rel_err(y_hyb, y_mix_ref)
    y_p = dia_spmm_torch(mix_hyb.dia, x_mix) + csr5_spmm_torch(mix_hyb.csr5, x_mix)
    e = float((y_hyb - y_p).abs().max())
    err["csr5_spmm"] = max(err["csr5_spmm"], e)
    err["dia_spmm"] = max(err["dia_spmm"], e)
    ok = rel == 0.0 and torch.equal(y_hyb, y_p) and tuple(y_hyb.shape) == (mix.shape[0], 8)
    failed += [] if ok else ["hyb_spmm hybmix400k"]
    say(f"[hyb_spmm hybmix400k R=8, API] {'PASS' if ok else 'FAIL'} max rel err {rel} vs scipy, "
        f"max abs err vs plain (K6 + K2 plain) {e}; {mix_hyb.dia.ndiag} diagonals + "
        f"{mix_hyb.csr5.nnz} csr5 nnz")
    say(f"SpMM path launches: K2 {launches['csr5_spmm']}, K6 {launches['dia_spmm']}, "
        f"K7 {launches['bandmm_spmm']}")
    for k, v in launches.items():
        if v == 0:
            failed.append(f"no {k} launch on the SpMM path")
    return results, launches, err


def spmm_crossover(dev, card, a5, dia, bb):
    """K2, K6 and K7 at R = 8 on the same banded500k matrix and X, K7 at
    R = 16, in turns with their plain versions; device times."""
    import torch

    from benchmark_spmv_using_csr5_tpu_torch.ops import bandmm_kernel, csr5_kernel, dia_kernel
    from benchmark_spmv_using_csr5_tpu_torch.ops.bandmm import bandmm_spmm_torch
    from benchmark_spmv_using_csr5_tpu_torch.ops.csr5_spmv import csr5_spmm_torch
    from benchmark_spmv_using_csr5_tpu_torch.ops.dia import dia_spmm_torch
    from benchmark_spmv_using_csr5_tpu_torch.utils import perf

    gen = torch.Generator(dev).manual_seed(0)
    x8 = torch.randint(1, 10, (a5.n, 8), dtype=torch.float32, device=dev, generator=gen)
    x16 = torch.randint(1, 10, (a5.n, 16), dtype=torch.float32, device=dev, generator=gen)
    fns = {
        "k2": (csr5_kernel.csr5_spmm_cuda, a5, x8, 100),
        "k2_plain": (csr5_spmm_torch, a5, x8, 5),
        "k6": (dia_kernel.dia_spmm_cuda, dia, x8, 100),
        "k6_plain": (dia_spmm_torch, dia, x8, 20),
        "k7": (bandmm_kernel.bandmm_spmm_cuda, bb, x8, 100),
        "k7_plain": (bandmm_spmm_torch, bb, x8, 10),
        "k7_r16": (bandmm_kernel.bandmm_spmm_cuda, bb, x16, 100),
        "k7_r16_plain": (bandmm_spmm_torch, bb, x16, 10),
    }
    order = ["k2_plain", "k2", "k6", "k6_plain", "k7", "k7_plain", "k7_r16", "k7_r16_plain"]
    times = {k: [] for k in fns}
    for k in order + order[::-1]:
        fn, mat, x, n = fns[k]
        times[k].append(perf.benchmark(fn, mat, x, device=dev, warmup=3, num_run=n))
    t = {k: sum(v) / len(v) for k, v in times.items()}
    dev_us = {
        "k2": device_us(csr5_kernel.csr5_spmm_cuda, a5, x8, match="csr5_spmm_tile_kernel"),
        "k6": device_us(dia_kernel.dia_spmm_cuda, dia, x8, match="dia_spmm_kernel"),
        "k7": device_us(bandmm_kernel.bandmm_spmm_cuda, bb, x8, match="bandmm_kernel"),
        "k7_r16": device_us(bandmm_kernel.bandmm_spmm_cuda, bb, x16, match="bandmm_kernel"),
    }
    mb = {
        "k2": (a5.col_idx_tiles.numel() * 4 + a5.val_tiles.numel() * a5.val_tiles.element_size()) / 1e6,
        "k6": dia.data.numel() * dia.data.element_size() / 1e6,
        "k7": bb.dense_bytes / 1e6,
    }
    say(f"[banded500k SpMM crossover, {card}] turns (ms per call, event loop): "
        + ", ".join(f"{k} {v}" for k, v in times.items()))
    say(f"[banded500k SpMM crossover] R=8: K2 (CSR5, {mb['k2']:.1f} MB cols+vals) {t['k2']:.5f} ms, "
        f"K6 (DIA, {mb['k6']:.1f} MB plane) {t['k6']:.5f} ms, K7 (band-block, "
        f"{str(bb.dtype).removeprefix('torch.')} plane of {mb['k7']:.1f} MB, K={bb.K}) "
        f"{t['k7']:.5f} ms; R=16: K7 {t['k7_r16']:.5f} ms; plain K2 {t['k2_plain']:.4f}, "
        f"K6 {t['k6_plain']:.4f}, K7 {t['k7_plain']:.4f} (R=16 {t['k7_r16_plain']:.4f}) ms; "
        f"X and Y 16.0 MB each at R=8 [{card}]")
    say("[banded500k SpMM device time by torch.profiler, us per launch] " + ", ".join(
        f"{k} {'not measured' if v is None else f'{v:.2f}'}" for k, v in dev_us.items()))
    return t


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1

    import numpy as np
    import scipy.sparse as sp

    from benchmark_spmv_using_csr5_tpu_torch import CSR5Config, build_csr5
    from benchmark_spmv_using_csr5_tpu_torch.bench import cli
    from benchmark_spmv_using_csr5_tpu_torch.ops import bandmm_kernel, csr5_kernel, dia_kernel
    from benchmark_spmv_using_csr5_tpu_torch.ops.csr5_spmv import csr5_spmv_torch
    from benchmark_spmv_using_csr5_tpu_torch.utils import cuda_build, perf, synth

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    kind = torch.cuda.get_device_name(0)

    # --- 1. the card and the build -----------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    card = smi[0].strip()
    say(card)
    say(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device {kind}")
    t0 = time.perf_counter()
    cuda_build.build(SOURCES)
    csr5_kernel._lib()
    csr5_kernel._lib_spmm()
    dia_kernel._lib()
    bandmm_kernel._lib()
    say(
        "build: " + ", ".join(f"{k}.cu {cuda_build.build_seconds[k]:.1f} s" for k in SOURCES)
        + f" with nvcc, in parallel (load {time.perf_counter() - t0:.1f} s)"
    )

    # --- 2. kernel vs plain vs scipy on the odd shapes ------------------------
    failed = []
    rng = np.random.default_rng(0)
    for name, a_sp, cfg, win_mode in sweep_cases(synth, CSR5Config):
        a = sp.csr_matrix(a_sp).astype(np.float32)
        x = rng.integers(1, 10, a.shape[1]).astype(np.float32)
        y_ref = torch.from_numpy(a @ x)
        xd = torch.from_numpy(x).to(dev)
        for vdt in (torch.float32, torch.bfloat16):
            a5 = build_csr5(
                (a.indptr, a.indices, a.data, a.shape), cfg,
                value_dtype=vdt, win_mode=win_mode, device=dev,
            )
            y_k = csr5_kernel.csr5_spmv_cuda(a5, xd).cpu()
            y_p = csr5_spmv_torch(a5, xd).cpu()
            ok = torch.equal(y_k, y_p) and torch.equal(y_k, y_ref)
            tag = f"{name}/{str(vdt).removeprefix('torch.')}"
            if not ok:
                failed.append(tag)
            say(
                f"[{tag}] {'PASS' if ok else 'FAIL'} m={a.shape[0]} nnz={a.nnz} "
                f"sigma={a5.sigma} tiles={a5.num_tiles} capw={a5.capw} "
                f"win={'wrapped' if a5.win_rel else 'aligned'} "
                f"max|k-plain|={float((y_k - y_p).abs().max()):.3g} "
                f"max|k-scipy|={float((y_k - y_ref).abs().max()):.3g}"
            )
    # alpha, folded into x by the wrapper and applied to y by the plain version
    a = sp.csr_matrix(synth.banded(1500, 9)).astype(np.float32)
    x = rng.integers(1, 10, a.shape[1]).astype(np.float32)
    a5 = build_csr5((a.indptr, a.indices, a.data, a.shape), device=dev)
    xd = torch.from_numpy(x).to(dev)
    y_k = csr5_kernel.csr5_spmv_cuda(a5, xd, alpha=-1.75).cpu()
    ok = torch.equal(y_k, csr5_spmv_torch(a5, xd, alpha=-1.75).cpu()) and torch.equal(
        y_k, torch.from_numpy(-1.75 * (a @ x))
    )
    failed += [] if ok else ["alpha"]
    say(f"[alpha=-1.75] {'PASS' if ok else 'FAIL'}")
    # random floats: order of summation differs, so a tolerance
    a = sp.csr_matrix(synth.banded(20_000, 27)).astype(np.float32)
    a.data = rng.uniform(-1, 1, a.nnz).astype(np.float32)
    x = rng.uniform(-1, 1, a.shape[1]).astype(np.float32)
    a5 = build_csr5((a.indptr, a.indices, a.data, a.shape), device=dev)
    xd = torch.from_numpy(x).to(dev)
    y_k = csr5_kernel.csr5_spmv_cuda(a5, xd).double().cpu()
    y_p = csr5_spmv_torch(a5, xd).double().cpu()
    y64 = torch.from_numpy(a.astype(np.float64) @ x.astype(np.float64))
    row_abs = torch.from_numpy(abs(a).astype(np.float64) @ np.abs(x).astype(np.float64))
    lim = FLOAT_RTOL * row_abs + 1e-30
    ok = bool(((y_k - y_p).abs() <= lim).all() and ((y_k - y64).abs() <= lim).all())
    failed += [] if ok else ["random_floats"]
    say(
        f"[random_floats rtol={FLOAT_RTOL} of row |A||x|] {'PASS' if ok else 'FAIL'} "
        f"max|k-plain|/rowabs={float(((y_k - y_p).abs() / row_abs).max()):.3g} "
        f"max|k-f64|/rowabs={float(((y_k - y64).abs() / row_abs).max()):.3g}"
    )
    if failed:
        print(f"chip_smoke: kernel sweep failed: {failed}", file=sys.stderr)
        return 1

    # --- 3. the main path through the CLI and the harness ----------------------
    csr5_kernel.launches = 0
    results = [
        cli.run([os.path.join(ROOT, "example.mtx")]),
        cli.run(["--synthetic", "banded:500000:27"]),
    ]
    torch.cuda.synchronize()
    launches = csr5_kernel.launches
    for r in results:
        say(r.report())
        good = (
            r.check_ok
            and r.max_rel_err == 0.0
            and r.backend == "cuda"
            and tuple(r.y.shape) == (r.m,)
            and bool(torch.isfinite(r.y).all())
        )
        if not good:
            failed.append(r.name)
    say(f"K1 launches on the main path: {launches}")
    if launches == 0:
        failed.append("no K1 launch on the main path")

    # K1 and its plain version at the main path's shapes, same inputs
    max_abs = 0.0
    xs = {}
    for r in results:
        x = np.random.default_rng(0).integers(1, 10, size=r.n).astype(np.float32)
        xd = xs[r.name] = torch.from_numpy(x).to(dev)
        y_k = csr5_kernel.csr5_spmv_cuda(r.matrix, xd)
        y_p = csr5_spmv_torch(r.matrix, xd)
        err = float((y_k - y_p).abs().max())
        max_abs = max(max_abs, err)
        exact = torch.equal(y_k, y_p) and torch.equal(y_k, r.y)
        say(f"[{r.name}] K1 vs plain on the card: max abs err {err} {'PASS' if exact else 'FAIL'}")
        if not exact:
            failed.append(f"{r.name} K1 vs plain")
    big = results[1]
    times = {"plain": [], "cuda": []}
    for which in ("plain", "cuda", "cuda", "plain"):
        fn = csr5_spmv_torch if which == "plain" else csr5_kernel.csr5_spmv_cuda
        times[which].append(
            perf.benchmark(fn, big.matrix, xs[big.name], device=dev, num_run=50)
        )
    k_ms = sum(times["cuda"]) / 2
    p_ms = sum(times["plain"]) / 2
    met = perf.spmv_metrics(big.m, big.nnz, k_ms, 4, roofline_gbps=perf.device_hbm_gbps(kind))
    say(
        f"[{big.name}] K1 {k_ms:.4f} ms ({times['cuda']}), {met.gbps:.2f} GB/s, "
        f"{met.gflops:.2f} GFlops, {met.pct_of_roofline:.1f}% of {met.roofline_gbps:.0f} GB/s; "
        f"plain torch {p_ms:.4f} ms ({times['plain']}); "
        f"storage {big.storage}, peak mem {torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
        f"[{card}]"
    )
    if failed:
        print(f"chip_smoke: main path failed: {failed}", file=sys.stderr)
        return 1

    # --- 4. K5 and K6 vs plain vs scipy on the odd shapes ----------------------
    failed += dia_sweep(dev, rng)
    if failed:
        print(f"chip_smoke: DIA kernel sweep failed: {failed}", file=sys.stderr)
        return 1

    # --- 5. the format path at full width, through the CLI's own code ---------
    fmt, fmt_launches, fmt_err = format_path(dev, failed)
    if failed:
        print(f"chip_smoke: format path failed: {failed}", file=sys.stderr)
        return 1

    # --- 6. K5 vs K1 at banded500k, K6 at R = 8, device times ------------------
    t = crossover(dev, card, kind, big.matrix, fmt["auto_banded500k"], fmt["dia_spmm8"],
                  xs[big.name])

    # --- 7. K2 and K7 vs plain vs scipy on the odd shapes ----------------------
    failed += spmm_sweep(dev, rng)
    if failed:
        print(f"chip_smoke: SpMM kernel sweep failed: {failed}", file=sys.stderr)
        return 1

    # --- 8. the SpMM path at full width, through the CLI and the API -----------
    spmm, spmm_launches, spmm_err = spmm_path(dev, failed, fmt["hybmix400k"].matrix)
    spmmf8(dev, failed)
    if failed:
        print(f"chip_smoke: SpMM path failed: {failed}", file=sys.stderr)
        return 1

    # --- 9. K2 vs K6 vs K7 at banded500k, device times -------------------------
    t2 = spmm_crossover(dev, card, spmm["spmm8_banded500k"].matrix, fmt["dia_spmm8"].matrix,
                        spmm["bandblock_spmm8"].matrix)

    say(json.dumps({"kernels": [
        {
            "name": "csr5_spmv",
            "route": "cuda",
            "source": K1_SOURCE,
            "replaces": K1_REPLACES,
            "launches": launches + fmt_launches["csr5_spmv"],
            "max_abs_err": max(max_abs, fmt_err["csr5_spmv"]),
            "ms": k_ms,
            "plain_ms": p_ms,
        },
        {
            "name": "dia_spmv",
            "route": "cuda",
            "source": DIA_SOURCE,
            "replaces": K5_REPLACES,
            "launches": fmt_launches["dia_spmv"],
            "max_abs_err": fmt_err["dia_spmv"],
            "ms": t["k5"],
            "plain_ms": t["k5_plain"],
        },
        {
            "name": "dia_spmm",
            "route": "cuda",
            "source": DIA_SOURCE,
            "replaces": K6_REPLACES,
            "launches": fmt_launches["dia_spmm"] + spmm_launches["dia_spmm"],
            "max_abs_err": max(fmt_err["dia_spmm"], spmm_err["dia_spmm"]),
            "ms": t["k6"],
            "plain_ms": t["k6_plain"],
        },
        {
            "name": "csr5_spmm",
            "route": "cuda",
            "source": K2_SOURCE,
            "replaces": K2_REPLACES,
            "launches": spmm_launches["csr5_spmm"],
            "max_abs_err": spmm_err["csr5_spmm"],
            "ms": t2["k2"],
            "plain_ms": t2["k2_plain"],
        },
        {
            "name": "bandmm_spmm",
            "route": "cuda",
            "source": K7_SOURCE,
            "replaces": K7_REPLACES,
            "launches": spmm_launches["bandmm_spmm"],
            "max_abs_err": spmm_err["bandmm_spmm"],
            "ms": t2["k7"],
            "plain_ms": t2["k7_plain"],
        },
    ]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
