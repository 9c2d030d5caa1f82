#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's main paths once on one card: CSR5 SpMV,
and the structural formats (DIA, HYB5, ``--format auto``).

Run from the root of the repository, with one NVIDIA GPU visible:

    python3 chip_smoke.py

Phases, each of which must pass:

1. the card (``nvidia-smi`` name and power limit) and the nvcc builds of
   ``csrc/csr5_spmv.cu`` and ``csrc/dia_spmv.cu`` from the sources in the
   checkout, both started at once;
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
   and the device time of each kernel by ``torch.profiler``.

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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1

    import numpy as np
    import scipy.sparse as sp

    from benchmark_spmv_using_csr5_tpu_torch import CSR5Config, build_csr5
    from benchmark_spmv_using_csr5_tpu_torch.bench import cli
    from benchmark_spmv_using_csr5_tpu_torch.ops import csr5_kernel, dia_kernel
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
    cuda_build.build(["csr5_spmv", "dia_spmv"])
    csr5_kernel._lib()
    dia_kernel._lib()
    say(
        f"build: csr5_spmv.cu {cuda_build.build_seconds['csr5_spmv']:.1f} s and "
        f"dia_spmv.cu {cuda_build.build_seconds['dia_spmv']:.1f} s with nvcc, in parallel "
        f"(load {time.perf_counter() - t0:.1f} s)"
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
            "launches": fmt_launches["dia_spmm"],
            "max_abs_err": fmt_err["dia_spmm"],
            "ms": t["k6"],
            "plain_ms": t["k6_plain"],
        },
    ]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
