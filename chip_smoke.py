#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's CSR5 SpMV main path once on one card.

Run from the root of the repository, with one NVIDIA GPU visible:

    python3 chip_smoke.py

Phases, each of which must pass:

1. the card (``nvidia-smi`` name and power limit) and the nvcc build of
   ``csrc/csr5_spmv.cu`` from the sources in the checkout;
2. kernel K1 against its plain PyTorch version on the card and against
   scipy, on the odd shapes of the TPU sweep (``scripts/smoke_chip.py``):
   one tile, few tiles, every sigma, aligned maps, a scattered band, a
   power law, one dense row over many tiles, FEM blocks and the edge-case
   matrices, each with float32 and with bfloat16 value planes. On their
   integer-valued data the three agree exactly; one case of random floats
   holds the kernel to 1e-5 of each row's absolute sum;
3. the main path through the CLI and harness: ``example.mtx`` and
   ``--synthetic banded:500000:27``, with the launch count of K1 over
   that run, then K1 and the plain version timed at those shapes.

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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1

    import numpy as np
    import scipy.sparse as sp

    from benchmark_spmv_using_csr5_tpu_torch import CSR5Config, build_csr5
    from benchmark_spmv_using_csr5_tpu_torch.bench import cli
    from benchmark_spmv_using_csr5_tpu_torch.ops import csr5_kernel
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
    csr5_kernel._lib()
    say(
        f"build: csr5_spmv.cu with nvcc in {cuda_build.build_seconds['csr5_spmv']:.1f} s "
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

    say(json.dumps({"kernels": [{
        "name": "csr5_spmv",
        "route": "cuda",
        "source": K1_SOURCE,
        "replaces": K1_REPLACES,
        "launches": launches,
        "max_abs_err": max_abs,
        "ms": k_ms,
        "plain_ms": p_ms,
    }]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
