#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's main paths once on one card: CSR5 SpMV,
the structural formats (DIA, HYB5, ``--format auto``), the
multi-right-hand-side path (``--spmm K``: CSR5 SpMM, band-block SpMM), the
float64 path (``--dtype float64``, the SpMVHandle, the solvers), the
large-matrix path (the row-sliced form at 20M rows, the packed columns),
the conversion on the card and the distributed layer at D = 1 on NCCL.

Run from the root of the repository, with one NVIDIA GPU visible:

    python3 chip_smoke.py

Phases, each of which must pass:

1. the card (``nvidia-smi`` name and power limit) and the nvcc builds of
   every source under ``csrc/`` (``csr5_spmv.cu``, ``csr5_spmv_f64.cu``,
   ``csr5_spmm.cu``, ``dia_spmv.cu``, ``bandmm.cu``, ``csr5_sliced.cu``)
   from the checkout, all started at once;
2. kernel K1 against its plain PyTorch version on the card and against
   scipy, on the odd shapes of the TPU sweep (``scripts/smoke_chip.py``):
   one tile, few tiles, every sigma, aligned maps, a scattered band, a
   power law, one dense row over many tiles, FEM blocks and the edge-case
   matrices, then K1's own sigmas (``K1_SIGMAS``: less than a group of
   rows, whole groups, remainders) on a band and on a power law with
   aligned maps, a dense row at sigma 13 and a diagonal at the largest
   sigma K1 takes on a raw plane (447: a sigma % 16 == 0 plane is packed
   and runs K1p), each with float32 and with bfloat16 value planes. On their
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
   and the device time of each kernel by ``torch.profiler``; K1's y once
   more bit-equal to the plain version, with the share of x it holds in L2,
   its share of rows loaded a group ahead, its shared memory a block and
   its device time over ``K1_US_BEFORE``;
7. kernels K2 (CSR5 SpMM) and K7 (band-block SpMM) against their plain
   versions on the card and against scipy, on the odd shapes of phases 2
   and 4: R in {1, 2, 5, 8, 16, 17} (K7 also 32, one pass over the plane,
   and 33, two chunks), both layouts, float32 and bfloat16 planes (K7:
   "highest" and "default" on float32, "default" on bfloat16), alpha =
   -1.75, exact on integer data; random floats held to 1e-5 of each row's
   |A||X| against the plain version and float64 scipy (K7 in "highest"
   and in "default", the tensor cores on a float32 plane, whose float64
   reference takes the bf16-rounded operands). Every K2 case prints the
   staging mode of its launches (``spmm_mode``: X staged in shared memory,
   or gathered), and the phase fails unless both modes ran and every
   launch in each was exact;
8. the SpMM path at full width through the CLI's own code and the API:
   ``--spmm 8`` at banded500k (csr5: K2), ``--format bandblock --spmm 8``
   and ``--spmm 16`` (K7, bfloat16 plane by the gate), ``--format auto
   --spmm 8`` at banded500k (must pick bandblock) and at hybmix400k (must
   pick csr5), and ``hyb_spmm`` at hybmix400k, R = 8 (K6 + K2), each PASS
   with max rel err 0.0 and the kernels' launch counts over that run; then
   spmmf8 (banded500k with decade-spread values, X on [0.5, 1.5]): the
   auto gate must pick a float32 plane and K7 land within 1e-4 of the
   float64 oracle, and a forced bfloat16 plane within 1 %;
9. K2 (with its staging mode), K6 and K7 at R = 8 on the same banded500k
   matrix and X, and K7 at R = 16, in turns with their plain versions, and
   their device times by ``torch.profiler``: the card's own SpMM crossover;
   K7's device time at R = 8 and 16 beside its bound, cuSPARSE's SpMM at
   R = 16, and K7/K2 at R = 8 (the ratio ``--format auto --spmm`` pays);
10. kernel K4 (float64 CSR5 SpMV) against its plain version and scipy
    float64 on the odd shapes of phase 2: exact on integer data at alpha 1
    and -1.75, within T * 2^-53 of the row's tile mass on non-dyadic
    values, and a float32 x refused;
11. the float64 path at full width: ``--dtype float64`` on example.mtx
    and banded500k (PASS, max rel err 0.0) and on df64_banded500k (max rel
    err against scipy float64 at most 1e-12), the SpMVHandle at banded500k
    in float32 and float64 (spmv against scipy, asCSR round trip,
    setSigma, destroy), and the solvers on a 500,000-row SPD matrix:
    iterative refinement (K1 inner CG, K4 residual) to at most 1e-10
    relative residual and 10x below float32-only CG, with the launches of
    K4 and K1 over that run; then all seven solvers as device programs
    (one CUDA graph per solve, ``utils/graphs.py``): CG, iterative
    refinement, BiCGSTAB, GMRES(20) x 5, Lanczos (30) and power iteration
    (100) on that matrix, PageRank (50) on the example's 100,000-node
    graph, CG on the Poisson example's 65,536-row Laplacian: the first
    call eager, the second captured, then replays, each within
    ``SOLVER_RTOL`` of the eager body (``__wrapped__``) on the same
    inputs, other inputs too; one replay's K1/K4 kernels by torch.profiler
    equal to the launches an eager run's wrappers count, one capture per
    solver; eager, first-call, capture-call and replay ms, and that
    replay's kernel time with its idle share; then twenty solves with a
    new lambda each, and a kept callable dropped after its capture, leave
    the card's allocated memory where it was. Each replay's capture record
    must hold the eager run's launches and place each of its operators'
    calls among the graph's device operations, and a replay add none to
    the counters: the kernels line counts launches at a wrapper, eager or
    captured;
12. K4 at df64_banded500k in turns with cuSPARSE's float64 SpMV (k4,
    lib, lib, k4; the ratio printed) and with its plain version, its device
    time, the library yardstick (``torch.sparse_csr_tensor @ x``, cuSPARSE
    through PyTorch, used nowhere in the port) beside every kernel, and
    each kernel's bound from this run's inputs;
13. kernels K1p and K2p (the packed column stream) and K3 (row-sliced
    SpMV, one launch over every slice) against their plain versions on the
    card and against scipy: K1p and K2p on the odd shapes of phase 2 at
    sigma 16 and 32 (float32 and bfloat16 planes, R in {1, 2, 5, 8, 16,
    17}, both layouts, K1 on the raw plane of the same matrix too), K3 over
    forced multi-slice builds (an empty slice, a window past n, packed
    slices, bfloat16 and float32 slices in one matrix), exact on integer
    data at alpha 1 and -1.75; one random-float case each within 1e-5 of
    each row's |A||x|; K2p's staging modes as in phase 7, both required;
14. the large-matrix path at full width through the CLI's and the API's
    own code: ``--synthetic banded:2000000:27`` (K1), ``banded:20000000:27``
    (the row-sliced form, K3), the same matrix through ``run_benchmark(...,
    backend="cuda")`` (one whole-matrix K1 pass), ``banded:500000:27
    --sigma 16`` (K1p), fem3block600k with ``--autotune`` (sigma 16, K1p),
    ``--sigma 16 --spmm 8`` (K2p) and the SpMVHandle at banded20M (K3), each
    PASS with max rel err 0.0, the one SpMV kernel its launch counts name,
    each phase's seconds and the peak host memory;
15. in turns on the same inputs: K3 against one whole-matrix K1 pass at
    banded20M, K1p against K1 on the raw plane and K2p against K2 at
    banded500k sigma 16 (each with its staging mode), with device times by
    torch.profiler, each one's bound from this run's inputs and the
    cuSPARSE yardstick; K1p's residency line as K1's in phase 6, against
    ``K1P_US_BEFORE``, and K1's on the raw plane against ``K1_US_BEFORE``;
16. the benchmark suite on the card: ``bench/suite.py`` in a subprocess
    (so banded20M's 24 GB of host memory is freed after it), its lines
    relayed; every one of its 18 cases (``dist1_banded500k`` with its
    aligned-map check inside ``check_ok``) must land with ``check_ok``, the
    integer-valued ones with max rel err 0.0, df64_banded500k within
    1e-12 of scipy float64, spmmf8 within 1e-4 (auto) and 1 % (forced
    bfloat16), and no share of HBM from the streamed bytes above 100 %
    unless the case's bytes fit in the L2 (``l2_resident``); the suite's
    launches are added to the kernels line;
17. checkpoints, the debug printer and the examples on the card: a CSR5
    matrix with a bfloat16 plane (banded500k) and a DIA matrix
    (tridiagonal 500k) saved and loaded back onto the card, y through K1
    and K5 bit-equal to before; ``tile_to_string`` of one tile; both
    examples at their default sizes (CG's residual, PageRank's mass and
    their seconds);
18. CSR -> CSR5 on the card (``ops/convert_device.py``) from CSR tensors
    already there, at banded500k, banded2M, fem3block600k (sigma 16, K1p),
    powerlaw200k, scatband300k and banded20M (560M nonzeros, one form):
    every plane bit-equal to the host build, y through K1/K1p equal to the
    host-built matrix's and to scipy, the device build's time in three
    parts (statics, upload, device stages) beside the host build's, the
    card's peak memory; then the host build's two column routes at
    banded2M and banded20M in turns (raw int32 upload, 2 B/nnz codes
    decoded on the card), the rebuilt plane bit-equal to the raw one;
19. the distributed layer at D = 1 on NCCL, in a process group of one
    rank from a FileStore (the NCCL version printed): ``distribute_csr``
    with halo none/auto and convert host/device at banded500k (the device
    route required), ``distributed_spmv`` through K1 on wrapped and aligned
    maps, ``distributed_spmm`` at R = 8 through K2, ``distribute_dia`` with
    its SpMV (K5) and SpMM (K6), each exact against scipy and its
    single-card counterpart; the rank-local SpMV against single-card K1 in
    turns, ``weak_scaling([1])``, the all-gather floor at D = 1 and the
    NVLink projection; then ``examples/distributed_spmv_torch.py`` at its
    default size. The launches of phases 18-19 join the kernels line;
20. the column relabel on the ``kron23`` cell's own graph (its config as
    the benchmark runs it, scale 23, seed 0, 1/deg values replaced by
    ones): the rule fires in ``build_csr5`` and its ``relabel`` phase is
    recorded; K1 on the relabelled plane with x' is ``torch.equal`` to K1
    on the original plane with x and to the plain version (integer x small
    enough that every row's sum is exact), each under its own launch
    counter; then, in turns by CUDA events, µs a launch of K1 both ways,
    the x' fill, and the whole product both ways, with the gathered ids
    and the hot share (:func:`hot_share`); last, PageRank as a device
    program on the relabelled matrix, its capture record counting the
    relabelled K1 launches, its replay against the eager body. Its
    launches join the kernels line.

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
#: what K7's kernel names hold (bandmm_mma_kernel, bandmm_fma_kernel)
K7_KERNELS = "bandmm_"
#: K4's TPU original (the double-single kernel) and source
K4_REPLACES = "benchmark_spmv_using_csr5_tpu/ops/csr5_df64.py:281"
K4_SOURCE = "benchmark_spmv_using_csr5_tpu_torch/csrc/csr5_spmv_f64.cu"
#: K1p's, K2p's and K3's TPU originals (the packed decode of _spmv_kernel,
#: and its xwin mode) and sources
K1P_REPLACES = "benchmark_spmv_using_csr5_tpu/ops/csr5_kernel.py:311"
K3_REPLACES = "benchmark_spmv_using_csr5_tpu/ops/csr5_kernel.py:247"
K3_SOURCE = "benchmark_spmv_using_csr5_tpu_torch/csrc/csr5_sliced.cu"
#: K1's and K1p's device times at banded500k (K1p at sigma 16) before
#: their loads were placed in the cache hierarchy (PERF.md's kernel table,
#: NVIDIA H100 80GB HBM3 at 700 W); phases 6 and 15 print the ratio to them
K1_US_BEFORE = 35.81
K1P_US_BEFORE = 32.64
#: every CUDA source of the port, built at once in phase 1
SOURCES = ("csr5_spmv", "csr5_spmv_f64", "csr5_spmm", "dia_spmv", "bandmm", "csr5_sliced")
#: the suite's cases whose values are not integers (checked by their own
#: limits); every other case must be exact
SUITE_FLOAT_CASES = ("df64_banded500k", "spmmf8_banded500k")
#: peak rates of one H100 SXM (NVIDIA's data sheet, at the full 700 W):
#: float32 and float64 FLOP/s outside the tensor cores, bfloat16 dense on
#: them (K7's "default" products), for the bounds
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12, "bfloat16": 989e12}
#: right-hand-side counts of the SpMM sweep
SWEEP_RHS = (1, 2, 5, 8, 16, 17)
#: right-hand-side counts of K7's sweep: one pass over the plane up to 32,
#: two chunks at 33
K7_SWEEP_RHS = SWEEP_RHS + (32, 33)
#: rtol of the random-float case against the row's absolute sum: the
#: kernel and the plain version sum the tile prefix in another order
FLOAT_RTOL = 1e-5
#: why K7 meets FLOAT_RTOL on random floats, by precision: the plain
#: version is one float32 bmm on the same operands, the float64 reference
#: takes the operands K7's products take (bf16-rounded in "default")
K7_FLOAT_NOTE = {
    "highest": "exact float32 products summed in k order",
    "default": "bf16 operands, exact products, float32 sums in the MMA's order",
}
#: K4 on non-integer data, against its plain version and scipy float64:
#: within T * 2^-53 of the |A||x| mass of the row's tiles (T = sigma * 128
#: products per tile), the classical bound of a prefix sum of T terms,
#: which both K4's lane scan and the plain version's cumsum meet
K4_ULP = 2.0**-53
#: the new column ids phase 20 counts as hot: 32,768 float32 are 128 KB of
#: x', about the L1 an SM running K1 leaves to x
RELABEL_HOT_IDS = 32_768
#: a solver's replay against its eager body (``__wrapped__``) on the same
#: inputs, relative to the largest entry of each output held: the two run
#: the same kernels, but K1 and K4 add a row's partial sums with float
#: atomics, whose order may change between runs
SOLVER_RTOL = {"float32": 1e-5, "float64": 1e-12}


def say(msg: str) -> None:
    print(msg, flush=True)


def bound_ms(moved: int, flops: float, gbps: float, peak: float):
    """(ms, "bytes" or "operations"): the least time of a call that moves
    ``moved`` bytes (each input read once, each output written once) and
    does ``flops`` operations, on a card of ``gbps`` GB/s and ``peak``
    FLOP/s; whichever of the two takes longer sets it."""
    t_bytes = moved / (gbps * 1e9) * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def tile_scale(np, a, x, sigma):
    """Per row, max(|A||x| of the row, the largest |A||x| mass of the
    tiles the row spans): what a prefix-difference method's error scales
    with (``tests/test_df64.py::_tile_scale``)."""
    T = sigma * 128
    prods = np.abs(a.data) * np.abs(x)[a.indices]
    nt = max(1, -(-len(prods) // T))
    pad = np.zeros(nt * T)
    pad[: len(prods)] = prods
    mass = pad.reshape(nt, T).sum(axis=1)
    rp = a.indptr
    t0 = np.minimum(rp[:-1] // T, nt - 1)
    t1 = np.minimum(np.maximum(rp[1:] - 1, rp[:-1]) // T, nt - 1)
    row = abs(a) @ np.abs(x)
    return np.maximum(np.maximum(row, np.maximum(mass[t0], mass[t1])), 1e-300)


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


#: the sigmas of phase 2's K1 cases beyond the sweep's (8, 16, 24, 32):
#: below, at and past a group of K1's rows (``csr5_kernel.K1_UNROLL``),
#: and with a remainder after whole groups
K1_SIGMAS = (1, 3, 7, 9, 13, 31, 33, 47)


def k1_sigma_cases(synth, sp, np, CSR5Config, max_sigma):
    """(name, scipy matrix, config, win_mode) of phase 2's K1-only cases:
    every sigma of K1_SIGMAS on a band (wrapped maps) and a power law
    (aligned maps), a dense row over many tiles, and a diagonal at the
    largest sigma below ``max_sigma`` that is no multiple of 16 (the build
    keeps the raw plane, so K1 and not K1p runs), where a block takes
    nearly the most shared memory K1 asks for and every position ends a
    row."""
    cases = []
    for sig in K1_SIGMAS:
        cases.append((f"bandedB4_s{sig}", synth.banded(700, 9), CSR5Config(sigma=sig), "auto"))
        cases.append((f"powerlaw_s{sig}_aligned", synth.power_law(3000, 3000, 8.0),
                      CSR5Config(sigma=sig), "aligned"))
    cases.append(("fasttrack_s13", synth.single_dense_row(64, 8192), CSR5Config(sigma=13), "auto"))
    sig = max(s for s in range(1, max_sigma + 1) if s % 16)
    m = 2 * sig * 128 + 77
    diag = sp.diags(np.arange(m) % 4 + 1.0, format="csr")
    cases.append((f"diag_s{sig}", diag, CSR5Config(sigma=sig), "auto"))
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

    from benchmark_spmv_using_csr5_tpu_torch.bench import case_runner, cli
    from benchmark_spmv_using_csr5_tpu_torch.ops.csr5_spmv import csr5_spmv_torch
    from benchmark_spmv_using_csr5_tpu_torch.ops.dia import dia_spmm_torch, dia_spmv_torch
    from benchmark_spmv_using_csr5_tpu_torch.utils import cuda_build, synth

    tri = synth.banded(500_000, 3, dtype=np.float32)
    mix = case_runner.hybmix(400_000)
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
    keys = ("csr5_spmv", "dia_spmv", "dia_spmm")
    cuda_build.launches.update(dict.fromkeys(keys, 0))
    results = {}
    for name, want, go in runs:
        results[name] = go()
    torch.cuda.synchronize()
    launches = {k: cuda_build.launches[k] for k in keys}
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


def residency_line(name, a5, x, us, us_before, card) -> str:
    """One more launch of K1 or K1p on ``a5`` and ``x``: whether y is bit
    for bit the plain version's (integer data), the share of x it holds in
    L2, K1's share of rows loaded a group ahead and its shared memory a
    block, and its device time against the time before the loads were
    placed."""
    import torch

    from benchmark_spmv_using_csr5_tpu_torch.ops import csr5_kernel
    from benchmark_spmv_using_csr5_tpu_torch.ops.csr5_spmv import (
        csr5_spmv_packed_torch, csr5_spmv_torch,
    )
    from benchmark_spmv_using_csr5_tpu_torch.utils import cuda_build

    plain = csr5_spmv_packed_torch if a5.col_packed is not None else csr5_spmv_torch
    exact = torch.equal(csr5_kernel.csr5_spmv_cuda(a5, x), plain(a5, x))
    if not exact:
        raise RuntimeError(f"{name} at banded500k: y differs from the plain version")
    ratio = "not measured" if us is None else f"{us / us_before:.4f}"
    l2 = csr5_kernel._l2(cuda_build.bind("csr5_spmv"), x.device)
    pipeline = "" if a5.col_packed is not None else (
        f"rows loaded a group ahead {csr5_kernel.k1_grouped_share(a5.sigma):.4f} "
        f"(sigma {a5.sigma}), shared memory {csr5_kernel.k1_smem_bytes(a5.sigma)} B a block; ")
    return (f"[{name} residency] y equal to the plain version; {pipeline}"
            f"x {a5.n * 4 / 1e6:.1f} MB, share held in L2 "
            f"{csr5_kernel.resident_share(a5.n * 4, *l2):.4f}, L2 attributes (bytes, "
            f"persisting max) {l2}, set-aside granted "
            f"{csr5_kernel._setaside.get(x.device.index)}; device {us} us against "
            f"{us_before} us before: {ratio} [{card}]")


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
    say(residency_line("K1", a5, x, dev_us["k1"], K1_US_BEFORE, card))
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
    return t, xm


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


def count_mode(modes, a5, R, ok) -> None:
    """Counts one K2/K2p launch on ``a5`` at ``R`` in the staging mode it
    took ("staged" or "gathered"), and whether it was exact."""
    from benchmark_spmv_using_csr5_tpu_torch.ops.csr5_kernel import spmm_mode

    mode = modes[spmm_mode(a5, R)]
    mode[0] += 1
    mode[1] += int(ok)


def mode_list(a5) -> str:
    """The staging mode K2/K2p takes on ``a5`` at each R of SWEEP_RHS
    ("s" staged, "g" gathered)."""
    from benchmark_spmv_using_csr5_tpu_torch.ops.csr5_kernel import spmm_mode

    return "/".join(spmm_mode(a5, R)[0] for R in SWEEP_RHS)


def modes_ran(tag, modes) -> list:
    """The failures of a sweep's staging modes: each must have launched,
    and every launch in it been exact."""
    say(f"[{tag} staging modes] " + ", ".join(
        f"{m}: {ok} of {n} launches exact" for m, (n, ok) in modes.items()))
    return [f"{tag} {m}: {n - ok} of {n} launches not exact" if n else f"{tag} {m}: never ran"
            for m, (n, ok) in modes.items() if n == 0 or ok < n]


def spmm_sweep(dev, rng) -> list:
    """K2 against its plain version on the card and scipy on the odd
    shapes of phase 2, every R of SWEEP_RHS, both layouts, both planes,
    alpha = -1.75, and one random-float case; then K7 (:func:`k7_sweep`)."""
    import numpy as np
    import scipy.sparse as sp
    import torch

    from benchmark_spmv_using_csr5_tpu_torch import CSR5Config, build_csr5
    from benchmark_spmv_using_csr5_tpu_torch.ops import csr5_kernel
    from benchmark_spmv_using_csr5_tpu_torch.ops.csr5_spmv import csr5_spmm_torch
    from benchmark_spmv_using_csr5_tpu_torch.utils import synth

    alpha = -1.75
    rmax = max(SWEEP_RHS)
    failed = []
    modes = {"staged": [0, 0], "gathered": [0, 0]}  # mode -> [launches, exact ones]
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
                ok = _exact(y_nr, y_p, y_s) and torch.equal(y_rn, y_s)
                count_mode(modes, a5, R, ok)
                if not ok:
                    errs.append(f"R={R}")
            tag = f"K2 {name}/{str(vdt).removeprefix('torch.')}"
            failed += [f"{tag} {e}" for e in errs]
            say(f"[{tag}] {'PASS' if not errs else 'FAIL ' + ','.join(errs)} R {SWEEP_RHS} "
                f"nr+rn sigma={a5.sigma} capw={a5.capw} chunk(8)={csr5_kernel.spmm_chunk(a5, 8)} "
                f"pmax={a5.pmax} contig={a5.pages_contig} modes {mode_list(a5)}")
    failed += modes_ran("K2", modes)
    failed += k7_sweep(dev, rng)
    # random floats: K2 sums in K1's order
    a = sp.csr_matrix(synth.banded(20_000, 27)).astype(np.float32)
    a.data = rng.uniform(-1, 1, a.nnz).astype(np.float32)
    xm = rng.uniform(-1, 1, (a.shape[1], 5)).astype(np.float32)
    xmd = torch.from_numpy(xm).to(dev)
    y64 = torch.from_numpy(a.astype(np.float64) @ xm.astype(np.float64))
    row_abs = torch.from_numpy(abs(a).astype(np.float64) @ np.abs(xm).astype(np.float64))
    lim = FLOAT_RTOL * row_abs + 1e-30
    a5 = build_csr5(a, device=dev)
    y_k = csr5_kernel.csr5_spmm_cuda(a5, xmd)
    yk, yp = y_k.double().cpu(), csr5_spmm_torch(a5, xmd).double().cpu()
    ok = bool(((yk - yp).abs() <= lim).all() and ((yk - y64).abs() <= lim).all())
    failed += [] if ok else ["K2 random_floats"]
    say(f"[K2 random_floats rtol={FLOAT_RTOL} of row |A||X|] {'PASS' if ok else 'FAIL'} "
        f"max|k-plain|/rowabs={float(((yk - yp).abs() / row_abs).max()):.3g} "
        f"max|k-f64|/rowabs={float(((yk - y64).abs() / row_abs).max()):.3g}")
    y1 = torch.stack([csr5_kernel.csr5_spmv_cuda(a5, xmd[:, r].contiguous()) for r in range(5)], 1)
    say(f"[K2 random_floats] columns bit-equal to K1 on each X[:, r]: {torch.equal(y1, y_k)}")
    return failed


def k7_sweep(dev, rng) -> list:
    """K7 against its plain version on the card and scipy on phase 4's
    shapes and the band-block test shapes: every R of K7_SWEEP_RHS (one
    pass and two chunks), both layouts, "highest" and "default" on a
    float32 plane and "default" on a bfloat16 plane, alpha = -1.75, exact
    on integer data; then random floats in both modes (the tolerance at
    K7_FLOAT_NOTE)."""
    import numpy as np
    import scipy.sparse as sp
    import torch

    from benchmark_spmv_using_csr5_tpu_torch import build_bandblock
    from benchmark_spmv_using_csr5_tpu_torch.ops import bandmm_kernel
    from benchmark_spmv_using_csr5_tpu_torch.ops.bandmm import bandmm_spmm_torch
    from benchmark_spmv_using_csr5_tpu_torch.ops.dia import CHUNK_ROWS
    from benchmark_spmv_using_csr5_tpu_torch.utils import synth

    alpha = -1.75
    rmax = max(K7_SWEEP_RHS)
    failed = []
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
                for R in K7_SWEEP_RHS:
                    xr = xmd[:, :R].contiguous()
                    y_nr, y_rn = _both_layouts(bandmm_kernel.bandmm_spmm_cuda, bb, xr, alpha,
                                               precision=prec)
                    y_p = bandmm_spmm_torch(bb, xr, alpha, prec).cpu()
                    y_s = torch.from_numpy((alpha * (a @ xm[:, :R])).astype(np.float32))
                    if not (_exact(y_nr, y_p, y_s) and torch.equal(y_rn, y_s)):
                        errs.append(f"{prec} R={R}")
            failed += [f"{tag} {e}" for e in errs]
            say(f"[{tag}] {'PASS' if not errs else 'FAIL ' + ','.join(errs)} {'/'.join(precs)} "
                f"R {K7_SWEEP_RHS} nr+rn K={bb.K} blocks={bb.num_blocks} nx_pad={bb.nx_pad} n={a.shape[1]}")
    # random floats on a float32 plane (the bfloat16 gate keeps them there)
    a = sp.csr_matrix(synth.banded(20_000, 27)).astype(np.float32)
    a.data = rng.uniform(-1, 1, a.nnz).astype(np.float32)
    xm = rng.uniform(-1, 1, (a.shape[1], 5)).astype(np.float32)
    xmd = torch.from_numpy(xm).to(dev)
    bb = build_bandblock(a, device=dev)
    as_bf16 = lambda v: torch.from_numpy(v).to(torch.bfloat16).double().numpy()  # noqa: E731
    for prec in ("highest", "default"):
        a_op, x_op = a.astype(np.float64), xm.astype(np.float64)
        if prec == "default":  # the operands the products take
            a_op.data, x_op = as_bf16(a.data), as_bf16(xm)
        y64 = torch.from_numpy(a_op @ x_op)
        row_abs = torch.from_numpy(abs(a_op) @ np.abs(x_op))
        lim = FLOAT_RTOL * row_abs + 1e-30
        y_nr, y_rn = _both_layouts(bandmm_kernel.bandmm_spmm_cuda, bb, xmd, 1.0, precision=prec)
        y_p = bandmm_spmm_torch(bb, xmd, 1.0, prec).double().cpu()
        for layout, y_k in (("nr", y_nr.double()), ("rn", y_rn.double())):
            ok = bool(((y_k - y_p).abs() <= lim).all() and ((y_k - y64).abs() <= lim).all())
            ok = ok and bb.dtype == torch.float32
            failed += [] if ok else [f"K7 random_floats {prec} {layout}"]
            say(f"[K7 random_floats {prec} {layout} rtol={FLOAT_RTOL} of row |A||X|, {K7_FLOAT_NOTE[prec]}] "
                f"{'PASS' if ok else 'FAIL'} "
                f"max|k-plain|/rowabs={float(((y_k - y_p).abs() / row_abs).max()):.3g} "
                f"max|k-f64|/rowabs={float(((y_k - y64).abs() / row_abs).max()):.3g}")
    return failed


def spmmf8(dev, failed) -> dict:
    """The suite's spmmf8_banded500k (``bench/case_runner.py``, after the
    JAX ``case_runner.py:485-561``): decade-spread float values, X^T on
    [0.5, 1.5], layout "rn", against the float64 oracle; the auto gate
    must pick a float32 plane within 1e-4 and the forced bfloat16 plane
    land within 1 %."""
    from benchmark_spmv_using_csr5_tpu_torch.bench import case_runner

    out = case_runner._run_spmmf8_case(dev)
    ok_auto = out["storage"] == "float32" and out["max_rel_err"] <= 1e-4
    ok16 = out["bf16_forced_rel_err"] <= 0.01
    failed += ([] if ok_auto else ["spmmf8 auto"]) + ([] if ok16 else ["spmmf8 bf16"])
    say(f"[spmmf8_banded500k] auto gate -> {out['storage']} plane + highest: max rel err "
        f"{out['max_rel_err']:.3e} vs float64 (limit 1e-4) {'PASS' if ok_auto else 'FAIL'}; forced "
        f"bfloat16 plane: {out['bf16_forced_rel_err']:.3e} (limit 1e-2) {'PASS' if ok16 else 'FAIL'}; "
        f"build {out['convert_ms']:.1f} ms")
    return out


def spmm_path(dev, failed, mix_hyb):
    """The SpMM path at full width through the CLI's own code and the
    API, with every kernel count set to 0 just before and read just
    after. Returns (results by name, launches, max |kernel - plain|)."""
    import numpy as np
    import torch

    from benchmark_spmv_using_csr5_tpu_torch import hyb_spmm
    from benchmark_spmv_using_csr5_tpu_torch.bench import case_runner, cli, harness
    from benchmark_spmv_using_csr5_tpu_torch.ops import csr5_kernel
    from benchmark_spmv_using_csr5_tpu_torch.ops.bandmm import bandmm_spmm_torch
    from benchmark_spmv_using_csr5_tpu_torch.ops.csr5_spmv import csr5_spmm_torch
    from benchmark_spmv_using_csr5_tpu_torch.ops.dia import dia_spmm_torch
    from benchmark_spmv_using_csr5_tpu_torch.utils import cuda_build

    mix = case_runner.hybmix(400_000)
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
    cuda_build.launches.update(dict.fromkeys(keys, 0))
    results = {name: go() for name, _, go in runs}
    y_hyb = hyb_spmm(mix_hyb, x_mix)
    torch.cuda.synchronize()
    launches = {k: cuda_build.launches[k] for k in keys}
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
            y_p, key, how = bandmm_spmm_torch(r.matrix, xd), "bandmm_spmm", ""
        else:
            y_p, key = csr5_spmm_torch(r.matrix, xd), "csr5_spmm"
            how = f" (K2 {csr5_kernel.spmm_mode(r.matrix, r.num_rhs)})"
        e = float((r.y - y_p).abs().max())
        err[key] = max(err[key], e)
        exact = torch.equal(r.y, y_p)
        say(f"[{name}] kernel Y vs plain on the card{how}: max abs err {e} "
            f"{'PASS' if exact else 'FAIL'}")
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


def spmm_crossover(dev, card, kind, a5, dia, bb):
    """K2, K6 and K7 at R = 8 on the same banded500k matrix and X, K7 at
    R = 16, in turns with their plain versions; device times, K7's beside
    its bound at both R, cuSPARSE's SpMM at R = 16, and K7/K2 at R = 8."""
    import numpy as np
    import scipy.sparse as sp
    import torch

    from benchmark_spmv_using_csr5_tpu_torch.ops import bandmm_kernel, csr5_kernel, dia_kernel
    from benchmark_spmv_using_csr5_tpu_torch.ops.bandmm import bandmm_spmm_torch
    from benchmark_spmv_using_csr5_tpu_torch.ops.csr5_spmv import csr5_spmm_torch
    from benchmark_spmv_using_csr5_tpu_torch.ops.dia import dia_spmm_torch
    from benchmark_spmv_using_csr5_tpu_torch.utils import perf, synth

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
        "k7": device_us(bandmm_kernel.bandmm_spmm_cuda, bb, x8, match=K7_KERNELS),
        "k7_r16": device_us(bandmm_kernel.bandmm_spmm_cuda, bb, x16, match=K7_KERNELS),
    }
    # cuSPARSE's SpMM at R = 16 on the same matrix and X (the yardstick)
    band = library_csr(sp.csr_matrix(synth.banded(500_000, 27)).astype(np.float32), np.float32, dev)
    mm = lambda A, v: A @ v  # noqa: E731
    t["lib_r16"] = perf.benchmark(mm, band, x16, device=dev, num_run=100)
    dev_us["lib_r16"] = device_us_per_call(mm, band, x16)
    del band
    # K7's bound at both R from this run's inputs (bf16 operands: the tensor
    # cores' rate for the operations)
    gbps = perf.device_hbm_gbps(kind)
    for key, x in (("k7", x8), ("k7_r16", x16)):
        R = x.shape[1]
        t[f"{key}_bound"], t[f"{key}_bound_by"] = bound_ms(
            perf.streamed_bytes(bb, x, R), 2 * bb.dense.numel() * R, gbps, PEAK_FLOPS["bfloat16"])
        t[f"{key}_us"] = dev_us[key]
    t["lib_r16_us"] = dev_us["lib_r16"]
    mb = {
        "k2": (a5.col_idx_tiles.numel() * 4 + a5.val_tiles.numel() * a5.val_tiles.element_size()) / 1e6,
        "k6": dia.data.numel() * dia.data.element_size() / 1e6,
        "k7": bb.dense_bytes / 1e6,
    }
    say(f"[banded500k SpMM crossover, {card}] turns (ms per call, event loop): "
        + ", ".join(f"{k} {v}" for k, v in times.items()))
    say(f"[banded500k SpMM crossover] R=8: K2 (CSR5, {mb['k2']:.1f} MB cols+vals, "
        f"{csr5_kernel.spmm_mode(a5, 8)}) {t['k2']:.5f} ms, "
        f"K6 (DIA, {mb['k6']:.1f} MB plane) {t['k6']:.5f} ms, K7 (band-block, "
        f"{str(bb.dtype).removeprefix('torch.')} plane of {mb['k7']:.1f} MB, K={bb.K}) "
        f"{t['k7']:.5f} ms; R=16: K7 {t['k7_r16']:.5f} ms, cuSPARSE {t['lib_r16']:.5f} ms; "
        f"plain K2 {t['k2_plain']:.4f}, K6 {t['k6_plain']:.4f}, K7 {t['k7_plain']:.4f} "
        f"(R=16 {t['k7_r16_plain']:.4f}) ms; X and Y 16.0 MB each at R=8 [{card}]")
    say("[banded500k SpMM device time by torch.profiler, us per launch] " + ", ".join(
        f"{k} {'not measured' if v is None else f'{v:.2f}'}" for k, v in dev_us.items()))
    for key, R in (("k7", 8), ("k7_r16", 16)):
        us, b_us = dev_us[key], t[f"{key}_bound"] * 1e3
        share = "not measured" if us is None else f"{100 * b_us / us:.1f} % of it"
        say(f"[K7 R={R}, {card}] device {'not measured' if us is None else f'{us:.2f}'} us, "
            f"bound {b_us:.2f} us ({t[f'{key}_bound_by']}), {share}")
    ratio = (f"{dev_us['k7'] / dev_us['k2']:.4f}" if dev_us["k7"] and dev_us["k2"]
             else "not measured")
    say(f"[K7/K2 at R=8, banded500k, {card}] {t['k7'] / t['k2']:.4f} per call (event loop), "
        f"{ratio} in device time; --format auto --spmm 8 picks bandblock (K7)")
    return t, x8


def f64_sweep(dev, rng) -> list:
    """K4 against its plain version and scipy float64 on the odd shapes
    of phase 2 (wrapped and aligned maps as the cases give them): exact on
    integer data at alpha 1 and -1.75; non-dyadic values (7 decades,
    mixed signs) within T * 2^-53 of the row's tile mass at alpha -1.75;
    an f32 x on the f64 plane refused."""
    import numpy as np
    import scipy.sparse as sp
    import torch

    from benchmark_spmv_using_csr5_tpu_torch import CSR5Config, build_csr5
    from benchmark_spmv_using_csr5_tpu_torch.ops import csr5_f64
    from benchmark_spmv_using_csr5_tpu_torch.ops.csr5_spmv import csr5_spmv_torch
    from benchmark_spmv_using_csr5_tpu_torch.utils import synth

    f64 = torch.float64
    failed = []
    worst = 0.0
    for name, a_sp, cfg, win_mode in sweep_cases(synth, CSR5Config):
        a = sp.csr_matrix(a_sp).astype(np.float64)
        a5 = build_csr5(a, cfg, value_dtype=f64, win_mode=win_mode, device=dev)
        x = rng.integers(1, 10, a.shape[1]).astype(np.float64)
        xd = torch.from_numpy(x).to(dev)
        errs = []
        for alpha in (1.0, -1.75):
            y_k = csr5_f64.csr5_spmv_f64_cuda(a5, xd, alpha).cpu()
            y_p = csr5_spmv_torch(a5, xd, alpha).cpu()
            if not _exact(y_k, y_p, torch.from_numpy(alpha * (a @ x))):
                errs.append(f"integer alpha={alpha}")
        af = a.copy()
        af.data = (rng.uniform(0.1, 1.0, af.nnz) * 10.0 ** rng.integers(-3, 4, af.nnz)
                   * rng.choice([-1.0, 1.0], af.nnz))
        a5f = build_csr5(af, cfg, value_dtype=f64, win_mode=win_mode, device=dev)
        xf = rng.uniform(-1.0, 1.0, a.shape[1])
        xfd = torch.from_numpy(xf).to(dev)
        y_k = csr5_f64.csr5_spmv_f64_cuda(a5f, xfd, -1.75).cpu().numpy()
        y_p = csr5_spmv_torch(a5f, xfd, -1.75).cpu().numpy()
        lim = a5f.sigma * 128 * K4_ULP * 1.75 * tile_scale(np, af, xf, a5f.sigma)
        ratio = float(max((np.abs(y_k - y_p) / lim).max(), (np.abs(y_k + 1.75 * (af @ xf)) / lim).max()))
        worst = max(worst, ratio)
        if ratio > 1.0:
            errs.append(f"floats {ratio:.3g} of the bound")
        failed += [f"K4 {name} {e}" for e in errs]
        say(f"[K4 {name}] {'PASS' if not errs else 'FAIL ' + ','.join(errs)} sigma={a5.sigma} "
            f"tiles={a5.num_tiles} win={'wrapped' if a5.win_rel else 'aligned'}; floats: "
            f"{ratio:.3g} of the bound, bit-equal to plain {bool(np.array_equal(y_k, y_p))}")
    try:
        csr5_f64.csr5_spmv_f64_cuda(a5, xd.float())
        failed.append("K4 took a float32 x on a float64 plane")
    except ValueError as e:
        say(f"[K4 refuses float32 x on the float64 plane] PASS ({e})")
    say(f"[K4 sweep] worst float case at {worst:.3g} of T * 2^-53 of the row's tile mass")
    return failed


def f64_path(dev, card, failed):
    """The float64 path at full width: ``--dtype float64`` through the
    CLI on example.mtx, banded500k and df64_banded500k, the SpMVHandle at
    banded500k in float32 and float64, and the solvers on a 500,000-row
    SPD matrix (iterative refinement: K1 inner CG, K4 residual; CG on
    K1), then all seven solvers as device programs
    (:func:`solver_programs`). Every kernel count is set to 0 just before
    and read just after.
    Returns (CLI results by name, launches, max |K4 - plain|, the df64
    matrix)."""
    import numpy as np
    import scipy.sparse as sp
    import torch

    from benchmark_spmv_using_csr5_tpu_torch import SpMVHandle, build_csr5, csr5_spmv, solvers
    from benchmark_spmv_using_csr5_tpu_torch.bench import cli
    from benchmark_spmv_using_csr5_tpu_torch.ops.csr5_spmv import csr5_spmv_torch
    from benchmark_spmv_using_csr5_tpu_torch.utils import cuda_build, synth

    f64 = torch.float64
    df64 = synth.f64_banded(500_000, 27)
    band = sp.csr_matrix(synth.banded(500_000, 27))
    spd = df64 + df64.T
    spd = (spd * 0.5 + sp.eye(spd.shape[0]) * (abs(df64).sum(axis=1).max() + 1.0)).tocsr()
    runs = [
        ("example.mtx", lambda: cli.run([os.path.join(ROOT, "example.mtx"), "--dtype", "float64"])),
        ("banded500k", lambda: cli.run(["--synthetic", "banded:500000:27", "--dtype", "float64"])),
        ("df64_banded500k", lambda: cli.run_matrix(
            cli.parse_args(["--dtype", "float64"]), "df64_banded500k",
            df64.indptr, df64.indices, df64.data, df64.shape)),
    ]
    launched = cuda_build.launches
    launched["csr5_spmv"] = launched["csr5_spmv_f64"] = launched["csr5_spmv_relabel"] = 0
    t0 = time.perf_counter()
    results = {name: go() for name, go in runs}
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0

    # the handle, float32 (K1) and float64 (K4), against scipy
    hrng = np.random.default_rng(11)
    for dt in (np.float32, np.float64):
        a = band.astype(dt)
        h = SpMVHandle(*a.shape)
        h.inputCSR(a.nnz, a.indptr, a.indices, a.data).asCSR5()
        x = hrng.integers(1, 10, a.shape[1]).astype(dt)
        y = h.setX(x).spmv(-1.75)
        ok = torch.equal(y.cpu(), torch.from_numpy(-1.75 * (a @ x)))
        sigma0, plane = h.csr5.sigma, str(h.csr5.val_tiles.dtype).removeprefix("torch.")
        h.asCSR()
        c = h.csr
        ok = ok and np.array_equal(c.row_ptr.cpu().numpy(), a.indptr) and np.array_equal(
            c.col_idx.cpu().numpy(), a.indices) and np.array_equal(c.values.cpu().numpy(), a.data)
        h.asCSR5().setSigma(16)
        ok = ok and h.csr5.sigma == 16 and torch.equal(h.spmv(1.0).cpu(), torch.from_numpy(a @ x))
        rc = h.destroy()
        ok = ok and rc == 0
        failed += [] if ok else [f"handle {np.dtype(dt).name}"]
        say(f"[SpMVHandle banded500k {np.dtype(dt).name}] {'PASS' if ok else 'FAIL'}: inputCSR -> "
            f"asCSR5 (sigma {sigma0}, {plane} plane) -> setX -> spmv(-1.75) == scipy, asCSR round "
            f"trip, setSigma(16) reconverts, destroy() = {rc}")

    # the solvers at full width: IR (K1 inner, K4 residual) and CG on K1
    a64 = build_csr5(spd, value_dtype=f64, device=dev)
    a32 = build_csr5(spd.astype(np.float32), value_dtype="auto", device=dev)
    lo = lambda v: csr5_spmv(a32, v)  # noqa: E731
    hi = lambda v: csr5_spmv(a64, v)  # noqa: E731
    b = torch.ones(spd.shape[0], dtype=f64, device=dev)
    bn = float(torch.linalg.vector_norm(b))
    k1_0 = launched["csr5_spmv"]
    t0 = time.perf_counter()
    x32, _ = solvers.conjugate_gradient(lo, b.float(), iters=300)
    res32 = float(torch.linalg.vector_norm(b - hi(x32.double()))) / bn
    torch.cuda.synchronize()
    cg_s = time.perf_counter() - t0
    k1_cg = launched["csr5_spmv"] - k1_0
    k1_0, k4_0 = launched["csr5_spmv"], launched["csr5_spmv_f64"]
    t0 = time.perf_counter()
    x_ir, res_ir = solvers.iterative_refinement(lo, hi, b, outer_iters=5, inner_iters=50)
    res_ir = float(res_ir) / bn
    torch.cuda.synchronize()
    ir_s = time.perf_counter() - t0
    k1_ir, k4_ir = launched["csr5_spmv"] - k1_0, launched["csr5_spmv_f64"] - k4_0
    res_ir_scipy = float(np.linalg.norm(1.0 - spd @ x_ir.cpu().numpy())) / bn
    ok = res_ir <= 1e-10 and res_ir * 10 <= res32 and res_ir_scipy <= 1e-10 and x_ir.dtype == f64
    failed += [] if ok else ["iterative refinement"]
    say(f"[solvers, SPD {spd.shape[0]} rows, {spd.nnz} nnz] {'PASS' if ok else 'FAIL'}: float32-only "
        f"CG (K1, 300 iterations, {k1_cg} K1 launches) relative residual {res32:.3e} in {cg_s:.3f} s; "
        f"iterative refinement (5 x 50, K1 inner, K4 residual: {k1_ir} K1 and {k4_ir} K4 launches) "
        f"{res_ir:.3e} (scipy: {res_ir_scipy:.3e}) in {ir_s:.3f} s; limit 1e-10 and 10x below CG")
    solver_programs(dev, card, spd, a32, a64, failed)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    # the kernels line counts launches at a wrapper, eager or captured; a
    # replay adds none (phase 11 holds its capture record against the
    # profiler instead); K1's count takes its launches on either column plane
    launches = {"csr5_spmv": launched["csr5_spmv"] + launched["csr5_spmv_relabel"],
                "csr5_spmv_f64": launched["csr5_spmv_f64"]}

    # the CLI runs: checks, K4 against its plain version on the same x
    err = 0.0
    for name, _ in runs:
        r = results[name]
        say(r.report())
        good = (
            r.check_ok and r.backend == "cuda" and r.storage == "float64" and r.y.dtype == f64
            and tuple(r.y.shape) == (r.m,) and bool(torch.isfinite(r.y).all())
            and (r.max_rel_err == 0.0 or name == "df64_banded500k")
        )
        x = np.random.default_rng(0).integers(1, 10, r.n).astype(np.float64)
        xd = torch.from_numpy(x).to(dev)
        y_p = csr5_spmv_torch(r.matrix, xd)
        e = float((r.y - y_p).abs().max())
        err = max(err, e)
        a = df64 if name == "df64_banded500k" else None
        if a is not None:
            y_ref = a @ x
            raw = float((np.abs(r.y.cpu().numpy() - y_ref) / np.abs(y_ref)).max())
            lim = r.matrix.sigma * 128 * K4_ULP * tile_scale(np, a, x, r.matrix.sigma)
            inside = bool((np.abs(r.y.cpu().numpy() - y_p.cpu().numpy()) <= lim).all())
            good = good and raw <= 1e-12 and inside
            say(f"[{name}] K4 vs scipy float64: max rel err {raw:.3e} per row (no floor; "
                f"limit 1e-12); vs plain: max abs err {e:.3e}, within T * 2^-53 of the tile mass: "
                f"{inside}")
        else:
            good = good and torch.equal(r.y, y_p)
            say(f"[{name}] K4 vs plain on the card: max abs err {e} {'PASS' if e == 0 else 'FAIL'}")
        if not good:
            failed.append(f"f64 {name}")
    say(f"float64 path launches: K4 {launches['csr5_spmv_f64']}, K1 {launches['csr5_spmv']} "
        f"(CLI runs {cli_s:.1f} s)")
    for k, v in launches.items():
        if v == 0:
            failed.append(f"no {k} launch on the float64 path")
    return results, launches, err, df64


def _device_window(call):
    """One call of ``call`` under torch.profiler: (device µs by kernel
    name, activities by kernel name, busy µs, span µs from the first
    device activity to the last, number of activities), or None when the
    profiler shows no device activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    evs = sorted(
        (e.time_range.start, e.time_range.end, e.name) for e in prof.events()
        if e.device_type == DeviceType.CUDA and e.time_range.end > e.time_range.start
    )
    if not evs:
        return None
    by_name, counts, busy = {}, {}, 0.0
    lo, hi = evs[0][0], evs[0][1]
    for t0, t1, name in evs:
        by_name[name] = by_name.get(name, 0.0) + (t1 - t0)
        counts[name] = counts.get(name, 0) + 1
        if t0 > hi:
            busy += hi - lo
            lo, hi = t0, t1
        else:
            hi = max(hi, t1)
    busy += hi - lo
    return by_name, counts, busy, max(t1 for _, t1, _ in evs) - evs[0][0], len(evs)


#: launch counter -> the name of its kernel in a profiler trace, for the
#: kernels the solvers run (K1 on either column plane, K1p, K4)
SOLVER_KERNELS = {
    "csr5_spmv": "csr5_spmv_tile_kernel",
    "csr5_spmv_relabel": "csr5_spmv_tile_kernel",
    "csr5_spmv_packed": "csr5_spmv_packed_kernel",
    "csr5_spmv_f64": "csr5_spmv_f64_tile_kernel",
}


def solver_programs(dev, card, spd, a32, a64, failed) -> dict:
    """Phase 11's seven solvers as device programs at full width: CG (300
    iterations), iterative refinement (5 x 50: K1 inner CG, K4 residual),
    BiCGSTAB (50), GMRES(20) x 5, Lanczos (30) and power iteration (100)
    on the phase's SPD matrix through K1 (and K4), PageRank (50) on the
    example's 100,000-node graph (its columns relabelled by count: K1's
    launches count as ``csr5_spmv_relabel``, three device operations a
    product with the x' fill), and CG (300) on the Poisson example's
    65,536-row Laplacian, where K1 is short. Each runs its eager body
    (``__wrapped__``) three times; then through the decorated solver a
    first call (the eager body, no capture), a second (warm-up, capture,
    replay), five replays, one replay under torch.profiler, and one call
    on other inputs (a replay that must read the refilled buffers). Each
    call must lie within :data:`SOLVER_RTOL` of the eager body on the
    same inputs, the solver capture once, and the profiled replay run as
    many K1/K4 kernels as the eager run's wrappers counted. Then twenty
    solves with a new ``lambda`` each, and one kept callable dropped after
    its capture, must leave ``torch.cuda.memory_allocated()`` where it
    was. Prints each one's ms (eager, first call, capture call, replay
    median of 5) and the profiled replay's kernel time with its idle share
    against the replay's CUDA-event time. Returns the numbers by
    solver."""
    import gc

    import numpy as np
    import torch

    from benchmark_spmv_using_csr5_tpu_torch import build_csr5, csr5_spmv, solvers
    from benchmark_spmv_using_csr5_tpu_torch.utils import graphs

    n = spd.shape[0]
    pt = _load_example("pagerank_torch").transition_matrix(100_000)
    g5 = build_csr5((pt.indptr, pt.indices, pt.data, pt.shape), device=dev)
    lap = _load_example("poisson_cg_torch").laplacian_2d(256)
    l5 = build_csr5((lap.indptr, lap.indices, lap.data, lap.shape), device=dev)
    lo = lambda v: csr5_spmv(a32, v)  # noqa: E731
    hi = lambda v: csr5_spmv(a64, v)  # noqa: E731
    walk = lambda v: csr5_spmv(g5, v)  # noqa: E731
    poisson = lambda v: csr5_spmv(l5, v)  # noqa: E731
    b64 = torch.ones(n, dtype=torch.float64, device=dev)
    b32 = b64.float()
    b_lap = torch.ones(lap.shape[0], device=dev)
    vrng = np.random.default_rng(3)
    v0s = [torch.from_numpy(vrng.uniform(-1, 1, n).astype(np.float32)).to(dev) for _ in range(2)]

    def start(seed):
        return torch.randn(n, generator=torch.Generator().manual_seed(seed)).to(dev)

    def ritz(al, be):
        T = torch.diag(al) + torch.diag(be[:-1], 1) + torch.diag(be[:-1], -1)
        return al, be, torch.linalg.eigvalsh(T)

    S = solvers
    # name, program, decorated call (input), eager call (input), the inputs
    # (the second for the refill check), outputs held (names by index)
    runs = [
        ("conjugate_gradient", S.conjugate_gradient,
         lambda b: S.conjugate_gradient(lo, b, iters=300),
         lambda b: S.conjugate_gradient.__wrapped__(lo, b, 300), (b32, b32 * 0.5 + 1), ("x",)),
        ("iterative_refinement", S.iterative_refinement,
         lambda b: S.iterative_refinement(lo, hi, b, outer_iters=5, inner_iters=50),
         lambda b: S.iterative_refinement.__wrapped__(lo, hi, b, 5, 50), (b64, b64 * 0.5 + 1),
         ("x",)),
        ("bicgstab", S.bicgstab, lambda b: S.bicgstab(lo, b, iters=50),
         lambda b: S.bicgstab.__wrapped__(lo, b, 50), (b32, b32 * 0.5 + 1), ("x",)),
        ("gmres", S.gmres, lambda b: S.gmres(lo, b, restart=20, outer_iters=5),
         lambda b: S.gmres.__wrapped__(lo, b, 20, 5), (b32, b32 * 0.5 + 1), ("x",)),
        ("lanczos", S.lanczos_loop, lambda v: S.lanczos(lo, v, iters=30),
         lambda v: ritz(*S.lanczos_loop.__wrapped__(lo, v, 30)), v0s,
         ("alphas", "betas", "eigvals")),
        ("power_iteration", S.power_iteration_loop,
         lambda seed: S.power_iteration(lo, n, iters=100,
                                        generator=torch.Generator().manual_seed(seed), device=dev),
         lambda seed: S.power_iteration_loop.__wrapped__(lo, start(seed), 100), (0, 1),
         ("lambda", "v")),
        # PageRank takes no tensor: there is no buffer to refill
        ("pagerank", S.pagerank,
         lambda _: S.pagerank(walk, pt.shape[0], damping=0.85, iters=50, device=dev),
         lambda _: S.pagerank.__wrapped__(walk, pt.shape[0], 0.85, 50, torch.float32, dev),
         (None,), ("r",)),
        ("conjugate_gradient_poisson65k", S.conjugate_gradient,
         lambda b: S.conjugate_gradient(poisson, b, iters=300),
         lambda b: S.conjugate_gradient.__wrapped__(poisson, b, 300), (b_lap, b_lap * 0.5 + 1),
         ("x",)),
    ]

    def timed(call, arg):
        """(outputs, host ms, device ms between CUDA events, launches) of
        one call."""
        torch.cuda.synchronize()
        before = graphs.read_launches()
        ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        ev0.record()
        out = call(arg)
        ev1.record()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        out = out if isinstance(out, tuple) else (out,)
        return out, ms, ev0.elapsed_time(ev1), graphs.launches_between(before, graphs.read_launches())

    def rel_errs(out, ref, held):
        errs = {}
        for i, label in enumerate(held):
            scale = float(ref[i].abs().max())
            errs[label] = float((out[i] - ref[i]).abs().max()) / scale if scale else 0.0
        finite = all(bool(torch.isfinite(o).all()) and o.shape == r.shape for o, r in zip(out, ref))
        return errs, finite

    report, out2, ref2 = {}, None, None
    for name, prog, decorated, eager, inputs, held in runs:
        eager_ms = []
        for _ in range(3):
            ref, ms, _, eager_n = timed(eager, inputs[0])
            eager_ms.append(ms)
        size0 = prog.cache_size()
        out, first_ms, _, first_n = timed(decorated, inputs[0])
        errs_first, finite = rel_errs(out, ref, held)
        first_captured = prog.cache_size() - size0
        _, capture_ms, _, _ = timed(decorated, inputs[0])
        replay_ms, replay_ev = [], []
        for _ in range(5):
            out, ms, ev_ms, replay_n = timed(decorated, inputs[0])
            replay_ms.append(ms)
            replay_ev.append(ev_ms)
        captures = prog.cache_size() - size0
        errs, finite_r = rel_errs(out, ref, held)
        dtype = str(out[0].dtype).removeprefix("torch.")
        rtol = SOLVER_RTOL[dtype]
        win = _device_window(lambda: decorated(inputs[0]))
        refill = None
        if len(inputs) > 1:
            # other inputs: the replay must read them from the refilled
            # buffers (its result moves) and match the eager body on them
            out2, _, _, _ = timed(decorated, inputs[1])
            ref2, _, _, _ = timed(eager, inputs[1])
            refill, finite2 = rel_errs(out2, ref2, held)
            moved = any(float((o - r).abs().max()) > 0 for o, r in zip(out2, ref))
            refill_ok = (finite2 and moved and all(e <= rtol for e in refill.values())
                         and prog.cache_size() - size0 == 1)
        # one replay runs what its capture record holds: the profiler's
        # kernels of the profiled replay, and the eager run's launches
        record = next(reversed(prog.cache.programs.values())).record
        record_n = record.launches
        # each call of the solver's operators lies in the graph, one
        # product a launch here
        products = (None if record.products is None else
                    [b - a for spans in record.products.values() for a, b in spans])
        measured = None
        if win is not None:
            measured = {c: sum(k for nm, k in win[1].items() if SOLVER_KERNELS.get(c, "\0") in nm)
                        for c in eager_n}
        ok = (finite and finite_r and all(e <= rtol for e in (*errs.values(), *errs_first.values()))
              and first_captured == 0 and first_n == eager_n and captures == 1
              and measured == eager_n == record_n and replay_n == {}
              and products is not None and len(products) == sum(eager_n.values())
              and min(products) > 0
              and eager_n.get("csr5_spmv", 0) + eager_n.get("csr5_spmv_relabel", 0) > 0
              and (name != "iterative_refinement" or eager_n.get("csr5_spmv_f64", 0) > 0)
              and (refill is None or refill_ok))
        failed += [] if ok else [f"solver {name}"]
        rep = {"dtype": dtype, "rel_err": errs, "rel_err_first_call": errs_first, "rtol": rtol,
               "rel_err_refill": refill, "launches_eager": eager_n, "launches_first_call": first_n,
               "launches_replay_profiled": measured, "launches_replay_record": record_n,
               "product_ops": products,
               "captures": captures, "eager_ms": eager_ms, "first_ms": first_ms,
               "capture_ms": capture_ms, "replay_ms": replay_ms,
               "replay_median_ms": float(np.median(replay_ms)),
               "replay_event_ms": float(np.median(replay_ev)),
               "eager_median_ms": float(np.median(eager_ms))}
        if win is None:
            dev_txt = "device time not measured (the profiler showed no device activity)"
        else:
            # the idle share is taken against the replay's own device time
            # (CUDA events, no profiler): tracing stretches the gaps between
            # a graph's kernels, so the profiler's span reads high
            by_name, _, busy, span, count = win
            k1 = sum(v for k, v in by_name.items() if SOLVER_KERNELS["csr5_spmv"] in k)
            k4 = sum(v for k, v in by_name.items() if SOLVER_KERNELS["csr5_spmv_f64"] in k)
            idle = 1.0 - busy / (1e3 * rep["replay_event_ms"])
            rep.update(kernel_us=sum(by_name.values()), k1_us=k1, k4_us=k4, busy_us=busy,
                       profiler_span_us=span, activities=count, idle_share=idle)
            dev_txt = (f"one replay on the device: {count} activities, kernels {rep['kernel_us']:.1f} "
                       f"µs (K1 {k1:.1f}, K4 {k4:.1f}), busy {busy:.1f} µs of the replay's "
                       f"{rep['replay_event_ms']:.3f} ms by CUDA events: idle {100 * idle:.1f} % "
                       f"(profiler span {span:.1f} µs)")
        report[name] = rep
        refill_txt = ("no tensor input to refill" if refill is None else
                      "other inputs " + ", ".join(f"{k} {v:.3g}" for k, v in refill.items()))
        say(f"[solver {name}, {dtype}] {'PASS' if ok else 'FAIL'}: vs eager body on the same inputs "
            f"(of the largest entry, limit {rtol:g}): first call "
            + ", ".join(f"{k} {v:.3g}" for k, v in errs_first.items()) + ", replay "
            + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()) + f", {refill_txt}; launches "
            f"eager {eager_n}, first call {first_n}, capture record {record_n}, profiled replay's "
            f"kernels {measured}; {len(products or ())} products in the record, device "
            f"operations each {sorted(set(products or ()))}; "
            f"{captures} capture; eager {rep['eager_median_ms']:.3f} ms, first call {first_ms:.3f} ms "
            f"(eager), second call {capture_ms:.3f} ms (warm-up, capture, replay), replay "
            f"{rep['replay_median_ms']:.3f} ms (median of 5: "
            f"{', '.join(f'{t:.3f}' for t in replay_ms)}); {dev_txt} [{card}]")

    # the cache's memory: a new lambda per solve never captures, and a kept
    # callable's program (graph and pool) goes when the callable dies
    cg = S.conjugate_gradient

    def solve(spmv):  # its result dies with the call
        cg(spmv, b32, iters=10)

    del out, ref, out2, ref2  # the last solver's results, freed before m0
    gc.collect()
    torch.cuda.synchronize()
    m0, size0 = torch.cuda.memory_allocated(dev), cg.cache_size()
    for _ in range(20):
        solve(lambda v: csr5_spmv(a32, v))
    torch.cuda.synchronize()
    m_fresh, size_fresh, seen = torch.cuda.memory_allocated(dev), cg.cache_size(), len(cg.cache.seen)
    kept = lambda v: csr5_spmv(a32, v)  # noqa: E731
    for _ in range(3):
        solve(kept)
    size_kept = cg.cache_size()
    del kept
    gc.collect()
    torch.cuda.synchronize()
    m_dropped, size_dropped = torch.cuda.memory_allocated(dev), cg.cache_size()
    ok = (m_fresh == m0 and size_fresh == size0 and m_dropped == m0 and size_kept == size0 + 1
          and size_dropped == size0)
    failed += [] if ok else ["solver cache memory"]
    say(f"[solver cache memory] {'PASS' if ok else 'FAIL'}: 20 CG solves with a new lambda each: "
        f"memory allocated {m_fresh - m0:+d} B, programs {size_fresh - size0:+d}, {seen} keys noted "
        f"once left; a kept lambda called 3 times: programs {size_kept - size0:+d}, then dropped with "
        f"it: {size_dropped - size0:+d} programs, memory allocated {m_dropped - m0:+d} B")
    report["cache_memory"] = {"fresh_bytes": m_fresh - m0, "dropped_bytes": m_dropped - m0}
    say(json.dumps({"solvers": report}))
    for _, prog, *_ in runs:
        prog.cache_clear()
    return report


def library_csr(a, dtype, dev):
    """The matrix as a ``torch.sparse_csr_tensor`` on ``dev``: the
    library yardstick's operand (cuSPARSE through PyTorch), used nowhere
    in the port."""
    import numpy as np
    import torch

    return torch.sparse_csr_tensor(
        torch.from_numpy(a.indptr.astype(np.int32)), torch.from_numpy(a.indices.astype(np.int32)),
        torch.from_numpy(a.data.astype(dtype)), size=a.shape, device=dev)


def device_us_per_call(fn, *args, n: int = 50):
    """Device time (us) of everything one call of ``fn`` launches, by
    torch.profiler over ``n`` calls; None when it shows no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(5):
        fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn(*args)
        torch.cuda.synchronize()
    total = sum(ev.device_time_total for ev in prof.key_averages())
    return total / n if total else None


def yardstick(dev, card, kind, df64, a64, mats):
    """K4 and its plain version at df64_banded500k, in turns, with its
    device time; the library call (``torch.sparse_csr_tensor @ x``) beside
    K1, K2, K4, K5, K6 and K7 on the same matrices and x; and every
    kernel's bound from this run's inputs. ``mats`` holds the inputs the
    earlier phases timed: name -> (matrix, x). Returns name -> (bound ms,
    bound_by, library ms) and K4's (ms, plain ms)."""
    import numpy as np
    import scipy.sparse as sp
    import torch

    from benchmark_spmv_using_csr5_tpu_torch.ops import csr5_f64
    from benchmark_spmv_using_csr5_tpu_torch.ops.csr5_spmv import csr5_spmv_torch
    from benchmark_spmv_using_csr5_tpu_torch.utils import perf, synth

    gbps = perf.device_hbm_gbps(kind)
    x64 = torch.from_numpy(np.random.default_rng(0).integers(1, 10, a64.n).astype(np.float64)).to(dev)
    band = sp.csr_matrix(synth.banded(500_000, 27)).astype(np.float32)
    A32, A64 = library_csr(band, np.float32, dev), library_csr(df64, np.float64, dev)
    mm = lambda A, v: A @ v  # noqa: E731
    # K4 in turns with cuSPARSE's float64 SpMV on the same matrix and x, then
    # with its plain version
    fns = {"k4": (csr5_f64.csr5_spmv_f64_cuda, a64, 100), "lib_f64": (mm, A64, 100),
           "k4_plain": (csr5_spmv_torch, a64, 20)}
    times = {k: [] for k in fns}
    for k in ("k4", "lib_f64", "lib_f64", "k4", "k4_plain", "k4", "k4", "k4_plain"):
        fn, mat, n = fns[k]
        times[k].append(perf.benchmark(fn, mat, x64, device=dev, num_run=n))
    k4_ms, k4_plain_ms, lib_f64_ms = (sum(times[k]) / len(times[k])
                                      for k in ("k4", "k4_plain", "lib_f64"))
    k4_lib = sum(times["k4"][:2]) / sum(times["lib_f64"])

    x = mats["csr5_spmv"][1]
    X8 = mats["csr5_spmm"][1]
    lib = {
        "spmv_f32": perf.benchmark(mm, A32, x, device=dev, num_run=100),
        "spmv_f64": lib_f64_ms,
        "spmm8_f32": perf.benchmark(mm, A32, X8, device=dev, num_run=100),
    }
    dev_us = {
        "k4": device_us(csr5_f64.csr5_spmv_f64_cuda, a64, x64, match="csr5_spmv_f64_tile_kernel"),
        "lib_spmv_f32": device_us_per_call(mm, A32, x),
        "lib_spmv_f64": device_us_per_call(mm, A64, x64),
        "lib_spmm8_f32": device_us_per_call(mm, A32, X8),
    }
    # bounds: each input read once, each output written once (perf.streamed_bytes)
    f32, f64p = PEAK_FLOPS["float32"], PEAK_FLOPS["float64"]
    sb = perf.streamed_bytes
    out = {}
    a5, xk1 = mats["csr5_spmv"]
    out["csr5_spmv"] = bound_ms(sb(a5, xk1), 2 * a5.nnz, gbps, f32) + (lib["spmv_f32"],)
    out["csr5_spmv_f64"] = bound_ms(sb(a64, x64), 2 * a64.nnz, gbps, f64p) + (lib["spmv_f64"],)
    d, xd = mats["dia_spmv"]
    # the DIA kernels multiply every element of the plane, zeros included
    out["dia_spmv"] = bound_ms(sb(d, xd), 2 * d.data.numel(), gbps, f32) + (lib["spmv_f32"],)
    d, X = mats["dia_spmm"]
    R = X.shape[1]
    out["dia_spmm"] = bound_ms(sb(d, X, R), 2 * d.data.numel() * R, gbps, f32) + (lib["spmm8_f32"],)
    a5, X = mats["csr5_spmm"]
    out["csr5_spmm"] = bound_ms(sb(a5, X, R), 2 * a5.nnz * R, gbps, f32) + (lib["spmm8_f32"],)
    bb, X = mats["bandmm_spmm"]
    out["bandmm_spmm"] = bound_ms(sb(bb, X, R), 2 * bb.dense.numel() * R, gbps,
                                  PEAK_FLOPS["bfloat16"]) + (lib["spmm8_f32"],)
    say(f"[df64_banded500k K4, {card}] turns (ms per call, event loop): "
        + ", ".join(f"{k} {v}" for k, v in times.items())
        + f"; K4 {k4_ms:.5f} ms, device {dev_us['k4']} us, bound {out['csr5_spmv_f64'][0] * 1e3:.2f} us "
        f"({perf.plane_bytes(a64) / 1e6:.1f} MB planes "
        f"+ x, y); plain {k4_plain_ms:.4f} ms; cuSPARSE float64 {lib_f64_ms:.5f} ms, device "
        f"{dev_us['lib_spmv_f64']} us")
    dev_ratio = (dev_us["k4"] / dev_us["lib_spmv_f64"]
                 if dev_us["k4"] and dev_us["lib_spmv_f64"] else None)
    say(f"[df64_banded500k K4 / cuSPARSE float64, in turns k4, lib, lib, k4] {k4_lib:.4f} per call "
        f"(event loop), {'not measured' if dev_ratio is None else f'{dev_ratio:.4f}'} in device "
        f"time [{card}]")
    say(f"[library yardstick, torch.sparse_csr_tensor @ dense, {card}] ms per call (event loop): "
        + ", ".join(f"{k} {v:.5f}" for k, v in lib.items())
        + "; device us per call: " + ", ".join(
            f"{k} {'not measured' if v is None else f'{v:.2f}'}" for k, v in dev_us.items()))
    say("[bounds, us] " + ", ".join(f"{k} {v[0] * 1e3:.2f} ({v[1]})" for k, v in out.items()))
    return out, (k4_ms, k4_plain_ms)


def _narrow(sp, np):
    """n = 100 < 128 columns, 700 rows whose first 300 are empty: sliced
    with a small cap, the all-empty slice takes the window (0, 128), past
    n (``tests/test_torch_bigslice.py``)."""
    rng = np.random.default_rng(1)
    rows = np.repeat(np.arange(300, 700), 5)
    cols = np.concatenate([rng.choice(100, 5, replace=False) for _ in range(400)])
    return sp.csr_matrix((np.ones(rows.size), (rows, cols)), shape=(700, 100))


def _tail_window(sp, np, synth):
    """A band over rows 0-1999 and rows 2000-2999 that touch only columns
    2950-2989 of n = 2990: the last slice's page-aligned window of 128
    columns reaches past n."""
    band = sp.csr_matrix(synth.banded(2000, 9))
    rng = np.random.default_rng(4)
    rows = np.repeat(np.arange(2000, 3000), 3)
    tail = sp.csr_matrix((np.ones(rows.size), (rows, rng.integers(2950, 2990, rows.size))),
                         shape=(3000, 2990))
    return (sp.vstack([sp.hstack([band, sp.csr_matrix((2000, 990))]),
                       sp.csr_matrix((1000, 2990))]) + tail).tocsr()


def large_sweep(dev, rng) -> list:
    """K1p, K2p and K3 against their plain versions on the card and
    against scipy on the odd shapes of phase 2 at sigma 16 and 32 (K1p and
    K2p: float32 and bfloat16 planes, R in SWEEP_RHS, both layouts; K1 on
    the raw plane of the same matrix too), K3 over forced multi-slice
    builds (small elem_cap: an empty slice, a window past n, empty rows,
    packed and raw slices, a mix of bfloat16 and float32 slices), exact on
    integer data at alpha 1 and -1.75; one random-float case each, within
    FLOAT_RTOL of each row's |A||x|."""
    import dataclasses

    import numpy as np
    import scipy.sparse as sp
    import torch

    from benchmark_spmv_using_csr5_tpu_torch import CSR5Config, build_csr5, build_csr5_sliced
    from benchmark_spmv_using_csr5_tpu_torch.ops import bigslice_kernel, csr5_kernel
    from benchmark_spmv_using_csr5_tpu_torch.ops.bigslice import sliced_spmv_torch
    from benchmark_spmv_using_csr5_tpu_torch.ops.csr5_spmv import (
        csr5_spmm_packed_torch, csr5_spmv_packed_torch,
    )
    from benchmark_spmv_using_csr5_tpu_torch.utils import synth

    alpha = -1.75
    rmax = max(SWEEP_RHS)
    failed = []
    cases = [(n, a, c, w) for n, a, c, w in sweep_cases(synth, CSR5Config)
             if c is not None and c.sigma in (16, 32)]
    for name, make in synth.EDGE_CASE_MATRICES.items():
        for sig in (16, 32):
            cases.append((f"edge_{name}_s{sig}", make(), CSR5Config(sigma=sig), "auto"))
    cases.append(("fem_small_s16", synth.fem_blocks(6000, neighbors=9, node_bandwidth=600),
                  CSR5Config(sigma=16), "auto"))
    packed_cases = 0
    modes = {"staged": [0, 0], "gathered": [0, 0]}  # mode -> [launches, exact ones]
    for name, a_sp, cfg, win_mode in cases:
        a = sp.csr_matrix(a_sp).astype(np.float32)
        x = rng.integers(1, 10, a.shape[1]).astype(np.float32)
        xm = rng.integers(1, 10, (a.shape[1], rmax)).astype(np.float32)
        xd, xmd = torch.from_numpy(x).to(dev), torch.from_numpy(xm).to(dev)
        for vdt in (torch.float32, torch.bfloat16):
            a5 = build_csr5((a.indptr, a.indices, a.data, a.shape), cfg, value_dtype=vdt,
                            win_mode=win_mode, keep_raw_cols=True, device=dev)
            tag = f"K1p/K2p {name}/{str(vdt).removeprefix('torch.')}"
            if a5.col_packed is None:
                say(f"[{tag}] no packed plane (pmax {a5.pmax} > 512): not a K1p case")
                continue
            packed_cases += 1
            raw = dataclasses.replace(a5, col_packed=None)
            errs = []
            for al in (1.0, alpha):
                y_k = csr5_kernel.csr5_spmv_cuda(a5, xd, al).cpu()
                y_p = csr5_spmv_packed_torch(a5, xd, al).cpu()
                y_1 = csr5_kernel.csr5_spmv_cuda(raw, xd, al).cpu()
                if not (_exact(y_k, y_p, torch.from_numpy((al * (a @ x)).astype(np.float32)))
                        and torch.equal(y_k, y_1)):
                    errs.append(f"K1p alpha={al}")
            for R in SWEEP_RHS:
                xr = xmd[:, :R].contiguous()
                y_nr, y_rn = _both_layouts(csr5_kernel.csr5_spmm_cuda, a5, xr, alpha)
                y_p = csr5_spmm_packed_torch(a5, xr, alpha).cpu()
                y_s = torch.from_numpy((alpha * (a @ xm[:, :R])).astype(np.float32))
                ok = _exact(y_nr, y_p, y_s) and torch.equal(y_rn, y_s)
                count_mode(modes, a5, R, ok)
                if not ok:
                    errs.append(f"K2p R={R}")
            failed += [f"{tag} {e}" for e in errs]
            say(f"[{tag}] {'PASS' if not errs else 'FAIL ' + ','.join(errs)} sigma={a5.sigma} "
                f"pmax={a5.pmax} contig={a5.pages_contig} tiles={a5.num_tiles} "
                f"win={'wrapped' if a5.win_rel else 'aligned'} K2p R {SWEEP_RHS} nr+rn, "
                f"chunk(8)={csr5_kernel.spmm_chunk(a5, 8)} modes {mode_list(a5)}")
    if packed_cases < 20:
        failed.append(f"only {packed_cases} packed K1p/K2p cases")
    failed += modes_ran("K2p", modes)

    # K3 over forced multi-slice builds
    mixed = sp.csr_matrix(synth.banded(4000, 9)).astype(np.float32)
    # 257 is not bfloat16-exact, so the slices over rows 3000+ keep float32
    # planes; at one value in four every tile prefix stays exact in float32
    mixed.data[mixed.indptr[3000]::4] = 257.0
    k3_cases = [  # name, matrix, elem_cap, sigma (None: the heuristic), value dtype
        ("banded4000_bw9", synth.banded(4000, 9), 3000, None, None),
        ("banded4000_bw27_s16", synth.banded(4000, 27), 3000, 16, None),
        ("banded4000_bw27_s24", synth.banded(4000, 27), 3000, 24, None),
        ("banded6000_bw33_s32", synth.banded(6000, 33), 6000, 32, None),
        ("scatband_s16", synth.scattered_band(3000, 16, 600), 2500, 16, None),
        ("narrow_empty_slice", _narrow(sp, np), 300, None, None),
        ("tail_window_past_n", _tail_window(sp, np, synth), 2000, None, None),
        ("mixed_bf16_f32", mixed, 3000, 16, "auto"),
    ]
    for name, a_sp, cap, sig, vdt0 in k3_cases:
        a = sp.csr_matrix(a_sp).astype(np.float32)
        x = rng.integers(1, 10, a.shape[1]).astype(np.float32)
        xd = torch.from_numpy(x).to(dev)
        cfg = None if sig is None else CSR5Config(sigma=sig)
        for vdt in ((vdt0,) if vdt0 else (torch.float32, torch.bfloat16)):
            sl = build_csr5_sliced(a, cfg, value_dtype=vdt, elem_cap=cap, device=dev)
            tag = f"K3 {name}/{vdt if isinstance(vdt, str) else str(vdt).removeprefix('torch.')}"
            if sl is None or sl.num_slices < 3:
                failed.append(f"{tag}: not sliced into 3 or more")
                say(f"[{tag}] FAIL: build gave {None if sl is None else sl.num_slices} slices")
                continue
            errs = []
            for al in (1.0, alpha):
                y_k = bigslice_kernel.sliced_spmv_cuda(sl, xd, al).cpu()
                y_p = sliced_spmv_torch(sl, xd, al).cpu()
                if not _exact(y_k, y_p, torch.from_numpy((al * (a @ x)).astype(np.float32))):
                    errs.append(f"alpha={al}")
            packed = sum(s.col_packed is not None for s in sl.slices)
            dts = sorted({str(s.val_tiles.dtype).removeprefix("torch.") for s in sl.slices})
            if name == "mixed_bf16_f32" and len(dts) != 2:
                errs.append("the slices are not of both dtypes")
            failed += [f"{tag} {e}" for e in errs]
            say(f"[{tag}] {'PASS' if not errs else 'FAIL ' + ','.join(errs)} shape={a.shape} "
                f"slices={sl.num_slices} sigma={sl.sigma} packed slices={packed} planes={dts} "
                f"windows={[(c0, s.n) for c0, s in zip(sl.col_starts, sl.slices)]}")

    # random floats: K1p and K2p sum as K1 and K2 do; K3 as K1 per slice
    a = sp.csr_matrix(synth.scattered_band(20_000, 20, 4000)).astype(np.float32)
    a.data = rng.uniform(-1, 1, a.nnz).astype(np.float32)
    xm = rng.uniform(-1, 1, (a.shape[1], 5)).astype(np.float32)
    xmd = torch.from_numpy(xm).to(dev)
    y64 = torch.from_numpy(a.astype(np.float64) @ xm.astype(np.float64))
    row_abs = torch.from_numpy(abs(a).astype(np.float64) @ np.abs(xm).astype(np.float64))
    lim = FLOAT_RTOL * row_abs + 1e-30
    a5 = build_csr5(a, CSR5Config(sigma=16), device=dev)
    sl = build_csr5_sliced(a, CSR5Config(sigma=16), elem_cap=12_000, device=dev)
    x0 = xmd[:, 0].contiguous()
    runs = {
        "K1p": (csr5_kernel.csr5_spmv_cuda(a5, x0)[:, None], csr5_spmv_packed_torch(a5, x0)[:, None], 1),
        "K2p": (csr5_kernel.csr5_spmm_cuda(a5, xmd), csr5_spmm_packed_torch(a5, xmd), 5),
        "K3": (bigslice_kernel.sliced_spmv_cuda(sl, x0)[:, None], sliced_spmv_torch(sl, x0)[:, None], 1),
    }
    for k, (y_k, y_p, R) in runs.items():
        y_k, y_p = y_k.double().cpu(), y_p.double().cpu()
        ok = bool(((y_k - y_p).abs() <= lim[:, :R]).all() and ((y_k - y64[:, :R]).abs() <= lim[:, :R]).all())
        ok = ok and a5.col_packed is not None and sl.num_slices >= 3
        failed += [] if ok else [f"{k} random_floats"]
        say(f"[{k} random_floats rtol={FLOAT_RTOL} of row |A||x|] {'PASS' if ok else 'FAIL'} "
            f"bit-equal to plain: {torch.equal(y_k, y_p)} "
            f"max|k-f64|/rowabs={float(((y_k - y64[:, :R]).abs() / row_abs[:, :R]).max()):.3g}")
    return failed


def _peak_rss_gb() -> float:
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6  # KiB on Linux


def large_path(dev, failed):
    """The large-matrix path at full width through the CLI's and the API's
    own code, with every kernel count set to 0 just before and read just
    after: banded2M on CSR5 (K1); banded20M (20,000,000 rows) sliced (K3)
    and as one whole-matrix K1 pass (``backend="cuda"``); banded500k at
    sigma 16 (K1p); fem3block600k autotuned (sigma 16, K1p); ``--spmm 8``
    at sigma 16 (K2p); the SpMVHandle at banded20M (K3). Returns (results by
    name, launches, max |kernel - plain| by kernel, the banded20M matrix)."""
    import numpy as np
    import torch

    from benchmark_spmv_using_csr5_tpu_torch import SpMVHandle
    from benchmark_spmv_using_csr5_tpu_torch.bench import cli, harness
    from benchmark_spmv_using_csr5_tpu_torch.ops.bigslice import sliced_spmv_torch
    from benchmark_spmv_using_csr5_tpu_torch.ops.csr5_spmv import (
        csr5_spmm_packed_torch, csr5_spmv_packed_torch, csr5_spmv_torch,
    )
    from benchmark_spmv_using_csr5_tpu_torch.utils import cuda_build, synth

    t0 = time.perf_counter()
    args20 = cli.parse_args(["--synthetic", "banded:20000000:27"])
    rp20, ci20, v20, shape20, name20 = cli.load_matrix(args20)
    fem = synth.fem_blocks(600_000)
    say(f"[large path] banded20M {shape20} nnz {len(v20)} and fem3block600k generated in "
        f"{time.perf_counter() - t0:.1f} s; peak RSS {_peak_rss_gb():.1f} GB")
    band = ["--synthetic", "banded:500000:27", "--sigma", "16"]
    runs = [  # name, the kernel it must launch, how
        ("banded2M", "csr5_spmv", lambda: cli.run(["--synthetic", "banded:2000000:27"])),
        ("banded20M", "csr5_sliced", lambda: cli.run_matrix(args20, name20, rp20, ci20, v20, shape20)),
        ("banded20M_whole", "csr5_spmv", lambda: harness.run_benchmark(
            "banded20M_whole", rp20, ci20, v20, shape20, backend="cuda")),
        ("banded500k_s16", "csr5_spmv_packed", lambda: cli.run(band)),
        ("fem3block600k", "csr5_spmv_packed", lambda: cli.run_matrix(
            cli.parse_args(["--autotune"]), "fem3block600k", fem.indptr, fem.indices, fem.data,
            fem.shape)),
        ("spmm8_s16", "csr5_spmm_packed", lambda: cli.run(band + ["--spmm", "8"])),
    ]
    spmv_keys = ("csr5_spmv", "csr5_spmv_packed", "csr5_sliced")
    keys = spmv_keys + ("csr5_spmm", "csr5_spmm_packed")
    cuda_build.launches.update(dict.fromkeys(keys, 0))
    results, secs = {}, {}
    for name, _, go in runs:
        t0 = time.perf_counter()
        results[name] = go()
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        say(f"[large path] {name}: {secs[name]:.1f} s, peak RSS {_peak_rss_gb():.1f} GB, "
            f"device memory peak {torch.cuda.max_memory_allocated() / 1e9:.1f} GB")

    # the handle at banded20M: inputCSR -> asCSR5 (the row-sliced form) -> spmv
    t0 = time.perf_counter()
    h = SpMVHandle(*shape20)
    h.inputCSR(len(v20), rp20, ci20, v20).asCSR5()
    xh = np.random.default_rng(11).integers(1, 10, shape20[1]).astype(np.float32)
    k3_0 = cuda_build.launches["csr5_sliced"]
    yh = h.setX(xh).spmv(-1.75)
    torch.cuda.synchronize()
    k3_h = cuda_build.launches["csr5_sliced"] - k3_0
    launches = {k: cuda_build.launches[k] for k in keys}
    import scipy.sparse as sp

    a20 = sp.csr_matrix((v20, ci20, rp20), shape=shape20)
    ok = (h.csr5 is None and h.csr5_sliced is not None and k3_h == 1
          and torch.equal(yh.cpu(), torch.from_numpy((-1.75 * (a20 @ xh)).astype(np.float32))))
    nsl = h.csr5_sliced.num_slices if h.csr5_sliced is not None else 0
    h.asCSR()
    ok = ok and h.csr5_sliced is None and h.destroy() == 0
    del h, yh
    torch.cuda.empty_cache()
    failed += [] if ok else ["handle banded20M"]
    say(f"[SpMVHandle banded20M] {'PASS' if ok else 'FAIL'}: inputCSR -> asCSR5 ({nsl} row slices) "
        f"-> setX -> spmv(-1.75) == scipy with {k3_h} K3 launch, asCSR drops the slices, destroy() "
        f"= 0; {time.perf_counter() - t0:.1f} s")

    err = {k: 0.0 for k in keys}
    for name, want, _ in runs:
        r = results[name]
        say(r.report())
        R = r.num_rhs
        good = (
            r.check_ok and r.max_rel_err == 0.0
            and r.backend == ("cuda-sliced" if want == "csr5_sliced" else "cuda")
            and r.launches[want] > 0 and r.storage == "bfloat16"
            and tuple(r.y.shape) == ((r.m,) if R == 1 else (r.m, R))
            and bool(torch.isfinite(r.y).all())
        )
        if R == 1:  # the one SpMV kernel that must run, and no other
            good = good and all(r.launches[k] == 0 for k in spmv_keys if k != want)
        if name == "fem3block600k":
            good = good and r.sigma == 16
        if not good:
            failed.append(name)
        # the kernel's y from the run against its plain version, same x
        x = np.random.default_rng(0).integers(1, 10, (r.n, R) if R > 1 else r.n)
        xd = torch.from_numpy(x.astype(np.float32)).to(dev)
        plain = {"csr5_spmv": csr5_spmv_torch, "csr5_spmv_packed": csr5_spmv_packed_torch,
                 "csr5_sliced": sliced_spmv_torch, "csr5_spmm_packed": csr5_spmm_packed_torch}[want]
        y_p = plain(r.matrix, xd)
        e = float((r.y - y_p).abs().max())
        err[want] = max(err[want], e)
        exact = torch.equal(r.y, y_p)
        del y_p
        say(f"[{name}] launches {dict((k, r.launches[k]) for k in keys)}; kernel y vs plain on the "
            f"card: max abs err {e} {'PASS' if exact else 'FAIL'}; {secs[name]:.1f} s")
        if not exact:
            failed.append(f"{name} vs plain")
    torch.cuda.empty_cache()
    say("large-matrix path launches: " + ", ".join(f"{k} {v}" for k, v in launches.items()))
    for k in ("csr5_spmv", "csr5_spmv_packed", "csr5_sliced", "csr5_spmm_packed"):
        if launches[k] == 0:
            failed.append(f"no {k} launch on the large-matrix path")
    return results, launches, err, a20


def large_turns(dev, card, kind, res, a20, band500k):
    """K3 against one whole-matrix K1 pass at banded20M, K1p against K1 on
    the raw plane of the same banded500k sigma-16 matrix, and K2p against K2
    at R = 8 there: in turns (kernel, other, other, kernel), each plain
    version, device times by torch.profiler, the cuSPARSE yardstick
    (``torch.sparse_csr_tensor @ x``) on the same matrix and x, and each
    kernel's bound from this run's inputs. Returns name -> (ms, plain ms,
    bound ms, bound_by, library ms)."""
    import dataclasses

    import numpy as np
    import torch

    from benchmark_spmv_using_csr5_tpu_torch.models.formats import col_tiles_of
    from benchmark_spmv_using_csr5_tpu_torch.ops import bigslice_kernel, csr5_kernel
    from benchmark_spmv_using_csr5_tpu_torch.ops.bigslice import sliced_spmv_torch
    from benchmark_spmv_using_csr5_tpu_torch.ops.csr5_spmv import (
        csr5_spmm_packed_torch, csr5_spmv_packed_torch, csr5_spmv_torch,
    )
    from benchmark_spmv_using_csr5_tpu_torch.utils import perf

    gbps = perf.device_hbm_gbps(kind)
    f32 = PEAK_FLOPS["float32"]
    mm = lambda A, v: A @ v  # noqa: E731

    def turns(fns, order):
        times = {k: [] for k in fns}
        for k in order + order[::-1]:
            fn, mat, x, n = fns[k]
            times[k].append(perf.benchmark(fn, mat, x, device=dev, warmup=3, num_run=n))
        return times, {k: sum(v) / len(v) for k, v in times.items()}

    planes, sb = perf.plane_bytes, perf.streamed_bytes
    out = {}
    # --- banded20M: K3 over the slices against one K1 pass ---------------------
    sl, whole = res["banded20M"].matrix, res["banded20M_whole"].matrix
    x20 = torch.from_numpy(np.random.default_rng(0).integers(1, 10, sl.n).astype(np.float32)).to(dev)
    fns = {
        "k3": (bigslice_kernel.sliced_spmv_cuda, sl, x20, 20),
        "k1_whole": (csr5_kernel.csr5_spmv_cuda, whole, x20, 20),
        "k3_plain": (sliced_spmv_torch, sl, x20, 2),
        "k1_whole_plain": (csr5_spmv_torch, whole, x20, 2),
    }
    times, t = turns(fns, ["k3", "k1_whole", "k3_plain", "k1_whole_plain"])
    dev_us = {
        "k3": device_us(bigslice_kernel.sliced_spmv_cuda, sl, x20, match="csr5_sliced_kernel", n=20),
        "k1_whole": device_us(csr5_kernel.csr5_spmv_cuda, whole, x20, match="csr5_spmv_tile_kernel", n=20),
    }
    A20 = library_csr(a20, np.float32, dev)
    lib20 = perf.benchmark(mm, A20, x20, device=dev, warmup=3, num_run=20)
    lib20_us = device_us_per_call(mm, A20, x20, n=20)
    del A20
    torch.cuda.empty_cache()
    b3 = bound_ms(sb(sl, x20), 2 * sl.nnz, gbps, f32)
    b1 = bound_ms(sb(whole, x20), 2 * whole.nnz, gbps, f32)
    out["csr5_sliced"] = (t["k3"], t["k3_plain"], *b3, lib20)
    say(f"[banded20M K3 vs K1, {card}] turns (ms per call, event loop): "
        + ", ".join(f"{k} {v}" for k, v in times.items()))
    say(f"[banded20M K3 vs K1] K3 ({sl.num_slices} slices, one launch) {t['k3']:.5f} ms, device "
        f"{dev_us['k3']} us; whole-matrix K1 {t['k1_whole']:.5f} ms, device {dev_us['k1_whole']} us; "
        f"K3/K1 = {t['k3'] / t['k1_whole']:.4f}; bound K3 {b3[0] * 1e3:.1f} us ({b3[1]}, "
        f"{planes(sl) / 1e9:.3f} GB planes + x, y), K1 {b1[0] * 1e3:.1f} us "
        f"({planes(whole) / 1e9:.3f} GB planes + x, y); plain K3 {t['k3_plain']:.3f} ms, plain K1 "
        f"{t['k1_whole_plain']:.3f} ms; cuSPARSE {lib20:.5f} ms (device {lib20_us} us) [{card}]")

    # --- banded500k at sigma 16: K1p against K1 on the raw plane ---------------
    a5p = res["banded500k_s16"].matrix
    # the same matrix with the raw plane (dropped beside col_packed) for K1
    a5r = dataclasses.replace(a5p, col_packed=None, col_idx_tiles=col_tiles_of(a5p).contiguous())
    x = torch.from_numpy(np.random.default_rng(0).integers(1, 10, a5p.n).astype(np.float32)).to(dev)
    x8 = torch.from_numpy(np.random.default_rng(0).integers(1, 10, (a5p.n, 8)).astype(np.float32)).to(dev)
    fns = {
        "k1p": (csr5_kernel.csr5_spmv_cuda, a5p, x, 100),
        "k1_raw": (csr5_kernel.csr5_spmv_cuda, a5r, x, 100),
        "k1p_plain": (csr5_spmv_packed_torch, a5p, x, 10),
        "k2p": (csr5_kernel.csr5_spmm_cuda, a5p, x8, 100),
        "k2_raw": (csr5_kernel.csr5_spmm_cuda, a5r, x8, 100),
        "k2p_plain": (csr5_spmm_packed_torch, a5p, x8, 3),
    }
    times, t = turns(fns, ["k1p", "k1_raw", "k1p_plain", "k2p", "k2_raw", "k2p_plain"])
    dev_us = {
        "k1p": device_us(csr5_kernel.csr5_spmv_cuda, a5p, x, match="csr5_spmv_packed_kernel"),
        "k1_raw": device_us(csr5_kernel.csr5_spmv_cuda, a5r, x, match="csr5_spmv_tile_kernel"),
        "k2p": device_us(csr5_kernel.csr5_spmm_cuda, a5p, x8, match="csr5_spmm_packed_kernel"),
        "k2_raw": device_us(csr5_kernel.csr5_spmm_cuda, a5r, x8, match="csr5_spmm_tile_kernel"),
    }
    say(residency_line("K1p", a5p, x, dev_us["k1p"], K1P_US_BEFORE, card))
    say(residency_line("K1 on the raw plane, sigma 16", a5r, x, dev_us["k1_raw"], K1_US_BEFORE,
                       card))
    A = library_csr(band500k, np.float32, dev)
    lib1 = perf.benchmark(mm, A, x, device=dev, num_run=100)
    lib8 = perf.benchmark(mm, A, x8, device=dev, num_run=100)
    bp = bound_ms(sb(a5p, x), 2 * a5p.nnz, gbps, f32)
    br = bound_ms(sb(a5r, x), 2 * a5r.nnz, gbps, f32)
    b2p = bound_ms(sb(a5p, x8, 8), 16 * a5p.nnz, gbps, f32)
    b2r = bound_ms(sb(a5r, x8, 8), 16 * a5r.nnz, gbps, f32)
    out["csr5_spmv_packed"] = (t["k1p"], t["k1p_plain"], *bp, lib1)
    out["csr5_spmm_packed"] = (t["k2p"], t["k2p_plain"], *b2p, lib8)
    say(f"[banded500k sigma 16 K1p vs K1, K2p vs K2, {card}] turns (ms per call, event loop): "
        + ", ".join(f"{k} {v}" for k, v in times.items()))
    say(f"[banded500k sigma 16] K1p {t['k1p']:.5f} ms (device {dev_us['k1p']} us, bound "
        f"{bp[0] * 1e3:.2f} us on {planes(a5p) / 1e6:.1f} MB planes) vs K1 on the raw plane "
        f"{t['k1_raw']:.5f} ms (device {dev_us['k1_raw']} us, bound {br[0] * 1e3:.2f} us on "
        f"{planes(a5r) / 1e6:.1f} MB); R=8: K2p ({csr5_kernel.spmm_mode(a5p, 8)}) {t['k2p']:.5f} ms "
        f"(device {dev_us['k2p']} us, bound {b2p[0] * 1e3:.2f} us) vs K2 "
        f"({csr5_kernel.spmm_mode(a5r, 8)}) {t['k2_raw']:.5f} ms (device {dev_us['k2_raw']} us, "
        f"bound {b2r[0] * 1e3:.2f} us); plain K1p {t['k1p_plain']:.4f}, K2p {t['k2p_plain']:.4f} ms; "
        f"cuSPARSE SpMV {lib1:.5f}, SpMM R=8 {lib8:.5f} ms; pmax {a5p.pmax}, tiles {a5p.num_tiles} "
        f"[{card}]")
    return out


def suite_phase(failed) -> dict:
    """Phase 16: the suite in a subprocess, its standard output relayed and
    its record checked case by case. Returns its launches by kernel."""
    from benchmark_spmv_using_csr5_tpu_torch.bench.suite import CASES

    out_path = os.path.join(ROOT, "chiprun_out", "bench_torch_full.json")
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "benchmark_spmv_using_csr5_tpu_torch.bench.suite", "--out", out_path],
        cwd=ROOT, stdout=subprocess.PIPE, text=True,
    )
    cases = {}
    for line in proc.stdout:
        say(f"[suite] {line.rstrip()}")
        try:
            rec = json.loads(line)
        except ValueError:
            continue
        if "name" in rec:
            cases[rec["name"]] = rec
    rc = proc.wait()
    launches = {}
    for name in CASES:
        r = cases.get(name)
        errs = []
        if r is None or "error" in r:
            errs.append("did not land" if r is None else r["error"])
        else:
            rel = r.get("max_rel_err")
            if not r.get("check_ok"):
                errs.append("check_ok false")
            if name == "df64_banded500k" and not rel <= 1e-12:
                errs.append(f"max rel err {rel} > 1e-12")
            if name == "spmmf8_banded500k" and not (rel <= 1e-4 and r["bf16_forced_rel_err"] <= 1e-2):
                errs.append(f"rel {rel} (1e-4), forced bfloat16 {r['bf16_forced_rel_err']} (1e-2)")
            if name not in SUITE_FLOAT_CASES and rel != 0.0:
                errs.append(f"max rel err {rel} on integer data")
            pct = r.get("pct_hbm_streamed")
            if pct is None or (pct > 100.0 and not r.get("l2_resident")):
                errs.append(f"{pct} % of HBM from the streamed bytes")
            for k, v in r.get("launches", {}).items():
                launches[k] = launches.get(k, 0) + v
        failed += [f"suite {name}: {e}" for e in errs]
        if errs:
            say(f"[suite {name}] FAIL {errs}")
    if rc != 0:
        failed.append(f"suite exit code {rc}")
    say(f"[suite] {len(cases)} of {len(CASES)} cases in {time.perf_counter() - t0:.1f} s, exit code "
        f"{rc}; launches {launches}; record {os.path.relpath(out_path, ROOT)}")
    return launches


def _load_example(name: str):
    import importlib.util

    path = os.path.join(ROOT, "examples", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def persistence_phase(dev, failed) -> int:
    """Phase 17: a CSR5 (bfloat16 plane, banded500k) and a DIA
    (tridiagonal 500k) checkpoint saved from the card and loaded back onto
    it, y through K1 and K5 bit-equal to before; ``tile_to_string`` of one
    tile; both examples at their default sizes. Returns the K1 launches
    of the examples' run."""
    import tempfile

    import numpy as np
    import torch

    from benchmark_spmv_using_csr5_tpu_torch import build_csr5, build_dia
    from benchmark_spmv_using_csr5_tpu_torch.models.formats import PLANE_FIELDS
    from benchmark_spmv_using_csr5_tpu_torch.ops import csr5_kernel, dia_kernel
    from benchmark_spmv_using_csr5_tpu_torch.utils import checkpoint, cuda_build, debug, synth

    band = synth.banded(500_000, 27, dtype=np.float32)
    tri = synth.banded(500_000, 3, dtype=np.float32)
    x = torch.from_numpy(np.random.default_rng(0).integers(1, 10, 500_000).astype(np.float32)).to(dev)
    with tempfile.TemporaryDirectory() as d:
        a5 = build_csr5(band, value_dtype=torch.bfloat16, device=dev)
        y0 = csr5_kernel.csr5_spmv_cuda(a5, x)
        p = os.path.join(d, "banded500k.npz")
        t0 = time.perf_counter()
        checkpoint.save_csr5(p, a5)
        t1 = time.perf_counter()
        b5 = checkpoint.load_csr5(p, device=dev)
        t2 = time.perf_counter()
        same = all(
            (getattr(a5, f) is None and getattr(b5, f) is None)
            or torch.equal(getattr(a5, f), getattr(b5, f)) for f in PLANE_FIELDS
        )
        ok = (same and b5.val_tiles.dtype == torch.bfloat16 and b5.device == a5.device
              and torch.equal(csr5_kernel.csr5_spmv_cuda(b5, x), y0))
        failed += [] if ok else ["csr5 checkpoint"]
        say(f"[checkpoint CSR5 banded500k, bfloat16 plane] {'PASS' if ok else 'FAIL'}: "
            f"{os.path.getsize(p) / 1e6:.1f} MB file, save {t1 - t0:.2f} s, load {t2 - t1:.2f} s, "
            f"planes equal {same}, K1 y bit-equal to before")
        say("[tile_to_string, banded500k tile 1]\n" + debug.tile_to_string(b5, 1))
        del a5, b5

        dm = build_dia(tri, device=dev)
        y0 = dia_kernel.dia_spmv_cuda(dm, x)
        p = os.path.join(d, "tridiag500k.npz")
        checkpoint.save_dia(p, dm)
        back = checkpoint.load_dia(p, device=dev)
        ok = (torch.equal(back.data, dm.data) and back.offsets == dm.offsets
              and torch.equal(back.offsets_t, dm.offsets_t)
              and torch.equal(dia_kernel.dia_spmv_cuda(back, x), y0))
        failed += [] if ok else ["dia checkpoint"]
        say(f"[checkpoint DIA tridiagonal 500k] {'PASS' if ok else 'FAIL'}: {back.ndiag} diagonals, "
            f"offsets_t rebuilt, K5 y bit-equal to before")

    cuda_build.launches["csr5_spmv"] = 0
    cg = _load_example("poisson_cg_torch").main([])
    pr = _load_example("pagerank_torch").main([])
    torch.cuda.synchronize()
    k1 = cuda_build.launches["csr5_spmv"]
    ok = (np.isfinite(cg["rel_residual"]) and cg["rel_residual"] < 1.0
          and abs(pr["mass"] - 1.0) <= 1e-5 and k1 > 0)
    failed += [] if ok else ["examples"]
    say(f"[examples] {'PASS' if ok else 'FAIL'}: poisson_cg_torch |r|/|b| {cg['rel_residual']:.3e} in "
        f"{cg['seconds']:.3f} s; pagerank_torch mass {pr['mass']:.7f} in {pr['seconds']:.3f} s; "
        f"{k1} K1 launches")
    return k1


def _planes_equal(a5, b5, ragged_eo: bool) -> list:
    """The fields where two CSR5 matrices differ: every plane bit for bit
    (uint32 through its int32 view) and every static field; with
    ``ragged_eo``, ``b5``'s ragged empty-offset table must sit in
    ``a5``'s padded one, tile by tile."""
    import torch

    from benchmark_spmv_using_csr5_tpu_torch.models.formats import PLANE_FIELDS, STATIC_FIELDS

    bad = [f for f in STATIC_FIELDS if getattr(a5, f) != getattr(b5, f)]
    for f in PLANE_FIELDS:
        if ragged_eo and f in ("empty_offset", "empty_offset_ptr"):
            continue
        s, t = getattr(a5, f), getattr(b5, f)
        if s is None or t is None:
            bad += [] if s is t else [f]
            continue
        as_i = (lambda u: u.view(torch.int32)) if s.dtype == torch.uint32 else (lambda u: u)
        if s.dtype != t.dtype or s.shape != t.shape or not torch.equal(as_i(s), as_i(t)):
            bad.append(f)
    if ragged_eo:
        w = a5.empty_offset.shape[0] // a5.num_tiles
        table = a5.empty_offset.view(a5.num_tiles, w).cpu()
        ptr, eo = b5.empty_offset_ptr.cpu(), b5.empty_offset.cpu()
        for t in torch.nonzero(b5.tile_dirty.cpu()).flatten().tolist():
            vals = eo[ptr[t]: ptr[t + 1]]
            if not torch.equal(table[t, : len(vals)], vals) or table[t, len(vals):].any():
                bad.append(f"empty_offset tile {t}")
                break
    return bad


def conversion_phase(dev, card, failed) -> dict:
    """Phase 18: CSR -> CSR5 on the card (``ops/convert_device.py``) from
    CSR tensors already there, at banded500k, banded2M, fem3block600k
    (sigma 16: col_packed, K1p), powerlaw200k (dirty tiles, page lists),
    scatband300k (page lists) and banded20M (560M nonzeros, one form):
    every plane bit-equal to the host build's (raw columns kept), y
    through K1/K1p exactly equal to the host-built matrix's and to scipy
    on integer data, and the times: the device build in three parts
    (statics on the host, upload, device stages) beside the host build,
    with the card's peak memory. Then the two column routes of the host
    build at banded2M and banded20M in turns (raw upload, 2 B/nnz codes
    decoded on the card, decoded, raw): the rebuilt plane bit-equal to the
    raw one. Returns the K1 and K1p launches of the phase."""
    import numpy as np
    import scipy.sparse as sp
    import torch

    from benchmark_spmv_using_csr5_tpu_torch import CSR5Config, build_csr5
    from benchmark_spmv_using_csr5_tpu_torch.ops import convert
    from benchmark_spmv_using_csr5_tpu_torch.ops.convert_device import build_csr5_device, plan_statics
    from benchmark_spmv_using_csr5_tpu_torch.ops.csr5_spmv import csr5_spmv
    from benchmark_spmv_using_csr5_tpu_torch.utils import cuda_build, synth

    def sync_ms(t0):
        torch.cuda.synchronize(dev)
        return (time.perf_counter() - t0) * 1e3

    mats = [  # name, factory, sigma (None: the heuristic)
        ("banded500k", lambda: synth.banded(500_000, 27, dtype=np.float32), None),
        ("banded2M", lambda: synth.banded(2_000_000, 27, dtype=np.float32), None),
        ("fem3block600k", lambda: synth.fem_blocks(600_000), 16),
        ("powerlaw200k", lambda: synth.power_law(200_000, 200_000, 8.0, dtype=np.float32), None),
        ("scatband300k", lambda: synth.scattered_band(300_000, 16, 6000, dtype=np.float32), None),
        ("banded20M", lambda: synth.banded(20_000_000, 27, dtype=np.float32), None),
    ]
    keys = ("csr5_spmv", "csr5_spmv_packed")
    cuda_build.launches.update(dict.fromkeys(keys, 0))
    for name, make, sig in mats:
        a = sp.csr_matrix(make()).astype(np.float32)
        host = (a.indptr, a.indices, a.data, a.shape)
        cfg = None if sig is None else CSR5Config(sigma=sig)
        t0 = time.perf_counter()
        a5h = build_csr5(host, cfg, keep_raw_cols=True, device=dev)
        host_ms = sync_ms(t0)
        t0 = time.perf_counter()
        st = plan_statics(a.indptr, a.indices, a.shape, cfg)
        statics_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        rp = torch.from_numpy(a.indptr.astype(np.int64)).to(dev)
        ci = torch.from_numpy(a.indices.astype(np.int32)).to(dev)
        v = torch.from_numpy(a.data).to(dev)
        upload_ms = sync_ms(t0)
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        a5d = build_csr5_device(rp, ci, v, st, device=dev)
        stages_ms = sync_ms(t0)
        peak_gb = (torch.cuda.max_memory_allocated(dev) - base) / 1e9
        del rp, ci, v
        bad = _planes_equal(a5d, a5h, ragged_eo=True)
        x = np.random.default_rng(0).integers(1, 10, a.shape[1]).astype(np.float32)
        xd = torch.from_numpy(x).to(dev)
        y_d, y_h = csr5_spmv(a5d, xd).cpu(), csr5_spmv(a5h, xd).cpu()
        exact = torch.equal(y_d, y_h) and torch.equal(y_d, torch.from_numpy(a @ x))
        kernel = "K1p" if a5d.col_packed is not None else "K1"
        ok = not bad and exact
        failed += [] if ok else [f"device conversion {name}: planes {bad}, y exact {exact}"]
        say(f"[device conversion {name}] {'PASS' if ok else 'FAIL'}: nnz {a.nnz}, sigma {a5d.sigma}, "
            f"pages {'contig' if a5d.pages_contig else 'list'} pmax {a5d.pmax}, dirty tiles "
            f"{int(a5d.tile_dirty.sum())}, every plane bit-equal to the host build "
            f"({'ok' if not bad else bad}), y through {kernel} equal to the host-built matrix's and "
            f"to scipy: {exact}; device build {statics_ms + upload_ms + stages_ms:.1f} ms = statics "
            f"{statics_ms:.1f} (host) + upload {upload_ms:.1f} + device stages {stages_ms:.1f}, "
            f"device peak {peak_gb:.2f} GB above the inputs; host build (raw columns kept) "
            f"{host_ms:.1f} ms {dict((k, round(w, 1)) for k, w in convert.last_convert_phases.items())} "
            f"[{card}]")
        del a5d, y_d, y_h
        if name in ("banded2M", "banded20M"):
            del a5h
            routes, cols = {"raw": [], "decode": []}, {}
            for route in ("raw", "decode", "decode", "raw"):
                torch.cuda.empty_cache()
                t0 = time.perf_counter()
                b5 = build_csr5(host, cfg, keep_raw_cols=route == "raw", device=dev)
                ms = sync_ms(t0)
                routes[route].append((ms, dict(convert.last_convert_phases)))
                cols[route] = b5.col_idx_tiles
                del b5
            took = all("decode" in ph for _, ph in routes["decode"])
            same = took and torch.equal(cols["raw"], cols["decode"])
            failed += [] if same else [f"column routes {name}: decode taken {took}, bit-equal {same}"]
            fmt = lambda r: ", ".join(  # noqa: E731
                f"{ms:.1f} ms (" + ", ".join(f"{k} {w:.1f}" for k, w in ph.items()
                                             if k in ("plan", "transpose", "upload", "decode", "upload_mb"))
                + ")" for ms, ph in r)
            say(f"[column routes {name}] {'PASS' if same else 'FAIL'}: raw int32 upload "
                f"(keep_raw_cols=True) {fmt(routes['raw'])}; 2 B/nnz codes decoded on the card "
                f"{fmt(routes['decode'])}; rebuilt plane bit-equal to the raw one: {same} [{card}]")
            del cols
            a5h = None
        del a5h
        torch.cuda.empty_cache()
    torch.cuda.synchronize(dev)
    launches = {k: cuda_build.launches[k] for k in keys}
    say(f"device conversion launches: {launches}")
    for k, n in launches.items():
        if n == 0:
            failed.append(f"no {k} launch in the device-conversion phase")
    return launches


def distribution_phase(dev, card, failed) -> dict:
    """Phase 19: the distributed layer at D = 1 on NCCL, in a process
    group of one rank (a FileStore: no network): ``distribute_csr`` with
    halo none/auto and convert host/device at banded500k (the device
    route required), ``distributed_spmv`` through K1 on wrapped (host) and
    aligned (device) maps, ``distributed_spmm`` at R = 8 through K2,
    ``distribute_dia`` with ``distributed_dia_spmv``/``_spmm`` through K5
    and K6, each exact against scipy and its single-card counterpart;
    ``weak_scaling([1])``, the all-gather floor and the projection; then
    the example at its default size. Returns the launches of the phase."""
    import numpy as np
    import scipy.sparse as sp
    import torch
    import torch.distributed as dist

    from benchmark_spmv_using_csr5_tpu_torch import build_csr5, build_dia, csr5_spmm, csr5_spmv
    from benchmark_spmv_using_csr5_tpu_torch.ops import csr5_kernel
    from benchmark_spmv_using_csr5_tpu_torch.ops.dia import dia_spmm, dia_spmv
    from benchmark_spmv_using_csr5_tpu_torch.parallel import distributed as pd
    from benchmark_spmv_using_csr5_tpu_torch.parallel import distributed_dia as pdd
    from benchmark_spmv_using_csr5_tpu_torch.parallel import launch, scaling
    from benchmark_spmv_using_csr5_tpu_torch.utils import cuda_build, perf, synth

    a = sp.csr_matrix(synth.banded(500_000, 27, dtype=np.float32))
    host = (a.indptr, a.indices, a.data, a.shape)
    rng = np.random.default_rng(0)
    x = rng.integers(1, 10, a.shape[1]).astype(np.float32)
    xm = rng.integers(1, 10, (a.shape[1], 8)).astype(np.float32)
    xd, xmd = torch.from_numpy(x).to(dev), torch.from_numpy(xm).to(dev)
    y_s, ym_s = torch.from_numpy(a @ x), torch.from_numpy(a @ xm)
    single = build_csr5(host, device=dev)
    d1 = build_dia(a, device=dev)
    y1, ym1 = csr5_spmv(single, xd).cpu(), csr5_spmm(single, xmd).cpu()
    yd1, ymd1 = dia_spmv(d1, xd).cpu(), dia_spmm(d1, xmd).cpu()
    keys = ("csr5_spmv", "csr5_spmv_packed", "csr5_spmm", "dia_spmv", "dia_spmm")
    cuda_build.launches.update(dict.fromkeys(keys, 0))
    out = {}
    with launch.single_rank_group(dev):
        mesh = pd.make_mesh(1, dev)
        backend = dist.get_backend()
        say(f"[distribution] process group of 1 rank on {backend} (NCCL "
            f"{torch.cuda.nccl.version()}), mesh device {mesh.device}")
        if backend != "nccl" or mesh.backend != "nccl":
            failed.append(f"distribution ran on {backend}, not NCCL")
        for halo in ("none", "auto"):
            for conv in ("host", "device"):
                t0 = time.perf_counter()
                da = pd.distribute_csr(*host, mesh, halo=halo, convert=conv)
                torch.cuda.synchronize(dev)
                build_s = time.perf_counter() - t0
                y = pd.distributed_spmv(da, xd, mesh).cpu()
                ok = (da.convert_route == conv and da.local.win_rel == (conv == "host")
                      and torch.equal(y, y_s) and torch.equal(y, y1) and da.halo is None
                      and da.x_bytes_exchanged() == 0)
                tag = f"halo={halo} convert={conv}"
                failed += [] if ok else [f"distributed_spmv {tag}"]
                say(f"[distributed_spmv {tag}] {'PASS' if ok else 'FAIL'}: route {da.convert_route}, "
                    f"{'wrapped' if da.local.win_rel else 'aligned'} maps, K1 on {da.local.num_tiles} "
                    f"tiles, y equal to scipy and to single-card K1; x bytes exchanged "
                    f"{da.x_bytes_exchanged()}; shard built in {build_s:.2f} s")
                out[(halo, conv)] = da
        da = out[("none", "host")]
        ym = pd.distributed_spmm(da, xmd, mesh).cpu()
        ok = torch.equal(ym, ym_s) and torch.equal(ym, ym1)
        failed += [] if ok else ["distributed_spmm"]
        say(f"[distributed_spmm R=8] {'PASS' if ok else 'FAIL'}: K2 "
            f"({csr5_kernel.spmm_mode(da.local, 8)}), Y equal to scipy and to single-card K2")
        dd = pdd.distribute_dia(a, mesh)
        yd = pdd.distributed_dia_spmv(dd, xd, mesh).cpu()
        ydm = pdd.distributed_dia_spmm(dd, xmd, mesh).cpu()
        ok = (torch.equal(yd, y_s) and torch.equal(yd, yd1) and torch.equal(ydm, ym_s)
              and torch.equal(ydm, ymd1) and dd.halo == (0, 0))
        failed += [] if ok else ["distributed DIA"]
        say(f"[distributed DIA] {'PASS' if ok else 'FAIL'}: {dd.ndiag} diagonals, halo {dd.halo}, "
            f"K5 y and K6 Y (R=8) equal to scipy and to single-card K5/K6")
        # the distributed path's time against single-card K1, in turns
        xs = pd.shard_of(xd, da.n, mesh)
        local = lambda d_, x_: pd.distributed_spmv_local(d_, x_, mesh)  # noqa: E731
        times = {"dist": [], "k1": []}
        for which in ("dist", "k1", "k1", "dist"):
            fn, mat, xx = (local, da, xs) if which == "dist" else (csr5_spmv, single, xd)
            times[which].append(perf.benchmark(fn, mat, xx, device=dev, num_run=200))
        t = {k: sum(v) / 2 for k, v in times.items()}
        # what one exchange costs at D = 1: the list all-gather of a halo and
        # of x, against a plain copy of the same bytes (host and device us)
        for nbytes in (2 * 128 * 4, 4 * a.shape[1]):
            src = torch.ones(nbytes // 4, device=dev)
            dst = torch.empty_like(src)
            costs = {}
            for label, fn in (("all_gather", lambda: pd.all_gather_cat(src, mesh)),
                              ("copy_", lambda: dst.copy_(src))):
                costs[label] = (perf.benchmark(fn, device=dev, warmup=20, num_run=300) * 1e3,
                                device_us_per_call(fn))
            say(f"[exchange cost at D = 1, {nbytes} B, {card}] " + "; ".join(
                f"{k}: {us:.2f} us per call (events), device {d_us} us" for k, (us, d_us) in costs.items()))
        pts = scaling.weak_scaling([1], rows_per_device=500_000, iters=200, device=dev)
        floor_s = scaling.collective_floor_s(mesh, 2 * 128 * 4)
        proj = scaling.project_weak_scaling(pts[0].ms_per_spmv, 500_000, latency_s=floor_s)
        say(f"[distribution timing, {card}] rank-local distributed SpMV (all-gather + K1) "
            f"{t['dist']:.5f} ms against single-card K1 {t['k1']:.5f} ms per call (turns "
            f"{times}); overhead {100 * (t['dist'] / t['k1'] - 1):.1f} %")
        say(scaling.report(pts))
        say(f"all-gather of a 1 KB halo at D = 1: {floor_s * 1e6:.2f} us per call (a floor "
            f"measured at D = 1, not a hop between cards)")
        say(scaling.projection_report(proj, pts[0].ms_per_spmv, scaling.NVLINK_GBPS, floor_s))
        if not (np.isfinite(pts[0].ms_per_spmv) and pts[0].efficiency == 1.0):
            failed.append("weak_scaling([1])")
    launches = {k: cuda_build.launches[k] for k in keys}
    t0 = time.perf_counter()
    ex = _load_example("distributed_spmv_torch").main([])
    torch.cuda.synchronize(dev)
    launches["csr5_spmv"] = cuda_build.launches["csr5_spmv"]
    ok = (ex["backend"] == "nccl" and ex["all_gather_rel_err"] == 0.0 and ex["halo_rel_err"] == 0.0)
    failed += [] if ok else ["distributed example"]
    say(f"[example distributed_spmv_torch] {'PASS' if ok else 'FAIL'} in "
        f"{time.perf_counter() - t0:.2f} s")
    say(f"distribution launches: {launches}")
    for k in ("csr5_spmv", "csr5_spmm", "dia_spmv", "dia_spmm"):
        if launches[k] == 0:
            failed.append(f"no {k} launch on the distributed path")
    return launches


def hot_share(a5, ids: int = RELABEL_HOT_IDS) -> float:
    """The share of ``a5``'s nonzeros whose new column id under the
    relabel by count (``ops/convert.py::relabel_columns``) is below
    ``ids``: the top ``ids`` of its column counts over their sum."""
    import torch

    from benchmark_spmv_using_csr5_tpu_torch.ops import convert

    counts = convert.column_counts(a5)
    total = int(counts.sum())
    return int(torch.sort(counts, descending=True).values[:ids].sum()) / total if total else 0.0


def relabel_phase(dev, card, failed) -> dict:
    """Phase 20: K1 on the column plane relabelled by count against K1 on
    the original plane, on ``kron23``'s graph (module docstring); returns
    its kernel launches."""
    import dataclasses

    import numpy as np
    import torch

    from benchmark_spmv_using_csr5_tpu_torch import build_csr5, solvers
    from benchmark_spmv_using_csr5_tpu_torch.ops import convert, csr5_kernel
    from benchmark_spmv_using_csr5_tpu_torch.ops.csr5_spmv import csr5_spmv, csr5_spmv_torch
    from benchmark_spmv_using_csr5_tpu_torch.utils import cuda_build, trace
    from csr5_bench import harness

    start = dict(cuda_build.launches)
    cfg = harness.load_cell("kron23.pagerank20").config
    tag = f"[relabel {cfg['name']}]"
    csr = harness.load_module(harness.ROOT, "generators", "kronecker").generate(cfg, 0, dev)
    m, n = csr["shape"]
    row_ptr = csr["row_ptr"].cpu().numpy()
    host = (row_ptr, csr["col"].cpu().numpy(), np.ones(csr["col"].shape[0], np.float32), (m, n))
    del csr
    torch.cuda.empty_cache()
    a5 = build_csr5(host, value_dtype=torch.float32, device=dev)
    del host
    relabel_ms = convert.last_convert_phases.get("relabel")
    fired = a5.col_relabel_tiles is not None
    say(f"{tag} n={n} nnz={a5.nnz} sigma={a5.sigma} rule fired: {fired}, "
        f"relabel phase {relabel_ms} ms")
    if not fired or relabel_ms is None:
        failed.append(f"relabel rule did not fire on {cfg['name']}")
        return {}
    k = a5.relabel_perm.shape[0]
    orig = dataclasses.replace(a5)  # the same planes, no relabel: K1 on col_idx_tiles
    # K1 alone on (relabelled plane, x'): a matrix of k columns and no relabel
    alone = dataclasses.replace(a5, col_idx_tiles=a5.col_relabel_tiles, shape=(m, k))
    # integer x with every row's sum below 2^24: each partial sum is exact in
    # float32 in any order, so all three products must agree bit for bit
    widest = int(np.diff(row_ptr).max())
    top = max(1, min(9, (2**24 - 1) // max(widest, 1)))
    gen = torch.Generator(device=dev).manual_seed(7)
    xs = [torch.randint(1, top + 1, (n,), generator=gen, device=dev).float() for _ in range(2)]
    before = dict(cuda_build.launches)
    y_rel = csr5_kernel.csr5_spmv_cuda(a5, xs[0])
    y_org = csr5_kernel.csr5_spmv_cuda(orig, xs[0])
    counted = {key: cuda_build.launches[key] - before[key] for key in before
               if cuda_build.launches[key] != before[key]}
    y_pln = csr5_spmv_torch(orig, xs[0])
    torch.cuda.empty_cache()
    exact = torch.equal(y_rel, y_org) and torch.equal(y_rel, y_pln)
    ok = exact and counted == {"csr5_spmv_relabel": 1, "csr5_spmv": 1}
    say(f"{tag} K1 relabelled vs original vs plain (x in 1..{top}, widest row {widest}): "
        f"{'PASS' if ok else 'FAIL'} torch.equal={exact} "
        f"max|rel-orig|={float((y_rel - y_org).abs().max())} "
        f"max|rel-plain|={float((y_rel - y_pln).abs().max())} launches {counted}")
    if not ok:
        failed.append("relabelled K1 differs from K1 on the original plane or the plain version")
    del y_rel, y_org, y_pln

    xrs = [torch.index_select(x, 0, a5.relabel_perm) for x in xs]
    turns = {
        "k1_original": (lambda x: csr5_kernel.csr5_spmv_cuda(orig, x), xs),
        "k1_relabelled": (lambda x: csr5_kernel.csr5_spmv_cuda(alone, x), xrs),
        "fill": (lambda x: torch.index_select(x, 0, a5.relabel_perm), xs),
        "product_relabelled": (lambda x: csr5_kernel.csr5_spmv_cuda(a5, x), xs),
    }
    us = {t: [] for t in turns}
    for r in range(4):
        for t in (list(turns) if r % 2 == 0 else list(turns)[::-1]):
            fn, args = turns[t]
            for i in range(3):
                fn(args[i % 2])
            ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            ev0.record()
            for i in range(50):
                fn(args[i % 2])
            ev1.record()
            torch.cuda.synchronize()
            us[t].append(ev0.elapsed_time(ev1) / 50 * 1e3)
    med = {t: float(np.median(v)) for t, v in us.items()}
    say(f"{tag} us a launch (CUDA events, median of 4 rounds of 50): "
        + ", ".join(f"{t} {med[t]:.2f}" for t in turns)
        + f"; product {med['product_relabelled'] / med['k1_original']:.3f} of K1 on the original "
        f"plane; gathered ids {k} of {n}, hot share {hot_share(a5):.4f} "
        f"(new ids below {RELABEL_HOT_IDS}) [{card}]")

    # PageRank as a device program: the capture counts the relabelled launches
    spmv = lambda v: csr5_spmv(a5, v)  # noqa: E731
    iters = 5
    eager = solvers.pagerank.__wrapped__(spmv, n, iters=iters, device=dev)
    outs = [solvers.pagerank(spmv, n, iters=iters, device=dev) for _ in range(3)]
    torch.cuda.synchronize()
    recs = [c for c in trace.captures().values() if c.solver == "pagerank"]
    rec = recs[-1].launches if recs else {}
    rel = float((outs[-1] - eager).abs().max() / eager.abs().max())
    good = rec == {"csr5_spmv_relabel": iters} and rel <= SOLVER_RTOL["float32"]
    say(f"{tag} pagerank program: capture launches {rec}, replay vs "
        f"eager max rel {rel:.3g} {'PASS' if good else 'FAIL'}")
    if not good:
        failed.append(f"pagerank on the relabelled {cfg['name']}")
    solvers.pagerank.cache_clear()
    del a5, orig, alone, xs, xrs, eager, outs
    torch.cuda.empty_cache()
    # K1's launches on both planes, for the kernels line
    return {"csr5_spmv": sum(cuda_build.launches[key] - start[key]
                             for key in ("csr5_spmv", "csr5_spmv_relabel"))}


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
    cuda_build.build(SOURCES)
    for name in SOURCES:
        cuda_build.bind(name)
    say(
        "build: " + ", ".join(f"{k}.cu {cuda_build.build_seconds[k]:.1f} s" for k in SOURCES)
        + f" with nvcc, in parallel (load {time.perf_counter() - t0:.1f} s)"
    )

    # --- 2. kernel vs plain vs scipy on the odd shapes ------------------------
    failed = []
    rng = np.random.default_rng(0)
    k1_cases = k1_sigma_cases(synth, sp, np, CSR5Config, csr5_kernel.MAX_SIGMA)
    for name, a_sp, cfg, win_mode in sweep_cases(synth, CSR5Config) + k1_cases:
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
                + ("K1p " if a5.col_packed is not None
                   else f"K1 smem={csr5_kernel.k1_smem_bytes(a5.sigma)} B ") +
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
    cuda_build.launches["csr5_spmv"] = 0
    results = [
        cli.run([os.path.join(ROOT, "example.mtx")]),
        cli.run(["--synthetic", "banded:500000:27"]),
    ]
    torch.cuda.synchronize()
    launches = cuda_build.launches["csr5_spmv"]
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
    met = perf.spmv_metrics(big.m, big.nnz, k_ms, 4, roofline_gbps=perf.device_hbm_gbps(kind),
                            streamed=perf.streamed_bytes(big.matrix, xs[big.name]))
    say(
        f"[{big.name}] K1 {k_ms:.4f} ms ({times['cuda']}), {met.getb_gbps:.2f} GB/s (getB), "
        f"{met.gflops:.2f} GFlops, {met.pct_hbm_streamed:.1f}% of {met.roofline_gbps:.0f} GB/s "
        f"({met.streamed_bytes / 1e6:.1f} MB streamed; getB {met.pct_getb_of_hbm:.1f}%); "
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
    t, xm6 = crossover(dev, card, kind, big.matrix, fmt["auto_banded500k"], fmt["dia_spmm8"],
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
    t2, x8 = spmm_crossover(dev, card, kind, spmm["spmm8_banded500k"].matrix, fmt["dia_spmm8"].matrix,
                            spmm["bandblock_spmm8"].matrix)

    # --- 10. K4 vs plain vs scipy float64 on the odd shapes --------------------
    failed += f64_sweep(dev, rng)
    if failed:
        print(f"chip_smoke: K4 sweep failed: {failed}", file=sys.stderr)
        return 1

    # --- 11. the float64 path at full width: CLI, handle, solvers ---------------
    f64res, f64_launches, f64_err, df64 = f64_path(dev, card, failed)
    if failed:
        print(f"chip_smoke: float64 path failed: {failed}", file=sys.stderr)
        return 1

    # --- 12. K4's time, the library yardstick and every kernel's bound ---------
    mats = {
        "csr5_spmv": (big.matrix, xs[big.name]),
        "dia_spmv": (fmt["auto_banded500k"].matrix, xs[big.name]),
        "dia_spmm": (fmt["dia_spmm8"].matrix, xm6),
        "csr5_spmm": (spmm["spmm8_banded500k"].matrix, x8),
        "bandmm_spmm": (spmm["bandblock_spmm8"].matrix, x8),
    }
    bounds, (k4_ms, k4_plain_ms) = yardstick(dev, card, kind, df64, f64res["df64_banded500k"].matrix,
                                             mats)

    # --- 13. K1p, K2p and K3 vs plain vs scipy on the odd shapes ---------------
    failed += large_sweep(dev, rng)
    if failed:
        print(f"chip_smoke: K1p/K2p/K3 sweep failed: {failed}", file=sys.stderr)
        return 1

    # --- 14. the large-matrix path at full width: CLI, harness, handle ---------
    mats.clear()  # the earlier phases' inputs are no longer needed
    del fmt, spmm, f64res, df64, results, big
    torch.cuda.empty_cache()
    large, large_launches, large_err, a20 = large_path(dev, failed)
    if failed:
        print(f"chip_smoke: large-matrix path failed: {failed}", file=sys.stderr)
        return 1

    # --- 15. K3 vs one K1 pass at banded20M, K1p vs K1 and K2p vs K2 -----------
    band500k = sp.csr_matrix(synth.banded(500_000, 27)).astype(np.float32)
    lt = large_turns(dev, card, kind, large, a20, band500k)
    del large, a20, band500k
    torch.cuda.empty_cache()

    # --- 16. the benchmark suite on the card, in a subprocess -----------------
    suite_launches = suite_phase(failed)
    if failed:
        print(f"chip_smoke: the suite failed: {failed}", file=sys.stderr)
        return 1

    # --- 17. checkpoints, the debug printer and the examples -------------------
    example_k1 = persistence_phase(dev, failed)
    if failed:
        print(f"chip_smoke: checkpoints/examples failed: {failed}", file=sys.stderr)
        return 1

    # --- 18. CSR -> CSR5 on the card, and the two column routes -------------
    conv_launches = conversion_phase(dev, card, failed)
    if failed:
        print(f"chip_smoke: device conversion failed: {failed}", file=sys.stderr)
        return 1

    # --- 19. distribution at D = 1 on NCCL, and its example -------------------
    dist_launches = distribution_phase(dev, card, failed)
    if failed:
        print(f"chip_smoke: distribution failed: {failed}", file=sys.stderr)
        return 1
    # --- 20. the column relabel on kron23's graph -----------------------------
    relabel_launches = relabel_phase(dev, card, failed)
    if failed:
        print(f"chip_smoke: column relabel failed: {failed}", file=sys.stderr)
        return 1
    extra = {k: conv_launches.get(k, 0) + dist_launches.get(k, 0) + relabel_launches.get(k, 0)
             for k in set(conv_launches) | set(dist_launches) | set(relabel_launches)}

    def entry(name, source, replaces, launches_, err, ms, plain):
        b_ms, b_by, lib_ms = bounds[name]
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches_ + suite_launches.get(name, 0) + extra.get(name, 0),
                "max_abs_err": err, "ms": ms,
                "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}

    def large_entry(name, source, replaces):
        ms, plain, b_ms, b_by, lib_ms = lt[name]
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": large_launches[name] + suite_launches.get(name, 0) + extra.get(name, 0),
                "max_abs_err": large_err[name], "ms": ms, "plain_ms": plain, "bound_ms": b_ms,
                "bound_by": b_by, "library_ms": lib_ms}

    say(json.dumps({"kernels": [
        entry("csr5_spmv", K1_SOURCE, K1_REPLACES,
              launches + fmt_launches["csr5_spmv"] + f64_launches["csr5_spmv"]
              + large_launches["csr5_spmv"] + example_k1,
              max(max_abs, fmt_err["csr5_spmv"], large_err["csr5_spmv"]), k_ms, p_ms),
        large_entry("csr5_spmv_packed", K1_SOURCE, K1P_REPLACES),
        large_entry("csr5_spmm_packed", K2_SOURCE, K1P_REPLACES),
        large_entry("csr5_sliced", K3_SOURCE, K3_REPLACES),
        entry("dia_spmv", DIA_SOURCE, K5_REPLACES, fmt_launches["dia_spmv"], fmt_err["dia_spmv"],
              t["k5"], t["k5_plain"]),
        entry("dia_spmm", DIA_SOURCE, K6_REPLACES,
              fmt_launches["dia_spmm"] + spmm_launches["dia_spmm"],
              max(fmt_err["dia_spmm"], spmm_err["dia_spmm"]), t["k6"], t["k6_plain"]),
        entry("csr5_spmm", K2_SOURCE, K2_REPLACES, spmm_launches["csr5_spmm"],
              spmm_err["csr5_spmm"], t2["k2"], t2["k2_plain"]),
        dict(entry("bandmm_spmm", K7_SOURCE, K7_REPLACES, spmm_launches["bandmm_spmm"],
                   spmm_err["bandmm_spmm"], t2["k7"], t2["k7_plain"]),
             device_us=t2["k7_us"], ms_r16=t2["k7_r16"], device_us_r16=t2["k7_r16_us"],
             plain_ms_r16=t2["k7_r16_plain"], bound_ms_r16=t2["k7_r16_bound"],
             library_ms_r16=t2["lib_r16"]),
        entry("csr5_spmv_f64", K4_SOURCE, K4_REPLACES, f64_launches["csr5_spmv_f64"], f64_err,
              k4_ms, k4_plain_ms),
    ]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
