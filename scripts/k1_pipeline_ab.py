#!/usr/bin/env python3
"""K1's grouped tile step on the card: the parent's K1 and variants of
``csrc/csr5_spmv.cu`` in turns at kron23 and banded500k, with each
variant's registers, local memory and blocks per SM; first, the SASS of
every function of the six kernel libraries against the parent's build.

    python3 scripts/k1_pipeline_ab.py --parent _archive_check/parent
    python3 scripts/k1_pipeline_ab.py --parent _archive_check/parent --mode relabel

``--mode relabel`` times K1 on the column plane relabelled by count
(``ops/convert.py::relabel_columns``) against K1 on the original plane,
on Kronecker graphs of scale 23 from kron23's skew (A = 0.57) down to
uniform columns (A = B = C = 0.25), each relabelled whether or not the
rule fires, in turns: the parent's K1 and the shipped K1 on (original
plane, x), the shipped K1 and the ``hot_l1`` variant (gathers at new ids
from ``chip_smoke.RELABEL_HOT_IDS`` on skip L1) on (relabelled plane, x'), the x'
fill alone, and the whole wrapper on each plane; at kron23 also K2 at
R = 16 on (original plane, X) and on (relabelled plane, X'), and the X'
fill. Each graph's line gives its top 1 % columns' share of the nonzeros,
the hot share, the gathered ids and whether the rule fired. ``--graphs``
names a subset of them.

``--parent`` is the root of the parent commit's files (``git archive``).
A variant is the shipped source with edits to a copy of its text (every
edit must match as often as it says):

  shipped           the kernel as it is
  ungrouped         one row at a time (the parent's step 1), the shipped
                    launch bounds
  ungrouped_b<B>    the same at __launch_bounds__(128, B) (B 0: no minimum)
  ungrouped_b16_s<N>  the same at 16 blocks' registers, with shared memory
                    padded for about N blocks an SM (the line gives the
                    blocks the runtime finds room for)
  u<U>_b<B>         the shipped kernel at kUnroll U and bounds B

Each variant's K1 is timed with CUDA events over back-to-back launches in
alternating rounds; the persisting L2 lines are reset before each. Lines go
to standard output and ``chiprun_out/k1_pipeline_ab.jsonl``. Exits 1 when a
variant's y differs from the shipped kernel's by more than 1e-5 of y's
largest entry, or when the SASS of a function differs from the parent's.
The SASS comparison alone:

    python3 -c "import sys; sys.path.insert(0, 'scripts'); import k1_pipeline_ab as k; \
        sys.exit(not k.sass_check('_archive_check/parent'))"
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
CSRC = "benchmark_spmv_using_csr5_tpu_torch/csrc"
OUT = os.path.join(ROOT, "chiprun_out", "k1_pipeline_ab.jsonl")
WORK = os.path.join(ROOT, "benchmark_spmv_using_csr5_tpu_torch", "_build", "k1_ab")
NVCC = "/usr/local/cuda/bin/nvcc"
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
         "-Xcompiler", "-fPIC"]

#: an edit: (text, replacement, how many times the text occurs)
NO_GROUPS = [("const int full = sigma - sigma % kUnroll;", "const int full = 0;", 1)]
BOUNDS = "__launch_bounds__(kLanes, kMinBlocks)"
K1_SMEM = "const size_t smem = (size_t)(sigma + 1) * kLanes * sizeof(float);\n" \
          "    const cudaError_t err = grant_smem<&csr5_spmv_tile_kernel<V>>(smem);"
#: the kernel libraries, one per ``csrc/<name>.cu``
LIBS = ("csr5_spmv", "csr5_spmv_f64", "csr5_spmm", "csr5_sliced", "dia_spmv", "bandmm")
#: the sigma of both matrices (compute_sigma's at banded500k and kron23)
SIGMA = 24
#: an SM's shared memory and what the card keeps of it for each block (bytes)
SM_SMEM, BLOCK_RESERVE = 233_472, 1024
#: (kUnroll, blocks) of the shipped kernel's sweep; blocks 0: no minimum
SWEEP = ((4, 0), (4, 12), (4, 16), (8, 0), (8, 10), (8, 12), (16, 0), (16, 8))


def bounds(blocks: int) -> list:
    new = "__launch_bounds__(kLanes)" if blocks == 0 else f"__launch_bounds__(kLanes, {blocks})"
    return [(BOUNDS, new, 1)]


def padded(sigma: int, blocks: int) -> int:
    """Bytes of padding that leave room for about ``blocks`` K1 blocks an
    SM at ``sigma``."""
    return SM_SMEM // blocks - BLOCK_RESERVE - (sigma + 1) * 128 * 4


#: registers, spills and resident blocks of K1 in a built variant
PROBE = r'''
extern "C" int k1_probe(int bf16, int smem, int* out) {
    cudaFuncAttributes a;
    cudaError_t err = bf16 ? cudaFuncGetAttributes(&a, csr5_spmv_tile_kernel<__nv_bfloat16>)
                           : cudaFuncGetAttributes(&a, csr5_spmv_tile_kernel<float>);
    if (err != cudaSuccess) return (int)err;
    out[0] = a.numRegs;
    out[1] = (int)a.localSizeBytes;
    out[2] = (int)a.sharedSizeBytes;
    return bf16 ? (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                      out + 3, csr5_spmv_tile_kernel<__nv_bfloat16>, 128, smem)
                : (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                      out + 3, csr5_spmv_tile_kernel<float>, 128, smem);
}
extern "C" int k1_reset_persisting() { return (int)cudaCtxResetPersistingL2Cache(); }
'''


def say(**kw) -> None:
    line = json.dumps(kw)
    print(line, flush=True)
    with open(OUT, "a") as f:
        f.write(line + "\n")


def edit(src: str, edits) -> str:
    for old, new, count in edits:
        if src.count(old) != count:
            raise RuntimeError(f"the edit {old!r} does not match {count} times")
        src = src.replace(old, new)
    return src


def variants(src: str, sigma: int) -> dict:
    """name -> (source text, shared-memory padding in bytes) of each
    variant of the shipped K1, for matrices of ``sigma``."""
    unroll = int(re.search(r"constexpr int kUnroll = (\d+);", src).group(1))
    out = {"shipped": (src, 0), "ungrouped": (edit(src, NO_GROUPS), 0)}
    for b in (0, 16):
        out[f"ungrouped_b{b}"] = (edit(src, NO_GROUPS + bounds(b)), 0)
    for n in (12, 8):
        pad = padded(sigma, n)
        out[f"ungrouped_b16_s{n}"] = (edit(src, NO_GROUPS + bounds(16) + [
            (K1_SMEM, K1_SMEM.replace("sizeof(float);", f"sizeof(float) + {pad};"), 1)]), pad)
    for u, b in SWEEP:
        out[f"u{u}_b{b}"] = (edit(src, bounds(b) + [
            (f"constexpr int kUnroll = {unroll};", f"constexpr int kUnroll = {u};", 1)]), 0)
    return out


def build(jobs: dict) -> dict:
    """Builds name -> (source path, include dir) at once; returns name -> .so."""
    procs = {}
    for name, (path, inc) in jobs.items():
        so = os.path.join(WORK, f"lib_{name}.so")
        procs[name] = (so, subprocess.Popen(
            [NVCC, *FLAGS, "-I", inc, "-o", so, path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-3000:]}")
        built[name] = so
    return built


def stable(text: str) -> str:
    """``text`` with the length-prefixed name of each anonymous namespace in
    its mangled names (nvcc's, after the source file and a hash, which
    differ between two builds) replaced by ``_anon_``."""
    out, i = [], 0
    for m in re.finditer(r"(\d+)(_GLOBAL__N__|_INTERNAL_)", text):
        if m.start() < i:
            continue
        out += [text[i:m.start()], "_anon_"]
        i = m.end(1) + int(m.group(1))
    return "".join(out) + text[i:]


def functions(so: str) -> dict:
    """kernel -> its SASS text, both with :func:`stable` names."""
    text = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass", so], capture_output=True,
                          text=True, check=True).stdout
    parts = re.split(r"\n\s*Function : (\S+)\n", text)
    return {stable(parts[i]): stable(parts[i + 1]) for i in range(1, len(parts) - 1, 2)}


def sass_check(parent: str) -> bool:
    """Every function of the six libraries against the parent's build,
    function by function; a function found in one build only differs."""
    os.makedirs(WORK, exist_ok=True)
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    jobs = {}
    for side, root in (("parent", parent), ("change", ROOT)):
        for lib in LIBS:
            jobs[f"sass_{side}_{lib}"] = (os.path.join(root, CSRC, f"{lib}.cu"),
                                          os.path.join(root, CSRC))
    built = build(jobs)
    same = True
    for lib in LIBS:
        a = functions(built[f"sass_parent_{lib}"])
        b = functions(built[f"sass_change_{lib}"])
        same &= bool(a)
        for fn in sorted(set(a) | set(b)):
            equal = a.get(fn) == b.get(fn)
            same &= equal
            say(sass=lib, function=fn, equal=equal, parent_lines=len((a.get(fn) or "").splitlines()),
                change_lines=len((b.get(fn) or "").splitlines()))
    return same


#: the relabel mode's variant: gathers at new ids from the hot prefix on
#: skip L1 (the prefix: chip_smoke.py::RELABEL_HOT_IDS)
HOT_L1 = [
    ("constexpr int kMinBlocks = 8;",
     "constexpr int kMinBlocks = 8;\n"
     "constexpr int kHotIds = 32768;\n"
     "__device__ __forceinline__ float gather_past_l1(const float* p, uint64_t pol) {\n"
     "    float v;\n"
     "    asm(\"ld.global.nc.L1::no_allocate.L2::cache_hint.f32 %0, [%1], %2;\"\n"
     "        : \"=f\"(v) : \"l\"(p), \"l\"(pol));\n"
     "    return v;\n"
     "}", 1),
    ("xv[u] = ld.gather(x + c0[u]);",
     "xv[u] = c0[u] < kHotIds ? ld.gather(x + c0[u]) : gather_past_l1(x + c0[u], ld.held);", 1),
]
#: the relabel mode's graphs: name -> (A, B = C) of the Kronecker generator
SKEWS = {"kron23": (0.57, 0.19), "kron23_a50": (0.50, 0.20), "kron23_a45": (0.45, 0.22),
         "kron23_a40": (0.40, 0.20), "kron23_uniform": (0.25, 0.25)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, help="root of the parent commit's files")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--mode", choices=("pipeline", "relabel"), default="pipeline")
    ap.add_argument("--graphs", nargs="+", choices=list(SKEWS), default=list(SKEWS),
                    help="the relabel mode's graphs")
    args = ap.parse_args()
    os.makedirs(WORK, exist_ok=True)
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    say(card=card)
    ok = sass_check(os.path.abspath(args.parent))
    say(sass_equal=ok)

    with open(os.path.join(ROOT, CSRC, "csr5_spmv.cu")) as f:
        src = f.read()
    with open(os.path.join(args.parent, CSRC, "csr5_spmv.cu")) as f:
        parent_src = f.read()
    jobs, pads = {}, {"parent": 0}
    if args.mode == "relabel":
        todo = {"parent": (parent_src, 0), "shipped": (src, 0), "hot_l1": (edit(src, HOT_L1), 0)}
    else:
        todo = {"parent": (parent_src, 0), **variants(src, SIGMA)}
    for name, (text, pads[name]) in todo.items():
        path = os.path.join(WORK, f"{name}.cu")
        with open(path, "w") as f:
            f.write(text + PROBE)
        inc = os.path.join(os.path.abspath(args.parent) if name == "parent" else ROOT, CSRC)
        jobs[name] = (path, inc)
    built = build(jobs)

    import numpy as np
    import scipy.sparse as sp
    import torch

    import benchmark_spmv_using_csr5_tpu_torch as port
    from benchmark_spmv_using_csr5_tpu_torch.ops import csr5_kernel
    from benchmark_spmv_using_csr5_tpu_torch.utils import cuda_build, synth
    from csr5_bench import harness

    dev = torch.device("cuda", 0)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    libs = {}
    for name, so in built.items():
        lib = ctypes.CDLL(so)
        for fn in (lib.csr5_spmv_f32, lib.csr5_spmv_bf16):
            fn.argtypes = [P] * 6 + [I] * 4 + [F, P]
        lib.k1_probe.argtypes = [I, I, ctypes.POINTER(I)]
        libs[name] = lib

    def call(lib, a5, x, share, col=None):
        y = torch.zeros(a5.m_pad, dtype=torch.float32, device=dev)
        fn = lib.csr5_spmv_bf16 if a5.val_tiles.dtype == torch.bfloat16 else lib.csr5_spmv_f32
        col = a5.col_idx_tiles if col is None else col
        rc = fn(col.data_ptr(), a5.val_tiles.data_ptr(), a5.win_map.data_ptr(),
                a5.tile_ptr.data_ptr(), x.data_ptr(), y.data_ptr(), a5.num_tiles, a5.sigma,
                a5.capw, int(a5.win_rel), share, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"launch failed ({rc})")
        return y

    def events_us(fn, xs, n):
        """µs a call of ``fn(x)`` over ``n`` back-to-back calls, after the
        persisting L2 lines are reset and five calls warm."""
        torch.cuda.synchronize()
        if libs["parent"].k1_reset_persisting() != 0:
            raise RuntimeError("cudaCtxResetPersistingL2Cache failed")
        for i in range(5):
            fn(xs[i % len(xs)])
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        for i in range(n):
            fn(xs[i % len(xs)])
        e.record()
        torch.cuda.synchronize()
        return s.elapsed_time(e) / n * 1e3

    def timed(lib, a5, xs, share, n):
        return events_us(lambda x: call(lib, a5, x, share), xs, n)

    def case(tag, a5, xs, n):
        if a5.sigma != SIGMA:
            raise RuntimeError(f"{tag}: sigma {a5.sigma}; the variants are padded for {SIGMA}")
        y0 = csr5_kernel.csr5_spmv_cuda(a5, xs[0])  # the shipped K1; grants the set-aside
        share = csr5_kernel.resident_share(
            a5.n * 4, *csr5_kernel._l2(cuda_build.bind("csr5_spmv"), dev))
        bf16 = int(a5.val_tiles.dtype == torch.bfloat16)
        scale = float(y0.abs().max()) or 1.0
        agree = True
        for name, lib in libs.items():
            out = (I * 4)()
            probe_smem = csr5_kernel.k1_smem_bytes(a5.sigma) + pads[name]
            rc = lib.k1_probe(bf16, probe_smem, out)
            d = float((call(lib, a5, xs[0], share)[: a5.m] - y0).abs().max()) / scale
            agree &= d <= 1e-5
            say(case=tag, variant=name, registers=out[0], local_bytes=out[1], static_smem=out[2],
                dynamic_smem=probe_smem, blocks_per_sm=out[3] if rc == 0 else None,
                max_rel_diff_to_shipped=d)
        res = {k: [] for k in libs}
        names = list(libs)
        for r in range(args.rounds):
            for k in (names if r % 2 == 0 else names[::-1]):
                res[k].append(timed(libs[k], a5, xs, share, n))
        for k in names:
            v = sorted(res[k])
            say(case=tag, variant=k, sigma=a5.sigma, capw=a5.capw, share=share, us=v,
                median=float(np.median(v)), card=card)
        return agree

    if args.mode == "relabel":
        ok &= relabel_cases(args, dev, libs, call, events_us, card)
        say(done=True, ok=bool(ok))
        return 0 if ok else 1

    band = sp.csr_matrix(synth.banded(500_000, 27)).astype(np.float32)
    xb = torch.from_numpy(np.random.default_rng(0).integers(1, 10, band.shape[1])
                          .astype(np.float32)).to(dev)
    a5 = port.build_csr5((band.indptr, band.indices, band.data, band.shape),
                         value_dtype=torch.bfloat16, device=dev)
    ok &= case("banded500k_bf16", a5, [xb], 300)
    del a5
    cell = harness.load_cell("kron23.pagerank20")
    csr = harness.load_module(harness.ROOT, "generators", "kronecker").generate(cell.config, 0, dev)
    m, n = csr["shape"]
    host = tuple(csr[k].cpu().numpy() for k in ("row_ptr", "col", "val")) + ((m, n),)
    del csr
    torch.cuda.empty_cache()
    a5 = port.build_csr5(host, value_dtype=torch.float32, device=dev)
    del host
    g = torch.Generator(device=dev).manual_seed(1)
    xs = [torch.rand(n, device=dev, generator=g) for _ in range(2)]
    ok &= case("kron23_f32", a5, xs, 30)
    say(done=True, ok=bool(ok))
    return 0 if ok else 1


def relabel_cases(args, dev, libs, call, events_us, card) -> bool:
    """The relabel mode's turns on each graph of :data:`SKEWS`; False
    when a y on the relabelled plane differs from the shipped K1's on the
    original plane by more than 1e-5 of y's largest entry."""
    import dataclasses
    import math

    import numpy as np
    import torch

    import benchmark_spmv_using_csr5_tpu_torch as port
    import chip_smoke
    from benchmark_spmv_using_csr5_tpu_torch.ops import convert, csr5_kernel
    from benchmark_spmv_using_csr5_tpu_torch.utils import cuda_build
    from csr5_bench import harness

    l2 = csr5_kernel._l2(cuda_build.bind("csr5_spmv"), dev)
    gen = harness.load_module(harness.ROOT, "generators", "kronecker")
    base = harness.load_cell("kron23.pagerank20").config
    ok = True
    for tag in args.graphs:
        a, b = SKEWS[tag]
        csr = gen.generate({**base, "A": a, "B": b, "C": b}, 0, dev)
        m, n = csr["shape"]
        host = tuple(csr[k].cpu().numpy() for k in ("row_ptr", "col", "val")) + ((m, n),)
        del csr
        torch.cuda.empty_cache()
        a5 = port.build_csr5(host, value_dtype=torch.float32, device=dev)
        del host
        fired = a5.col_relabel_tiles is not None
        counts = convert.column_counts(a5)
        if not fired:
            convert._relabel(a5, counts)
        ranked = torch.sort(counts, descending=True).values
        top = int(ranked[: math.ceil(n * convert.RELABEL_TOP_COLUMNS)].sum()) / int(counts.sum())
        k = a5.relabel_perm.shape[0]
        orig = dataclasses.replace(a5)  # no relabel: K1 on col_idx_tiles
        g = torch.Generator(device=dev).manual_seed(1)
        xs = [torch.rand(n, device=dev, generator=g) for _ in range(2)]
        xrs = [torch.index_select(x, 0, a5.relabel_perm) for x in xs]
        share_n = csr5_kernel.resident_share(n * 4, *l2)
        share_k = csr5_kernel.resident_share(k * 4, *l2)
        y0 = csr5_kernel.csr5_spmv_cuda(orig, xs[0])
        y1 = csr5_kernel.csr5_spmv_cuda(a5, xs[0])
        scale = float(y0.abs().max()) or 1.0
        diffs = {"wrapper": float((y1 - y0).abs().max()) / scale}
        for name in ("shipped", "hot_l1"):
            yk = call(libs[name], a5, xrs[0], share_k, a5.col_relabel_tiles)[:m]
            diffs[name] = float((yk - y0).abs().max()) / scale
        agree = all(d <= 1e-5 for d in diffs.values())
        ok &= agree
        say(case=tag, A=a, B=b, top1pct_share=top, hot_share=chip_smoke.hot_share(a5), gathered=k,
            n=n, nnz=a5.nnz, rule_fired=fired, share_n=share_n, share_k=share_k,
            relabel_ms=convert.last_convert_phases.get("relabel"),
            max_rel_diff_to_original=diffs, card=card)
        turns = {
            "parent_original": lambda x: call(libs["parent"], a5, x, share_n),
            "shipped_original": lambda x: call(libs["shipped"], a5, x, share_n),
            "shipped_relabel": lambda x: call(libs["shipped"], a5, x, share_k,
                                              a5.col_relabel_tiles),
            "hot_l1_relabel": lambda x: call(libs["hot_l1"], a5, x, share_k,
                                             a5.col_relabel_tiles),
            "fill": lambda x: torch.index_select(x, 0, a5.relabel_perm),
            "wrapper_original": lambda x: csr5_kernel.csr5_spmv_cuda(orig, x),
            "wrapper_relabel": lambda x: csr5_kernel.csr5_spmv_cuda(a5, x),
        }
        inputs = {t: xrs if t in ("shipped_relabel", "hot_l1_relabel") else xs for t in turns}
        if tag == "kron23":
            # K2 at R = 16 both ways: K2 keeps the original plane (ROADMAP 4.2)
            alone = dataclasses.replace(a5, col_idx_tiles=a5.col_relabel_tiles, shape=(m, k))
            Xs = [torch.rand((n, 16), device=dev, generator=g)]
            Xrs = [torch.index_select(Xs[0], 0, a5.relabel_perm)]
            y0 = csr5_kernel.csr5_spmm_cuda(orig, Xs[0])
            diffs = float((csr5_kernel.csr5_spmm_cuda(alone, Xrs[0]) - y0).abs().max())
            ok &= diffs <= 1e-5 * (float(y0.abs().max()) or 1.0)
            say(case=tag, k2_max_abs_diff=diffs, spmm_mode=csr5_kernel.spmm_mode(a5, 16))
            turns.update({
                "k2_original": lambda X: csr5_kernel.csr5_spmm_cuda(orig, X),
                "k2_relabel": lambda X: csr5_kernel.csr5_spmm_cuda(alone, X),
                "k2_fill": lambda X: torch.index_select(X, 0, a5.relabel_perm),
            })
            inputs.update(k2_original=Xs, k2_relabel=Xrs, k2_fill=Xs)
        res = {t: [] for t in turns}
        names = list(turns)
        for r in range(args.rounds):
            for t in (names if r % 2 == 0 else names[::-1]):
                res[t].append(events_us(turns[t], inputs[t], 30))
        for t in names:
            v = sorted(res[t])
            say(case=tag, turn=t, us=v, median=float(np.median(v)), card=card)
        del a5, orig, xs, xrs, counts, ranked, y0, y1
        torch.cuda.empty_cache()
    return ok


if __name__ == "__main__":
    sys.exit(main())
