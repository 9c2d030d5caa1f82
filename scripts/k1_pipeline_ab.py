#!/usr/bin/env python3
"""K1's grouped tile step on the card: the parent's K1 and variants of
``csrc/csr5_spmv.cu`` in turns at kron23 and banded500k, with each
variant's registers, local memory and blocks per SM; first, the SASS of
every function of the six kernel libraries against the parent's build.

    python3 scripts/k1_pipeline_ab.py --parent _archive_check/parent

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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, help="root of the parent commit's files")
    ap.add_argument("--rounds", type=int, default=4)
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
    for name, (text, pads[name]) in {"parent": (parent_src, 0), **variants(src, SIGMA)}.items():
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

    def call(lib, a5, x, share):
        y = torch.zeros(a5.m_pad, dtype=torch.float32, device=dev)
        fn = lib.csr5_spmv_bf16 if a5.val_tiles.dtype == torch.bfloat16 else lib.csr5_spmv_f32
        rc = fn(a5.col_idx_tiles.data_ptr(), a5.val_tiles.data_ptr(), a5.win_map.data_ptr(),
                a5.tile_ptr.data_ptr(), x.data_ptr(), y.data_ptr(), a5.num_tiles, a5.sigma,
                a5.capw, int(a5.win_rel), share, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"launch failed ({rc})")
        return y

    def timed(lib, a5, xs, share, n):
        torch.cuda.synchronize()
        if lib.k1_reset_persisting() != 0:
            raise RuntimeError("cudaCtxResetPersistingL2Cache failed")
        for i in range(5):
            call(lib, a5, xs[i % len(xs)], share)
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        for i in range(n):
            call(lib, a5, xs[i % len(xs)], share)
        e.record()
        torch.cuda.synchronize()
        return s.elapsed_time(e) / n * 1e3

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


if __name__ == "__main__":
    sys.exit(main())
