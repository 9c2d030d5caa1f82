"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles alone into
``_build/lib<name>.so`` inside the package (listed in ``.gitignore``),
at first use, for ``sm_90a`` (Hopper). The library is rebuilt when its
source, or a shared header ``csrc/*.cuh``, is newer; :func:`build` starts
one nvcc per stale source at once. Nothing is built when a module is
imported, and a failed build raises: there is no fallback.

It is also the one launch path of the kernels' wrappers (``ops/*_kernel.py``,
``ops/csr5_f64.py``): :data:`SIGNATURES` declares every library's C
interface, :func:`bind` loads a library with it, :func:`launch` runs an
entry point on x's device and current stream, raises on an error code and
counts the launch in :data:`launches`, and :func:`on_cuda` is the
dispatchers' rule between a kernel and its plain version.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Dict, Optional

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

_P, _I, _I64, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_I64P = ctypes.POINTER(ctypes.c_longlong)
#: K1: col, val, win_map, tile_ptr, x, y, p, sigma, capw, win_rel, share, stream
_K1 = (_P,) * 6 + (_I,) * 4 + (_F, _P)
#: K1p: colp, val, win_map, tile_ptr, pages, x, y, p, sigma, capw, win_rel,
#: pmax, share, stream
_K1P = (_P,) * 7 + (_I,) * 5 + (_F, _P)
#: K2 and K2p: col, val, win_map, tile_ptr, pages, pmax, packed, staged, x,
#: y, p, sigma, capw, win_rel, nends, m, n, R, xs_c, xs_r, ys_row, ys_r, rc,
#: vec, stream
_K2 = (_P,) * 5 + (_I,) * 3 + (_P,) * 2 + (_I,) * 8 + (_I64,) * 4 + (_I,) * 2 + (_P,)
#: K5: data, offsets, x, y, m, n, nd, m_pad, interleaved, stream
_K5 = (_P,) * 4 + (_I,) * 5 + (_P,)
#: K6: data, offsets, x, y, m, n, nd, m_pad, interleaved, R, vec, stream
_K6 = (_P,) * 4 + (_I,) * 7 + (_P,)
#: K7: dense, c0, x, y, m, n, K, nblk, R, xs_c, xs_r, ys_row, ys_r, rc,
#: bf16_ops, stream
_K7 = (_P,) * 4 + (_I,) * 5 + (_I64,) * 4 + (_I,) * 2 + (_P,)

#: library -> entry point -> its argument types: the only declaration of the
#: kernels' C interface in Python. Every entry point returns an int, a CUDA
#: error code (0 on success); each library also exports :data:`ERROR_STRING`
SIGNATURES: Dict[str, Dict[str, tuple]] = {
    "csr5_spmv": {
        "csr5_spmv_f32": _K1, "csr5_spmv_bf16": _K1,
        "csr5_spmv_packed_f32": _K1P, "csr5_spmv_packed_bf16": _K1P,
        "csr5_l2_attributes": (_I, _I64P),
        "csr5_grant_persisting_l2": (_I, _I64, _I64P),
    },
    # col, val, win_map, tile_ptr, x, y, p, sigma, capw, win_rel, stream
    "csr5_spmv_f64": {"csr5_spmv_f64": (_P,) * 6 + (_I,) * 4 + (_P,)},
    # table, nslices, total_tiles, x, y, sigma, stream
    "csr5_sliced": {"csr5_sliced_spmv": (_P, _I, _I, _P, _P, _I, _P)},
    "csr5_spmm": {"csr5_spmm_f32": _K2, "csr5_spmm_bf16": _K2},
    "dia_spmv": {"dia_spmv_f32": _K5, "dia_spmv_bf16": _K5,
                 "dia_spmm_f32": _K6, "dia_spmm_bf16": _K6},
    "bandmm": {"bandmm_f32": _K7, "bandmm_bf16": _K7},
}
#: the text of an error code, ``const char* (int)``, in every library
#: (``csrc/csr5_error.cuh``)
ERROR_STRING = "csr5_cuda_error_string"

#: kernel -> the launches its wrapper enqueued so far in this process,
#: eagerly or into a captured graph (a replay runs no wrapper, so it adds
#: nothing); :func:`launch` adds to them. ``csr5_spmv_relabel`` counts K1's
#: launches on a relabelled column plane (``csr5_spmv`` the others)
launches: Dict[str, int] = dict.fromkeys((
    "csr5_spmv", "csr5_spmv_packed", "csr5_sliced", "csr5_spmv_f64", "csr5_spmm",
    "csr5_spmm_packed", "dia_spmv", "dia_spmm", "bandmm_spmm", "csr5_spmv_relabel"), 0)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_bound: Dict[str, ctypes.CDLL] = {}
#: seconds each library took to build in this process (0.0 when an
#: up-to-date library was found)
build_seconds: Dict[str, float] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _paths(name: str):
    return os.path.join(CSRC_DIR, f"{name}.cu"), os.path.join(BUILD_DIR, f"lib{name}.so")


def _headers_mtime() -> float:
    """The newest modification time of the shared headers ``csrc/*.cuh``."""
    return max(
        (os.path.getmtime(os.path.join(CSRC_DIR, f)) for f in os.listdir(CSRC_DIR)
         if f.endswith(".cuh")),
        default=0.0,
    )


def _build_stale(names) -> None:
    """Build every library of ``names`` that is missing or older than its
    source or a shared header: one nvcc process per source, all started
    together. Call with ``_lock`` held."""
    stale = []
    hdr = _headers_mtime()
    for name in names:
        src, out = _paths(name)
        if os.path.exists(out) and os.path.getmtime(out) >= max(os.path.getmtime(src), hdr):
            build_seconds.setdefault(name, 0.0)
        else:
            stale.append((name, src, out))
    if not stale:
        return
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    jobs = []
    for name, src, out in stale:
        # build to a temporary name, then rename: a concurrent loader never
        # sees a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", tmp, src],
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
            text=True,
        )
        jobs.append((name, src, out, tmp, proc, time.perf_counter()))
    errors = []
    for name, src, out, tmp, proc, t0 in jobs:
        try:
            try:
                _, err = proc.communicate(timeout=600)
            except subprocess.TimeoutExpired:
                proc.kill()
                _, err = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"nvcc failed for {src} (rc {proc.returncode}):\n{err[-4000:]}")
            else:
                os.replace(tmp, out)
            build_seconds[name] = time.perf_counter() - t0
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    if errors:
        raise RuntimeError("\n".join(errors))


def build(names) -> None:
    """Build the libraries of ``names`` that are stale, in parallel."""
    with _lock:
        _build_stale(names)


def load(name: str) -> ctypes.CDLL:
    """The loaded ``lib<name>.so``, built from ``csrc/<name>.cu`` if it is
    missing or older than its source."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        _build_stale([name])
        lib = ctypes.CDLL(_paths(name)[1])
        _libs[name] = lib
        return lib


#: the current stream of a device as an int without building a Stream
#: object (0.15 us per call on the H100's host, against 4.6 us for
#: ``torch.cuda.current_stream(dev).cuda_stream``; PERF.md); PyTorch's own
#: kernel launchers read it this way. CPU-only builds of torch lack it.
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def stream_handle(dev) -> int:
    """The current CUDA stream of ``dev`` as an int, for a kernel launch."""
    if _raw_stream is not None:
        return _raw_stream(dev.index)
    return torch.cuda.current_stream(dev).cuda_stream


def loaded() -> Dict[str, ctypes.CDLL]:
    """The libraries loaded so far in this process, by name."""
    return dict(_libs)


def bind(name: str) -> ctypes.CDLL:
    """``lib<name>.so`` (:func:`load`) with its entry points declared as
    :data:`SIGNATURES` says, once a process."""
    lib = _bound.get(name)
    if lib is None:
        lib = load(name)
        for entry, args in SIGNATURES[name].items():
            fn = getattr(lib, entry)
            fn.argtypes, fn.restype = list(args), ctypes.c_int
        fn = getattr(lib, ERROR_STRING)
        fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_char_p
        _bound[name] = lib
    return lib


def launch(lib: ctypes.CDLL, entry: str, dev: torch.device, args: tuple, who: str,
           counter: Optional[str]) -> None:
    """``lib.entry(*args, stream)`` on ``dev``, the device of the call's x,
    entered only where it is not the current device, with ``dev``'s current
    stream (:func:`stream_handle`). Raises on a nonzero code; otherwise adds
    one to ``launches[counter]`` (None: the launch does not count)."""
    fn = getattr(lib, entry)
    if dev.index == torch.cuda.current_device():
        rc = fn(*args, stream_handle(dev))
    else:
        with torch.cuda.device(dev):
            rc = fn(*args, stream_handle(dev))
    if rc:
        msg = getattr(lib, ERROR_STRING)(rc).decode(errors="replace")
        raise RuntimeError(f"{who}: kernel launch failed: {msg} ({rc})")
    if counter is not None:
        launches[counter] += 1


def on_cuda(x: torch.Tensor, backend: str) -> bool:
    """True when a dispatcher's call goes to the kernel: ``backend`` names
    the path the caller expects, ``"auto"`` (follow x's device), ``"cuda"``
    or ``"torch"`` (the plain version, CPU tensors only); a mismatch raises
    instead of changing path."""
    if backend not in ("auto", "cuda", "torch"):
        raise ValueError(f"unknown backend {backend!r} (auto|cuda|torch)")
    if backend == "torch" and x.is_cuda:
        raise ValueError(
            "backend='torch' runs the plain version on CPU tensors only; "
            "CUDA tensors go through the kernel"
        )
    return backend == "cuda" or x.is_cuda
