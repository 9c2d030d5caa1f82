"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles alone into
``_build/lib<name>.so`` inside the package (listed in ``.gitignore``),
at first use, for ``sm_90a`` (Hopper). The library is rebuilt when its
source, or a shared header ``csrc/*.cuh``, is newer; :func:`build` starts
one nvcc per stale source at once. Nothing is built when a module is
imported, and a failed build raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Dict

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
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
