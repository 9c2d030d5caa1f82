"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles alone into
``_build/lib<name>.so`` inside the package (listed in ``.gitignore``),
at first use, for ``sm_90a`` (Hopper). The library is rebuilt when its
source is newer. Nothing is built when a module is imported, and a failed
build raises: there is no fallback.
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
#: up-to-date library was only loaded)
build_seconds: Dict[str, float] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def load(name: str) -> ctypes.CDLL:
    """The loaded ``lib<name>.so``, built from ``csrc/<name>.cu`` if it is
    missing or older than its source."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        src = os.path.join(CSRC_DIR, f"{name}.cu")
        out = os.path.join(BUILD_DIR, f"lib{name}.so")
        t0 = time.perf_counter()
        if not os.path.exists(out) or os.path.getmtime(out) < os.path.getmtime(src):
            os.makedirs(BUILD_DIR, exist_ok=True)
            # build to a temporary name, then rename: a concurrent loader
            # never sees a half-written library
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            try:
                res = subprocess.run(
                    [_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                    capture_output=True,
                    text=True,
                    timeout=600,
                )
                if res.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed for {src} (rc {res.returncode}):\n"
                        f"{res.stderr[-4000:]}"
                    )
                os.replace(tmp, out)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        build_seconds[name] = time.perf_counter() - t0
        lib = ctypes.CDLL(out)
        _libs[name] = lib
        return lib


def loaded() -> Dict[str, ctypes.CDLL]:
    """The libraries loaded so far in this process, by name."""
    return dict(_libs)
