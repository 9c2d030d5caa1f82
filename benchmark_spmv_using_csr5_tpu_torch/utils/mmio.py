"""Matrix Market I/O and COO->CSR construction.

Copied unchanged from ``benchmark_spmv_using_csr5_tpu/utils/mmio.py``:
the JAX package cannot be imported without jax and flax, which the
port does not depend on.

Re-implements, from the Matrix Market format specification, the loading
pipeline of the reference benchmark drivers (NIST ``mmio.{h,c}`` + the COO
read / symmetric-expansion / CSR-build logic of ``CSR5_cuda/main.cu:157-312``):

- banner parse: ``matrix coordinate real|integer|pattern
  general|symmetric|skew-symmetric|hermitian`` (complex rejected, like
  ``main.cu:175-185``).
- coordinate data: 1-based -> 0-based (``main.cu:211-238``); ``pattern``
  entries get value 1.0.
- symmetric / hermitian / skew expansion mirroring off-diagonal entries
  (``main.cu:243-270``).
- CSR build: stable counting sort by row; column order within a row follows
  file order, as in the reference's insertion-order build
  (``main.cu:276-312``). Duplicates are kept, not summed, matching the
  reference.

A C++ fast path for huge files lives in ``native/`` (see
``utils.nativelib``); this module is the always-available pure-Python path
and the behavioural oracle for it.
"""

from __future__ import annotations

import gzip
import io
import os
from dataclasses import dataclass
from typing import Tuple

import numpy as np


class MatrixMarketError(ValueError):
    pass


@dataclass
class MMHeader:
    object: str  # "matrix"
    format: str  # "coordinate" | "array"
    field: str  # "real" | "integer" | "pattern" | "complex"
    symmetry: str  # "general" | "symmetric" | "skew-symmetric" | "hermitian"
    shape: Tuple[int, int]
    nnz_stored: int


def _open(path: str):
    if str(path).endswith(".gz"):
        return io.TextIOWrapper(gzip.open(path, "rb"))
    return open(path, "r")


def read_header(f) -> MMHeader:
    banner = f.readline()
    if not banner.startswith("%%MatrixMarket"):
        raise MatrixMarketError(f"bad MatrixMarket banner: {banner!r}")
    parts = banner.strip().split()
    if len(parts) < 5:
        raise MatrixMarketError(f"short MatrixMarket banner: {banner!r}")
    _, obj, fmt, field, symmetry = parts[:5]
    obj, fmt, field, symmetry = (s.lower() for s in (obj, fmt, field, symmetry))
    if obj != "matrix":
        raise MatrixMarketError(f"unsupported object {obj!r}")
    if fmt != "coordinate":
        # parity: reference supports only sparse coordinate (main.cu:186-189)
        raise MatrixMarketError("only 'coordinate' (sparse) .mtx is supported")
    if field == "complex":
        # parity: main.cu:175-179 rejects complex
        raise MatrixMarketError("complex matrices are not supported")
    # skip comments / blank lines
    line = f.readline()
    while line.startswith("%") or not line.strip():
        line = f.readline()
    dims = line.split()
    if len(dims) != 3:
        raise MatrixMarketError(f"bad size line: {line!r}")
    m, n, nnz = (int(v) for v in dims)
    return MMHeader(obj, fmt, field, symmetry, (m, n), nnz)


def read_mtx_coo(
    path: str, dtype=np.float64
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, Tuple[int, int]]:
    """Read a .mtx file into 0-based COO with symmetry expanded.

    Returns ``(row, col, values, (m, n))`` as numpy arrays, behaviourally
    matching ``main.cu:157-312``.
    """
    with _open(path) as f:
        hdr = read_header(f)
        rest = f.read()

    ncols = 2 if hdr.field == "pattern" else 3
    data = np.array(rest.split(), dtype=np.float64)
    if data.size < hdr.nnz_stored * ncols:
        raise MatrixMarketError(
            f"expected {hdr.nnz_stored} entries, file has {data.size // ncols}"
        )
    data = data[: hdr.nnz_stored * ncols].reshape(hdr.nnz_stored, ncols)

    row = data[:, 0].astype(np.int64) - 1
    col = data[:, 1].astype(np.int64) - 1
    if hdr.field == "pattern":
        val = np.ones(hdr.nnz_stored, dtype=dtype)
    else:
        val = data[:, 2].astype(dtype)

    if hdr.symmetry in ("symmetric", "hermitian", "skew-symmetric"):
        off = row != col
        sign = -1.0 if hdr.symmetry == "skew-symmetric" else 1.0
        row = np.concatenate([row, col[off]])
        col = np.concatenate([col, data[:, 0].astype(np.int64)[off] - 1])
        val = np.concatenate([val, sign * val[off]])

    return (
        row.astype(np.int32),
        col.astype(np.int32),
        val,
        hdr.shape,
    )


def coo_to_csr(
    row: np.ndarray,
    col: np.ndarray,
    val: np.ndarray,
    shape: Tuple[int, int],
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Stable counting sort by row -> (row_ptr, col_idx, values).

    Keeps within-row file order and duplicates (parity with
    ``main.cu:276-312``).
    """
    m = shape[0]
    counts = np.bincount(row, minlength=m).astype(np.int64)
    row_ptr = np.zeros(m + 1, dtype=np.int64)
    np.cumsum(counts, out=row_ptr[1:])
    order = np.argsort(row, kind="stable")
    if row_ptr[-1] > np.iinfo(np.int32).max:
        raise MatrixMarketError("nnz exceeds int32 index range")
    return row_ptr.astype(np.int32), col[order].astype(np.int32), val[order]


def read_mtx_csr(path: str, dtype=np.float64):
    """One-shot: .mtx -> (row_ptr, col_idx, values, shape)."""
    row, col, val, shape = read_mtx_coo(path, dtype=dtype)
    row_ptr, col_idx, values = coo_to_csr(row, col, val, shape)
    return row_ptr, col_idx, values, shape


def write_mtx(path: str, row_ptr, col_idx, values, shape, field="real"):
    """Write CSR as a general coordinate .mtx (mm_write_* parity,
    ``mmio.h:29-31`` -- unused in the reference but part of its API).

    Delegates to the native writer when available (the Python per-line
    loop is ~50x slower on this 1-vCPU host); ``field`` other than
    "real" always takes the Python path.
    """
    m, n = shape
    nnz = len(values)
    if field == "real":
        from . import nativelib

        if nativelib.write_matrix_market(path, row_ptr, col_idx, values, shape):
            return
    with open(path, "w") as f:
        f.write(f"%%MatrixMarket matrix coordinate {field} general\n")
        f.write(f"{m} {n} {nnz}\n")
        rows = np.repeat(np.arange(m), np.diff(row_ptr))
        for r, c, v in zip(rows, col_idx, values):
            if field == "pattern":
                f.write(f"{r + 1} {c + 1}\n")
            else:
                f.write(f"{r + 1} {c + 1} {v:.17g}\n")


def load_example_matrix(dtype=np.float64):
    """Small deterministic example matrix for smoke tests (the bundled
    ``example.mtx`` analogue from the reference README usage)."""
    dense = np.array(
        [
            [1, 0, 0, 2, 0, 0],
            [0, 3, 0, 0, 0, 4],
            [0, 0, 0, 0, 0, 0],  # empty row: exercises the dirty-bit path
            [5, 0, 6, 7, 0, 0],
            [0, 0, 0, 0, 8, 0],
            [0, 9, 0, 0, 10, 11],
        ],
        dtype=dtype,
    )
    import scipy.sparse as sp

    return sp.csr_matrix(dense)
