"""Synthetic sparse-matrix generators for tests and benchmarks.

Copied unchanged from ``benchmark_spmv_using_csr5_tpu/utils/synth.py``,
plus :func:`f64_banded` from the JAX bench's ``case_runner.py``:
the JAX package cannot be imported without jax and flax, which the
port does not depend on.

The reference ships no matrices (README usage is ``./spmv example.mtx``);
its correctness strategy uses small random integer values for stable fp
comparison (``main.cu:314-326``). These generators reproduce that value
distribution (integers in [0, 10)) and add shape families covering every
CSR5 edge case: empty rows (dirty tiles), single dense rows (fast-track
tiles), power-law rows (calibrator stress), and banded FEM-like structure
(the SuiteSparse ``cant``/``consph`` class from BASELINE.json configs).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


from .hostmem import chunked_random_integers as _chunked_random_integers
from .hostmem import prefaulted


def random_csr(
    m: int,
    n: int,
    density: float = 0.01,
    dtype=np.float64,
    seed: int = 0,
    integer_values: bool = True,
) -> sp.csr_matrix:
    """Uniform random sparsity; values are rand()%10-style small integers."""
    rng = np.random.default_rng(seed)
    a = sp.random(m, n, density=density, format="csr", dtype=np.float64, random_state=rng)
    if integer_values:
        a.data = rng.integers(1, 10, size=a.nnz).astype(np.float64)
    return a.astype(dtype)


def banded(m: int, bandwidth: int = 27, dtype=np.float64, seed: int = 0) -> sp.csr_matrix:
    """FEM-like banded matrix (structured SuiteSparse class).

    Direct CSR assembly into prefaulted buffers: ``sp.diags`` + dia->csr
    took >400 s at m=20M on this host (the first-touch write pathology,
    see ``prefaulted``); this path builds the exact sparsity pattern of
    the original ``sp.diags`` construction — diagonals
    ``-bw//2 .. bw//2`` with Python floor division, i.e. offsets
    -(h+1)..h for odd bw (bw+1 diagonals; hence banded500k(27) = 14.0M
    nnz at 28/row interior) and -h..h for even bw, clipped at the
    edges — in a few seconds at 100M nnz.
    """
    rng = np.random.default_rng(seed)
    lo, hi = -bandwidth // 2, bandwidth // 2  # offsets lo..hi inclusive
    nd = hi - lo + 1
    if m <= 4 * nd + 8:  # tiny: the generic path is instant
        offsets = list(range(lo, hi + 1))
        diags = [rng.integers(1, 10, size=m).astype(np.float64) for _ in offsets]
        return sp.diags(diags, offsets, shape=(m, m), format="csr").astype(dtype)

    # row lengths: min(m-1, i+hi) - max(0, i+lo) + 1; interior rows
    # (-lo <= i < m-hi) carry all nd entries
    # int32 row_ptr matches col_idx's index dtype: the csr_matrix
    # constructor would otherwise upcast one of them into a fresh (slow,
    # see ``prefaulted``) buffer
    row_ptr = prefaulted(m + 1, np.int32)
    view = row_ptr[1:]
    view.fill(nd)
    for i in range(-lo):  # left-clipped rows
        view[i] = min(m - 1, i + hi) - 0 + 1
    for i in range(max(m - hi, -lo), m):  # right-clipped rows
        view[i] = (m - 1) - max(0, i + lo) + 1
    np.cumsum(row_ptr[1:], out=row_ptr[1:])
    nnz = int(row_ptr[-1])

    col_idx = prefaulted(nnz, np.int32)
    a0, b0 = -lo, m - hi  # interior row range
    inner = col_idx[row_ptr[a0] : row_ptr[b0]].reshape(b0 - a0, nd)
    # chunked iota+offset writes (each chunk's temps stay cache-sized)
    CH = 1 << 18
    offs_row = np.arange(lo, hi + 1, dtype=np.int32)[None, :]
    for s in range(a0, b0, CH):
        e = min(s + CH, b0)
        np.add(
            np.arange(s, e, dtype=np.int32)[:, None],
            offs_row,
            out=inner[s - a0 : e - a0],
        )
    for i in range(a0):  # left edge rows
        c0, c1 = 0, min(m - 1, i + hi)
        col_idx[row_ptr[i] : row_ptr[i + 1]] = np.arange(c0, c1 + 1, dtype=np.int32)
    for i in range(b0, m):  # right edge rows
        c0, c1 = max(0, i + lo), m - 1
        col_idx[row_ptr[i] : row_ptr[i + 1]] = np.arange(c0, c1 + 1, dtype=np.int32)

    values = prefaulted(nnz, np.dtype(dtype))
    _chunked_random_integers(rng, 1, 10, values)
    a = sp.csr_matrix((values, col_idx, row_ptr), shape=(m, m))
    a.has_sorted_indices = True
    a.has_canonical_format = True
    return a


def f64_banded(m: int, bw: int, seed: int = 0) -> sp.csr_matrix:
    """Banded with full-precision float64 values (non-dyadic, 3-decade
    spread): the JAX bench's ``df64_banded500k`` matrix at
    ``f64_banded(500_000, 27)``, copied from
    ``benchmark_spmv_using_csr5_tpu/bench/case_runner.py:44-55``
    (``_f64_banded``). Integer values would be exact in float32 and hide
    the float64 kernel's precision."""
    a = sp.csr_matrix(banded(m, bw, dtype=np.float64))
    rng = np.random.default_rng(seed)
    a.data = rng.uniform(0.1, 1.0, a.nnz) * 10.0 ** rng.integers(-1, 2, a.nnz)
    return a


def power_law(
    m: int,
    n: int,
    mean_nnz_per_row: float = 8.0,
    alpha: float = 1.8,
    dtype=np.float64,
    seed: int = 0,
) -> sp.csr_matrix:
    """Power-law row lengths (webbase/circuit class): a few huge rows, many
    tiny or empty rows. Exercises fast-track, dirty tiles and the
    calibrator."""
    rng = np.random.default_rng(seed)
    raw = rng.pareto(alpha, size=m) + 0.1
    lengths = np.minimum((raw / raw.mean() * mean_nnz_per_row).astype(np.int64), n)
    # force some empty rows
    lengths[rng.random(m) < 0.1] = 0
    row_ptr = np.zeros(m + 1, dtype=np.int64)
    np.cumsum(lengths, out=row_ptr[1:])
    nnz = int(row_ptr[-1])
    col_idx = rng.integers(0, n, size=nnz).astype(np.int32)
    values = rng.integers(1, 10, size=nnz).astype(np.float64)
    a = sp.csr_matrix((values, col_idx, row_ptr), shape=(m, n))
    return a.astype(dtype)


def scattered_band(
    m: int,
    nnz_per_row: int = 16,
    bandwidth: int = 6000,
    dtype=np.float64,
    seed: int = 0,
) -> sp.csr_matrix:
    """Random columns inside a diagonal band: moderate page locality (the
    tier-1 masked-unroll gather regime -- pages span > CONTIG_PAGE_CAP but
    stay under MAX_UNROLL_PAGES)."""
    rng = np.random.default_rng(seed)
    rows_i = np.arange(m, dtype=np.int64)[:, None]
    lo = np.clip(rows_i - bandwidth // 2, 0, max(m - bandwidth, 0))
    off = rng.integers(0, bandwidth, size=(m, nnz_per_row))
    cols = np.minimum(lo + off, m - 1).astype(np.int32)
    cols.sort(axis=1)
    vals = rng.integers(1, 10, size=(m, nnz_per_row)).astype(dtype)
    row_ptr = np.arange(m + 1, dtype=np.int64) * nnz_per_row
    return sp.csr_matrix((vals.ravel(), cols.ravel(), row_ptr), shape=(m, m))


def fem_blocks(
    m: int,
    block: int = 3,
    neighbors: int = 21,
    node_bandwidth: int = 1400,
    dtype=np.float32,
    seed: int = 0,
) -> sp.csr_matrix:
    """FEM block-structured matrix (the SuiteSparse ``cant``/``consph``
    class, BASELINE.json configs[1]): every node couples a ``block`` x
    ``block`` dense sub-block to ``neighbors`` other nodes drawn once
    from a +-``node_bandwidth``/2 window — uniform dense row blocks
    (every interior row has exactly ``neighbors * block`` nnz in
    ``neighbors`` runs of ``block`` consecutive columns) at mid
    bandwidth. Defaults mimic cant's ~63 nnz/row with 3-dof nodes.

    Structurally distinct from every other generator here: banded() is
    fully contiguous (tier 0), scattered_band() has no block runs; this
    one sits at the tier-0/1 boundary with sigma >= 24 row spans.
    """
    b = block
    N = max(m // b, 1)
    m = N * b
    rng = np.random.default_rng(seed)
    half = max(node_bandwidth // 2, 1)
    pool = np.arange(-half, half + 1)
    pool = pool[pool != 0]
    take = min(neighbors - 1, pool.size)
    offs = np.sort(
        np.concatenate(
            [[0], rng.choice(pool, size=take, replace=False)]
        )
    ).astype(np.int64)
    ncon = offs.size
    K = ncon * b  # nnz per interior dof row

    node_i = np.arange(N, dtype=np.int64)
    valid = (node_i[:, None] + offs[None, :] >= 0) & (
        node_i[:, None] + offs[None, :] < N
    )
    vcnt = valid.sum(axis=1).astype(np.int64)  # valid neighbors per node

    row_ptr = prefaulted(m + 1, np.int64)
    row_ptr[0] = 0
    np.cumsum(np.repeat(vcnt * b, b), out=row_ptr[1:])
    nnz = int(row_ptr[-1])
    col_idx = prefaulted(nnz, np.int32)

    a0 = int(-offs[0])  # first node with all neighbors in range
    b0 = int(N - offs[-1])
    # interior nodes: all b rows of a node share one sorted column
    # template ((i + offs) * b expanded to runs of b); chunked broadcast
    # writes into the prefaulted plane (first-touch rules, NOTES.md)
    if b0 > a0:
        inner = col_idx[row_ptr[a0 * b] : row_ptr[b0 * b]].reshape(
            (b0 - a0) * b, K
        )
        CH = 1 << 15
        lane = np.arange(b, dtype=np.int32)
        for s in range(a0, b0, CH):
            e = min(s + CH, b0)
            tmpl = (
                (np.arange(s, e, dtype=np.int64)[:, None] + offs) * b
            )[:, :, None] + lane  # (chunk, ncon, b)
            tmpl = tmpl.reshape(e - s, K).astype(np.int32)
            np.copyto(
                inner[(s - a0) * b : (e - a0) * b],
                np.broadcast_to(tmpl[:, None, :], (e - s, b, K)).reshape(
                    (e - s) * b, K
                ),
            )
    for i in list(range(a0)) + list(range(max(b0, a0), N)):  # boundary
        nb = i + offs[valid[i]]
        tmpl = ((nb * b)[:, None] + np.arange(b, dtype=np.int64)).reshape(-1)
        for k in range(b):
            r = i * b + k
            col_idx[row_ptr[r] : row_ptr[r + 1]] = tmpl
    values = prefaulted(nnz, np.dtype(dtype))
    _chunked_random_integers(rng, 1, 10, values)
    a = sp.csr_matrix((values, col_idx, row_ptr), shape=(m, m))
    a.has_sorted_indices = True
    a.has_canonical_format = True
    return a


def single_dense_row(m: int, n: int, row: int = 0, row_nnz: int = 4096, dtype=np.float64, seed: int = 0) -> sp.csr_matrix:
    """One long row among near-empty rows: many consecutive fast-track tiles
    sharing a single output row (calibrator chain stress,
    csr5_spmv_cuda.h:335-353)."""
    rng = np.random.default_rng(seed)
    cols = rng.choice(n, size=min(row_nnz, n), replace=False).astype(np.int32)
    rows = np.full(cols.shape, row, dtype=np.int32)
    # sprinkle a diagonal so other rows are non-empty
    diag_rows = np.arange(0, m, 3, dtype=np.int32)
    rows = np.concatenate([rows, diag_rows])
    cols = np.concatenate([cols, diag_rows % n])
    vals = rng.integers(1, 10, size=rows.size).astype(np.float64)
    a = sp.csr_matrix((vals, (rows, cols)), shape=(m, n))
    a.sum_duplicates()
    return a.astype(dtype)


def dense_x(n: int, dtype=np.float64, seed: int = 1) -> np.ndarray:
    """x vector with rand()%10 values (main.cu:323-326 parity)."""
    rng = np.random.default_rng(seed)
    return rng.integers(1, 10, size=n).astype(dtype)


EDGE_CASE_MATRICES = {
    "tiny": lambda dtype=np.float64: random_csr(40, 40, 0.15, dtype=dtype),
    "empty_rows": lambda dtype=np.float64: power_law(300, 300, 4.0, dtype=dtype),
    "banded": lambda dtype=np.float64: banded(500, 9, dtype=dtype),
    "fast_track": lambda dtype=np.float64: single_dense_row(64, 8192, dtype=dtype),
    "power_law": lambda dtype=np.float64: power_law(2000, 2000, 16.0, dtype=dtype),
    "wide": lambda dtype=np.float64: random_csr(64, 5000, 0.02, dtype=dtype),
    "tall": lambda dtype=np.float64: random_csr(5000, 64, 0.02, dtype=dtype),
}
