"""Locality-preserving matrix reorderings (bandwidth reduction).

A copy of ``benchmark_spmv_using_csr5_tpu/utils/reorder.py`` (host only,
scipy): the port's RCM permutation equals the JAX one element for
element. A symmetric permutation that clusters each tile's columns
shortens the span of x a scattered matrix reads. Solvers should run
entirely in permuted space (permute b once, un-permute x at the end) so
the per-iteration cost is zero.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import scipy.sparse as sp


def rcm_permutation(a_sp: sp.spmatrix) -> np.ndarray:
    """Reverse Cuthill-McKee ordering of the symmetrized pattern."""
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    a = sp.csr_matrix(a_sp)
    pattern = a + a.T
    return np.asarray(reverse_cuthill_mckee(pattern, symmetric_mode=True))


def permute_symmetric(
    a_sp: sp.spmatrix, perm: np.ndarray
) -> sp.csr_matrix:
    """A' = A[perm][:, perm] (rows and columns, same permutation).

    SpMV relation: ``A' (x[perm]) == (A x)[perm]`` — permute the input,
    un-permute the output with the same ``perm``.
    """
    a = sp.csr_matrix(a_sp)
    return a[perm][:, perm].tocsr()


def bandwidth(a_sp: sp.spmatrix) -> int:
    """Max |row - col| over the nonzeros (the quantity RCM minimizes)."""
    coo = sp.coo_matrix(a_sp)
    if coo.nnz == 0:
        return 0
    return int(np.abs(coo.row.astype(np.int64) - coo.col).max())


def reorder_for_locality(
    a_sp: sp.spmatrix, method: str = "rcm"
) -> Tuple[sp.csr_matrix, np.ndarray]:
    """Returns (A', perm) with A' = A[perm][:, perm].

    ``method``: "rcm" (reverse Cuthill-McKee). Use
    ``y = y_perm[inv_perm]`` with ``inv_perm = np.argsort(perm)`` to map
    results back, or keep solvers in permuted space.
    """
    if method != "rcm":
        raise ValueError(f"unknown reorder method {method!r}")
    perm = rcm_permutation(a_sp)
    return permute_symmetric(a_sp, perm), perm
