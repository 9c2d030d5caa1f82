"""Structure-driven format selection: DIA / HYB5 / CSR5, and auto-RCM.

A copy of the host pass of ``benchmark_spmv_using_csr5_tpu/ops/select.py``
(``select.py:53-190``), with the same thresholds, so that both packages
make the same decision on the same matrix. One O(nnz) pass over the
diagonal occupancy picks the format:

- **DIA** whenever the whole matrix fits dense diagonals (ndiag <=
  MAX_DIAGS, fill >= MIN_FILL): K5 streams only the value plane, with no
  column indices and no gather.
- **HYB5** when a dense-diagonal core holds a meaningful share of nnz but
  a scattered remainder rules pure DIA out.
- **CSR5** otherwise: the general path (K1).

The thresholds were set by crossovers the JAX package measured on a TPU.
Whether they hold on an H100 is what ``PERF.md`` records: its K5-vs-K1 rows
at banded500k are the card's own answer, and no TPU time is carried over.

:func:`select_plan` adds the reordering decision: a CSR5 matrix whose
bandwidth exceeds ``SCATTER_BANDWIDTH`` gets the RCM permutation when it
shrinks the bandwidth at least ``RCM_MIN_GAIN`` times.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional

import numpy as np

from .dia import MAX_DIAGS, MIN_FILL

#: a diagonal is HYB-dense when filled to at least this ratio of its
#: maximum length (ops/hyb.py default)
HYB_DIAG_FILL = 0.5
#: HYB pays two kernel launches and a y add; only worth it when the dense
#: diagonals carry at least this share of nnz
HYB_MIN_DIA_SHARE = 0.35


class DiagStats(NamedTuple):
    ndiag: int  #: distinct diagonals
    nnz: int
    #: nnz share on diagonals filled >= HYB_DIAG_FILL (capped at MAX_DIAGS)
    dense_share: float
    dense_diags: int
    #: True when build_dia would accept the whole matrix
    dia_ok: bool


def analyze_diagonals(
    row_ptr, col_idx, shape, max_diags: int = MAX_DIAGS
) -> DiagStats:
    """One pass over the structure: diagonal count, fill, dense share."""
    m, n = shape
    row_ptr = np.asarray(row_ptr, np.int64)
    col_idx = np.asarray(col_idx, np.int64)
    nnz = int(col_idx.shape[0])
    if nnz == 0:
        return DiagStats(0, 0, 0.0, 0, False)
    rows = np.repeat(np.arange(m, dtype=np.int64), np.diff(row_ptr))
    off = col_idx - rows
    uniq, counts = np.unique(off, return_counts=True)
    ndiag = int(len(uniq))
    length = np.minimum(m, n - uniq) - np.maximum(0, -uniq)
    fill = counts / np.maximum(length, 1)
    dense = fill >= HYB_DIAG_FILL
    if dense.sum() > max_diags:
        keep = np.argsort(fill[dense])[::-1][:max_diags]
        sel = np.flatnonzero(dense)[keep]
        dense = np.zeros_like(dense)
        dense[sel] = True
    dense_share = float(counts[dense].sum() / nnz)
    dia_ok = ndiag <= max_diags and nnz >= MIN_FILL * ndiag * m
    return DiagStats(ndiag, nnz, dense_share, int(dense.sum()), dia_ok)


def select_format(row_ptr, col_idx, shape) -> str:
    """Pick ``"dia"``, ``"hyb"`` or ``"csr5"`` from the structure alone."""
    st = analyze_diagonals(row_ptr, col_idx, shape)
    if st.dia_ok:
        return "dia"
    if st.dense_diags > 0 and st.dense_share >= HYB_MIN_DIA_SHARE:
        return "hyb"
    return "csr5"


#: bandwidth (max |col-row|) above which a reordering attempt is worth its
#: one-time cost (the JAX kernel's contiguous-gather reach, 8 pages of 128
#: columns; kept so both packages plan alike)
SCATTER_BANDWIDTH = 8 * 128
#: apply RCM only when it shrinks the bandwidth at least this much
RCM_MIN_GAIN = 4.0


class Plan(NamedTuple):
    """A full execution plan: storage format + optional reordering."""

    format: str  #: "dia" | "hyb" | "csr5"
    reorder: Optional[str]  #: None | "rcm"
    bandwidth_before: int
    bandwidth_after: Optional[int]  #: RCM result (None if not attempted)
    plan_ms: float  #: decision cost (incl. the RCM attempt if made)


def select_plan(row_ptr, col_idx, shape) -> Plan:
    """Format selection plus scattered-locality recovery (the auto
    ``--reorder`` path): when the format is CSR5 and the bandwidth exceeds
    ``SCATTER_BANDWIDTH``, compute the RCM permutation and recommend it
    iff it shrinks the bandwidth >= ``RCM_MIN_GAIN`` times. Matrices with
    unrecoverable locality (uniform-random columns) fail the gain gate and
    stay unpermuted. Apply the plan with :func:`apply_plan`."""
    t0 = time.perf_counter()
    fmt = select_format(row_ptr, col_idx, shape)
    bw0 = _bandwidth(row_ptr, col_idx)
    reorder = None
    bw1 = None
    if fmt == "csr5" and bw0 > SCATTER_BANDWIDTH:
        import scipy.sparse as sp

        from ..utils.reorder import bandwidth as bw_of
        from ..utils.reorder import rcm_permutation

        a = sp.csr_matrix(
            (np.ones(len(col_idx), np.float32), col_idx, row_ptr),
            shape=shape,
        )
        perm = rcm_permutation(a)
        bw1 = int(bw_of(a[perm][:, perm]))
        if bw1 * RCM_MIN_GAIN <= bw0:
            reorder = "rcm"
    return Plan(
        format=fmt,
        reorder=reorder,
        bandwidth_before=bw0,
        bandwidth_after=bw1,
        plan_ms=(time.perf_counter() - t0) * 1e3,
    )


def apply_plan(csr, plan: Plan):
    """Apply a plan's reordering: returns ``(csr', perm)`` with
    ``csr' = (row_ptr, col_idx, values, shape)`` permuted symmetrically
    (perm is None when the plan keeps the original order). SpMV relation:
    ``A' (x[perm]) == (A x)[perm]`` (utils/reorder.permute_symmetric)."""
    if plan.reorder is None:
        return csr, None
    import scipy.sparse as sp

    from ..utils.reorder import reorder_for_locality

    if not isinstance(csr, sp.spmatrix):
        row_ptr, col_idx, values, shape = csr
        csr = sp.csr_matrix((values, col_idx, row_ptr), shape=shape)
    a2, perm = reorder_for_locality(csr, method=plan.reorder)
    return (a2.indptr, a2.indices, a2.data, a2.shape), perm


def _bandwidth(row_ptr, col_idx) -> int:
    """max |col - row| straight from CSR (no scipy COO materialisation)."""
    row_ptr = np.asarray(row_ptr, np.int64)
    col_idx = np.asarray(col_idx, np.int64)
    if len(col_idx) == 0:
        return 0
    m = len(row_ptr) - 1
    rows = np.repeat(np.arange(m, dtype=np.int64), np.diff(row_ptr))
    return int(np.abs(col_idx - rows).max())
