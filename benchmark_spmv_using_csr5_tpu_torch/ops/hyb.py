"""HYB5: the hybrid DIA + CSR5 format.

The counterpart of ``benchmark_spmv_using_csr5_tpu/ops/hyb.py``. Nonzeros
on dense diagonals (filled to at least ``diag_fill`` of their length) go
to a DIA part, run by K5 (SpMV) or K6 (SpMM); the irregular remainder goes
to a CSR5 part, run by K1 or K2; ``y = A_dia x + A_csr5 x``, DIA first, as
in the JAX package.

Unlike the JAX ``hyb_spmv``/``hyb_spmm``, which take the XLA path for a
part the Pallas kernels cannot take, the port has no second path on the
card: on CUDA tensors each part runs its kernel or raises.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import CSR5Config
from ..models.formats import CSR5Matrix
from .convert import build_csr5
from .csr5_spmv import csr5_spmm, csr5_spmv
from .dia import CHUNK_ROWS, LANES, MAX_DIAGS, DIAMatrix, _as_host, dia_spmm, dia_spmv


@dataclasses.dataclass
class HYBMatrix:
    """DIA part + CSR5 part; either may be None (degenerate splits)."""

    shape: Tuple[int, int]
    nnz_stored: int
    dia: Optional[DIAMatrix] = None
    csr5: Optional[CSR5Matrix] = None

    @property
    def m(self) -> int:
        return self.shape[0]

    @property
    def n(self) -> int:
        return self.shape[1]

    @property
    def nnz(self) -> int:
        return self.nnz_stored


def build_hyb(
    csr,
    diag_fill: float = 0.5,
    max_diags: int = MAX_DIAGS,
    config: Optional[CSR5Config] = None,
    device="cpu",
) -> HYBMatrix:
    """Split nonzeros into dense diagonals (DIA) and the rest (CSR5)
    (``hyb.py:67-136``).

    A diagonal is "dense" when it holds at least ``diag_fill`` of its
    maximum possible length; the densest ``max_diags`` qualify. Either
    side may come out empty, and the field is then None. Both parts keep
    the input's value dtype (float64 narrowed to float32) and go to
    ``device``.
    """
    row_ptr, col_idx, values, (m, n) = _as_host(csr)
    nnz = int(values.shape[0])
    if nnz == 0:
        return HYBMatrix(shape=(m, n), nnz_stored=0)
    rows = np.repeat(np.arange(m, dtype=np.int64), np.diff(row_ptr))
    off = col_idx - rows
    uniq, inv, counts = np.unique(off, return_inverse=True, return_counts=True)
    # max length of diagonal o on an (m, n) matrix
    length = np.minimum(m, n - uniq) - np.maximum(0, -uniq)
    fill = counts / np.maximum(length, 1)
    dense = fill >= diag_fill
    if dense.sum() > max_diags:
        cut = np.sort(fill[dense])[::-1][max_diags - 1]
        dense &= fill >= cut
        # ties may still exceed the cap: keep the first max_diags
        keep_idx = np.flatnonzero(dense)[:max_diags]
        dense = np.zeros_like(dense)
        dense[keep_idx] = True

    on_dia = dense[inv]
    dia = None
    if on_dia.any():
        sel = np.flatnonzero(on_dia)
        d_rows = rows[sel]
        d_off = off[sel]
        d_uniq = uniq[dense]
        m_pad = -(-m // CHUNK_ROWS) * CHUNK_ROWS
        # the interleaved (m_pad/128, ndiag, 128) layout, duplicates summed
        data = np.zeros((m_pad // LANES, len(d_uniq), LANES), values.dtype)
        k = np.searchsorted(d_uniq, d_off)
        np.add.at(data, (d_rows >> 7, k, d_rows & (LANES - 1)), values[sel])
        dia = DIAMatrix(
            shape=(m, n),
            offsets=tuple(int(o) for o in d_uniq),
            nnz_stored=int(len(sel)),
            data=torch.from_numpy(data).to(device=device, dtype=torch.float32),
            m_pad=m_pad,
            interleaved=True,
        )

    csr5 = None
    if not on_dia.all():
        keep = ~on_dia
        counts_r = np.bincount(rows[keep], minlength=m)
        rp2 = np.zeros(m + 1, np.int64)
        np.cumsum(counts_r, out=rp2[1:])
        csr5 = build_csr5(
            (rp2, col_idx[keep].astype(np.int32), values[keep], (m, n)),
            config,
            device=device,
        )

    return HYBMatrix(shape=(m, n), nnz_stored=nnz, dia=dia, csr5=csr5)


def hyb_spmv(
    h: HYBMatrix, x: torch.Tensor, alpha=1.0, backend: str = "auto"
) -> torch.Tensor:
    """y = alpha * A @ x = DIA part (K5) + CSR5 part (K1) on CUDA tensors;
    the plain versions of both on CPU tensors. ``backend`` is passed to
    both dispatchers."""
    y = None
    if h.dia is not None:
        y = dia_spmv(h.dia, x, alpha, backend=backend)
    if h.csr5 is not None:
        yc = csr5_spmv(h.csr5, x, alpha, backend=backend)
        y = yc if y is None else y + yc
    if y is None:
        return torch.zeros(h.m, dtype=x.dtype, device=x.device)
    return y


def hyb_spmm(
    h: HYBMatrix, x: torch.Tensor, alpha=1.0, backend: str = "auto"
) -> torch.Tensor:
    """Y = alpha * A @ X for X (n, R) (``hyb.py:176-217``): DIA part (K6)
    + CSR5 part (K2) on CUDA tensors, the plain versions of both on CPU
    tensors; each part streams its value plane once for all R."""
    y = None
    if h.dia is not None:
        y = dia_spmm(h.dia, x, alpha, backend=backend)
    if h.csr5 is not None:
        yc = csr5_spmm(h.csr5, x, alpha, backend=backend)
        y = yc if y is None else y + yc
    if y is None:
        return torch.zeros((h.m, x.shape[1]), dtype=x.dtype, device=x.device)
    return y
