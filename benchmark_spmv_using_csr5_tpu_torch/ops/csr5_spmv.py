"""CSR5 SpMV and SpMM executors: y = alpha * A @ x
(``anonymouslib_cuda.h:262-285``) and Y = alpha * A @ X.

- :func:`csr5_spmv_torch`: the plain PyTorch version of kernel K1, the
  twin of the JAX package's ``csr5_spmv_xla`` (``csr5_spmv.py:34-75``):
  gather, products, cumsum in element order, the row-end map, the
  wrapped or aligned diff, and a scatter-add into ``m_pad`` rows.
- :func:`csr5_spmm_torch`: the plain version of kernel K2, the twin of
  ``csr5_spmm_xla`` (``csr5_spmv.py:90-96``): the same steps with the R
  right-hand sides as a trailing dimension.
- :func:`csr5_spmv_packed_torch` and :func:`csr5_spmm_packed_torch`: the
  plain versions of K1p and K2p, the same steps on the columns decoded
  from ``col_packed`` and ``pages`` even where the raw plane is present.
- :func:`csr5_spmv` and :func:`csr5_spmm`: the dispatchers. CUDA tensors
  go through the hand-written kernels, by dtype: float32 x to K1 or K2
  (K1p or K2p on a matrix with ``col_packed``, :mod:`.csr5_kernel`),
  float64 x on a float64 plane to K4
  (:mod:`.csr5_f64`). CPU tensors go through the plain versions, which
  are dtype-generic: :func:`csr5_spmv_torch` on float64 is K4's plain
  version. Nothing else: a CUDA tensor never reaches a plain version
  through them, and a float64 x never meets a float32 or bfloat16 plane
  (or the reverse): that raises instead of casting.
"""

from __future__ import annotations

import dataclasses

import torch

from ..models.formats import CSR5Matrix, col_tiles_from_packed, col_tiles_of
from ..utils.cuda_build import on_cuda


def csr5_spmm_torch(
    a5: CSR5Matrix, x: torch.Tensor, alpha=1.0, layout: str = "nr"
) -> torch.Tensor:
    """The CSR5 tile decomposition for R right-hand sides in plain torch
    ops (any device). ``layout="nr"``: X (n, R) in, Y (m, R) out;
    ``layout="rn"``: X^T (R, n) in, Y^T (R, m) out."""
    if layout not in ("nr", "rn"):
        raise ValueError(f"unknown layout {layout!r} (nr|rn)")
    xm = x.T if layout == "rn" else x  # (n, R)
    p = a5.num_tiles
    sig, omega = a5.sigma, a5.omega
    T = sig * omega
    R = xm.shape[1]

    cols = col_tiles_of(a5).reshape(-1).long()
    xg = xm[cols].reshape(p, sig, omega, R)
    prod = (a5.val_tiles[..., None] * xg).to(x.dtype)

    # tile-local inclusive prefix in element order (lane-major), per rhs
    elem = prod.transpose(1, 2).reshape(p, T, R)  # [t, l*sig + s, r]
    P = torch.cumsum(elem, dim=1)

    # routed window extraction: W_end[t, d] = P[t, win_end[t, d]]
    # (lane bits are 16-22; flag bits 23/24 are masked off)
    wm = a5.win_map
    win_end = ((wm >> 16) & 127) * sig + (wm & 0xFFFF)
    W_end = torch.gather(P, 1, win_end.long()[:, :, None].expand(p, a5.capw, R))

    rs = a5.tile_ptr[:-1].long()
    base = (rs // 128) * 128
    a = (rs - base)[:, None]  # (p, 1)
    d = torch.arange(a5.capw, device=x.device)[None, :]
    zero = torch.zeros((), dtype=P.dtype, device=x.device)
    if a5.win_rel:
        # wrapped maps: slot d = row base+d for d >= rs%128, else
        # base+capw+d; the wrap seam is consecutive rows
        W_prev = torch.where((d == a)[..., None], zero, torch.roll(W_end, 1, dims=1))
        W2 = W_end - W_prev
        rows = base[:, None] + d + torch.where(d < a, a5.capw, 0)
    else:
        # aligned maps: mask slots before the tile's first row
        W_prev = torch.cat([torch.zeros_like(W_end[:, :1]), W_end[:, :-1]], dim=1)
        W_prev = torch.where((d - 1 >= a)[..., None], W_prev, zero)
        W2 = torch.where((d >= a)[..., None], W_end - W_prev, zero)
        rows = (base[:, None] + d).expand(p, a5.capw)
    y_pad = torch.zeros((a5.m_pad, R), dtype=x.dtype, device=x.device)
    y_pad.index_add_(0, rows.reshape(-1), W2.reshape(-1, R))
    y = (alpha * y_pad[: a5.m]).to(x.dtype)
    return y.T.contiguous() if layout == "rn" else y


def csr5_spmv_torch(a5: CSR5Matrix, x: torch.Tensor, alpha=1.0) -> torch.Tensor:
    """The CSR5 tile decomposition in plain torch ops (any device): the
    R = 1 case of :func:`csr5_spmm_torch`, the same gather, products,
    cumsum in element order, window diff and scatter-add."""
    return csr5_spmm_torch(a5, x[:, None], alpha)[:, 0]


def _decoded(a5: CSR5Matrix) -> CSR5Matrix:
    """``a5`` with its raw column plane replaced by the decode of
    ``col_packed``."""
    return dataclasses.replace(a5, col_idx_tiles=col_tiles_from_packed(a5))


def csr5_spmv_packed_torch(a5: CSR5Matrix, x: torch.Tensor, alpha=1.0) -> torch.Tensor:
    """The plain version of K1p: :func:`csr5_spmv_torch` on the columns
    decoded from ``col_packed`` (raises when the matrix has none)."""
    return csr5_spmv_torch(_decoded(a5), x, alpha)


def csr5_spmm_packed_torch(
    a5: CSR5Matrix, x: torch.Tensor, alpha=1.0, layout: str = "nr"
) -> torch.Tensor:
    """The plain version of K2p: :func:`csr5_spmm_torch` on the columns
    decoded from ``col_packed``."""
    return csr5_spmm_torch(_decoded(a5), x, alpha, layout)


def _is_f64(a5: CSR5Matrix, x: torch.Tensor, who: str) -> bool:
    """True for a float64 x on a float64 plane; raises when one of the two
    is float64 and the other is not."""
    x64, p64 = x.dtype == torch.float64, a5.val_tiles.dtype == torch.float64
    if x64 != p64:
        raise ValueError(
            f"{who}: x is {x.dtype} and the value plane {a5.val_tiles.dtype}; float64 x "
            "needs a float64 plane (build_csr5(..., value_dtype=torch.float64)) and a "
            "float32 or bfloat16 plane needs float32 x: nothing is cast"
        )
    return x64


def csr5_spmv(
    a5: CSR5Matrix, x: torch.Tensor, alpha=1.0, backend: str = "auto"
) -> torch.Tensor:
    """Dispatching spmv(): K1 (float32 x) or K4 (float64 x on a float64
    plane) for CUDA tensors, the plain version for CPU tensors.
    ``backend`` names the path the caller expects: ``"auto"`` follows the
    device, ``"cuda"`` requires CUDA tensors and ``"torch"`` CPU tensors;
    a mismatch raises instead of changing path."""
    f64 = _is_f64(a5, x, "csr5_spmv")
    if on_cuda(x, backend):
        if f64:
            from .csr5_f64 import csr5_spmv_f64_cuda

            return csr5_spmv_f64_cuda(a5, x, alpha)
        from .csr5_kernel import csr5_spmv_cuda

        return csr5_spmv_cuda(a5, x, alpha)
    return csr5_spmv_torch(a5, x, alpha)


def csr5_spmm(
    a5: CSR5Matrix, x: torch.Tensor, alpha=1.0, backend: str = "auto", layout: str = "nr"
) -> torch.Tensor:
    """Dispatching SpMM (``csr5_spmv.py:99-114``): K2 for CUDA tensors,
    the plain version for CPU tensors, in either layout. float32 only:
    float64 raises, since neither the JAX Pallas path nor the reference
    has a float64 SpMM (``csr5_df64.py:48-49``)."""
    if x.dtype == torch.float64 or a5.val_tiles.dtype == torch.float64:
        raise ValueError(
            f"csr5_spmm: x is {x.dtype} and the value plane {a5.val_tiles.dtype}; there "
            "is no float64 SpMM (neither the JAX Pallas path nor the reference has one): "
            "run csr5_spmv on each column, or use float32"
        )
    if on_cuda(x, backend):
        from .csr5_kernel import csr5_spmm_cuda

        return csr5_spmm_cuda(a5, x, alpha, layout)
    return csr5_spmm_torch(a5, x, alpha, layout)
