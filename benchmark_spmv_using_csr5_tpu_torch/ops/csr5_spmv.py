"""CSR5 SpMV executors: y = alpha * A @ x (``anonymouslib_cuda.h:262-285``).

- :func:`csr5_spmv_torch`: the plain PyTorch version of kernel K1, the
  twin of the JAX package's ``csr5_spmv_xla`` (``csr5_spmv.py:34-75``):
  gather, products, cumsum in element order, the row-end map, the
  wrapped or aligned diff, and a scatter-add into ``m_pad`` rows.
- :func:`csr5_spmv`: the dispatcher. CUDA tensors go through the
  hand-written kernel (:mod:`.csr5_kernel`), CPU tensors through the
  plain version. Nothing else: a CUDA tensor never reaches the plain
  version through it.
"""

from __future__ import annotations

import torch

from ..models.formats import CSR5Matrix, col_tiles_of


def csr5_spmv_torch(a5: CSR5Matrix, x: torch.Tensor, alpha=1.0) -> torch.Tensor:
    """The CSR5 tile decomposition in plain torch ops (any device)."""
    p = a5.num_tiles
    sig, omega = a5.sigma, a5.omega
    T = sig * omega

    cols = col_tiles_of(a5).reshape(-1).long()
    xg = x[cols].reshape(p, sig, omega)
    prod = (a5.val_tiles * xg).to(x.dtype)

    # tile-local inclusive prefix in element order (lane-major)
    elem = prod.transpose(1, 2).reshape(p, T)  # [t, l*sig + s]
    P = torch.cumsum(elem, dim=1)

    # routed window extraction: W_end[t, d] = P[t, win_end[t, d]]
    # (lane bits are 16-22; flag bits 23/24 are masked off)
    wm = a5.win_map
    win_end = ((wm >> 16) & 127) * sig + (wm & 0xFFFF)
    W_end = torch.gather(P, 1, win_end.long())

    rs = a5.tile_ptr[:-1].long()
    base = (rs // 128) * 128
    a = (rs - base)[:, None]  # (p, 1)
    d = torch.arange(a5.capw, device=x.device)[None, :]
    zero = torch.zeros((), dtype=P.dtype, device=x.device)
    if a5.win_rel:
        # wrapped maps: slot d = row base+d for d >= rs%128, else
        # base+capw+d; the wrap seam is consecutive rows
        W_prev = torch.where(d == a, zero, torch.roll(W_end, 1, dims=1))
        W2 = W_end - W_prev
        rows = base[:, None] + d + torch.where(d < a, a5.capw, 0)
    else:
        # aligned maps: mask slots before the tile's first row
        W_prev = torch.cat([torch.zeros_like(W_end[:, :1]), W_end[:, :-1]], dim=1)
        W_prev = torch.where(d - 1 >= a, W_prev, zero)
        W2 = torch.where(d >= a, W_end - W_prev, zero)
        rows = (base[:, None] + d).expand(p, a5.capw)
    y_pad = torch.zeros(a5.m_pad, dtype=x.dtype, device=x.device)
    y_pad.index_add_(0, rows.reshape(-1), W2.reshape(-1))
    return (alpha * y_pad[: a5.m]).to(x.dtype)


def csr5_spmv(
    a5: CSR5Matrix, x: torch.Tensor, alpha=1.0, backend: str = "auto"
) -> torch.Tensor:
    """Dispatching spmv(): the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors.

    ``backend`` names the path the caller expects: ``"auto"`` follows the
    device, ``"cuda"`` requires CUDA tensors and ``"torch"`` CPU tensors;
    a mismatch raises instead of changing path.
    """
    if backend not in ("auto", "cuda", "torch"):
        raise ValueError(f"unknown backend {backend!r} (auto|cuda|torch)")
    on_cuda = x.is_cuda
    if backend == "torch" and on_cuda:
        raise ValueError(
            "backend='torch' runs the plain version on CPU tensors only; "
            "CUDA tensors go through the kernel"
        )
    if backend == "cuda" or on_cuda:
        from .csr5_kernel import csr5_spmv_cuda

        return csr5_spmv_cuda(a5, x, alpha)
    return csr5_spmv_torch(a5, x, alpha)
