"""Iterative solvers built on SpMV: the library's users.

The counterpart of ``benchmark_spmv_using_csr5_tpu/models/solvers.py``
(``solvers.py:20-223``), the same seven algorithms with the same
arguments and results. Each is a plain function on tensors that takes an
``spmv`` callable (for example ``lambda v: csr5_spmv(a5, v)``, which runs
K1 on a float32 plane and K4 on a float64 one). Where JAX runs
``fori_loop`` with a static count, these run a Python loop of the same
fixed count; where JAX calls ``jnp.linalg``, they call ``torch.linalg``.
Scalars stay tensors on the vectors' device, so the loops do not wait on
the card (GMRES's small least-squares solve runs on the host). Vectors
the solvers make themselves go to ``device`` (default: the card).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from ..config import DEFAULT_DEVICE, resolve_device

SpMV = Callable[[torch.Tensor], torch.Tensor]


def _safe_div(num: torch.Tensor, den: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    """num / den where ``ok``, else 0 (``jnp.where(ok, num / den, 0.0)``)."""
    return torch.where(ok, num / torch.where(ok, den, torch.ones_like(den)), torch.zeros_like(num))


def conjugate_gradient(
    spmv: SpMV, b: torch.Tensor, iters: int = 50
) -> Tuple[torch.Tensor, torch.Tensor]:
    """CG for SPD A, ``iters`` iterations. Returns (x, final residual
    norm)."""
    x = torch.zeros_like(b)
    r = b.clone()
    p = r.clone()
    rs = torch.dot(r, r)
    for _ in range(iters):
        ap = spmv(p)
        denom = torch.dot(p, ap)
        alpha = _safe_div(rs, denom, denom != 0)
        x = x + alpha * p
        r = r - alpha * ap
        rs_new = torch.dot(r, r)
        beta = _safe_div(rs_new, rs, rs != 0)
        p = r + beta * p
        rs = rs_new
    return x, torch.sqrt(rs)


def bicgstab(spmv: SpMV, b: torch.Tensor, iters: int = 50) -> Tuple[torch.Tensor, torch.Tensor]:
    """BiCGSTAB for general square A."""
    x = torch.zeros_like(b)
    r = b.clone()
    rhat = r.clone()
    one = torch.ones((), dtype=b.dtype, device=b.device)
    rho = alpha = omega = one
    v = p = torch.zeros_like(b)
    for _ in range(iters):
        rho_new = torch.dot(rhat, r)
        beta = (rho_new / torch.where(rho == 0, one, rho)) * (
            alpha / torch.where(omega == 0, one, omega)
        )
        p = r + beta * (p - omega * v)
        v = spmv(p)
        denom = torch.dot(rhat, v)
        alpha = rho_new / torch.where(denom == 0, one, denom)
        s = r - alpha * v
        t = spmv(s)
        tt = torch.dot(t, t)
        omega = _safe_div(torch.dot(t, s), tt, tt != 0)
        x = x + alpha * p + omega * s
        r = s - omega * t
        rho = rho_new
    return x, torch.linalg.vector_norm(r)


def iterative_refinement(
    spmv_lo: SpMV,
    spmv_hi: SpMV,
    b: torch.Tensor,
    outer_iters: int = 5,
    inner_iters: int = 50,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mixed-precision solve of SPD ``A x = b`` to float64 accuracy.

    The inner CG runs on the fast float32 operator (``spmv_lo``: K1 on a
    float32 or lossless bfloat16 plane), the residual is formed with the
    float64 operator (``spmv_hi``: K4 on the float64 plane). The error
    contracts by about the float32 accuracy factor per outer iteration.
    Returns (x in b's dtype, final residual norm).
    """
    x = torch.zeros_like(b)
    for _ in range(outer_iters):
        r = b - spmv_hi(x)
        d, _ = conjugate_gradient(spmv_lo, r.to(torch.float32), iters=inner_iters)
        x = x + d.to(b.dtype)
    r = b - spmv_hi(x)
    return x, torch.linalg.vector_norm(r)


def power_iteration(
    spmv: SpMV,
    n: int,
    iters: int = 100,
    generator: Optional[torch.Generator] = None,
    dtype=torch.float32,
    device=DEFAULT_DEVICE,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dominant eigenpair of A by power iteration, from a normal start
    vector drawn on the host from ``generator`` (a seeded
    :class:`torch.Generator`, in place of the JAX ``PRNGKey(seed)``;
    default ``manual_seed(0)``) and moved to ``device``. The two give
    different start vectors from the same seed."""
    device = resolve_device(device, "power_iteration")
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    v = torch.randn(n, generator=generator, dtype=dtype).to(device)
    v = v / torch.linalg.vector_norm(v)
    for _ in range(iters):
        w = spmv(v)
        v = w / torch.clamp(torch.linalg.vector_norm(w), min=1e-30)
    lam = torch.dot(v, spmv(v))
    return lam, v


def pagerank(
    spmv_T: SpMV, n: int, damping: float = 0.85, iters: int = 50, dtype=torch.float32,
    device=DEFAULT_DEVICE,
) -> torch.Tensor:
    """PageRank via repeated A^T @ r (``spmv_T`` must apply the column-
    stochastic transition matrix), with r on ``device``."""
    device = resolve_device(device, "pagerank")
    r = torch.full((n,), 1.0 / n, dtype=dtype, device=device)
    for _ in range(iters):
        r = damping * spmv_T(r) + (1.0 - damping) / n
        r = r / torch.clamp(torch.sum(r), min=1e-30)
    return r


def gmres(
    spmv: SpMV, b: torch.Tensor, restart: int = 20, outer_iters: int = 5
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Restarted GMRES(m) for general square A: Arnoldi with modified
    Gram-Schmidt, then the small (m+1, m) least-squares solve. Returns
    (x, final residual norm)."""
    m = restart
    n = b.shape[0]
    x = torch.zeros_like(b)
    tiny = 1e-30
    for _ in range(outer_iters):
        r = b - spmv(x)
        beta = torch.linalg.vector_norm(r)
        V = torch.zeros((m + 1, n), dtype=b.dtype, device=b.device)
        V[0] = r / torch.where(beta > tiny, beta, torch.ones_like(beta))
        H = torch.zeros((m + 1, m), dtype=b.dtype, device=b.device)
        for j in range(m):
            w = spmv(V[j])
            for i in range(j + 1):
                hij = torch.dot(V[i], w)
                w = w - hij * V[i]
                H[i, j] = hij
            hn = torch.linalg.vector_norm(w)
            H[j + 1, j] = hn
            V[j + 1] = w / torch.where(hn > tiny, hn, torch.ones_like(hn))
        e1 = torch.zeros(m + 1, dtype=b.dtype, device=b.device)
        e1[0] = beta
        # the least-squares solve is (m+1) x m: small, on the host
        y = torch.linalg.lstsq(H.cpu(), e1.cpu()[:, None]).solution[:, 0].to(b.device)
        x = x + V[:m].T @ y
    return x, torch.linalg.vector_norm(b - spmv(x))


def lanczos(
    spmv: SpMV, v0: torch.Tensor, iters: int = 30
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Symmetric Lanczos tridiagonalisation (no reorthogonalisation).

    Returns (alphas, betas, eigvals of the tridiagonal T): the extremal
    eigenvalues of T approximate A's spectrum edges.
    """
    v = v0 / torch.linalg.vector_norm(v0)
    v_prev = torch.zeros_like(v)
    beta_prev = torch.zeros((), dtype=v.dtype, device=v.device)
    al = torch.zeros(iters, dtype=v.dtype, device=v.device)
    be = torch.zeros(iters, dtype=v.dtype, device=v.device)
    for j in range(iters):
        w = spmv(v) - beta_prev * v_prev
        alpha = torch.dot(v, w)
        w = w - alpha * v
        beta = torch.linalg.vector_norm(w)
        v_prev, v = v, w / torch.where(beta > 1e-30, beta, torch.ones_like(beta))
        beta_prev = beta
        al[j] = alpha
        be[j] = beta
    T = torch.diag(al) + torch.diag(be[:-1], 1) + torch.diag(be[:-1], -1)
    return al, be, torch.linalg.eigvalsh(T)
