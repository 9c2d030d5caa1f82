"""Iterative solvers built on SpMV: the library's users.

The counterpart of ``benchmark_spmv_using_csr5_tpu/models/solvers.py``
(``solvers.py:20-223``), the same seven algorithms with the same
arguments and results. Each takes an ``spmv`` callable (for example
``lambda v: csr5_spmv(a5, v)``, which runs K1 on a float32 plane and K4
on a float64 one). Where JAX runs ``fori_loop`` with a static count,
these run a Python loop of the same fixed count; where JAX calls
``jnp.linalg``, they call ``torch.linalg`` or, for GMRES's least squares,
:func:`hessenberg_lstsq`.

Where JAX jits each solver whole, the port decorates each with
:func:`..utils.graphs.device_program`: on CUDA tensors a solve is one
CUDA graph, captured on the first call per key and replayed once per
call; on CPU tensors it is the eager body (``__wrapped__``). Two solvers
keep a step outside their graph: :func:`power_iteration` draws its start
vector on the host before :func:`power_iteration_loop`, and
:func:`lanczos` takes the tridiagonal's eigenvalues after
:func:`lanczos_loop` (cuSOLVER checks its info on the host, which cannot
be captured). Scalars stay tensors on the vectors' device, so no solver
waits on the card. Vectors the solvers make themselves go to ``device``
(default: the card).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from ..config import DEFAULT_DEVICE, resolve_device
from ..utils.graphs import device_program

SpMV = Callable[[torch.Tensor], torch.Tensor]


def _safe_div(num: torch.Tensor, den: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    """num / den where ``ok``, else 0 (``jnp.where(ok, num / den, 0.0)``)."""
    return torch.where(ok, num / torch.where(ok, den, torch.ones_like(den)), torch.zeros_like(num))


@device_program(loops=("iters",))
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


@device_program(loops=("iters",))
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


@device_program(loops=("outer_iters", "inner_iters"))
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
    different start vectors from the same seed. The iteration is
    :func:`power_iteration_loop`."""
    device = resolve_device(device, "power_iteration")
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    v0 = torch.randn(n, generator=generator, dtype=dtype).to(device)
    return power_iteration_loop(spmv, v0, iters=iters)


@device_program(loops=("iters",))
def power_iteration_loop(
    spmv: SpMV, v0: torch.Tensor, iters: int = 100
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Power iteration from the start vector ``v0``: ``iters`` products,
    each normalised, then the Rayleigh quotient. Returns (lambda, v)."""
    v = v0 / torch.linalg.vector_norm(v0)
    for _ in range(iters):
        w = spmv(v)
        v = w / torch.clamp(torch.linalg.vector_norm(w), min=1e-30)
    lam = torch.dot(v, spmv(v))
    return lam, v


@device_program(loops=("iters",))
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


def hessenberg_lstsq(H: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The least-squares solution y of ``H y = g`` for an upper Hessenberg
    H (k + 1, k), in tensor ops on H's device with no wait on the host:
    Givens rotations take [H | g] to upper triangular form, then one
    triangular solve. GMRES's counterpart of the JAX ``jnp.linalg.lstsq``.

    Arnoldi that breaks down at column j leaves H with a zero subdiagonal
    there and zero columns after it; those columns get zero pivots, and
    the minimum-norm answer that ``lstsq`` gives sets their coefficients to
    0. Every zero pivot is guarded so: its coefficient is 0."""
    k = H.shape[1]
    A = torch.cat([H, g[:, None]], dim=1)
    for j in range(k):
        ab = A[j : j + 2, j]
        r = torch.linalg.vector_norm(ab)
        dead = r == 0
        cs = ab / (r + dead)  # (c, s); (0, 0) where both entries are 0
        c, s = cs[0] + dead, cs[1]  # the identity there
        rot = torch.stack([c, s, -s, c]).view(2, 2)
        A[j : j + 2] = rot @ A[j : j + 2]
    R, rhs = A[:k, :k], A[:k, k]
    dead = R.diagonal() == 0
    R = torch.where(dead[:, None], torch.eye(k, dtype=R.dtype, device=R.device), R)
    rhs = torch.where(dead, torch.zeros_like(rhs), rhs)
    return torch.linalg.solve_triangular(R, rhs[:, None], upper=True)[:, 0]


@device_program(loops=("outer_iters", "restart"))
def gmres(
    spmv: SpMV, b: torch.Tensor, restart: int = 20, outer_iters: int = 5
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Restarted GMRES(m) for general square A: Arnoldi with modified
    Gram-Schmidt, then the small (m+1, m) least-squares solve on the
    vectors' device (:func:`hessenberg_lstsq`). Returns (x, final residual
    norm)."""
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
        x = x + V[:m].T @ hessenberg_lstsq(H, e1)
    return x, torch.linalg.vector_norm(b - spmv(x))


def lanczos(
    spmv: SpMV, v0: torch.Tensor, iters: int = 30
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Symmetric Lanczos tridiagonalisation (no reorthogonalisation).

    Returns (alphas, betas, eigvals of the tridiagonal T): the extremal
    eigenvalues of T approximate A's spectrum edges. The recurrence is
    :func:`lanczos_loop`; the eigenvalues of T follow it on the same
    device.
    """
    al, be = lanczos_loop(spmv, v0, iters=iters)
    T = torch.diag(al) + torch.diag(be[:-1], 1) + torch.diag(be[:-1], -1)
    return al, be, torch.linalg.eigvalsh(T)


@device_program(loops=("iters",))
def lanczos_loop(
    spmv: SpMV, v0: torch.Tensor, iters: int = 30
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Lanczos recurrence from ``v0``: ``iters`` steps. Returns (the
    alphas, the betas) of the tridiagonal T."""
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
    return al, be
