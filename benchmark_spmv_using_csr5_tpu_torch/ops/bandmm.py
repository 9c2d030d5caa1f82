"""Dense band-block SpMM: the multi-rhs path for banded matrices (kernel K7).

The counterpart of ``benchmark_spmv_using_csr5_tpu/ops/bandmm.py``. For
matrices whose 128-row blocks touch a bounded column window (banded,
stencil, RCM-reordered), each block is stored DENSE over its window, and
for every block b

    Y[b*128:(b+1)*128, :] = A_b (128, K) @ X[c0_b : c0_b + K, :]  (K, R)

so the dense plane streams once for all R right-hand sides. The build gate
(``MAX_K``, ``MAX_BYTES_RATIO``) sends other matrices to CSR5.

- :func:`build_bandblock` is the JAX host build: the same window plan, the
  same native fill (``utils/nativelib.py::bandblock_fill``) or numpy
  scatter, and the same bfloat16 gate (every value round-trips bfloat16
  exactly), so ``dense``, ``c0``, ``K`` and ``nx_pad`` equal the JAX ones.
  The plane is cast on the host and uploaded once: one device copy.
- :func:`bandmm_spmm_torch` is the plain PyTorch version of K7: the
  windows of X gathered per block, one batched float32 product.
- :func:`bandmm_spmm` and :func:`bandmm_spmv` dispatch: K7
  (:mod:`.bandmm_kernel`, ``csrc/bandmm.cu``) for CUDA tensors, the plain
  version for CPU tensors. Nothing else.

Precision (``bandmm.py:34-44``, ``:337-344``): ``"auto"`` is ``"highest"``
on a float32 plane (exact float32 products) and ``"default"`` on a
bfloat16 plane (X rounded to bfloat16; products of two bfloat16 values
are exact in float32). ``"default"`` on a float32 plane rounds both A and
X to bfloat16, as the TPU's DEFAULT matmul precision does (XLA on the CPU
does not: there DEFAULT is full float32). ``"highest"`` on a bfloat16
plane raises. Sums are float32 throughout; no TF32.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import DEFAULT_DEVICE, resolve_device
from ..utils import nativelib
from ..utils.cuda_build import on_cuda
from ..utils.hostmem import arena_take
from .convert import _as_host_csr, _bf16_roundtrip_exact

LANES = 128
#: per-block column-window width cap (the JAX package's gate)
MAX_K = 4096
#: reject when the dense plane (as float32) exceeds this multiple of the
#: CSR5 stream (val + col = 8 B/nnz)
MAX_BYTES_RATIO = 10.0
PRECISIONS = ("auto", "default", "highest")

#: phase timings (ms) of the most recent build_bandblock call
last_build_phases: dict = {}


@dataclasses.dataclass
class BandBlockMatrix:
    """Dense band-block form: 128-row blocks over per-block 128-aligned
    column windows of uniform width K (the JAX ``BandBlockMatrix``,
    ``bandmm.py:71-101``)."""

    dense: torch.Tensor  # (m_pad, K) float32 or bfloat16: block b = rows b*128..+128
    c0: torch.Tensor  # (1, nblk) int32: window start PAGE (column / 128) per block
    shape: Tuple[int, int]
    K: int
    nx_pad: int  # columns of X any window reaches: c0.max() * 128 + K
    nnz_stored: int = 0

    @property
    def m(self) -> int:
        return self.shape[0]

    @property
    def n(self) -> int:
        return self.shape[1]

    @property
    def nnz(self) -> int:
        return self.nnz_stored

    @property
    def num_blocks(self) -> int:
        return self.dense.shape[0] // LANES

    @property
    def dtype(self) -> torch.dtype:
        return self.dense.dtype

    @property
    def dense_bytes(self) -> int:
        return self.dense.numel() * self.dense.element_size()


def _window_plan(row_ptr, col_idx, m: int, nnz: int, max_k: int, max_bytes_ratio: float):
    """``(c0, K)`` of the band-block form (``bandmm.py:130-156``): c0 the
    128-aligned window start column of each block, K the uniform window
    width; None when a gate rejects the matrix."""
    if nnz == 0 or m == 0:
        return None
    nblk = -(-m // LANES)
    # per-block column ranges (one reduceat pass)
    starts = row_ptr[np.minimum(np.arange(nblk) * LANES, m)].astype(np.int64)
    ends = row_ptr[np.minimum(np.arange(1, nblk + 1) * LANES, m)].astype(np.int64)
    ne = np.flatnonzero(ends > starts)
    cmin = np.zeros(nblk, np.int64)
    cmax = np.zeros(nblk, np.int64)
    if ne.size:
        cmin[ne] = np.minimum.reduceat(col_idx, starts[ne])
        cmax[ne] = np.maximum.reduceat(col_idx, starts[ne])
    c0 = (cmin >> 7) << 7
    span = int((cmax - c0 + 1).max())
    K = -(-max(span, 1) // LANES) * LANES
    if K > max_k:
        return None
    if nblk * LANES * K * 4 > max_bytes_ratio * nnz * 8:
        return None
    return c0, K


def bandblock_accepts(
    csr, max_k: int = MAX_K, max_bytes_ratio: float = MAX_BYTES_RATIO
) -> bool:
    """True when :func:`build_bandblock` would return a matrix: its gates
    alone, without filling the plane (the CLI's ``--format auto --spmm``
    decision)."""
    row_ptr, col_idx, values, (m, _) = _as_host_csr(csr)
    nnz = int(values.shape[0])
    return _window_plan(row_ptr, col_idx, m, nnz, max_k, max_bytes_ratio) is not None


def build_bandblock(
    csr,
    max_k: int = MAX_K,
    max_bytes_ratio: float = MAX_BYTES_RATIO,
    value_dtype: Optional[torch.dtype] = None,
    device=DEFAULT_DEVICE,
) -> Optional[BandBlockMatrix]:
    """CSR -> dense band-block form on ``device`` (default: the card), or None when the
    matrix's 128-row blocks have no bounded column windows (uniform window
    width K <= ``max_k`` and float32 dense bytes <= ``max_bytes_ratio`` x
    the 8 B/nnz CSR5 stream; ``bandmm.py:104-202``). ``csr`` is
    ``(row_ptr, col_idx, values, shape)``, a scipy CSR matrix or a
    :class:`..models.formats.CSRMatrix`.

    ``value_dtype=None`` picks the storage: bfloat16 when every value
    round-trips bfloat16 exactly, else float32; ``torch.float32`` or
    ``torch.bfloat16`` forces it. Duplicate (row, col) entries keep the
    last value, as the JAX fill does. Phases land in
    :data:`last_build_phases`."""
    device = resolve_device(device, "build_bandblock")
    ph = {}
    t = time.perf_counter()
    row_ptr, col_idx, values, (m, n) = _as_host_csr(csr)
    nnz = int(values.shape[0])
    plan = _window_plan(row_ptr, col_idx, m, nnz, max_k, max_bytes_ratio)
    if plan is None:
        return None
    c0, K = plan
    nblk = c0.shape[0]
    m_pad = nblk * LANES
    # window starts as PAGE indices, as the JAX plane stores them
    c0_pages = (c0 >> 7).astype(np.int32)
    ph["plan"] = (time.perf_counter() - t) * 1e3

    t = time.perf_counter()
    dense = nativelib.bandblock_fill(
        row_ptr, col_idx, values, c0_pages, m, m_pad, K, arena="bb:dense"
    )
    if dense is None:
        # numpy route: flat index row*K + (col - c0[row >> 7])
        dense = arena_take((m_pad, K), np.float32, "bb:dense")
        rows = np.repeat(np.arange(m, dtype=np.int64), np.diff(row_ptr))
        idx = col_idx.astype(np.int64) - c0[rows >> 7] + rows * K
        dense.reshape(-1)[idx] = values
    ph["fill"] = (time.perf_counter() - t) * 1e3

    t = time.perf_counter()
    if value_dtype is None:
        value_dtype = torch.bfloat16 if _bf16_roundtrip_exact(values) else torch.float32
    if value_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"value_dtype {value_dtype}: the plane is float32 or bfloat16")
    ph["gate"] = (time.perf_counter() - t) * 1e3

    # cast on the host, then one upload: the device holds one copy. The
    # result never aliases the host plane, which lives in the reused arena.
    t = time.perf_counter()
    host = torch.from_numpy(dense)
    fresh = value_dtype != torch.float32
    if fresh:
        host = host.to(value_dtype)
    ph["cast"] = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    plane = host.to(device, copy=not fresh)
    c0_t = torch.from_numpy(c0_pages[None, :].copy()).to(device)
    if plane.is_cuda:
        torch.cuda.synchronize(plane.device)
    ph["upload"] = (time.perf_counter() - t) * 1e3
    last_build_phases.clear()
    last_build_phases.update(ph)
    return BandBlockMatrix(
        dense=plane,
        c0=c0_t,
        shape=(m, n),
        K=K,
        nx_pad=int(c0.max()) + K,
        nnz_stored=nnz,
    )


def bandmm_supported(bb: Optional[BandBlockMatrix], num_rhs: int) -> bool:
    """True when K7 takes ``bb`` with ``num_rhs`` right-hand sides: a
    float32 or bfloat16 plane whose K is a multiple of 128, and R >= 1.
    The JAX package's VMEM gate (``bandmm.py:233-240``) has no
    counterpart: K7 reads X from global memory at any size."""
    if bb is None or num_rhs < 1:
        return False
    return bb.dense.dtype in (torch.float32, torch.bfloat16) and bb.K % LANES == 0


def resolve_precision(bb: BandBlockMatrix, precision: str) -> str:
    """``"default"`` or ``"highest"`` for ``precision`` on ``bb``'s plane
    (``bandmm.py:337-343``)."""
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r} (auto|default|highest)")
    f32 = bb.dense.dtype == torch.float32
    if precision == "auto":
        return "highest" if f32 else "default"
    if precision == "highest" and not f32:
        raise ValueError(
            "precision='highest' needs an f32 dense plane: "
            "build_bandblock(..., value_dtype=torch.float32)"
        )
    return precision


def _round_bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(torch.float32)


def bandmm_spmm_torch(
    bb: BandBlockMatrix,
    x: torch.Tensor,
    alpha=1.0,
    precision: str = "auto",
    layout: str = "nr",
) -> torch.Tensor:
    """The plain version of K7 (any device): Y = alpha * A @ X as one
    batched float32 product of the (nblk, 128, K) plane with the gathered
    (nblk, K, R) windows of X, zero past n. ``"default"`` rounds the
    operands to bfloat16 first (both on a float32 plane, X on a bfloat16
    plane), so every product is exact and only the sums round. On CUDA
    tensors it needs ``torch.backends.cuda.matmul.allow_tf32`` False (the
    default), or the float32 product would run in TF32: it raises then."""
    prec = resolve_precision(bb, precision)
    if layout not in ("nr", "rn"):
        raise ValueError(f"unknown layout {layout!r} (nr|rn)")
    if x.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "bandmm_spmm_torch: torch.backends.cuda.matmul.allow_tf32 is True; "
            "the plain version needs full float32 products"
        )
    xm = (x.T if layout == "rn" else x).to(torch.float32) * alpha  # (n, R)
    n, R = xm.shape
    nblk, K = bb.num_blocks, bb.K
    cols = bb.c0.reshape(-1).to(x.device).long()[:, None] * LANES + torch.arange(
        K, device=x.device
    )
    valid = (cols < n)[..., None]
    xw = torch.where(valid, xm[cols.clamp_max(n - 1)], torch.zeros((), device=x.device))
    a = bb.dense.to(torch.float32).reshape(nblk, LANES, K)
    if prec == "default":
        xw = _round_bf16(xw)
        if bb.dense.dtype == torch.float32:
            a = _round_bf16(a)
    y = torch.bmm(a, xw).reshape(nblk * LANES, R)[: bb.m].to(x.dtype)
    return y.T.contiguous() if layout == "rn" else y


def bandmm_spmm(
    bb: BandBlockMatrix,
    x: torch.Tensor,
    alpha=1.0,
    precision: str = "auto",
    layout: str = "nr",
    backend: str = "auto",
) -> torch.Tensor:
    """Y = alpha * A @ X on the band-block path: K7 for CUDA tensors, the
    plain version for CPU tensors (``backend`` as in
    :func:`.dia.dia_spmv`). ``layout="nr"``: X (n, R) in, Y (m, R)
    out; ``layout="rn"``: X^T (R, n) in, Y^T (R, m) out. ``precision``:
    see the module docstring."""
    if on_cuda(x, backend):
        from .bandmm_kernel import bandmm_spmm_cuda

        return bandmm_spmm_cuda(bb, x, alpha, precision, layout)
    return bandmm_spmm_torch(bb, x, alpha, precision, layout)


def bandmm_spmv(bb: BandBlockMatrix, x: torch.Tensor, alpha=1.0, **kw) -> torch.Tensor:
    """y = alpha * A @ x, run as an R = 1 SpMM (the CSR5 and DIA kernels
    are the better SpMV; this exists for API completeness)."""
    return bandmm_spmm(bb, x[:, None], alpha, **kw)[:, 0]
