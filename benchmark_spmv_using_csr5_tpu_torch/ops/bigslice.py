"""Row-sliced CSR5: the counterpart of ``benchmark_spmv_using_csr5_tpu/
ops/bigslice.py``.

The JAX package cuts a matrix whose m + n passes its VMEM budget into ROW
SLICES, each a self-contained CSR5 matrix over its own rows and a
page-aligned COLUMN WINDOW [c0, c0 + n_k), so that the slice's y and x
window fit the TPU kernel's VMEM. Slice boundaries are chosen greedily over
fixed row quanta (:func:`_slice_bounds`, copied). The port keeps the same
rule and the same slices, plane for plane, so a sliced matrix carries
across between the two packages (:func:`sliced_from_numpy`,
:func:`sliced_to_numpy`).

On the card the cap is not a memory limit: x and y of any matrix fit the
H100's 80 GB, and one K1 pass covers any tile count. The port slices where
the JAX package does (:func:`should_slice`) so that both routes run on the
same matrix and the card can say which is faster.

- :func:`sliced_spmv`: y = alpha * A @ x over every slice, through K3
  (``csrc/csr5_sliced.cu``, ONE launch over the tiles of every slice) for
  CUDA tensors and :func:`sliced_spmv_torch` for CPU tensors;
- :func:`sliced_spmm`: Y = alpha * A @ X, K2 or K2p per slice on X's
  window rows, the results concatenated (``_sliced_spmm_jit``,
  ``bigslice.py:276-295``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import AUTO_TUNED_SIGMA, DEFAULT_DEVICE, CSR5Config, compute_sigma, resolve_device
from ..models.formats import CSR5Matrix, csr5_from_numpy, csr5_to_numpy
from ..utils.hostmem import arena_take
from . import convert
from .convert import _as_host_csr, build_csr5
from .csr5_kernel import LANES, MAX_SIGMA
from .csr5_spmv import csr5_spmm, csr5_spmv_torch

#: row quantum of the greedy slicer (boundaries land on multiples); the
#: JAX package's value
SLICE_QUANTUM_ROWS = 131_072
#: elements of x window + y per slice: the JAX package's share of its
#: 96 MiB VMEM budget (``bigslice.py:50``, ``csr5_kernel.py:110``). On the
#: card this is that package's slicing rule, kept so both packages slice the
#: same matrices the same way, not a memory limit of the H100.
_SLICE_ELEM_CAP = int(96 * 2**20 * 0.72) // 4


@dataclasses.dataclass
class SlicedCSR5:
    """A row-sliced CSR5 matrix: slice k covers rows [row_starts[k],
    row_starts[k+1]) and columns [col_starts[k], col_starts[k] +
    slices[k].n) (the JAX ``SlicedCSR5``, field for field)."""

    slices: Tuple[CSR5Matrix, ...]
    shape: Tuple[int, int]
    row_starts: Tuple[int, ...]
    col_starts: Tuple[int, ...]
    nnz_stored: int = 0
    #: K3's slice table on the card, made at its first launch
    #: (:mod:`.bigslice_kernel`)
    kernel_table: Optional[object] = dataclasses.field(default=None, repr=False, compare=False)

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
    def num_slices(self) -> int:
        return len(self.slices)

    @property
    def sigma(self) -> int:
        return self.slices[0].sigma if self.slices else 0


def _slice_bounds(
    row_ptr: np.ndarray,
    col_idx: np.ndarray,
    m: int,
    elem_cap: int,
) -> Optional[list]:
    """Greedy row-slice boundaries [(r0, r1, c0, c1), ...] such that each
    slice's rows + page-aligned column window fit ``elem_cap`` elements.
    Returns None when some single quantum already exceeds the cap.
    Copied from the JAX package (``bigslice.py:86-148``)."""
    # quantum scales down with the cap so tiny test caps still slice;
    # production caps (~tens of M elements) use the full quantum. A
    # multiple of 128 except in the single-slice m < 128 case.
    q = min(SLICE_QUANTUM_ROWS, m, max(128, -(-(elem_cap // 8) // 128) * 128))
    nq = -(-m // q)
    # per-quantum column ranges in one reduceat pass over col_idx
    starts = row_ptr[np.minimum(np.arange(nq) * q, m)]
    qmin = np.full(nq, np.iinfo(np.int64).max, dtype=np.int64)
    qmax = np.full(nq, -1, dtype=np.int64)
    nnz = len(col_idx)
    nonempty = np.flatnonzero(np.diff(np.append(starts, nnz)) > 0)
    if nonempty.size:
        idx = starts[nonempty].astype(np.int64)
        qmin[nonempty] = np.minimum.reduceat(col_idx, idx)
        qmax[nonempty] = np.maximum.reduceat(col_idx, idx)
    bounds = []
    k = 0
    while k < nq:
        r0 = k * q
        cmin, cmax = qmin[k], qmax[k]
        j = k
        while True:
            rows = min((j + 1) * q, m) - r0
            lo = 0 if cmin > cmax else (int(cmin) // 128) * 128
            win = 0 if cmin > cmax else int(cmax) + 1 - lo
            if rows + win > elem_cap:
                if j == k:
                    return None  # one quantum alone overflows the cap
                j -= 1
                break
            if j + 1 >= nq:
                break
            nmin = min(cmin, qmin[j + 1])
            nmax = max(cmax, qmax[j + 1])
            nrows = min((j + 2) * q, m) - r0
            nlo = 0 if nmin > nmax else (int(nmin) // 128) * 128
            nwin = 0 if nmin > nmax else int(nmax) + 1 - nlo
            if nrows + nwin > elem_cap:
                break
            cmin, cmax, j = nmin, nmax, j + 1
        r1 = min((j + 1) * q, m)
        # recompute the window of the accepted range (the probe loop may
        # have backed off)
        cmin = qmin[k : j + 1].min()
        cmax = qmax[k : j + 1].max()
        if cmin > cmax:  # all-empty slice
            bounds.append((r0, r1, 0, 128))
        else:
            c0 = (int(cmin) // 128) * 128
            bounds.append((r0, r1, c0, int(cmax) + 1))
        k = j + 1
    return bounds


def _kernel_takes(a5: CSR5Matrix) -> bool:
    """True when K1 and K3 take the slice (the port's counterpart of the
    JAX ``pallas_supported`` gate): omega 128, sigma <= 448, float32 or
    bfloat16 values."""
    return (
        a5.omega == LANES
        and a5.sigma <= MAX_SIGMA
        and a5.val_tiles.dtype in (torch.float32, torch.bfloat16)
    )


def build_csr5_sliced(
    csr,
    config: Optional[CSR5Config] = None,
    sigma: int = AUTO_TUNED_SIGMA,
    value_dtype=None,
    elem_cap: Optional[int] = None,
    num_rhs: int = 1,
    device=DEFAULT_DEVICE,
) -> Optional[SlicedCSR5]:
    """CSR -> row-sliced CSR5 (``build_csr5_sliced``, ``bigslice.py:151``).

    Returns None where the JAX function does: when some row quantum's
    window alone passes the cap (fully scattered rows at huge n), or when
    the kernel would refuse a slice (sigma > 448 or a float64 value plane);
    callers then build the whole-matrix form for K1. ``elem_cap``
    overrides the per-slice element budget (tests use a tiny cap to force
    multi-slice builds); ``num_rhs > 1`` divides it by R, as the JAX
    package sizes slices for SpMM. Every plane goes to ``device``
    (default: the card); the host arena is reused slice after slice and
    each slice's planes are copies. ``convert.last_convert_phases`` holds
    the slices' phases summed.
    """
    device = resolve_device(device, "build_csr5_sliced")
    row_ptr, col_idx, values, (m, n) = _as_host_csr(csr)
    nnz = int(values.shape[0])
    if config is None:
        config = CSR5Config(sigma=compute_sigma(m, nnz, sigma))
    cap = elem_cap if elem_cap is not None else _SLICE_ELEM_CAP
    cap = cap // max(1, num_rhs)
    bounds = _slice_bounds(row_ptr, col_idx, m, cap)
    if bounds is None:
        return None
    slices = []
    row_starts = [0]
    col_starts = []
    phases: dict = {}
    for r0, r1, c0, c1 in bounds:
        k0, k1 = int(row_ptr[r0]), int(row_ptr[r1])
        rp = arena_take(r1 - r0 + 1, np.int64, "sl:rp", zero=False)
        np.subtract(row_ptr[r0 : r1 + 1], k0, out=rp)
        ci = col_idx[k0:k1]
        if c0:
            cs = arena_take(k1 - k0, np.int32, "sl:ci", zero=False)
            np.subtract(ci, np.int32(c0), out=cs)
            ci = cs
        n_k = max(c1 - c0, 128)
        a5 = build_csr5(
            (rp, ci, values[k0:k1], (r1 - r0, n_k)), config, value_dtype=value_dtype,
            device=device,
        )
        if not _kernel_takes(a5):
            return None
        for k, v in convert.last_convert_phases.items():
            phases[k] = phases.get(k, 0.0) + v
        slices.append(a5)
        row_starts.append(r1)
        col_starts.append(c0)
    if phases.get("upload", 0.0) > 0:
        phases["upload_gbps"] = phases["upload_mb"] / phases["upload"]
    convert.last_convert_phases.clear()
    convert.last_convert_phases.update(phases)
    return SlicedCSR5(
        slices=tuple(slices),
        shape=(m, n),
        row_starts=tuple(row_starts),
        col_starts=tuple(col_starts),
        nnz_stored=nnz,
    )


def should_slice(m: int, n: int) -> bool:
    """True when the JAX package's whole-matrix kernel could not keep x and
    y in VMEM and the sliced path is taken first (``bigslice.py:307``)."""
    return m + n > _SLICE_ELEM_CAP


def _window(sl: SlicedCSR5, x: torch.Tensor, k: int) -> torch.Tensor:
    """Slice k's rows of x (``(n,)`` or ``(n, R)``): x[c0 : c0 + n_k],
    zero-padded where the page-aligned window reaches past n."""
    c0, n_k = sl.col_starts[k], sl.slices[k].n
    xk = x[c0 : min(c0 + n_k, sl.n)]
    if xk.shape[0] < n_k:
        pad = torch.zeros((n_k - xk.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
        xk = torch.cat([xk, pad])
    return xk


def sliced_spmv_torch(sl: SlicedCSR5, x: torch.Tensor, alpha=1.0) -> torch.Tensor:
    """The plain version of K3 (any device): alpha folded into x, as K3
    and the JAX executor do, then each slice's :func:`csr5_spmv_torch` on
    its x window, added into one y at the slice's rows."""
    xa = x if alpha == 1.0 else x * alpha
    y = torch.zeros(sl.m, dtype=x.dtype, device=x.device)
    for k, a5 in enumerate(sl.slices):
        r0 = sl.row_starts[k]
        y[r0 : r0 + a5.m] += csr5_spmv_torch(a5, _window(sl, xa, k))
    return y


def sliced_spmv(
    sl: SlicedCSR5, x: torch.Tensor, alpha=1.0, backend: str = "auto"
) -> torch.Tensor:
    """y = alpha * A @ x over the row slices: K3, one launch over every
    slice, for CUDA tensors; :func:`sliced_spmv_torch` for CPU tensors.
    ``backend`` names the path the caller expects (auto|cuda|torch); a
    mismatch raises instead of changing path."""
    from .dia import _on_cuda

    if _on_cuda(x, backend):
        from .bigslice_kernel import sliced_spmv_cuda

        return sliced_spmv_cuda(sl, x, alpha)
    return sliced_spmv_torch(sl, x, alpha)


def sliced_spmm(
    sl: SlicedCSR5, x_mat: torch.Tensor, alpha=1.0, backend: str = "auto"
) -> torch.Tensor:
    """Y = alpha * A @ X over the row slices, X (n, R): alpha folded into
    X, then each slice's :func:`..ops.csr5_spmv.csr5_spmm` (K2 or K2p on the
    card, the plain version on the CPU) on its window rows of X, the slices'
    Y stacked (``_sliced_spmm_jit``). Build the sliced form with
    ``num_rhs=R``, as the JAX package sizes it."""
    xs = x_mat * alpha
    outs = [
        csr5_spmm(a5, _window(sl, xs, k), backend=backend) for k, a5 in enumerate(sl.slices)
    ]
    return torch.cat(outs, dim=0) if len(outs) > 1 else outs[0]


def sliced_from_numpy(slices: list, static: dict, device=DEFAULT_DEVICE) -> SlicedCSR5:
    """A :class:`SlicedCSR5` from host planes: ``slices`` holds one
    ``(planes, static)`` pair per slice, as :func:`..models.formats.
    csr5_from_numpy` takes them, and ``static`` the fields ``shape``,
    ``row_starts``, ``col_starts`` and ``nnz_stored``. A JAX
    ``SlicedCSR5`` crosses slice by slice as its CSR5 matrices do."""
    return SlicedCSR5(
        slices=tuple(csr5_from_numpy(p, s, device) for p, s in slices),
        shape=tuple(int(v) for v in static["shape"]),
        row_starts=tuple(int(v) for v in static["row_starts"]),
        col_starts=tuple(int(v) for v in static["col_starts"]),
        nnz_stored=int(static["nnz_stored"]),
    )


def sliced_to_numpy(sl: SlicedCSR5) -> Tuple[list, dict]:
    """``(slices, static)`` of a port sliced matrix as host copies: the
    inverse of :func:`sliced_from_numpy`."""
    static = {
        "shape": sl.shape,
        "row_starts": sl.row_starts,
        "col_starts": sl.col_starts,
        "nnz_stored": sl.nnz_stored,
    }
    return [csr5_to_numpy(a5) for a5 in sl.slices], static
