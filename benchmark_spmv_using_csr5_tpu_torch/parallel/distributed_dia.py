"""Row-block distributed DIA SpMV and SpMM over ``torch.distributed``.

The counterpart of ``benchmark_spmv_using_csr5_tpu/parallel/distributed_dia.py``.
The interleaved DIA plane ``(m_pad/128, ndiag, 128)`` splits by rows into
D slabs of ``rp/128`` row blocks (``rp``, the rows per shard, a multiple
of ``CHUNK_ROWS``); the diagonal offsets are the same for every shard,
shifted by the uniform left halo; and the x window a row block reads is
``[r0 + min_off, r1 + max_off)``: two neighbour halos of lane-rounded
width, unless the band reaches past a neighbour's shard (or x is wider
than the row grid), where x is all-gathered and each rank cuts its window.
Each rank fills only its own slab, on the host, and runs the port's
``dia_spmv``/``dia_spmm`` on it: K5/K6 on the card, the plain versions on
the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import DEFAULT_DEVICE, resolve_device
from ..ops.dia import CHUNK_ROWS, LANES, MAX_DIAGS, MIN_FILL, DIAMatrix, _as_host, dia_spmm, dia_spmv
from .distributed import Mesh, all_gather_cat, halo_exchange, shard_of


@dataclasses.dataclass
class DistributedDIA:
    """This rank's slab of a row-block DIA matrix (the JAX
    ``DistributedDIA``, ``distributed_dia.py:49-88``, whose ``data``
    stacks every slab). ``local`` is the slab as a DIA matrix of
    ``rows_per_shard`` rows over its x window ``h_l + rp + h_r``, its
    offsets shifted by ``h_l``. ``halo``: ``(H_l, H_r)`` for the
    neighbour exchange, None for the all-gather."""

    shape: Tuple[int, int]
    offsets: Tuple[int, ...]
    nnz_stored: int
    num_devices: int
    rows_per_shard: int
    rank: int
    local: DIAMatrix
    halo: Optional[Tuple[int, int]] = None

    @property
    def m(self) -> int:
        return self.shape[0]

    @property
    def n(self) -> int:
        return self.shape[1]

    @property
    def ndiag(self) -> int:
        return len(self.offsets)

    def x_bytes_exchanged(self, itemsize: int = 4) -> int:
        """x bytes each rank receives per SpMV (JAX :81-88)."""
        D = self.num_devices
        if self.halo is None:
            n_per = -(-max(self.n, D * self.rows_per_shard) // D)
            return (D - 1) * n_per * itemsize
        return (self.halo[0] + self.halo[1]) * itemsize


def _band_halo(offsets) -> Tuple[int, int]:
    """The lane-rounded x window extents of the band (JAX :147-154)."""
    h_l = -(-max(0, -offsets[0]) // LANES) * LANES
    h_r = -(-max(0, offsets[-1]) // LANES) * LANES
    return h_l, h_r


def build_dia_shard(
    csr,
    rank: int,
    world_size: int,
    max_diags: int = MAX_DIAGS,
    min_fill: float = MIN_FILL,
    value_dtype=None,
    device=DEFAULT_DEVICE,
) -> Optional[DistributedDIA]:
    """Rank ``rank``'s slab of the ``world_size``-way row-block DIA (JAX
    ``distribute_dia``, ``distributed_dia.py:91-144``, for one slab), on
    ``device`` (default: the card); None when the matrix is not
    diagonal-structured (the gates of ``build_dia``). Needs no process
    group. Duplicate entries are summed, as ``np.add.at`` does in the JAX
    build; the plane is float32 (or ``value_dtype``), as ``build_dia``'s."""
    device = resolve_device(device, "build_dia_shard")
    row_ptr, col_idx, values, (m, n) = _as_host(csr)
    nnz = int(values.shape[0])
    if nnz == 0:
        return None
    D = world_size
    rows = np.repeat(np.arange(m, dtype=np.int64), np.diff(row_ptr))
    uniq, inv = np.unique(col_idx - rows, return_inverse=True)
    if len(uniq) > max_diags or nnz < min_fill * len(uniq) * m:
        return None
    rp = -(-m // (D * CHUNK_ROWS)) * CHUNK_ROWS
    nd = len(uniq)
    offsets = tuple(int(o) for o in uniq)
    h_l, h_r = _band_halo(offsets)
    halo: Optional[Tuple[int, int]] = (h_l, h_r)
    if D == 1:
        halo = (0, 0) if n <= rp else None
    elif h_l > rp or h_r > rp or n > D * rp:
        # the band reaches past a neighbour's shard, or x is wider than the
        # row grid: a single hop cannot cover it
        halo = None

    r0 = rank * rp
    lo, hi = int(row_ptr[min(r0, m)]), int(row_ptr[min(r0 + rp, m)])
    loc = rows[lo:hi] - r0
    data = np.zeros((rp // LANES, nd, LANES), values.dtype)
    np.add.at(data, (loc >> 7, inv[lo:hi], loc & (LANES - 1)), values[lo:hi])
    plane = torch.from_numpy(data).to(device=device, dtype=torch.float32)
    if value_dtype is not None:
        plane = plane.to(value_dtype)
    w_l, w_r = halo if halo is not None else (h_l, h_r)  # JAX _halo_widths
    local = DIAMatrix(
        shape=(rp, w_l + rp + w_r),
        offsets=tuple(o + w_l for o in offsets),
        nnz_stored=nnz,
        data=plane,
        m_pad=rp,
        interleaved=True,
    )
    return DistributedDIA(shape=(m, n), offsets=offsets, nnz_stored=nnz, num_devices=D,
                          rows_per_shard=rp, rank=rank, local=local, halo=halo)


def distribute_dia(csr, mesh: Mesh, max_diags: int = MAX_DIAGS, min_fill: float = MIN_FILL,
                   value_dtype=None) -> Optional[DistributedDIA]:
    """This rank's slab of A over ``mesh`` (:func:`build_dia_shard` at the
    mesh's rank and size, on its device), or None when A is not
    diagonal-structured."""
    if mesh.rank is None:
        raise ValueError("distribute_dia: this rank is outside the mesh")
    return build_dia_shard(csr, mesh.rank, mesh.size, max_diags, min_fill, value_dtype, mesh.device)


def _x_rows(dd: DistributedDIA) -> int:
    """The padded length of x: the row grid in halo mode, else the row
    grid or n, whichever is longer, rounded to D (JAX :214)."""
    D, rp = dd.num_devices, dd.rows_per_shard
    return D * rp if dd.halo is not None else D * (-(-max(dd.n, D * rp) // D))


def _exchange_x(dd: DistributedDIA, x_shard: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``[left halo | own rows | right halo]`` of x for this slab: two
    neighbour halos, or the all-gather and a window cut at ``rank * rp``
    (JAX ``_exchange_x``, :172-198). Vectors and (rows, R) blocks alike."""
    rp = dd.rows_per_shard
    if dd.halo is not None:
        return halo_exchange(x_shard, dd.halo[0], dd.halo[1], mesh)
    h_l, h_r = _band_halo(dd.offsets)
    x_full = all_gather_cat(x_shard, mesh)
    rest = tuple(x_full.shape[1:])
    x_pad = torch.zeros((h_l + x_full.shape[0] + h_r,) + rest, dtype=x_full.dtype,
                        device=x_full.device)
    x_pad[h_l: h_l + x_full.shape[0]] = x_full
    start = mesh.rank * rp
    return x_pad[start: start + h_l + rp + h_r].contiguous()


def distributed_dia_spmv(dd: DistributedDIA, x: torch.Tensor, mesh: Mesh, alpha=1.0) -> torch.Tensor:
    """y = alpha * A @ x, A row-sharded DIA (JAX :201-235): the global x
    in, the global y out on every rank."""
    x_shard = shard_of(x, _x_rows(dd) // dd.num_devices, mesh)
    y = dia_spmv(dd.local, _exchange_x(dd, x_shard, mesh), alpha)
    return all_gather_cat(y, mesh)[: dd.m]


def distributed_dia_spmm(dd: DistributedDIA, xm: torch.Tensor, mesh: Mesh, alpha=1.0) -> torch.Tensor:
    """Y = alpha * A @ X for X (n, R) (JAX :238-274): the plane streams
    once per shard for all R right-hand sides; the halos move (H_l + H_r)
    * R elements per rank."""
    x_shard = shard_of(xm, _x_rows(dd) // dd.num_devices, mesh)
    y = dia_spmm(dd.local, _exchange_x(dd, x_shard, mesh), alpha)
    return all_gather_cat(y, mesh)[: dd.m]
