"""Row-block distributed CSR5 SpMV and SpMM over ``torch.distributed``.

The counterpart of ``benchmark_spmv_using_csr5_tpu/parallel/distributed.py``.
A's rows are split into D contiguous blocks of ``ceil(m / D)`` rows; each
rank holds the CSR5 tiles of its block, padded to the statics of the
largest shard, so every rank's planes equal the JAX package's
``da.local[d]``. x is exchanged by an all-gather, or, where the column
spread allows it (``halo="auto"``), by two neighbour halos of lane-rounded
width. The JAX package is one controller that stacks D shards under
``shard_map``; the port is SPMD: D processes, one rank and one shard each.

- :func:`make_mesh`: the first ``n`` ranks of the default group, NCCL on
  ``cuda:<local rank>`` or gloo on the CPU. On the card the group is NCCL
  or the call raises: nothing falls back to the CPU.
- :func:`build_shard`: rank ``d``'s shard from the host CSR, a function
  of ``(rank, world_size)`` that needs no process group. Every rank plans
  every shard on the host (the JAX host's uniform statics) and converts
  only its own: on the host and uploaded (``convert="host"``), or from
  its raw CSR on its device (``convert="device"``,
  :func:`..ops.convert_device.build_csr5_device`), which falls back to the
  host route when the shards cannot share statics, as JAX does
  (``distributed.py:234-235``, ``:358``). ``convert_route`` says which ran.
- :func:`distributed_spmv` takes the global x and returns the global y;
  :func:`distributed_spmv_local` takes this rank's x shard and returns its
  y block (the timed loop's and a distributed solver's form). The local
  product is the port's ``csr5_spmv``: K1, K1p or K4 on the card, the
  plain version on the CPU. On the card under NCCL a halo shard's product
  is one device program, as the JAX package's jitted ``shard_map`` is one
  executable (below).
- :func:`distributed_spmm`: the ring of JAX ``distributed.py:443-512``: D
  steps, each the local K2/K2p product on the held column shard of X, then
  a pass to rank ``(r + 1) % D``.

The exchanges: ``dist.all_gather`` in its list form (the tensor form is
deprecated in newer torch; the list form runs on both), and
``dist.batch_isend_irecv`` for halos and the ring, edge ranks filling
their missing halo with zeros themselves (JAX's ``ppermute`` gives zeros
for free).

**The product as one program.** Eagerly, a halo product costs about ten
host calls (two fills, the exchange and its waits, a ``cat``, the
kernel's wrapper), as long on an H100's host as the kernel on its card.
So on CUDA tensors under NCCL, :func:`distributed_spmv_local` runs a halo
shard's product as one CUDA graph per call, keyed by (shard, x shape,
dtype, device, alpha), as ``utils/graphs.py`` runs a solver: the first
call of a key is the eager body (it also makes NCCL's communicator); the
second keeps a buffer ``[left | x | right]``, zeroed once (an edge rank's
outer halo stays zero), and captures the exchange into its halo slots
from x's boundary planes, then the local product on the whole buffer.
Every call from then on copies x into the buffer's middle and replays.

**One exchange a call.** Every call of a key, eager, capture or replay,
makes exactly one exchange with its neighbours, whatever the caller
holds, so the ranks' point-to-point calls pair one for one even where
one rank captures while another replays: a capture's warm-up leaves the
exchange out (``graphs.capture``'s ``exchange``), and the capture then
runs once.

**Who owns y.** Each program writes its own y, and the caller owns every
y returned: a key keeps up to :data:`RING` programs on its one buffer, a
call replays the next program whose y nothing outside it still holds
(its storage's use count is back to what it was at capture) and returns
that y, captures another program while every y is held and there are
fewer than :data:`RING`, and past that runs the eager body. So a
replay's device work is the eager body's less its halo fills: x's copy,
the exchange, y's fill and the kernel. Where torch cannot count a
storage's holders (``torch._C._storage_Use_Count``), a key keeps one
program and each call returns a clone of its y. Gloo, CPU tensors and
all-gathered shards keep the eager body; so does a call made inside a
caller's own capture.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import weakref
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..config import AUTO_TUNED_SIGMA, DEFAULT_DEVICE, CSR5Config, compute_sigma, resolve_device
from ..models.formats import CSR5Matrix, col_tiles_of
from ..ops import convert
from ..ops.convert_device import PlanStatics, build_csr5_device, plan_statics
from ..ops.csr5_spmv import csr5_spmm, csr5_spmv
from ..utils import graphs, trace
from .launch import backend_for


@dataclasses.dataclass
class Mesh:
    """The first ``size`` ranks of the default process group on
    ``device``: ``rank`` is this process's rank in it (None outside)."""

    group: object
    size: int
    rank: Optional[int]
    device: torch.device
    backend: str


def make_mesh(n_devices: Optional[int] = None, device=DEFAULT_DEVICE) -> Mesh:
    """The mesh of the first ``n_devices`` ranks (default: all) of the
    initialized default group (JAX ``make_mesh``, ``distributed.py:73-76``).
    Every rank of the default group must call it. On the card (the
    default) the group is NCCL on ``cuda:<LOCAL_RANK or rank>``, and the
    default group must be NCCL; with ``device="cpu"`` it is gloo."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh: no process group; initialize one first (launch.single_rank_group, "
            "launch.run_ranks or torch.distributed.init_process_group)"
        )
    world, rank = dist.get_world_size(), dist.get_rank()
    n = n_devices or world
    if not 1 <= n <= world:
        raise ValueError(f"make_mesh: {n} devices asked of a world of {world}")
    device = resolve_device(device, "make_mesh")
    backend = backend_for(device)
    if device.type == "cuda":
        if dist.get_backend() != "nccl":
            raise RuntimeError(
                f"make_mesh: the default group runs {dist.get_backend()}; on the card the mesh "
                "runs NCCL"
            )
        if device.index is None:
            local = int(os.environ.get("LOCAL_RANK", rank))
            device = torch.device("cuda", local % torch.cuda.device_count())
    if n == world and dist.get_backend() == backend:
        group = dist.group.WORLD
    else:
        group = dist.new_group(list(range(n)), backend=backend)
    return Mesh(group=group, size=n, rank=rank if rank < n else None, device=device,
                backend=backend)


@dataclasses.dataclass(eq=False)
class DistributedCSR5:
    """This rank's shard of a row-block-partitioned CSR5 matrix (the JAX
    ``DistributedCSR5``, ``distributed.py:35-70``, whose ``local`` stacks
    every shard). ``halo``: None, x is all-gathered; ``(H_l, H_r)``, the
    shards were built over the column windows ``[d * n_per - H_l, (d + 1)
    * n_per + H_r)`` and x moves as two neighbour halos. ``convert_route``
    is ``"host"`` or ``"device"``: the route that built the shard. Two
    shards are equal only when they are one object (its captured products
    are kept by it)."""

    shape: Tuple[int, int]
    config: CSR5Config
    num_devices: int
    rows_per_shard: int
    rank: int
    local: CSR5Matrix
    halo: Optional[Tuple[int, int]] = None
    convert_route: str = "host"

    @property
    def m(self) -> int:
        return self.shape[0]

    @property
    def n(self) -> int:
        return self.shape[1]

    def x_bytes_exchanged(self, itemsize: int = 4) -> int:
        """x bytes each rank receives per SpMV: the halo-against-all-gather
        counter (JAX :62-70)."""
        D = self.num_devices
        n_per = -(-self.n // D)
        if self.halo is None:
            return (D - 1) * n_per * itemsize
        return (self.halo[0] + self.halo[1]) * itemsize


def _halo_widths(row_ptr, col_idx, m: int, D: int, rows_per: int, n_per: int):
    """(H_l, H_r), lane-rounded, such that shard d reads only the columns
    ``[d * n_per - H_l, (d + 1) * n_per + H_r)``, or None when a halo
    would reach past the neighbour's shard (JAX :175-207)."""
    hl = hr = 0
    for d in range(D):
        r0, r1 = d * rows_per, min((d + 1) * rows_per, m)
        if r0 >= r1:
            continue
        lo, hi = int(row_ptr[r0]), int(row_ptr[r1])
        if lo >= hi:
            continue
        hl = max(hl, d * n_per - int(col_idx[lo:hi].min()))
        hr = max(hr, int(col_idx[lo:hi].max()) + 1 - (d + 1) * n_per)
    # lane-rounded, then bounded by the neighbour's shard
    hl = -(-max(hl, 0) // 128) * 128
    hr = -(-max(hr, 0) // 128) * 128
    if hl > n_per or hr > n_per:
        return None
    return (hl, hr)


def _shard_csrs(row_ptr, col_idx, values, shape, D: int, halo_wid) -> list:
    """Each shard's host CSR ``(row_ptr, col_idx, values, (rows_per,
    n_loc))``, the columns shifted into the shard's window in halo mode
    (JAX :326-353)."""
    m, n = shape
    rows_per = -(-m // D)
    n_per = -(-n // D)
    out = []
    for d in range(D):
        if halo_wid is not None:
            c0, n_loc = d * n_per - halo_wid[0], n_per + halo_wid[0] + halo_wid[1]
        else:
            c0, n_loc = 0, n
        r0, r1 = d * rows_per, min((d + 1) * rows_per, m)
        if r0 >= m:  # an empty shard: one padded tile
            out.append((np.zeros(rows_per + 1, np.int64), np.zeros(0, np.int32),
                        np.zeros(0, values.dtype), (rows_per, n_loc)))
            continue
        lo, hi = int(row_ptr[r0]), int(row_ptr[r1])
        lrp = np.zeros(rows_per + 1, dtype=np.int64)
        lrp[: r1 - r0 + 1] = np.asarray(row_ptr[r0: r1 + 1]) - lo
        lrp[r1 - r0 + 1:] = lrp[r1 - r0]
        cols = np.asarray(col_idx[lo:hi], np.int32)
        if c0:
            cols = cols - np.int32(c0)
        out.append((lrp, cols, values[lo:hi], (rows_per, n_loc)))
    return out


def _pad_plane(t: torch.Tensor, lead: int, fill=0) -> torch.Tensor:
    """``t`` padded along its first axis to ``lead`` rows of ``fill``."""
    if t.shape[0] == lead:
        return t
    src = t.view(torch.int32) if t.dtype == torch.uint32 else t
    out = torch.full((lead,) + tuple(src.shape[1:]), fill, dtype=src.dtype, device=src.device)
    out[: src.shape[0]] = src
    return out.view(t.dtype) if t.dtype == torch.uint32 else out


def _pad_edge(t: torch.Tensor, lead: int) -> torch.Tensor:
    """``t`` padded along its first axis to ``lead`` rows repeating its last."""
    if t.shape[0] == lead:
        return t
    return torch.cat([t, t[-1:].expand((lead - t.shape[0],) + tuple(t.shape[1:]))])


def _pad_shard(s: CSR5Matrix, p: int, capw: int, pmax: int, m_pad: int, n_pad: int,
               contig: bool, packed: bool, raw: bool, eo_len: int) -> CSR5Matrix:
    """One shard re-padded to the uniform statics (JAX
    ``_pad_shard_statics`` :79-161 and the ``empty_offset`` pad of
    ``_stack_shards`` :164-172): tile-axis pads are zeros (``tile_ptr``,
    ``empty_offset_ptr`` and ``win_map`` repeat their last entry: a
    monotone map gives zero differences), slot-axis pads of ``pages`` are
    the sentinel page, the raw plane is decoded where another shard lacks
    the packed one."""
    if raw and s.col_idx_tiles is None:
        s = dataclasses.replace(s, col_idx_tiles=col_tiles_of(s).contiguous())
    wm = s.win_map
    if capw > s.capw:
        wm = torch.cat([wm, wm[:, -1:].expand(-1, capw - s.capw)], dim=1)
    pages = _pad_plane(s.pages, p)
    if pmax > s.pmax:
        pages = torch.cat([pages, torch.full((p, pmax - s.pmax), n_pad // 128, dtype=pages.dtype,
                                             device=pages.device)], dim=1)
    return dataclasses.replace(
        s,
        num_tiles=p,
        capw=capw,
        pmax=pmax,
        m_pad=m_pad,
        n_pad=n_pad,
        nnz_stored=p * s.sigma * s.omega,
        tail_row_start=0,
        tile_ptr=_pad_edge(s.tile_ptr, p + 1),
        tile_dirty=_pad_plane(s.tile_dirty, p),
        y_offset=_pad_plane(s.y_offset, p),
        seg_offset=_pad_plane(s.seg_offset, p),
        bit_flag=_pad_plane(s.bit_flag, p),
        empty_offset_ptr=_pad_edge(s.empty_offset_ptr, p + 1),
        empty_offset=_pad_plane(s.empty_offset, eo_len),
        col_idx_tiles=_pad_plane(s.col_idx_tiles, p) if raw else None,
        val_tiles=_pad_plane(s.val_tiles, p),
        col_packed=_pad_plane(s.col_packed, p) if packed else None,
        pages=pages,
        page_cnt=_pad_plane(s.page_cnt, p),
        win_map=_pad_edge(wm, p),
        pages_contig=contig,
    )


def _host_shard(shards: list, rank: int, cfg: CSR5Config, win_mode: str, device,
                value_dtype=None) -> CSR5Matrix:
    """Rank ``rank``'s shard by the host pipeline, padded to the statics
    of every shard's host plan (the own shard is planned last: the plans
    share the host arena), its value plane of ``value_dtype`` as
    ``build_csr5`` takes it."""
    D = len(shards)
    ph = convert._Phases()
    stats = {}
    for d in [d for d in range(D) if d != rank] + [rank]:
        rp, ci, v, (mm, nn) = shards[d]
        hp = convert._host_plan(rp, ci, v, mm, nn, cfg, win_mode, ph, False, device)
        packed = hp.col16 is not None and hp.stream_packed
        stats[d] = (hp.p_pad, hp.capw, hp.pmax, hp.pages_contig, packed, int(hp.eo.shape[0]))
    own = convert._transpose_upload(hp, shards[rank][2], value_dtype, device, ph, False)
    p, capw, pmax = (max(s[i] for s in stats.values()) for i in range(3))
    contig = all(s[3] and s[2] == pmax for s in stats.values())
    # col_packed survives only in every shard; else every shard carries raw
    # columns (a shard's raw plane is dropped exactly where it is packed,
    # but on a float64 plane, which K4 reads by its raw columns)
    packed = all(s[4] for s in stats.values())
    raw = not packed or value_dtype == torch.float64
    eo_len = max(s[5] for s in stats.values()) or 1
    m_pad = -(-(own.m + capw + 128) // 1024) * 1024
    return _pad_shard(own, p, capw, pmax, m_pad, own.n_pad, contig, packed, raw, eo_len)


def _device_shard(shards: list, rank: int, cfg: CSR5Config, device,
                  value_dtype=None) -> Optional[CSR5Matrix]:
    """Rank ``rank``'s shard converted on ``device`` from its raw CSR
    (JAX ``_convert_shards_on_device`` :210-278), under statics unified
    over every shard's host pre-pass, its values cast to ``value_dtype``
    (None: kept); None when the shards' gather modes or page-list widths
    differ (the caller takes the host route). The host pre-pass over every
    shard is the ``plan`` phase of ``convert.last_convert_phases``."""
    ph = convert._Phases()
    stats = [plan_statics(rp, ci, shp, cfg, win_mode="aligned") for rp, ci, _v, shp in shards]
    ph.mark("plan")
    convert.last_convert_phases.clear()
    convert.last_convert_phases.update(ph.ms)
    if len({(s.pages_contig, s.pmax) for s in stats}) != 1:
        return None
    uni = PlanStatics(
        config=cfg,
        p_pad=max(s.p_pad for s in stats),
        capw=max(s.capw for s in stats),
        pmax=stats[0].pmax,
        pages_contig=stats[0].pages_contig,
        win_rel=False,
        tail_row_start=0,
        eo_width=max(s.eo_width for s in stats),
        m=shards[0][3][0],
        n=max(shp[1] for _rp, _ci, _v, shp in shards),
    )
    # every shard padded to one nnz: columns repeat the shard's last, values
    # are zero (the device build's own tile-padding convention)
    nnz_max = max(len(ci) for _rp, ci, _v, _s in shards)
    rp, ci, v, _ = shards[rank]
    pad = nnz_max - len(ci)
    ci = np.concatenate([ci, np.full(pad, ci[-1] if len(ci) else 0, np.int32)])
    v = np.concatenate([v, np.zeros(pad, v.dtype)])
    return build_csr5_device(
        torch.from_numpy(rp).to(device), torch.from_numpy(ci).to(device),
        torch.from_numpy(v).to(device=device, dtype=value_dtype), uni, device=device,
    )


def build_shard(
    row_ptr: np.ndarray,
    col_idx: np.ndarray,
    values: np.ndarray,
    shape: Tuple[int, int],
    rank: int,
    world_size: int,
    sigma: int = AUTO_TUNED_SIGMA,
    halo: str = "none",
    convert: str = "host",
    device=DEFAULT_DEVICE,
    value_dtype=None,
) -> DistributedCSR5:
    """Rank ``rank``'s part of the ``world_size``-way row-block partition
    (JAX ``distribute_csr``, ``distributed.py:281-382``, for one shard),
    on ``device`` (default: the card). Needs no process group.

    ``halo``: ``"none"`` (shards address all of x, all-gathered) or
    ``"auto"`` (column-window shards and neighbour halos, when the column
    spread allows a single hop and it moves fewer bytes than the
    all-gather). ``convert``: ``"host"`` or ``"device"``. Window maps are
    aligned for D > 1 (shards must share one anchoring) and wrapped at
    D = 1 (no cross-shard padding), as JAX does (:359-368); the device
    route builds aligned maps at any D. ``value_dtype``: the value plane's
    type on either route, ``torch.float32``, ``torch.bfloat16`` or
    ``torch.float64`` (K4's plane); None keeps each route's own rule, the
    host route narrowing float64 values to float32 as ``build_csr5``
    does, the device route keeping the values' type."""
    device = resolve_device(device, "build_shard")
    if convert not in ("host", "device"):
        raise ValueError(f"unknown convert {convert!r} (host|device)")
    if value_dtype not in (None, torch.float32, torch.bfloat16, torch.float64):
        raise ValueError(f"unknown value_dtype {value_dtype!r} (None, float32, bfloat16, float64)")
    m, n = shape
    D = world_size
    rows_per = -(-m // D)
    cfg = CSR5Config(sigma=compute_sigma(m, len(values), sigma))
    row_ptr = np.asarray(row_ptr, np.int64)
    col_idx = np.asarray(col_idx)
    values = np.asarray(values)
    halo_wid = None
    if halo == "auto" and D > 1:
        n_per = -(-n // D)
        hw = _halo_widths(row_ptr, col_idx, m, D, rows_per, n_per)
        # worth the window build only when it moves fewer x bytes
        if hw is not None and hw[0] + hw[1] < (D - 1) * n_per:
            halo_wid = hw
    shards = _shard_csrs(row_ptr, col_idx, values, shape, D, halo_wid)
    local, route = None, "host"
    if convert == "device":
        local = _device_shard(shards, rank, cfg, device, value_dtype)
        route = "device" if local is not None else "host"
    if local is None:
        local = _host_shard(shards, rank, cfg, "aligned" if D > 1 else "auto", device, value_dtype)
    return DistributedCSR5(shape=tuple(shape), config=cfg, num_devices=D, rows_per_shard=rows_per,
                           rank=rank, local=local, halo=halo_wid, convert_route=route)


def distribute_csr(
    row_ptr: np.ndarray,
    col_idx: np.ndarray,
    values: np.ndarray,
    shape: Tuple[int, int],
    mesh: Mesh,
    sigma: int = AUTO_TUNED_SIGMA,
    halo: str = "none",
    convert: str = "host",
    value_dtype=None,
) -> DistributedCSR5:
    """This rank's shard of A over ``mesh`` (:func:`build_shard` at the
    mesh's rank and size, on its device). Every rank of the mesh calls it
    with the same host CSR."""
    if mesh.rank is None:
        raise ValueError("distribute_csr: this rank is outside the mesh")
    return build_shard(row_ptr, col_idx, values, shape, mesh.rank, mesh.size, sigma, halo,
                       convert, mesh.device, value_dtype)


# ---------------------------------------------------------------------------
# exchanges
# ---------------------------------------------------------------------------


def all_gather_cat(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's ``t`` concatenated along the first axis, in rank order
    (``dist.all_gather``, list form)."""
    parts = [torch.empty_like(t) for _ in range(mesh.size)]
    dist.all_gather(parts, t.contiguous(), group=mesh.group)
    return torch.cat(parts)


def _exchange(sends: list, recvs: list, mesh: Mesh) -> None:
    """Point-to-point transfers in one batch: ``sends`` and ``recvs`` are
    ``(tensor, peer rank)`` pairs."""
    ops = [dist.P2POp(dist.isend, t.contiguous(), peer, group=mesh.group) for t, peer in sends]
    ops += [dist.P2POp(dist.irecv, t, peer, group=mesh.group) for t, peer in recvs]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()


def _halo_pairs(x_shard: torch.Tensor, left: torch.Tensor, right: torch.Tensor,
                mesh: Mesh) -> Tuple[list, list]:
    """The sends and receives of a halo exchange: x_shard's last
    ``len(left)`` rows to rank r + 1 and first ``len(right)`` to rank
    r - 1; ``left`` from rank r - 1 and ``right`` from rank r + 1 (an edge
    rank's outer halo receives nothing)."""
    r, D = mesh.rank, mesh.size
    h_l, h_r = left.shape[0], right.shape[0]
    sends, recvs = [], []
    if h_l:
        if r + 1 < D:
            sends.append((x_shard[x_shard.shape[0] - h_l:], r + 1))
        if r > 0:
            recvs.append((left, r - 1))
    if h_r:
        if r > 0:
            sends.append((x_shard[:h_r], r - 1))
        if r + 1 < D:
            recvs.append((right, r + 1))
    return sends, recvs


def halo_exchange(x_shard: torch.Tensor, h_l: int, h_r: int, mesh: Mesh) -> torch.Tensor:
    """``[left halo | x_shard | right halo]`` along the first axis: the
    last ``h_l`` rows of rank r - 1's shard and the first ``h_r`` of rank
    r + 1's, zeros at the edges (JAX's two ``ppermute``s, :404-420)."""
    rest = tuple(x_shard.shape[1:])
    left = torch.zeros((h_l,) + rest, dtype=x_shard.dtype, device=x_shard.device)
    right = torch.zeros((h_r,) + rest, dtype=x_shard.dtype, device=x_shard.device)
    _exchange(*_halo_pairs(x_shard, left, right, mesh), mesh)
    return torch.cat([left, x_shard, right]) if h_l or h_r else x_shard


# ---------------------------------------------------------------------------
# products
# ---------------------------------------------------------------------------


def shard_of(x: torch.Tensor, n_per: int, mesh: Mesh) -> torch.Tensor:
    """This rank's ``n_per`` rows of ``x`` zero-padded to ``n_per * D``."""
    x_pad = torch.zeros((n_per * mesh.size,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    x_pad[: x.shape[0]] = x
    return x_pad[mesh.rank * n_per: (mesh.rank + 1) * n_per].contiguous()


def distributed_spmv_local(da: DistributedCSR5, x_shard: torch.Tensor, mesh: Mesh,
                           alpha=1.0) -> torch.Tensor:
    """This rank's y block (``rows_per_shard`` rows) of y = alpha * A @ x
    from its x shard (``ceil(n / D)`` entries): the exchange, then the
    local product (JAX ``local_step``, :400-431). A halo shard's product on
    the card under NCCL is one captured program from its key's second call
    (the module's notes); the caller owns every y returned. While a
    profiler records, each call is a ``csr5.dist.product`` span."""
    if not trace.recording():
        return _product(da, x_shard, mesh, alpha)
    with trace.span("csr5.dist.product", rank=mesh.rank, halo=da.halo,
                    bytes=da.x_bytes_exchanged(x_shard.element_size())) as attrs:
        return _product(da, x_shard, mesh, alpha, attrs)


#: each shard's captured products, by key; they go with the shard
_programs: "weakref.WeakKeyDictionary[DistributedCSR5, graphs._Cache]" = weakref.WeakKeyDictionary()
#: programs a product key keeps at most, each writing its own y
RING = 8


def _graphed(da: DistributedCSR5, x_shard: torch.Tensor, mesh: Mesh) -> bool:
    """True where the product runs as a captured program: a halo shard, x
    on the card, an NCCL mesh, and no caller's capture or program around
    the call (there the body runs inline, as a nested solver does)."""
    return (da.halo is not None and x_shard.is_cuda and mesh.backend == "nccl"
            and not graphs._inline())


def _product(da: DistributedCSR5, x_shard: torch.Tensor, mesh: Mesh, alpha, attrs=None):
    ring, mode, prog = None, "eager", None
    if _graphed(da, x_shard, mesh):
        cache = _programs.get(da)
        if cache is None:
            cache = _programs[da] = graphs._Cache()
        key = (id(da.local), tuple(x_shard.shape), x_shard.dtype, x_shard.device, alpha)
        ring = cache.get(key)
        if ring is None and not cache.first_call(key, ()):
            ring = cache.put(key, _Ring(da, x_shard, mesh, alpha))
    got = None if ring is None else ring(x_shard)
    if got is None:
        y = _eager_product(da, x_shard, mesh, alpha)
    else:
        y, prog, captured = got
        mode = "capture" if captured else "replay"
    if attrs is not None:
        attrs.update(mode=mode, program=prog)
    return y


def _eager_product(da: DistributedCSR5, x_shard: torch.Tensor, mesh: Mesh, alpha) -> torch.Tensor:
    if da.halo is not None:
        x_full = halo_exchange(x_shard, da.halo[0], da.halo[1], mesh)
    else:
        x_full = all_gather_cat(x_shard, mesh)[: da.n]
    return csr5_spmv(da.local, x_full, alpha)[: da.rows_per_shard]


def _counted() -> bool:
    """True where torch counts the holders of a storage (:func:`_use_count`)."""
    return hasattr(torch._C, "_storage_Use_Count")


def _use_count(t: torch.Tensor) -> int:
    """The tensors (views among them) that hold ``t``'s storage."""
    return torch._C._storage_Use_Count(t.untyped_storage()._cdata)


class _Ring:
    """A halo product key's programs (module notes): the kept buffer
    ``[left | x | right]``, and up to :data:`RING` programs captured on it,
    each with its own y (one program, its y cloned a call, where torch
    cannot count a y's holders). It holds the shard's matrix, not the
    shard."""

    def __init__(self, da: DistributedCSR5, x_shard: torch.Tensor, mesh: Mesh, alpha):
        h_l, h_r = da.halo
        n, dev = x_shard.shape[0], x_shard.device
        self.buf = torch.zeros((h_l + n + h_r,) + tuple(x_shard.shape[1:]), dtype=x_shard.dtype,
                               device=dev)
        self.x_mid = self.buf[h_l: h_l + n]
        pairs = _halo_pairs(self.x_mid, self.buf[:h_l], self.buf[h_l + n:], mesh)
        self.capture = functools.partial(_capture_program, da.local, da.rows_per_shard, self.buf,
                                         self.x_mid, pairs, mesh, alpha, dev)
        self.progs: list = []
        self.free_at: list = []  # each y's use count while nothing else holds it
        self.turn = 0

    def __call__(self, x_shard: torch.Tensor) -> Optional[Tuple[torch.Tensor, int, bool]]:
        """(y, the program's id, whether it was captured in this call), or
        None where every one of :data:`RING` programs' y is held (the call
        then runs the eager body)."""
        counted, k = _counted(), len(self.progs)
        if counted:
            free = next((i % k for i in range(self.turn, self.turn + k)
                         if _use_count(self.progs[i % k].outputs) == self.free_at[i % k]), None)
        else:
            free = 0 if k else None
        captured = free is None and k < (RING if counted else 1)
        if captured:
            self.progs.append(self.capture())
            self.free_at.append(_use_count(self.progs[-1].outputs) if counted else None)
            free = k
        if free is None:
            return None
        prog = self.progs[free]
        self.turn = (free + 1) % len(self.progs)
        prog.run({"x_shard": x_shard})
        y = prog.outputs.detach() if counted else prog.outputs.clone()
        return y, prog.record.program, captured


def _capture_program(local: CSR5Matrix, rows: int, buf: torch.Tensor, x_mid: torch.Tensor,
                     pairs: Tuple[list, list], mesh: Mesh, alpha,
                     dev: torch.device) -> graphs._Program:
    """One program of a ring: the exchange into ``buf``'s halo slots, then
    the local product on all of ``buf``; ``x_mid`` is its static input."""

    def exchange(_x_full):
        _exchange(*pairs, mesh)

    def spmv(x_full):
        return csr5_spmv(local, x_full, alpha)[:rows]

    def distributed_spmv_local(x_full, exchange, spmv):  # the body, named for its record
        exchange(x_full)
        return spmv(x_full)

    with torch.cuda.device(dev):
        return graphs.capture(distributed_spmv_local,
                              {"x_full": buf, "exchange": exchange, "spmv": spmv},
                              {"x_shard": x_mid}, dev, keep=(local,), exchange="exchange",
                              cloned=not _counted())


def distributed_spmv(da: DistributedCSR5, x: torch.Tensor, mesh: Mesh, alpha=1.0) -> torch.Tensor:
    """y = alpha * A @ x with A row-sharded (JAX ``distributed_spmv``,
    :385-440): the global x in (on the mesh's device), the global y out on
    every rank."""
    n_per = -(-da.n // da.num_devices)
    y_blk = distributed_spmv_local(da, shard_of(x, n_per, mesh), mesh, alpha)
    return all_gather_cat(y_blk, mesh)[: da.m]


def distributed_spmm(da: DistributedCSR5, xm: torch.Tensor, mesh: Mesh, alpha=1.0) -> torch.Tensor:
    """Y = alpha * A @ X, A row-sharded and the columns of X sharded, as a
    ring (JAX ``distributed_spmm``, :443-512): in each of D steps the rank
    multiplies its block of A by the column shard it holds (K2 or K2p on
    the card) and passes the shard on to rank ``(r + 1) % D``. The global
    X (n, R) in, the global Y (m, R) out on every rank."""
    if da.halo is not None:
        raise ValueError("distributed_spmm needs full-x shards; build with halo='none'")
    D, r = mesh.size, mesh.rank
    n, R = xm.shape
    r_per = -(-R // D)
    x_pad = torch.zeros((n, r_per * D), dtype=xm.dtype, device=xm.device)
    x_pad[:, :R] = xm
    xs = x_pad[:, r * r_per: (r + 1) * r_per].contiguous()
    y_rows = torch.zeros((da.rows_per_shard, r_per * D), dtype=xm.dtype, device=xm.device)
    for t in range(D):
        src = (r - t) % D  # after t passes this rank holds rank (r - t)'s shard
        y_rows[:, src * r_per: (src + 1) * r_per] = csr5_spmm(da.local, xs, alpha)[: da.rows_per_shard]
        if t + 1 < D:
            nxt = torch.empty_like(xs)
            _exchange([(xs, (r + 1) % D)], [(nxt, (r - 1) % D)], mesh)
            xs = nxt
    return all_gather_cat(y_rows, mesh)[: da.m, :R]
