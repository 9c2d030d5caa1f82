"""Weak scaling of the distributed CSR5 SpMV, and its projection.

The counterpart of ``benchmark_spmv_using_csr5_tpu/parallel/scaling.py``.
Weak scaling holds each rank's share fixed (``rows_per_device`` rows of a
band), so the matrix grows with D; efficiency(D) = (nnz/s at D) / D /
(nnz/s at 1). :func:`weak_scaling` sweeps the meshes of the first d ranks
of the default group and times the rank-local SpMV (the exchange and the
local product): CUDA events on the card, the host clock on the CPU, after
a barrier, the slowest rank's time (``all_reduce`` MAX). On gloo CPU ranks
the times measure the CPU and the loopback, and only the plumbing is
checked.

:func:`project_weak_scaling` adds the x exchange to a measured per-rank
SpMV time under a link model. The JAX module's ICI figures are a TPU's
and are not carried over: the link defaults to :data:`NVLINK_GBPS`, a
data-sheet number, and the per-exchange latency has no default; the
caller passes one it measured (``chip_smoke.py`` passes
:func:`collective_floor_s`, an all-gather of the halo's size at D = 1:
a floor, not a hop between cards).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..config import DEFAULT_DEVICE
from ..utils import perf, synth
from .distributed import (
    Mesh,
    all_gather_cat,
    distribute_csr,
    distributed_spmv_local,
    make_mesh,
    shard_of,
)

#: NVLink between the H100s of one host: 900 GB/s in all, 450 GB/s each
#: way (NVIDIA's H100 data sheet), the link of the projection
NVLINK_GBPS = 450.0


@dataclasses.dataclass
class ScalePoint:
    devices: int
    nnz: int
    ms_per_spmv: float
    nnz_per_sec: float
    efficiency: float  # against the first point's nnz/s per rank
    #: (max - min) / min over the repeats at this D
    spread: float = 0.0


def _time_distributed(da, mesh: Mesh, x_shard: torch.Tensor, iters: int) -> float:
    """ms per rank-local SpMV, the slowest rank's: three warm-up calls, a
    barrier, ``iters`` calls between two events (the host clock on the
    CPU), then the maximum over the mesh."""
    for _ in range(3):
        distributed_spmv_local(da, x_shard, mesh)
    dist.barrier(group=mesh.group)
    t = perf.Timer(mesh.device).start()
    for _ in range(iters):
        distributed_spmv_local(da, x_shard, mesh)
    ms = torch.tensor([t.stop_ms() / iters], dtype=torch.float64, device=mesh.device)
    dist.all_reduce(ms, op=dist.ReduceOp.MAX, group=mesh.group)
    return float(ms.item())


def weak_scaling(
    device_counts: Optional[List[int]] = None,
    rows_per_device: int = 65536,
    bandwidth: int = 27,
    iters: int = 20,
    matrix_factory: Optional[Callable[[int], object]] = None,
    repeats: int = 1,
    device=DEFAULT_DEVICE,
) -> List[ScalePoint]:
    """One :class:`ScalePoint` per mesh size (default: 1, 2, 4, 8 up to
    the world size), the same list on every rank of the default group,
    which all call it. ``repeats`` measures each size that many times and
    keeps the least, with the spread (JAX :73-123)."""
    world = dist.get_world_size()
    if device_counts is None:
        device_counts = [d for d in (1, 2, 4, 8) if d <= world]
    points: List[ScalePoint] = []
    base_rate = None
    reps = max(repeats, 1)
    for d in device_counts:
        m = rows_per_device * d
        mesh = make_mesh(d, device)
        samples = torch.zeros(reps + 1, dtype=torch.float64, device=mesh.device)
        if mesh.rank is not None:
            a = (matrix_factory(m) if matrix_factory is not None
                 else synth.banded(m, bandwidth, dtype=np.float32))
            da = distribute_csr(a.indptr, a.indices, a.data, a.shape, mesh)
            x = torch.from_numpy(synth.dense_x(a.shape[1], dtype=np.float32)).to(mesh.device)
            xs = shard_of(x, -(-a.shape[1] // d), mesh)
            samples[:reps] = torch.tensor([_time_distributed(da, mesh, xs, iters) for _ in range(reps)],
                                          dtype=torch.float64)
            samples[reps] = a.nnz
        if world > 1:  # every rank learns rank 0's numbers
            dist.broadcast(samples, src=0)
        vals = samples.tolist()
        ms, nnz = min(vals[:reps]), int(vals[reps])
        rate = nnz / (ms * 1e-3)
        base_rate = base_rate or rate
        points.append(ScalePoint(devices=d, nnz=nnz, ms_per_spmv=ms, nnz_per_sec=rate,
                                 efficiency=rate / d / base_rate,
                                 spread=(max(vals[:reps]) - ms) / ms if ms > 0 else 0.0))
    return points


def report(points: List[ScalePoint]) -> str:
    lines = ["devices      nnz    ms/spmv      nnz/s   weak-eff   spread"]
    for p in points:
        lines.append(
            f"{p.devices:7d} {p.nnz:9d} {p.ms_per_spmv:9.3f} "
            f"{p.nnz_per_sec:11.3e} {p.efficiency:9.2%} {p.spread:8.1%}"
        )
    return "\n".join(lines)


def collective_floor_s(mesh: Mesh, nbytes: int, iters: int = 200) -> float:
    """Seconds per ``all_gather`` of ``nbytes`` of float32 over ``mesh``:
    at D = 1 the fixed cost of one collective call on this card, the
    latency argument of :func:`project_weak_scaling` (a floor measured at
    D = 1, not a hop between cards)."""
    t = torch.zeros(max(nbytes // 4, 1), dtype=torch.float32, device=mesh.device)
    for _ in range(10):
        all_gather_cat(t, mesh)
    timer = perf.Timer(mesh.device).start()
    for _ in range(iters):
        all_gather_cat(t, mesh)
    return timer.stop_ms() / iters * 1e-3


@dataclasses.dataclass
class ProjectedPoint:
    devices: int
    exchange: str  # "halo" | "all-gather"
    comm_bytes_per_dev: int
    comm_ms: float
    step_ms: float  # projected per-step time at D devices
    efficiency: float  # spmv_ms / step_ms (weak scaling)


def project_weak_scaling(
    spmv_ms: float,
    rows_per_device: int,
    bandwidth: int = 27,
    device_counts=(2, 4, 8, 16, 64, 256),
    link_gbps: float = NVLINK_GBPS,
    itemsize: int = 4,
    overlap: bool = False,
    *,
    latency_s: float,
) -> List[ProjectedPoint]:
    """The weak-scaling efficiency a measured per-rank SpMV time
    ``spmv_ms`` would keep at each D, adding the x exchange each rank
    makes per step (JAX :155-209): two neighbour halos of the band's
    lane-rounded width (``halo="auto"``), or the all-gather's (D - 1) *
    ``rows_per_device`` entries, at ``link_gbps`` each way plus
    ``latency_s`` per exchange (two for the halos, D - 1 for the
    all-gather). ``efficiency = spmv_ms / (spmv_ms + comm_ms)``: no
    overlap (``overlap=True`` takes the larger of the two instead)."""
    out: List[ProjectedPoint] = []
    halo_cols = max(-(-(bandwidth // 2) // 128) * 128, 128)  # lane grain
    for d in device_counts:
        for exchange in ("halo", "all-gather"):
            if exchange == "halo":
                nbytes, lat = 2 * halo_cols * itemsize, 2 * latency_s
            else:
                nbytes, lat = (d - 1) * rows_per_device * itemsize, (d - 1) * latency_s
            comm_ms = (nbytes / (link_gbps * 1e9) + lat) * 1e3
            step = max(spmv_ms, comm_ms) if overlap else spmv_ms + comm_ms
            out.append(ProjectedPoint(devices=d, exchange=exchange, comm_bytes_per_dev=nbytes,
                                      comm_ms=comm_ms, step_ms=step, efficiency=spmv_ms / step))
    return out


def projection_report(points: List[ProjectedPoint], spmv_ms: float, link_gbps: float,
                      latency_s: float) -> str:
    lines = [
        f"projection (per-rank compute {spmv_ms:.4f} ms, link {link_gbps:.0f} GB/s each way "
        f"(data sheet), {latency_s * 1e6:.2f} us per exchange (all-gather floor measured at "
        f"D = 1), no overlap):",
        "devices  exchange     comm B/dev   comm ms    step ms  proj-eff",
    ]
    for p in points:
        lines.append(
            f"{p.devices:7d}  {p.exchange:<10s} {p.comm_bytes_per_dev:12d} "
            f"{p.comm_ms:9.4f} {p.step_ms:10.4f} {p.efficiency:9.2%}"
        )
    return "\n".join(lines)
