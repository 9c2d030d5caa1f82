"""The distributed product as a program on the cards: one rank per card,
joined by NCCL, on HPCG's stencil over 1 x 1 x D stacked local grids.

    python3 scripts/dist_program_check.py [--ranks 4] [--local 64 192] [--products 200]

For each local grid size (the float64 plane on K4, then the float32 plane
on K1 at the first size) every rank builds its shard by the device route,
then:

1. runs the eager body (``distributed._eager_product``) and the program
   path (``distributed_spmv_local``: eager, capture, then replays) on the
   same seeded x shards, and holds them bit for bit; each y's largest gap
   against the float64 reference of the rank's rows over the largest
   answer, and the conversion's phases; then, on a key of its own
   (alpha -1), the even ranks keep every y while the odd ranks drop each
   (the even ones capture a program a call while the odd ones replay),
   each y against the eager body's bit for bit;
2. times both in turns (eager, program, program, eager) over
   ``--products`` back-to-back products between barriers: the card's ms
   per product (CUDA events) and the host's µs to enqueue one;
3. profiles 50 replays: the host events (count and mean µs:
   ``cudaGraphLaunch``, ``aten::zeros``, ``aten::cat``, ``aten::copy_``,
   ``aten::clone``), the device operations by name, the programs the key
   keeps, and the last program's capture record.

Each rank writes its lines to ``chiprun_out/dist_program_check.rank<r>.jsonl``
and rank 0 prints them all; the exit code is 1 unless every rank held the
two paths equal. Needs ``--ranks`` CUDA cards.
"""

from __future__ import annotations

import argparse
import collections
import json
import multiprocessing as mp
import os
import sys
import tempfile
import time
from datetime import timedelta
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

#: the seed of the matrix; x's seeds follow it
SEED = 2**31 + 4242
OUT = ROOT / "chiprun_out"


def _events(prof):
    """Host events by name (count, mean µs) and device operations by name
    (count), the card's copies of host annotations left out."""
    host, dev = collections.defaultdict(list), collections.Counter()
    for e in prof.events():
        if e.time_range.end <= e.time_range.start:
            continue
        if str(e.device_type).endswith("CUDA"):
            if not (getattr(e, "is_user_annotation", False)
                    or getattr(e, "activity_type", None) == "gpu_user_annotation"):
                dev[e.name[:60]] += 1
        else:
            host[e.name].append(e.time_range.end - e.time_range.start)
    return {k: (len(v), sum(v) / len(v)) for k, v in host.items()}, dev


def _rank(rank: int, world: int, store: str, sizes, products: int) -> None:
    lines: list = []
    try:
        ok = _run(rank, world, store, sizes, products, lines)
    except Exception:  # noqa: BLE001 - written out, then the rank fails
        import traceback

        lines.append(json.dumps({"rank": rank, "error": traceback.format_exc()}))
        ok = False
    OUT.mkdir(exist_ok=True)
    (OUT / f"dist_program_check.rank{rank}.jsonl").write_text("\n".join(lines) + "\n")
    if not ok:
        sys.exit(1)


def _run(rank: int, world: int, store: str, sizes, products: int, lines: list) -> bool:
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from benchmark_spmv_using_csr5_tpu_torch.ops import convert
    from benchmark_spmv_using_csr5_tpu_torch.parallel import distributed as pd
    from benchmark_spmv_using_csr5_tpu_torch.utils import trace
    from csr5_bench import reference
    from csr5_bench.generators import stencil27_zstack

    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    torch.cuda.set_device(rank)
    dev = torch.device("cuda", rank)
    dist.init_process_group("nccl", store=dist.FileStore(store, world), rank=rank,
                            world_size=world, timeout=timedelta(seconds=300))
    mesh = pd.make_mesh(world, device=dev)
    dist.all_reduce(torch.ones(1, device=dev), group=mesh.group)
    sync = lambda: torch.cuda.synchronize(dev)  # noqa: E731
    ok = True

    def emit(**kw):
        kw.update(rank=rank)
        lines.append(json.dumps(kw))

    runs = [(n, torch.float64) for n in sizes] + [(sizes[0], torch.float32)]
    for local, plane in runs:
        cfg = {"nx": local, "ny": local, "nz": local, "process_grid": [1, 1, world]}
        g = stencil27_zstack.generate(cfg, SEED, dev, rank=rank)
        rp, ci, val = (g[k].cpu().numpy() for k in ("row_ptr", "col", "val"))
        m, n = g["shape"]
        del g
        t0 = time.perf_counter()
        da = pd.distribute_csr(rp, ci, val, (m, n), mesh, halo="auto", convert="device",
                               value_dtype=plane)
        sync()
        convert_s = time.perf_counter() - t0
        phases = dict(convert.last_convert_phases)
        rows, n_per = da.rows_per_shard, -(-n // world)
        gen = torch.Generator(device=dev).manual_seed(SEED + 1)
        xs = [torch.rand(n, generator=gen, dtype=plane, device=dev) * 2 - 1 for _ in range(4)]
        shards = [x[rank * n_per:(rank + 1) * n_per].contiguous() for x in xs]

        # 1. the two paths on the same x shards, bit for bit
        eager = [pd._eager_product(da, s, mesh, 1.0) for s in shards]
        graphed = [pd.distributed_spmv_local(da, shards[i % 4], mesh) for i in range(8)]
        sync()
        same = all(torch.equal(graphed[i], eager[i % 4]) for i in range(8))
        ok &= same
        r0, r1 = rank * rows, min((rank + 1) * rows, m)
        lo, hi = int(rp[r0]), int(rp[r1])
        ref = reference.CSR(rp[r0:r1 + 1] - lo, ci[lo:hi], val[lo:hi], (r1 - r0, n), dev)
        errs = []
        for i, x in enumerate(xs):
            want = ref.matmul(x)
            errs.append(float((graphed[i][: r1 - r0].double() - want).abs().max()
                              / want.abs().max()))
        del ref, want, eager, graphed
        records = trace.captures()
        emit(kind="equal", local=local, plane=str(plane), halo=da.halo, route=da.convert_route,
             convert_s=convert_s, phases=phases, bit_identical=same, y_err=errs,
             record=vars(records[max(records)]) if records else None)
        # the even ranks hold every y, the odd drop each: one exchange a
        # call on every rank keeps the ranks' exchanges paired
        mixed, held, calls = True, [], pd.RING + 4
        with profile(activities=[ProfilerActivity.CPU]):
            for i in range(calls):
                y = pd.distributed_spmv_local(da, shards[i % 4], mesh, -1.0)
                mixed &= bool(torch.equal(y, pd._eager_product(da, shards[i % 4], mesh, -1.0)))
                if rank % 2 == 0:
                    held.append((y, y.clone()))
                del y
            sync()
        mixed &= all(torch.equal(y, c) for y, c in held)
        modes = [s.attrs["mode"] for s in trace.spans() if s.name == "csr5.dist.product"][-calls:]
        ok &= mixed
        del held
        emit(kind="mixed", local=local, plane=str(plane), holds=rank % 2 == 0, modes=modes,
             bit_identical=mixed)

        # 2. eager and program in turns
        def timed(fn):
            dist.barrier()
            sync()
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            h0 = time.perf_counter()
            e0.record()
            for i in range(products):
                fn(shards[i % 4])
            h1 = time.perf_counter()
            e1.record()
            sync()
            return e0.elapsed_time(e1) / products, (h1 - h0) * 1e6 / products

        turns = {}
        for name in ("eager", "program", "program", "eager"):
            fn = ((lambda s: pd._eager_product(da, s, mesh, 1.0)) if name == "eager"
                  else (lambda s: pd.distributed_spmv_local(da, s, mesh)))
            turns.setdefault(name, []).append(timed(fn))
        emit(kind="turns", local=local, plane=str(plane), products=products,
             ms=turns, card=torch.cuda.get_device_name(dev))

        # 3. 50 replays under the profiler
        dist.barrier()
        sync()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for i in range(50):
                pd.distributed_spmv_local(da, shards[i % 4], mesh)
            sync()
        host, devc = _events(prof)
        spans = [s for s in trace.spans() if s.name == "csr5.dist.product"][-50:]
        emit(kind="profile", local=local, plane=str(plane), products=50,
             ring={str(k[-1]): len(r.progs) for k, r in pd._programs[da].programs.items()}
             if da in pd._programs else {},
             host={k: host.get(k, (0, None)) for k in (
                 "cudaGraphLaunch", "aten::zeros", "aten::cat", "aten::copy_", "aten::clone",
                 "cudaLaunchKernel", "cudaMemcpyAsync")},
             device=dict(devc), modes=dict(collections.Counter(s.attrs["mode"] for s in spans)),
             span_us=float(np.mean([(s.end - s.start) / 1e3 for s in spans])) if spans else None)
        del da, xs, shards
        torch.cuda.empty_cache()
    dist.barrier()
    dist.destroy_process_group()
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--local", type=int, nargs="+", default=[64, 192])
    ap.add_argument("--products", type=int, default=200)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < args.ranks:
        print(f"needs {args.ranks} CUDA cards", file=sys.stderr)
        return 2
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=_rank, args=(r, args.ranks, os.path.join(tmp, "store"),
                                                 args.local, args.products))
                 for r in range(args.ranks)]
        for p in procs:
            p.start()
        for p in procs:
            p.join()
    for r in range(args.ranks):
        path = OUT / f"dist_program_check.rank{r}.jsonl"
        if path.exists():
            print(path.read_text(), end="")
    codes = [p.exitcode for p in procs]
    print(json.dumps({"exit_codes": codes}))
    return 0 if all(c == 0 for c in codes) else 1


if __name__ == "__main__":
    sys.exit(main())
