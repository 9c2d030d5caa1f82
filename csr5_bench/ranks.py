"""A cell's ranks: a cell with more than one chip runs as one process per
chip, rank ``r`` on ``cuda:r``, joined in one NCCL group.

``run.py`` hands such a cell to :func:`run_cell`. The launcher, the
process that prints the result, starts the ranks by the ``spawn`` method
and touches no card itself. The ranks meet through a ``FileStore`` in a
fresh temporary directory. Their default group is NCCL on the cards (gloo
on the CPU, where the tests run it); a second group, gloo on the host,
carries the harness's own signals, so that no collective of the harness
runs on a card among the products. Every rank runs the steps of the
one-chip run (``harness.run_cell``) on its own shard:

1. The configuration's generator makes the global matrix from the seed,
   the same function of the seed on every rank as in one process, and the
   traffic makes its pool of global x vectors. The rank keeps its x shards
   on its card and the global vectors on the host for the check.
2. It converts a small matrix, untimed.
3. It times ``distribute_csr`` of the global matrix with the
   configuration's ``halo`` by the device route (:data:`CONVERT`), the
   rank's ``convert.host_ms``.
4. It warms the products, as one chip does.
5. The closed loop of ``distributed_spmv_local`` over the pool's x shards.
   Rank 0 decides when to stop. Between chunks of :data:`CHUNK` products
   every rank joins a max all-reduce of a stop flag on the host group, so
   every rank runs the same count, and no rank waits for its card inside
   the window. The window runs from a barrier after every rank's warm-up
   to a barrier after every rank's last product.
6. It checks its own rows of each sampled y against the float64 reference
   of those rows.

:func:`combine` makes the ranks' parts one result line. A rank that
raises or dies, or a run that outlasts its deadline, ends every rank and
raises :class:`RankFailure`: the run exits non-zero and prints no result.
"""

from __future__ import annotations

import gc
import math
import multiprocessing as mp
import os
import queue
import random
import shutil
import subprocess
import tempfile
import time
import traceback
from datetime import timedelta
from pathlib import Path
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from . import harness, reference, yardstick

#: products between two looks at the stop flag
CHUNK = 100
#: seconds a run of one seed may take beyond its window before the
#: launcher ends it (a run has 360 s in all)
JOB_SECONDS = 300.0
#: seconds the ranks have to exit once they have reported
EXIT_SECONDS = 30.0
#: ``distribute_csr``'s route: its host route takes no value type and
#: narrows every shard to float32, its device route keeps the type of the
#: values it is given. Until the port threads a ``value_dtype`` through
#: ``build_shard`` and ``distribute_csr``, only the device route holds a
#: float64 configuration.
CONVERT = "device"


class RankFailure(RuntimeError):
    """A rank raised, died or outlasted the deadline; every rank is ended."""


def chips_of(workload: str, root: Path = harness.ROOT) -> int:
    return next(w["chips"] for w in harness.load_spec(root)["workloads"] if w["name"] == workload)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *, control: bool = False,
             **kw) -> dict:
    """One run of the multi-rank cell ``workload``: the result object, as
    ``harness.run_cell`` returns it for one chip."""
    return run_cells(workload, [(seed, control)], seconds, trace, **kw)[0]


def run_cells(workload: str, jobs: Sequence[Tuple[int, bool]], seconds: float, trace: bool, *,
              device: str = "cuda", root: Path = harness.ROOT, overrides: Optional[dict] = None,
              hook: Optional[Callable[[int], None]] = None, t_start: Optional[float] = None,
              deadline_s: Optional[float] = None,
              on_result: Optional[Callable[[dict], None]] = None) -> List[dict]:
    """Runs of ``workload`` for each ``(seed, control)`` of ``jobs``, one
    after another in one set of ranks; their result objects.

    ``device`` is ``"cuda"`` (NCCL, rank r on ``cuda:r``) or ``"cpu"``
    (gloo, the program's plain versions). ``hook(rank)``, a module-level
    function, runs in each rank once its groups are up (tests plant faults
    with it). ``deadline_s`` (default :data:`JOB_SECONDS` plus the window
    per job) bounds the whole run from ``t_start``. ``on_result`` gets each
    result as soon as every rank has reported it."""
    t_start = time.perf_counter() if t_start is None else t_start
    root = Path(root)
    cell = harness.load_cell(workload, root, overrides)
    world = chips_of(workload, root)
    grid = cell.config.get("process_grid", [world])
    if math.prod(grid) != world:
        raise ValueError(f"{workload}: process grid {grid} is not {world} ranks")
    if deadline_s is None:
        deadline_s = len(jobs) * (JOB_SECONDS + seconds)
    deadline = t_start + deadline_s

    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="csr5_bench_ranks_")
    results = ctx.Queue()
    args = (world, os.path.join(tmp, "store"), workload, list(jobs), seconds, trace, device,
            str(root), overrides, hook, t_start, results)
    procs = [ctx.Process(target=_rank_main, args=(r,) + args, daemon=True) for r in range(world)]
    parts: dict = {}
    done: List[dict] = []
    failure = None
    try:
        for p in procs:
            p.start()
        finished = set()
        while len(finished) < world and failure is None:
            try:
                kind, rank, index, payload = results.get(timeout=0.2)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs) if r not in finished and p.exitcode is not None]
                if dead:
                    failure = f"rank {dead[0]} ended with exit code {procs[dead[0]].exitcode}"
                elif time.perf_counter() > deadline:
                    failure = f"the ranks did not finish within {deadline_s:.0f} s"
                continue
            if kind == "error":
                failure = f"rank {rank} raised:\n{payload}"
            elif kind == "done":
                finished.add(rank)
            else:
                parts.setdefault(index, {})[rank] = payload
                if len(parts[index]) == world:
                    got = parts.pop(index)
                    done.append(combine(cell, [got[r] for r in range(world)]))
                    if device == "cuda":
                        done[-1]["device"].update(_cards())
                    if on_result is not None:
                        on_result(done[-1])
    finally:
        _end(procs, failure is not None)
        shutil.rmtree(tmp, ignore_errors=True)
    if failure is not None:
        raise RankFailure(failure)
    return done


def _end(procs, now: bool) -> None:
    """Wait for every rank to exit (at once when ``now``), then end the
    rest: terminate, then kill."""
    procs = [p for p in procs if p.pid is not None]  # those started
    limit = time.perf_counter() + (0.0 if now else EXIT_SECONDS)
    for p in procs:
        p.join(timeout=max(limit - time.perf_counter(), 0.0))
    for p in procs:
        if p.is_alive():
            p.terminate()
    for p in procs:
        p.join(timeout=5.0)
        if p.is_alive():
            p.kill()
            p.join()


def _cards() -> dict:
    """Every card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout
        return {"nvidia_smi": "; ".join(out.strip().splitlines()) or "not read"}
    except (OSError, subprocess.SubprocessError):
        return {"nvidia_smi": "not read"}


def _worst(values: list, better: str):
    return min(values) if better == "higher" else max(values)


def combine(cell: harness.Cell, parts: List[dict]) -> dict:
    """The result line of one run from its ranks' parts, rank 0 first:
    the window, the count and the set-up are rank 0's (every rank ran the
    same count between shared barriers); y_err of a sampled product is the
    largest gap of any rank over the largest reference value of any rank,
    so of the whole y; the peak is the fullest card's; each per-layer
    metric is the worst rank's; ``busy_s``, ``window_s`` and the breakdown
    are the least busy rank's."""
    lead = parts[0]
    calls = {p["calls"] for p in parts}
    if len(calls) != 1:
        raise RankFailure(f"the ranks ran different counts of products: {sorted(calls)}")
    bad = sorted({name for p in parts for name in p["forbidden"]})
    if bad:
        raise RankFailure(f"a rank loaded forbidden modules: {', '.join(bad)}")
    limit = float(cell.limits[lead["check_name"]]["limit"])
    errs = []
    for i in range(len(lead["gaps"])):
        num = max(p["gaps"][i][0] for p in parts)
        den = max(p["gaps"][i][1] for p in parts)
        errs.append(num / den if den > 0 and math.isfinite(num) else math.inf)
    failed = sum(1 for x in errs if not x <= limit)
    result = {"correct": bool(errs) and failed == 0, "attempted": lead["calls"], "failed": failed}
    device = dict(lead["device"], count=len(parts),
                  memory_peak_bytes=max(p["device"]["memory_peak_bytes"] for p in parts))
    metrics = {}
    if "busy_s" in lead:
        units = {m["name"]: m for m in cell.per_layer}
        for name, m in units.items():
            values = [p["metrics"][name] for p in parts if p["metrics"].get(name) is not None]
            if values:
                metrics[name] = {"value": _worst(values, m["better"]), "unit": m["unit"]}
        idle = min(parts, key=lambda p: p["busy_s"] / p["window_s"] if p["window_s"] > 0 else 0.0)
        device.update(busy_s=idle["busy_s"], window_s=idle["window_s"])
        result.update(metrics=metrics, device=device, breakdown=idle["breakdown"])
    else:
        measured = {"setup_s": lead["setup_s"], "product_ms": lead["window_s"] * 1e3 / lead["calls"]}
        for m in cell.end_to_end:
            if m["name"] in measured:
                metrics[m["name"]] = {"value": measured[m["name"]], "unit": m["unit"]}
        result.update(metrics=metrics, device=device)
    result["shape"] = dict(lead["shape"], ranks=[p["rank_shape"] for p in parts])
    result["phases"] = lead["phases"]
    result["checks"] = {lead["check_name"]: {"value": max(errs) if errs else math.inf,
                                             "limit": limit, "compared": len(errs)}}
    return result


# ---------------------------------------------------------------------------
# a rank
# ---------------------------------------------------------------------------


def _rank_main(rank, world, store_path, workload, jobs, seconds, trace, device, root, overrides,
               hook, t_start, results) -> None:
    """Rank ``rank``: join the groups, then run each job and report its part."""
    try:
        # no network: NCCL's and gloo's bootstrap on the loopback interface
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        cuda = device == "cuda"
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world) if cuda else 1)
        if cuda:
            torch.cuda.set_device(rank)
        dev = torch.device("cuda", rank) if cuda else torch.device("cpu")
        dist.init_process_group("nccl" if cuda else "gloo",
                                store=dist.FileStore(store_path, world), rank=rank,
                                world_size=world, timeout=timedelta(seconds=600))
        host = dist.new_group(backend="gloo")
        if hook is not None:
            hook(rank)
        from benchmark_spmv_using_csr5_tpu_torch.parallel import distributed

        mesh = distributed.make_mesh(world, device=dev)
        # the first collective of the card's group, from every rank at once
        dist.all_reduce(torch.ones(1, device=dev), group=mesh.group)
        cell = harness.load_cell(workload, Path(root), overrides)
        for index, (seed, control) in enumerate(jobs):
            job = _RankRun(cell, Path(root), rank, dev, mesh, host, distributed)
            part = job.run(seed, control, seconds, trace,
                           t_start if index == 0 else time.perf_counter())
            del job
            gc.collect()
            results.put(("part", rank, index, part))
        results.put(("done", rank, None, None))
    except Exception:  # noqa: BLE001 - reported; the launcher ends every rank
        results.put(("error", rank, None, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


class _RankRun:
    """One run of one seed on one rank."""

    def __init__(self, cell, root, rank, dev, mesh, host, distributed):
        self.cell, self.root, self.rank, self.world = cell, root, rank, mesh.size
        self.traffic = cell.traffic
        self.dev, self.mesh, self.host, self.distributed = dev, mesh, host, distributed
        self.cuda = dev.type == "cuda"

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.dev)

    def stop_now(self, lead_says: bool) -> bool:
        """Rank 0's word, the same on every rank."""
        flag = torch.tensor([1 if lead_says else 0], dtype=torch.int32)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=self.host)
        return bool(flag.item())

    def loop(self, seconds: float) -> Tuple[int, float]:
        """The closed loop: (products, host seconds between the barriers)."""
        pool, p, product, kept = self.pool, len(self.pool), self.product, self.kept
        self.sync()
        dist.barrier(group=self.host)
        t0 = time.perf_counter()
        calls = 0
        while True:
            for _ in range(CHUNK):
                j = calls % p
                kept.offer((j, product(pool[j])))
                calls += 1
            if self.stop_now(self.rank == 0 and time.perf_counter() - t0 >= seconds):
                break
        self.sync()
        dist.barrier(group=self.host)
        return calls, time.perf_counter() - t0

    def dispatch_s(self) -> float:
        """``harness._Products.dispatch_s``, begun on every rank at once."""
        dist.barrier(group=self.host)
        return harness._Products.dispatch_s(self, self.sync)

    def run(self, seed: int, control: bool, seconds: float, trace: bool, t_start: float) -> dict:
        import benchmark_spmv_using_csr5_tpu_torch as port

        from .run import loaded_forbidden

        dev, r, D = self.dev, self.rank, self.world
        cfg, traffic = self.cell.config, self.cell.traffic
        if traffic["kind"] != "product" or int(traffic["rhs"]) != 1:
            raise ValueError("a multi-rank cell runs SpMV products (kind product, rhs 1)")
        plane = (harness.CONTROL_PLANES if control else harness.PLANES)[cfg["precision"]]
        if plane not in (torch.float64, torch.float32):
            raise ValueError(f"the distributed layer takes float64 or float32 values, not {plane}")
        phases = {"start_s": time.perf_counter() - t_start}

        # 1. the global matrix and the pool of global x vectors, from the seed
        gen = harness.load_module(self.root, "generators", cfg["generator"])
        csr = gen.generate(cfg, seed, dev, rank=r)
        m, n = csr["shape"]
        self.sync()
        phases["generate_s"] = time.perf_counter() - t_start
        xs = harness._inputs(traffic, csr, seed, dev, plane)["pool"]
        rp, ci, val = (csr[k].cpu().numpy() for k in ("row_ptr", "col", "val"))
        del csr
        # the program's values in the plane's type (the device route keeps
        # the type it is given); the reference reads the float64 ones
        val_prog = val if plane == torch.float64 else val.astype(np.float32)
        rows_per, n_per = -(-m // D), -(-n // D)
        c0, c1 = r * n_per, min((r + 1) * n_per, n)
        self.pool = []
        for x in xs:  # this rank's shard, zero-padded to n_per
            shard = torch.zeros(n_per, dtype=plane, device=dev)
            shard[: max(c1 - c0, 0)] = x[c0:c1]
            self.pool.append(shard)
        x_host = [x.cpu() for x in xs]
        del xs
        if self.cuda:
            torch.cuda.empty_cache()
        phases["to_host_s"] = time.perf_counter() - t_start

        # 2. a small conversion, untimed, loads the conversion's libraries
        k = min(m, harness.WARM_ROWS * D)
        e = int(rp[k])
        self.distributed.build_shard(rp[: k + 1], ci[:e], val_prog[:e], (k, n), r, D,
                                     convert=CONVERT, device=dev)
        self.sync()
        if self.cuda:
            torch.cuda.reset_peak_memory_stats(dev)

        # 3. the distribution of the configuration's matrix, timed
        port.ops.convert.last_convert_phases.clear()
        t0 = time.perf_counter()
        da = self.distributed.distribute_csr(rp, ci, val_prog, (m, n), self.mesh,
                                             halo=cfg["halo"], convert=CONVERT)
        self.sync()
        convert_ms = (time.perf_counter() - t0) * 1e3
        convert_phases = dict(port.ops.convert.last_convert_phases)
        phases["convert_s"] = time.perf_counter() - t_start
        if da.local.val_tiles.dtype != plane:
            raise RuntimeError(
                f"rank {r}: distribute_csr ({CONVERT} route, {da.convert_route} ran) built "
                f"a {da.local.val_tiles.dtype} plane, not the configuration's {plane}")

        # 4. the products, warmed
        distributed, mesh = self.distributed, self.mesh
        self.product = lambda x: distributed.distributed_spmv_local(da, x, mesh)
        self.kept = harness.Reservoir(int(traffic["keep"]), random.Random(seed))
        held = [self.product(self.pool[i % len(self.pool)])
                for i in range(len(self.pool) + self.kept.k)]
        self.sync()
        del held

        # 5. the window, from a barrier after every rank's warm-up
        dist.barrier(group=self.host)
        setup_s = time.perf_counter() - t_start
        phases["setup_s"] = setup_s
        gc.collect()
        gc.disable()
        try:
            if trace:
                dispatch = self.dispatch_s()
                span = min(seconds, float(traffic["trace_seconds"]))
                calls, window_s, dev_ops, host_ops = harness._profiled(
                    lambda: self.loop(span)[0], self.cuda, self.sync)
            else:
                calls, window_s = self.loop(seconds)
        finally:
            gc.enable()
        peak = torch.cuda.max_memory_allocated(dev) if self.cuda else 0
        phases["window_end_s"] = time.perf_counter() - t_start

        # 6. the check of this rank's rows, once the program's state is freed
        halo = da.halo
        self.product = None
        del da, val_prog
        gc.collect()
        if self.cuda:
            torch.cuda.empty_cache()
        r0, r1 = min(r * rows_per, m), min((r + 1) * rows_per, m)
        lo, hi = int(rp[r0]), int(rp[r1])
        ref = reference.CSR(rp[r0: r1 + 1] - lo, ci[lo:hi], val[lo:hi], (r1 - r0, n), dev)
        gaps: list = [None] * len(self.kept.items)  # (largest gap, largest value) a sample
        for j in sorted({j for j, _ in self.kept.items}):
            want = ref.matmul(x_host[j].to(dev))
            top = float(want.abs().max()) if r1 > r0 else 0.0
            for i, (jj, y) in enumerate(self.kept.items):
                if jj != j:
                    continue
                y = y[: r1 - r0].to(torch.float64)
                if not bool(torch.isfinite(y).all()):
                    gaps[i] = (math.inf, top)
                else:
                    gaps[i] = (float((y - want).abs().max()) if r1 > r0 else 0.0, top)
            del want
        del ref
        self.kept = self.pool = None
        phases["check_s"] = time.perf_counter() - t_start

        n_loc = n if halo is None else n_per + halo[0] + halo[1]
        part = {
            "calls": calls, "window_s": window_s, "setup_s": setup_s, "phases": phases,
            "check_name": "y_err", "gaps": gaps, "forbidden": loaded_forbidden(),
            "device": {"platform": "gpu" if self.cuda else dev.type,
                       "kind": torch.cuda.get_device_name(dev) if self.cuda else "cpu",
                       "memory_peak_bytes": int(peak)},
            "shape": {"rows": m, "cols": n, "nnz": int(rp[-1]), "plane": str(plane)},
            "rank_shape": {"rows": r1 - r0, "cols": n_loc, "nnz": hi - lo,
                           "halo": list(halo) if halo else None, "convert_ms": convert_ms,
                           "peak": int(peak)},
        }
        if trace:
            busy_s, idle = harness._union_s(dev_ops)
            model = yardstick.BYTE_MODELS[cfg["byte_model"]]
            value_bytes = 8 if cfg["precision"] == "float64" else 4
            peak_gbps = yardstick.hbm_gbps(part["device"]["kind"]) if self.cuda else math.nan
            t = harness.Trace("product", calls, 1, window_s, busy_s, dev_ops, host_ops, dispatch,
                              model(r1 - r0, n_loc, hi - lo, 1, value_bytes), peak_gbps,
                              convert_ms, convert_phases)
            part["metrics"] = {mt["name"]: harness.load_module(self.root, "metrics",
                                                                 mt["name"]).read(t)
                               for mt in self.cell.per_layer}
            part.update(busy_s=busy_s, window_s=window_s, breakdown=harness._breakdown(t, idle))
        return part
