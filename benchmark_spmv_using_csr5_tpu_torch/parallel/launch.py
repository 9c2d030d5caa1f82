"""The process groups the distributed layer runs in.

The JAX package is one controller over a mesh of D devices; on a CPU it
makes D virtual devices (``--xla_force_host_platform_device_count``). The
port is SPMD: one process per rank, joined by ``torch.distributed``.

- :func:`single_rank_group`: a group of world size 1 in this process, from
  a ``FileStore`` in a fresh temporary directory (no network), NCCL on
  the card and gloo on the CPU; destroyed on exit. What the suite's
  ``dist1_banded500k``, the example and ``chip_smoke.py`` open on the one
  H100.
- :func:`run_ranks`: ``fn(rank, world_size, *args)`` in D spawned CPU
  processes joined by gloo through a ``file://`` init, the counterpart of
  the virtual CPU mesh. ``fn`` must be importable by the children (a
  module-level function). Each rank runs one torch thread.
"""

from __future__ import annotations

import contextlib
import multiprocessing as mp
import os
import queue
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

from ..config import DEFAULT_DEVICE, resolve_device


def backend_for(device) -> str:
    """NCCL for a CUDA device, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


@contextlib.contextmanager
def single_rank_group(device=DEFAULT_DEVICE):
    """A default process group of world size 1 in this process, for
    ``device`` (default: the card, raising without one): NCCL on the card,
    gloo on the CPU. Raises when a group is already initialized."""
    device = resolve_device(device, "single_rank_group")
    if dist.is_initialized():
        raise RuntimeError("single_rank_group: a process group is already initialized")
    tmp = tempfile.mkdtemp(prefix="csr5_pg_")
    try:
        store = dist.FileStore(os.path.join(tmp, "store"), 1)
        dist.init_process_group(backend_for(device), store=store, rank=0, world_size=1)
        yield
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)


def _rank_main(fn, rank: int, world_size: int, init_method: str, results, args) -> None:
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=init_method, rank=rank, world_size=world_size)
        out = fn(rank, world_size, *args)
        results.put((rank, True, out))
    except Exception:  # noqa: BLE001 - reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn, world_size: int, *args, timeout: float = 300.0) -> list:
    """``[fn(0, world_size, *args), ..., fn(world_size - 1, ...)]``, each
    run in its own spawned CPU process with the default group initialized
    (gloo, ``file://`` init in a fresh temporary directory). Raises with
    the rank's traceback when a rank raises, and stops every process on
    the way out."""
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="csr5_ranks_")
    init = "file://" + os.path.join(tmp, "init")
    results = ctx.Queue()
    procs = [
        ctx.Process(target=_rank_main, args=(fn, r, world_size, init, results, args), daemon=True)
        for r in range(world_size)
    ]
    out, errors = {}, []
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        while len(out) + len(errors) < world_size:
            try:
                rank, ok, payload = results.get(timeout=max(deadline - time.monotonic(), 0.01))
            except queue.Empty:
                raise TimeoutError(
                    f"run_ranks: {world_size - len(out)} of {world_size} ranks did not finish "
                    f"in {timeout} s"
                ) from None
            if ok:
                out[rank] = payload
            else:
                errors.append(f"rank {rank}:\n{payload}")
                break  # the other ranks may wait on it forever
    finally:
        for p in procs:
            p.join(timeout=5 if not errors else 0.5)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)
        shutil.rmtree(tmp, ignore_errors=True)
    if errors:
        raise RuntimeError("run_ranks: " + "\n".join(errors))
    return [out[r] for r in range(world_size)]
