"""Faults planted under the timed path of the multi-rank harness, for
``test_cb_ranks.py``. Each is a module-level function that
``ranks.run_cells(hook=...)`` runs in every rank once its groups are up;
it changes the port's distributed layer in that rank's process only."""

import os
import time

from benchmark_spmv_using_csr5_tpu_torch.parallel import distributed


class _Products:
    """A hook that passes every local product of the ranks in ``on``
    (all when None) through ``change(y, calls)``; picklable, so spawned
    ranks can be handed it."""

    def __init__(self, change, on=None):
        self.change, self.on = change, on

    def __call__(self, rank):
        if self.on is not None and rank not in self.on:
            return
        spmv, change, calls = distributed.csr5_spmv, self.change, [0]

        def changed(a5, x, *args, **kw):
            calls[0] += 1
            return change(spmv(a5, x, *args, **kw), calls[0])

        distributed.csr5_spmv = changed


def halo_zero(rank):
    """The exchange left out on rank 1: its halos stay zero."""
    if rank != 1:
        return
    exchange = distributed.halo_exchange

    def zeroed(x_shard, h_l, h_r, mesh):
        out = exchange(x_shard, h_l, h_r, mesh).clone()
        out[:h_l] = 0
        out[out.shape[0] - h_r:] = 0
        return out

    distributed.halo_exchange = zeroed


def _altered(y, _calls):
    y = y.clone()
    y[y.shape[0] // 3] += 0.1 * y.abs().max()
    return y


def _half(y, _calls):
    y = y.clone()
    y[y.shape[0] // 2:] = 0
    return y


def _zeros(y, _calls):
    return y * 0


def _dies(y, calls):
    if calls > 3:
        os._exit(7)
    return y


#: one answer altered where it is produced, on rank 2
altered = _Products(_altered, (2,))
#: one rank's shard left out: rank 3's block never computed
shard_left_out = _Products(_zeros, (3,))
#: half of every rank's block left out
half = _Products(_half)
#: every product returns its zeroed output unchanged
unchanged = _Products(_zeros)
#: rank 1 dies inside the warm-up, while the others wait in an exchange
dies = _Products(_dies, (1,))


def raises(rank):
    """Rank 2 raises before the first collective."""
    if rank == 2:
        raise RuntimeError("a planted failure on rank 2")


def hangs(rank):
    """Rank 3 never reaches the first collective."""
    if rank == 3:
        time.sleep(3600)
