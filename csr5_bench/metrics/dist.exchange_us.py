"""Device microseconds per distributed product in its halo exchange: in
each traced replay, from the start of the first of the exchange's
operations to the end of the last (its NCCL kernels, placed by the
program's capture record; a receive waits in its kernel for the sender),
over the replays. The run takes the worst rank's."""

from csr5_bench import dist_replays


def read(t):
    reps = dist_replays.product_replays(t)
    parts = dist_replays.exchange_ops(reps) if reps else None
    if not parts:
        return None
    return sum(max(e for _, _, e in ops) - min(s for _, s, _ in ops) for ops in parts) / len(parts)
