"""The SpMV's share of its roofline inside a solve: the configuration's byte
model for one product, times the products that ran (the replays times
the calls of the solver's operator each one's capture record places),
over the card's data-sheet HBM bandwidth, against the device time of
every operation those calls enqueued inside the traced replays (the
program's spans and capture records place them; ``csr5_bench/replays.py``).
As ``spmv_roofline`` does, it counts every operation of a product."""

from csr5_bench import replays


def read(t):
    reps = replays.replays(t)
    parts = replays.split(reps) if reps else None
    if not parts or not parts[0] or not t.peak_gbps > 0:
        return None
    products = parts[0]
    device_s = sum(e - s for ops in products for _, s, e in ops) * 1e-6
    if device_s <= 0:
        return None
    return 100.0 * t.bytes_per_call * len(products) / (t.peak_gbps * 1e9) / device_s
