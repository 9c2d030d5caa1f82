"""The spmm product's share of its roofline: the configuration's byte model
for one product over the card's data-sheet HBM bandwidth, against the
summed device time of every operation per product in the traced window.
The byte model counts the least any format must move, so the share reads
the same work whatever format or kernel runs."""


def read(t):
    device_s = sum(end - start for _, start, end in t.device_ops) * 1e-6
    if t.kind != "product" or not t.calls or device_s <= 0 or not t.peak_gbps > 0:
        return None
    return 100.0 * t.bytes_per_call / (t.peak_gbps * 1e9) / (device_s / t.calls)
