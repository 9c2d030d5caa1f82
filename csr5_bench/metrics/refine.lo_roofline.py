"""K1's share of its roofline on the float32 plane inside iterative
refinement: the byte model at 4 B a value times the products of the
operator whose calls launched K1, over the card's data-sheet HBM
bandwidth, against the device time of every operation those products
enqueued in the traced replays (``csr5_bench/refine_replays.py``)."""

from csr5_bench import refine_replays


def read(t):
    return refine_replays.roofline(t, "lo")
