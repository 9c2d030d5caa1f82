"""Device microseconds per inner iteration in every graph node of the
traced replays of iterative refinement outside both operators' products:
the float32 CG's vector work, the casts and the outer float64 updates
(``csr5_bench/refine_replays.py``)."""

from csr5_bench import refine_replays


def read(t):
    c = refine_replays.cut(t)
    if c is None or not t.iters:
        return None
    return sum(e - s for _, s, e in c.rest) / (c.replays * t.iters)
