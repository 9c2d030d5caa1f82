"""Each traced replay of a two-operator solve (iterative refinement) cut by
operator: the products of the float32 plane's operator (K1), those of the
float64 plane's (K4), and every other graph node.

``replays.replays`` cuts the window's device operations into replays by
the capture records (``csr5_bench/replays.py``). Each record places every
call of each operator among its graph's device operations (``products``,
by argument name) and counts the launches each operator's calls enqueued
(``operator_launches``, by launch counter). An operator stands for a plane
by the kernel it launched, never by its name: K1's counters for the
float32 plane ``lo``, K4's for the float64 plane ``hi``. A record without
``operator_launches`` (a program older than it), or whose operators are
not exactly one of each, gives None, and so do the readers.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from csr5_bench import replays
from csr5_bench.replays import Op

#: the launch counters (``cuda_build.launches``) of each plane's kernel: K4
#: on the float64 plane, K1 (plain, packed or relabelled) on the float32 one
KERNELS = {"hi": ("csr5_spmv_f64",), "lo": ("csr5_spmv", "csr5_spmv_packed", "csr5_spmv_relabel")}


@dataclasses.dataclass
class Cut:
    """The traced replays of a two-operator solve, cut by operator."""

    products: Dict[str, List[List[Op]]]  #: by plane, the device operations of each product
    rest: List[Op]  #: every graph node outside the products
    replays: int


def plane_of(launched: Dict[str, int]) -> Optional[str]:
    """The plane whose kernel every launch of ``launched`` ran, or None."""
    for plane, counters in KERNELS.items():
        if launched and set(launched) <= set(counters):
            return plane
    return None


def cut(t) -> Optional[Cut]:
    reps = replays.replays(t)
    if not reps:
        return None
    products: Dict[str, List[List[Op]]] = {plane: [] for plane in KERNELS}
    rest: List[Op] = []
    for r in reps:
        placed = r.record.products
        launched = getattr(r.record, "operator_launches", None)
        if not placed or not launched or len(placed) != len(KERNELS):
            return None
        planes = {op: plane_of(launched.get(op, {})) for op in placed}
        if set(planes.values()) != set(KERNELS):
            return None
        inside = set()
        for op, calls in placed.items():
            for a, b in calls:
                products[planes[op]].append(r.nodes[a:b])
                inside.update(range(a, b))
        rest += [op for i, op in enumerate(r.nodes) if i not in inside]
    return Cut(products, rest, len(reps))


def roofline(t, plane: str) -> Optional[float]:
    """The share of its roofline of ``plane``'s products: a product's byte
    model at the plane's value width (``t.plane_bytes``) times the
    products, over the card's peak bandwidth, against the device time of
    every operation those products enqueued."""
    c = cut(t)
    if c is None or not c.products[plane] or plane not in t.plane_bytes or not t.peak_gbps > 0:
        return None
    device_s = sum(e - s for ops in c.products[plane] for _, s, e in ops) * 1e-6
    if device_s <= 0:
        return None
    products = len(c.products[plane])
    return 100.0 * t.plane_bytes[plane] * products / (t.peak_gbps * 1e9) / device_s
