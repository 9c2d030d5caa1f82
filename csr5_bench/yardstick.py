"""The benchmark's yardstick: the card's peak bandwidth, the roofline byte
models of the configurations, and the comparisons that decide ``correct``.

A byte model counts the least that any implementation of one product
must read and write, whatever format or kernel runs it, so a roofline
share read against it means the same work before and after a change of
format. A configuration names its model in ``byte_model``.
"""

from __future__ import annotations

import torch

#: HBM bandwidth (GB/s) by a substring of ``torch.cuda.get_device_name()``,
#: from NVIDIA's data sheets; checked in this order
HBM_GBPS_BY_DEVICE = (
    ("H100 NVL", 3900.0),
    ("H100 PCIe", 2000.0),
    ("H100 SXM", 3350.0),
    ("H100 80GB HBM3", 3350.0),
)


def hbm_gbps(device_name: str) -> float:
    """The data-sheet HBM bandwidth of the card named ``device_name``."""
    for key, gbps in HBM_GBPS_BY_DEVICE:
        if key.lower() in device_name.lower():
            return gbps
    raise ValueError(f"no HBM bandwidth known for device {device_name!r}")


def symmetric_stencil_bytes(m: int, n: int, nnz: int, rhs: int, value_bytes: int) -> float:
    """A symmetric stencil's product: its column indices follow from the
    grid, and of its values only the diagonal and one of each symmetric
    pair are distinct, (nnz + m) / 2 values; plus x read and y written."""
    return (nnz + m) / 2 * value_bytes + (n + m) * value_bytes * rhs


def pattern_only_bytes(m: int, n: int, nnz: int, rhs: int, value_bytes: int) -> float:
    """A transition matrix whose values 1 / deg follow from its pattern:
    one 4-byte column index per nonzero, plus x read and y written."""
    return nnz * 4 + (n + m) * value_bytes * rhs


BYTE_MODELS = {
    "symmetric_stencil": symmetric_stencil_bytes,
    "pattern_only": pattern_only_bytes,
}


def relative_error(x: torch.Tensor, x_ref: torch.Tensor, ord: float = 2) -> float:
    """``||x - x_ref|| / ||x_ref||`` in float64 over every entry, by the
    ``ord`` norm (``inf``: the largest gap of any one answer, against the
    largest answer); inf where x holds a non-finite value."""
    x = x.to(torch.float64)
    if not bool(torch.isfinite(x).all()):
        return float("inf")
    return float(torch.linalg.vector_norm(x - x_ref, ord) / torch.linalg.vector_norm(x_ref, ord))
