"""Performance model, timers and roofline reporting.

The counterpart of ``benchmark_spmv_using_csr5_tpu/utils/perf.py``. It
keeps the reference's metric formulation
(``CSR5_cuda/detail/utils.h:10-20``, ``main.cu:101-106``):

- ``bytes = (m+1+nnz)*sizeof(index) + (2*nnz+m)*sizeof(value)``
- ``flops = 2*nnz``
- ``GB/s = bytes / (1e6 * time_ms)``; ``GFLOPS = flops / (1e6 * time_ms)``

plus the percent of the card's HBM bandwidth for the same bytes model.
Device times come from CUDA events; a CPU run is timed on the host clock
and has no roofline.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import torch

#: HBM bandwidth (GB/s) by a substring of ``torch.cuda.get_device_name()``,
#: from NVIDIA's data sheets; checked in this order
HBM_GBPS_BY_DEVICE = (
    ("H100 NVL", 3900.0),
    ("H100 PCIe", 2000.0),
    ("H100 SXM", 3350.0),
    ("H100 80GB HBM3", 3350.0),
)


def get_bytes(m: int, nnz: int, index_bytes: int = 4, value_bytes: int = 8) -> int:
    """Bytes-moved model: getB (detail/utils.h:10-16)."""
    return (m + 1 + nnz) * index_bytes + (2 * nnz + m) * value_bytes


def get_flops(nnz: int) -> int:
    """FLOP model: getFLOP = 2*nnz (detail/utils.h:18-20)."""
    return 2 * nnz


def device_hbm_gbps(name: str) -> float:
    """HBM bandwidth of the card named ``name``; raises for a card the
    table does not know."""
    for key, bw in HBM_GBPS_BY_DEVICE:
        if key.lower() in name.lower():
            return bw
    raise ValueError(f"no HBM bandwidth known for device {name!r}")


@dataclasses.dataclass
class SpmvMetrics:
    """The headline metric line (main.cu:104-106) + roofline extension."""

    time_ms: float
    gbps: float
    gflops: float
    nnz_per_sec: float
    #: None for a CPU run: a host time has no device roofline
    roofline_gbps: Optional[float]
    pct_of_roofline: Optional[float]


def spmv_metrics(
    m: int,
    nnz: int,
    time_ms: float,
    value_bytes: int,
    index_bytes: int = 4,
    roofline_gbps: Optional[float] = None,
) -> SpmvMetrics:
    """SpMV metrics under the reference's models; the roofline share only
    when ``roofline_gbps`` is given."""
    gbps = get_bytes(m, nnz, index_bytes, value_bytes) / (1e6 * time_ms)
    return SpmvMetrics(
        time_ms=time_ms,
        gbps=gbps,
        gflops=get_flops(nnz) / (1e6 * time_ms),
        nnz_per_sec=nnz / (time_ms * 1e-3),
        roofline_gbps=roofline_gbps,
        pct_of_roofline=None if roofline_gbps is None else 100.0 * gbps / roofline_gbps,
    )


class Timer:
    """The anonymouslib_timer analogue (utils_cuda.h:6-23): CUDA events on
    the current stream of ``device``, the host clock on the CPU."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._t0 = None

    def start(self) -> "Timer":
        if self.device.type == "cuda":
            self._t0 = torch.cuda.Event(enable_timing=True)
            self._t0.record(torch.cuda.current_stream(self.device))
        else:
            self._t0 = time.perf_counter()
        return self

    def stop_ms(self) -> float:
        if self.device.type == "cuda":
            t1 = torch.cuda.Event(enable_timing=True)
            t1.record(torch.cuda.current_stream(self.device))
            t1.synchronize()
            return self._t0.elapsed_time(t1)
        return (time.perf_counter() - self._t0) * 1e3


def benchmark(
    fn: Callable, *args, device, warmup: int = 50, num_run: int = 200, **kwargs
) -> float:
    """Mean ms per call: ``warmup`` untimed calls, then ``num_run`` timed
    calls between two events (main.cu:85-101). The loop does not flush
    the L2 cache between calls."""
    for _ in range(warmup):
        fn(*args, **kwargs)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    t = Timer(device).start()
    for _ in range(num_run):
        fn(*args, **kwargs)
    return t.stop_ms() / num_run
