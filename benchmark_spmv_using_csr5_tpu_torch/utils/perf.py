"""Performance model, timers and roofline reporting.

The counterpart of ``benchmark_spmv_using_csr5_tpu/utils/perf.py``. It
keeps the reference's metric formulation
(``CSR5_cuda/detail/utils.h:10-20``, ``main.cu:101-106``):

- ``bytes = (m+1+nnz)*sizeof(index) + (2*nnz+m)*sizeof(value)`` (getB)
- ``flops = 2*nnz``
- ``GB/s = bytes / (1e6 * time_ms)``; ``GFLOPS = flops / (1e6 * time_ms)``

getB charges 4 B of index and a full value per nonzero whatever the
format stores, so on a bfloat16 plane, or on planes that partly stay in
the 50 MB L2 between calls, its share of the card's HBM bandwidth can
read above 100 %. :func:`streamed_bytes` counts instead what the
format's kernel streams: each plane it reads once, x once and y once.
That share (``pct_hbm_streamed``) is the physical roofline share; getB's
(``pct_getb_of_hbm``) stays beside it as the reference's metric. Device
times come from CUDA events; a CPU run is timed on the host clock and
has neither share.
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
#: the H100's L2 cache (NVIDIA's data sheet): a matrix whose streamed
#: bytes fit in it can stay resident between the timed loop's calls
L2_BYTES = 50 * 2**20


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


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def plane_bytes(matrix) -> int:
    """Bytes of the planes the format's kernel reads once per call:

    - CSR5 (K1/K2, K4): the raw column plane, values, ``win_map`` and
      ``tile_ptr``; where K1p/K2p run (``col_packed`` present on a
      float32 or bfloat16 plane) the packed columns and ``pages`` in
      place of the raw columns;
    - row-sliced CSR5 (K3): the sum over its slices;
    - DIA (K5/K6): the value plane and the offsets;
    - HYB5: its DIA part and its CSR5 part;
    - band-block (K7): the dense plane and the window starts ``c0``."""
    from ..models.formats import CSR5Matrix
    from ..ops.bandmm import BandBlockMatrix
    from ..ops.bigslice import SlicedCSR5
    from ..ops.dia import DIAMatrix
    from ..ops.hyb import HYBMatrix

    if isinstance(matrix, CSR5Matrix):
        packed = matrix.col_packed is not None and matrix.val_tiles.dtype != torch.float64
        cols = (matrix.col_packed, matrix.pages) if packed else (matrix.col_idx_tiles,)
        return _nbytes(*cols, matrix.val_tiles, matrix.win_map, matrix.tile_ptr)
    if isinstance(matrix, SlicedCSR5):
        return sum(plane_bytes(s) for s in matrix.slices)
    if isinstance(matrix, DIAMatrix):
        return _nbytes(matrix.data, matrix.offsets_t)
    if isinstance(matrix, HYBMatrix):
        return sum(plane_bytes(p) for p in (matrix.dia, matrix.csr5) if p is not None)
    if isinstance(matrix, BandBlockMatrix):
        return _nbytes(matrix.dense, matrix.c0)
    raise TypeError(f"no byte model for {type(matrix).__name__}")


def streamed_bytes(matrix, x: torch.Tensor, num_rhs: int = 1) -> int:
    """Bytes one product ``y = A @ x`` streams at least: the planes of
    :func:`plane_bytes`, x (or X, in either layout) read once and y (m
    rows by ``num_rhs``, in x's dtype) written once. What ``chip_smoke.py``
    divides by the card's bandwidth for each kernel's bound."""
    return plane_bytes(matrix) + _nbytes(x) + matrix.m * num_rhs * x.element_size()


@dataclasses.dataclass
class SpmvMetrics:
    """The headline metric line (main.cu:104-106) + the two roofline
    shares."""

    time_ms: float
    #: getB bytes over the time: the reference's GB/s
    getb_gbps: float
    gflops: float
    nnz_per_sec: float
    #: None for a CPU run: a host time has no device roofline
    roofline_gbps: Optional[float]
    #: getB GB/s over the card's bandwidth (can exceed 100 %)
    pct_getb_of_hbm: Optional[float]
    #: the bytes of :func:`streamed_bytes`, when the caller gave them
    streamed_bytes: Optional[int] = None
    #: streamed bytes over the time, over the card's bandwidth
    pct_hbm_streamed: Optional[float] = None


def spmv_metrics(
    m: int,
    nnz: int,
    time_ms: float,
    value_bytes: int,
    index_bytes: int = 4,
    roofline_gbps: Optional[float] = None,
    num_rhs: int = 1,
    n: Optional[int] = None,
    streamed: Optional[int] = None,
) -> SpmvMetrics:
    """SpMV metrics under the reference's models; the roofline shares only
    when ``roofline_gbps`` is given, the streamed one only with
    ``streamed`` bytes. For SpMM (``num_rhs > 1``) the flops scale by R and
    getB adds the (x + y) traffic of each extra right-hand side, as the
    JAX package counts them."""
    b = get_bytes(m, nnz, index_bytes, value_bytes)
    if num_rhs > 1:
        b += (num_rhs - 1) * ((n or m) + m) * value_bytes
    gbps = b / (1e6 * time_ms)
    on_card = roofline_gbps is not None
    return SpmvMetrics(
        time_ms=time_ms,
        getb_gbps=gbps,
        gflops=get_flops(nnz) * num_rhs / (1e6 * time_ms),
        nnz_per_sec=nnz / (time_ms * 1e-3),
        roofline_gbps=roofline_gbps,
        pct_getb_of_hbm=100.0 * gbps / roofline_gbps if on_card else None,
        streamed_bytes=streamed,
        pct_hbm_streamed=(
            100.0 * streamed / (1e6 * time_ms) / roofline_gbps
            if on_card and streamed is not None
            else None
        ),
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
