"""End-to-end benchmark harness for the CSR5 SpMV path.

The counterpart of ``benchmark_spmv_using_csr5_tpu/bench/harness.py``,
in the shape of the reference benchmark driver
(``CSR5_cuda/main.cu:17-116`` / ``call_anonymouslib``):

1. x from ``default_rng(0)``, integers 1-9 (main.cu:323-326)
2. reference SpMV -> y_ref, by scipy (the golden model, main.cu:336-355)
3. asCSR5 with conversion timing (anonymouslib_cuda.h:211-214)
4. one checked spmv + the 1%-relative validation (main.cu:361-384)
5. 50 warmup runs, then ``num_run`` timed runs (main.cu:85-101)
6. report ms / GB/s / GFLOPS (detail/utils.h:10-20) + %-of-HBM-roofline

Data goes on ``cuda`` when a card is present; the CPU runs the plain
version and reports a host time with no roofline. Nothing falls back
from the card to the CPU.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import scipy.sparse as sp
import torch

from ..config import AUTO_TUNED_SIGMA, CSR5Config, compute_sigma
from ..ops import convert
from ..ops.csr5_spmv import csr5_spmv
from ..utils import perf, progress

#: warmup runs before the timed loop (main.cu:85-92)
WARMUP = 50


@dataclasses.dataclass
class BenchResult:
    name: str
    m: int
    n: int
    nnz: int
    sigma: int
    dtype: str
    #: "cuda" (the kernel) or "torch" (the plain version, on the CPU)
    backend: str
    #: the device the run used: the card's name, or "cpu"
    device: str
    convert_ms: float
    convert_phases: dict
    spmv_ms: float
    gbps: float
    gflops: float
    nnz_per_sec: float
    #: None on the CPU: a host time has no device roofline
    pct_of_roofline: Optional[float]
    check_ok: bool
    max_rel_err: float
    #: the converted matrix, so callers timing extra variants need not
    #: convert again
    matrix: object = None
    #: value-plane storage dtype ("bfloat16" when the lossless auto gate
    #: engaged; results are then identical to float32 storage)
    storage: str = ""
    #: the checked y (length m, on the run's device)
    y: object = None

    def report(self) -> str:
        """The reference's output lines (main.cu:104-106, :361-384)."""
        ok = "PASS!" if self.check_ok else "NOT PASS!"
        ph = " ".join(f"{k}={v:.1f}" for k, v in self.convert_phases.items())
        roof = (
            "roofline not measured"
            if self.pct_of_roofline is None
            else f"{self.pct_of_roofline:.1f}% of HBM roofline"
        )
        return (
            f"[{self.name}] ({self.m}, {self.n}) nnz = {self.nnz}, sigma = {self.sigma}\n"
            f"CSR->CSR5 time = {self.convert_ms:.3f} ms ({ph})\n"
            f"CSR5-based SpMV time = {self.spmv_ms:.4f} ms, "
            f"{self.gbps:.2f} GB/s, {self.gflops:.2f} GFlops, {roof} "
            f"[{self.backend}, {self.storage}, {self.device}]\n"
            f"Check... {ok} (max rel err {self.max_rel_err:.2e})"
        )


def rel_err(y: torch.Tensor, y_ref: np.ndarray) -> float:
    """Max relative error of y against the host oracle, with differences
    below ``1e-6 * max(1, max|y_ref|)`` counted as 0 (the JAX harness's
    check, ``harness.py:84-95``). Reduced on y's device."""
    ref = torch.from_numpy(np.ascontiguousarray(y_ref)).to(y.device, y.dtype)
    floor = 1e-6 * max(1.0, float(np.abs(y_ref).max())) if y_ref.size else 1e-6
    diff = (y - ref).abs()
    rel = diff / ref.abs().clamp_min(1e-30)
    rel = torch.where(diff < floor, torch.zeros_like(rel), rel)
    return float(rel.max()) if rel.numel() else 0.0


def default_device() -> torch.device:
    """``cuda`` when a card is present, else the CPU."""
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def run_benchmark(
    name: str,
    row_ptr: np.ndarray,
    col_idx: np.ndarray,
    values: np.ndarray,
    shape,
    sigma: int = AUTO_TUNED_SIGMA,
    num_run: int = 50,
    device=None,
) -> BenchResult:
    """Benchmark CSR5 SpMV on one matrix, on ``device`` (default: the
    card when present). Values are stored as bfloat16 only when that is
    lossless (``value_dtype="auto"``)."""
    m, n = shape
    dtype = values.dtype
    if dtype != np.float32:
        raise NotImplementedError(
            f"value dtype {dtype}: the port runs float32 only "
            "(float64 is kernel K4, ROADMAP queue 1 item 7)"
        )
    device = default_device() if device is None else torch.device(device)
    x = np.random.default_rng(0).integers(1, 10, size=n).astype(dtype)
    nnz = int(row_ptr[-1])

    progress.emit("golden")
    y_ref = sp.csr_matrix((values, col_idx, row_ptr), shape=shape) @ x

    progress.emit("convert")
    t0 = time.perf_counter()
    cfg = CSR5Config(sigma=compute_sigma(m, nnz, sigma))
    a5 = convert.build_csr5(
        (row_ptr, col_idx, values, shape), cfg, value_dtype="auto", device=device
    )
    convert_ms = (time.perf_counter() - t0) * 1e3
    convert_phases = dict(convert.last_convert_phases)

    progress.emit("check")
    xd = torch.from_numpy(x).to(device)
    y = csr5_spmv(a5, xd)
    max_rel = rel_err(y, y_ref)

    progress.emit("timing")
    spmv_ms = perf.benchmark(
        csr5_spmv, a5, xd, device=device, warmup=WARMUP, num_run=num_run
    )
    progress.emit("timing:done")
    on_card = device.type == "cuda"
    dev_name = torch.cuda.get_device_name(device) if on_card else "cpu"
    met = perf.spmv_metrics(
        m,
        nnz,
        spmv_ms,
        dtype.itemsize,
        roofline_gbps=perf.device_hbm_gbps(dev_name) if on_card else None,
    )
    return BenchResult(
        name=name,
        m=m,
        n=n,
        nnz=nnz,
        sigma=a5.sigma,
        dtype=str(dtype),
        backend="cuda" if on_card else "torch",
        device=dev_name,
        storage=str(a5.val_tiles.dtype).removeprefix("torch."),
        convert_ms=convert_ms,
        convert_phases=convert_phases,
        spmv_ms=spmv_ms,
        gbps=met.gbps,
        gflops=met.gflops,
        nnz_per_sec=met.nnz_per_sec,
        pct_of_roofline=met.pct_of_roofline,
        check_ok=bool(max_rel <= 0.01),
        max_rel_err=max_rel,
        matrix=a5,
        y=y,
    )
