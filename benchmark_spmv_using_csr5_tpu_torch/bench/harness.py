"""End-to-end benchmark harness: CSR5 SpMV/SpMM, DIA SpMV/SpMM, HYB5 SpMV
and band-block SpMM.

The counterpart of ``benchmark_spmv_using_csr5_tpu/bench/harness.py``,
in the shape of the reference benchmark driver
(``CSR5_cuda/main.cu:17-116`` / ``call_anonymouslib``):

1. x from ``default_rng(0)``, integers 1-9 (main.cu:323-326); for SpMM
   X is (n, R)
2. reference SpMV -> y_ref, by scipy (the golden model, main.cu:336-355)
3. asCSR5 (or the DIA / HYB5 / band-block build) with conversion timing
   (anonymouslib_cuda.h:211-214)
4. one checked spmv + the 1%-relative validation (main.cu:361-384)
5. 50 warmup runs, then ``num_run`` timed runs (main.cu:85-101)
6. report ms / GB/s / GFLOPS (detail/utils.h:10-20) + %-of-HBM-roofline,
   and the launches of each kernel during the run

Every format is reported under the same getB bytes model, as the JAX
package reports them. Data goes on ``cuda`` when a card is present; the
CPU runs the plain versions and reports a host time with no roofline.
Nothing falls back from the card to the CPU.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import scipy.sparse as sp
import torch

from ..config import AUTO_TUNED_SIGMA, CSR5Config, compute_sigma
from ..ops import bandmm, bandmm_kernel, convert, csr5_kernel, dia_kernel
from ..ops.csr5_spmv import csr5_spmm, csr5_spmv
from ..ops.dia import build_dia, dia_spmm, dia_spmm_supported, dia_spmv, dia_supported
from ..ops.hyb import build_hyb, hyb_spmv
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
    #: the checked y (length m, or (m, R) for SpMM, on the run's device)
    y: object = None
    #: the format that ran: "csr5", "dia", "hyb" or "bandblock"
    format: str = "csr5"
    #: right-hand sides (1: SpMV)
    num_rhs: int = 1
    #: kernel launches during this run (check and timed loop), by kernel
    launches: dict = dataclasses.field(default_factory=dict)
    #: the format's own line ("sigma = 24", "ndiag = 28", the HYB split)
    detail: str = ""
    #: what the CLI decided before the run (auto format, reordering)
    plan: str = ""

    def report(self) -> str:
        """The reference's output lines (main.cu:104-106, :361-384)."""
        ok = "PASS!" if self.check_ok else "NOT PASS!"
        ph = " ".join(f"{k}={v:.1f}" for k, v in self.convert_phases.items())
        ph = f" ({ph})" if ph else ""
        roof = (
            "roofline not measured"
            if self.pct_of_roofline is None
            else f"{self.pct_of_roofline:.1f}% of HBM roofline"
        )
        fmt = {"csr5": "CSR5", "dia": "DIA", "hyb": "HYB5", "bandblock": "bandblock"}[
            self.format
        ]
        # the band-block path is SpMM at any R, as the JAX CLI reports it
        spmm = self.num_rhs > 1 or self.format == "bandblock"
        op = f"SpMM({self.num_rhs})" if spmm else "SpMV"
        runs = " ".join(f"{k}={v}" for k, v in self.launches.items() if v)
        return (
            (f"[{self.name}] {self.plan}\n" if self.plan else "")
            + f"[{self.name}] ({self.m}, {self.n}) nnz = {self.nnz}, "
            f"{self.detail or f'sigma = {self.sigma}'}\n"
            f"CSR->{fmt} time = {self.convert_ms:.3f} ms{ph}\n"
            f"{fmt}-based {op} time = {self.spmv_ms:.4f} ms, "
            f"{self.gbps:.2f} GB/s, {self.gflops:.2f} GFlops, {roof} "
            f"[{self.backend}, {self.storage}, {self.device}]\n"
            f"Check... {ok} (max rel err {self.max_rel_err:.2e})"
            + (f"\nkernel launches: {runs}" if runs else "")
        )


def kernel_launches() -> dict:
    """The launch counters of the port's kernels, by kernel name."""
    return {
        "csr5_spmv": csr5_kernel.launches,
        "csr5_spmm": csr5_kernel.spmm_launches,
        "dia_spmv": dia_kernel.spmv_launches,
        "dia_spmm": dia_kernel.spmm_launches,
        "bandmm_spmm": bandmm_kernel.launches,
    }


def _since(before: dict) -> dict:
    return {k: v - before[k] for k, v in kernel_launches().items()}


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


def _float32_only(values: np.ndarray) -> None:
    if values.dtype != np.float32:
        raise NotImplementedError(
            f"value dtype {values.dtype}: the port runs float32 only "
            "(float64 is kernel K4, ROADMAP queue 1 item 7)"
        )


def _measure(
    name, fmt, shape, values, x, y_ref, build, fn, num_run, device, num_rhs=1
) -> BenchResult:
    """Build the matrix, check one product against ``y_ref`` and time
    ``fn`` (50 warmup calls, then ``num_run`` between CUDA events).
    ``build()`` returns ``(matrix, sigma, storage, detail, phases)``."""
    m, n = shape
    nnz = int(values.shape[0])
    before = kernel_launches()
    progress.emit("convert")
    t0 = time.perf_counter()
    mat, sigma, storage, detail, phases = build()
    convert_ms = (time.perf_counter() - t0) * 1e3

    progress.emit("check")
    xd = torch.from_numpy(x).to(device)
    y = fn(mat, xd)
    max_rel = rel_err(y, y_ref)

    progress.emit("timing")
    spmv_ms = perf.benchmark(fn, mat, xd, device=device, warmup=WARMUP, num_run=num_run)
    progress.emit("timing:done")
    on_card = device.type == "cuda"
    dev_name = torch.cuda.get_device_name(device) if on_card else "cpu"
    met = perf.spmv_metrics(
        m,
        nnz,
        spmv_ms,
        values.dtype.itemsize,
        roofline_gbps=perf.device_hbm_gbps(dev_name) if on_card else None,
        num_rhs=num_rhs,
        n=n,
    )
    return BenchResult(
        name=name,
        m=m,
        n=n,
        nnz=nnz,
        sigma=sigma,
        dtype=str(values.dtype),
        backend="cuda" if on_card else "torch",
        device=dev_name,
        storage=storage,
        convert_ms=convert_ms,
        convert_phases=phases,
        spmv_ms=spmv_ms,
        gbps=met.gbps,
        gflops=met.gflops,
        nnz_per_sec=met.nnz_per_sec,
        pct_of_roofline=met.pct_of_roofline,
        check_ok=bool(max_rel <= 0.01),
        max_rel_err=max_rel,
        matrix=mat,
        y=y,
        format=fmt,
        num_rhs=num_rhs,
        launches=_since(before),
        detail=detail,
    )


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def run_benchmark(
    name: str,
    row_ptr: np.ndarray,
    col_idx: np.ndarray,
    values: np.ndarray,
    shape,
    sigma: int = AUTO_TUNED_SIGMA,
    num_run: int = 50,
    device=None,
    num_rhs: int = 1,
) -> BenchResult:
    """Benchmark CSR5 SpMV (K1) or, with ``num_rhs > 1``, SpMM (K2) on one
    matrix, on ``device`` (default: the card when present). X is (n, R)
    integers 1-9 from ``default_rng(0)`` for SpMM (``harness.py:169-172``).
    Values are stored as bfloat16 only when that is lossless
    (``value_dtype="auto"``)."""
    _float32_only(values)
    m, n = shape
    device = default_device() if device is None else torch.device(device)
    R = num_rhs
    x = np.random.default_rng(0).integers(1, 10, size=(n, R) if R > 1 else n)
    x = x.astype(values.dtype)
    progress.emit("golden")
    y_ref = sp.csr_matrix((values, col_idx, row_ptr), shape=shape) @ x

    def build():
        cfg = CSR5Config(sigma=compute_sigma(m, int(row_ptr[-1]), sigma))
        a5 = convert.build_csr5(
            (row_ptr, col_idx, values, shape), cfg, value_dtype="auto", device=device
        )
        phases = dict(convert.last_convert_phases)
        return a5, a5.sigma, _dtype_name(a5.val_tiles), "", phases

    fn = csr5_spmm if R > 1 else csr5_spmv
    return _measure(name, "csr5", shape, values, x, y_ref, build, fn, num_run, device, max(R, 1))


def run_dia(
    name: str,
    row_ptr: np.ndarray,
    col_idx: np.ndarray,
    values: np.ndarray,
    shape,
    num_rhs: int = 1,
    num_run: int = 50,
    device=None,
) -> BenchResult:
    """Benchmark DIA SpMV (K5) or, with ``num_rhs > 1``, SpMM (K6) on one
    matrix: the JAX CLI's ``_run_dia`` (``cli.py:257-314``). x holds
    integers 1-9 from ``default_rng(0)``, shaped (n, R) for SpMM; the plane
    is float32, as the JAX path builds it."""
    _float32_only(values)
    device = default_device() if device is None else torch.device(device)
    R = num_rhs
    x = np.random.default_rng(0).integers(1, 10, (shape[1], R) if R > 1 else shape[1])
    x = x.astype(values.dtype)
    progress.emit("golden")
    y_ref = sp.csr_matrix((values, col_idx, row_ptr), shape=shape) @ x

    def build():
        d = build_dia((row_ptr, col_idx, values, shape), device=device)
        if d is None:
            raise SystemExit("matrix is not diagonal-structured; use --format csr5")
        if not (dia_spmm_supported(d, R) if R > 1 else dia_supported(d)):
            raise SystemExit(
                "matrix exceeds the DIA kernels' limits (float32/bfloat16 values, "
                "at most MAX_DIAGS diagonals); use --format csr5"
            )
        return d, 0, _dtype_name(d.data), f"ndiag = {d.ndiag}", {}

    fn = dia_spmm if R > 1 else dia_spmv
    return _measure(name, "dia", shape, values, x, y_ref, build, fn, num_run, device, R)


def run_hyb(
    name: str,
    row_ptr: np.ndarray,
    col_idx: np.ndarray,
    values: np.ndarray,
    shape,
    num_run: int = 50,
    device=None,
) -> BenchResult:
    """Benchmark HYB5 SpMV (K5 on the dense diagonals plus K1 on the
    remainder) on one matrix: the JAX CLI's ``_run_hyb``
    (``cli.py:218-254``)."""
    _float32_only(values)
    device = default_device() if device is None else torch.device(device)
    x = np.random.default_rng(0).integers(1, 10, shape[1]).astype(values.dtype)
    progress.emit("golden")
    y_ref = sp.csr_matrix((values, col_idx, row_ptr), shape=shape) @ x

    def build():
        h = build_hyb((row_ptr, col_idx, values, shape), device=device)
        nd = h.dia.ndiag if h.dia is not None else 0
        cn = h.csr5.nnz_stored if h.csr5 is not None else 0
        sigma = h.csr5.sigma if h.csr5 is not None else 0
        # build_hyb stores both parts in float32, as the JAX package does
        return h, sigma, "float32", f"hyb split: {nd} diagonals + {cn} csr5 nnz", {}

    return _measure(name, "hyb", shape, values, x, y_ref, build, hyb_spmv, num_run, device)


def run_bandblock(
    name: str,
    row_ptr: np.ndarray,
    col_idx: np.ndarray,
    values: np.ndarray,
    shape,
    num_rhs: int = 1,
    num_run: int = 50,
    device=None,
) -> BenchResult:
    """Benchmark band-block SpMM (K7) on one matrix: the JAX CLI's
    ``_run_bandblock`` (``cli.py:171-215``). X is (n, R) integers 1-9
    from ``default_rng(0)``; the plane's dtype follows the lossless
    bfloat16 gate and ``precision="auto"`` follows the plane."""
    _float32_only(values)
    device = default_device() if device is None else torch.device(device)
    R = max(num_rhs, 1)
    x = np.random.default_rng(0).integers(1, 10, (shape[1], R)).astype(values.dtype)
    progress.emit("golden")
    y_ref = sp.csr_matrix((values, col_idx, row_ptr), shape=shape) @ x

    def build():
        bb = bandmm.build_bandblock((row_ptr, col_idx, values, shape), device=device)
        if bb is None:
            raise SystemExit(
                "matrix's 128-row blocks have no bounded column windows "
                "(or the dense plane would exceed the waste gate); use "
                "--format csr5"
            )
        if not bandmm.bandmm_supported(bb, R):
            raise SystemExit(f"--spmm {R} is not taken by the band-block kernel for K={bb.K}")
        detail = f"K = {bb.K}, dense = {bb.dense_bytes / 1e6:.0f} MB"
        return bb, 0, _dtype_name(bb.dense), detail, dict(bandmm.last_build_phases)

    return _measure(
        name, "bandblock", shape, values, x, y_ref, build, bandmm.bandmm_spmm, num_run, device, R
    )
