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
6. report ms / GB/s / GFLOPS (detail/utils.h:10-20), the share of the
   card's HBM bandwidth of the bytes the kernel streams (the roofline
   share) and of getB (the reference's model, which can exceed 100 %),
   and the launches of each kernel during the run

CSR5 SpMV on a matrix beyond the JAX package's VMEM cap (``should_slice``)
runs on the row-sliced form through K3, as the JAX harness takes its
``pallas-sliced`` route (``harness.py:215-234``); ``backend`` forces either
route. Every format is reported under the same getB bytes model, as the JAX
package reports them, and beside it under the bytes its own kernel streams
(``perf.streamed_bytes``). Float64 values run CSR5 SpMV on kernel K4 with a
float64 plane; every other format, and SpMM, has no float64 kernel and
exits saying so. Data goes on the card unless the caller passes
``device="cpu"``, where the plain versions run and report a host time
with no roofline. Without a card the default raises: nothing falls back
from the card to the CPU.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import scipy.sparse as sp
import torch

from ..config import AUTO_TUNED_SIGMA, DEFAULT_DEVICE, CSR5Config, compute_sigma, resolve_device
from ..ops import bandmm, bigslice, convert
from ..ops.csr5_spmv import csr5_spmm, csr5_spmv
from ..ops.dia import build_dia, dia_spmm, dia_spmm_supported, dia_spmv, dia_supported
from ..ops.hyb import build_hyb, hyb_spmv
from ..utils import graphs, perf, progress

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
    #: "cuda" (the kernels) or "torch" (the plain versions, on the CPU);
    #: "cuda-sliced" / "torch-sliced" on the row-sliced form
    backend: str
    #: the device the run used: the card's name, or "cpu"
    device: str
    convert_ms: float
    convert_phases: dict
    spmv_ms: float
    #: getB bytes over the time (the reference's GB/s)
    getb_gbps: float
    gflops: float
    nnz_per_sec: float
    #: getB GB/s over the card's HBM bandwidth; None on the CPU, where a
    #: host time has no device roofline
    pct_getb_of_hbm: Optional[float]
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
    #: bytes one product streams (``perf.streamed_bytes``)
    streamed_bytes: int = 0
    #: streamed bytes over the time, over the card's HBM bandwidth: the
    #: roofline share; None on the CPU
    pct_hbm_streamed: Optional[float] = None

    def report(self) -> str:
        """The reference's output lines (main.cu:104-106, :361-384)."""
        ok = "PASS!" if self.check_ok else "NOT PASS!"
        ph = " ".join(f"{k}={v:.1f}" for k, v in self.convert_phases.items())
        ph = f" ({ph})" if ph else ""
        roof = (
            "roofline not measured"
            if self.pct_hbm_streamed is None
            else f"{self.pct_hbm_streamed:.1f}% of HBM roofline ({self.streamed_bytes / 1e6:.1f} MB "
            f"streamed; getB {self.pct_getb_of_hbm:.1f}% of HBM)"
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
            f"{self.getb_gbps:.2f} GB/s, {self.gflops:.2f} GFlops, {roof} "
            f"[{self.backend}, {self.storage}, {self.device}]\n"
            f"Check... {ok} (max rel err {self.max_rel_err:.2e})"
            + (f"\nkernel launches: {runs}" if runs else "")
        )


def kernel_launches() -> dict:
    """The launch counters of the port's kernels, by kernel name."""
    return graphs.read_launches()


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


def _check_values(values: np.ndarray, fmt: str, num_rhs: int = 1) -> None:
    """float32 values run everywhere; float64 only CSR5 SpMV (K4). Every
    other float64 case exits naming the format, as the JAX DIA path does
    (``cli.py:283-287``): nothing is narrowed quietly."""
    if values.dtype == np.float32:
        return
    if values.dtype != np.float64:
        raise ValueError(f"value dtype {values.dtype}: the port runs float32 and float64")
    spmm = num_rhs > 1 or fmt == "bandblock"
    if fmt != "csr5" or spmm:
        raise SystemExit(
            f"--dtype float64: --format {fmt}{f' --spmm {num_rhs}' if spmm else ''} has no "
            "float64 kernel (float64 runs CSR5 SpMV on K4); use --format csr5 --spmm 1 "
            "or --dtype float32"
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
        streamed=perf.streamed_bytes(mat, xd, num_rhs),
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
        getb_gbps=met.getb_gbps,
        gflops=met.gflops,
        nnz_per_sec=met.nnz_per_sec,
        pct_getb_of_hbm=met.pct_getb_of_hbm,
        streamed_bytes=met.streamed_bytes,
        pct_hbm_streamed=met.pct_hbm_streamed,
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
    device=DEFAULT_DEVICE,
    num_rhs: int = 1,
    autotune: bool = False,
    backend: str = "auto",
) -> BenchResult:
    """Benchmark CSR5 SpMV (K1 or K1p, or K4 on float64 values) or, with
    ``num_rhs > 1``, SpMM (K2 or K2p) on one matrix, on ``device``
    (default: the card). x holds integers 1-9 from ``default_rng(0)`` in
    the values' dtype; X is (n, R) for SpMM (``harness.py:169-172``).
    float32 values are stored as bfloat16 only when that is lossless
    (``value_dtype="auto"``); float64 values keep a float64 plane.
    ``autotune`` converts with :func:`..ops.convert.build_csr5_autotuned`
    unless ``sigma`` is given.

    ``backend`` picks the route of float32 SpMV, as the JAX harness's
    ``pallas-sliced`` does: ``"auto"`` builds the row-sliced form directly
    (never the whole form first) and runs K3 when ``should_slice(m, n)``;
    ``"cuda"`` runs one whole-matrix K1 pass whatever the size;
    ``"cuda-sliced"`` slices whatever the size. A matrix that cannot be
    sliced takes the whole form. On ``device="cpu"`` the same routes run
    the plain versions. Float64 and SpMM never slice."""
    _check_values(values, "csr5", num_rhs)
    if backend not in ("auto", "cuda", "cuda-sliced"):
        raise ValueError(f"unknown backend {backend!r} (auto|cuda|cuda-sliced)")
    m, n = shape
    device = resolve_device(device, "run_benchmark")
    R = num_rhs
    slice_ok = R == 1 and values.dtype == np.float32
    if backend == "cuda-sliced" and not slice_ok:
        raise ValueError(
            "backend='cuda-sliced': the row-sliced form runs float32 SpMV only "
            f"(values {values.dtype}, num_rhs {R})"
        )
    sliced = slice_ok and (
        backend == "cuda-sliced" or (backend == "auto" and bigslice.should_slice(m, n))
    )
    x = np.random.default_rng(0).integers(1, 10, size=(n, R) if R > 1 else n)
    x = x.astype(values.dtype)
    progress.emit("golden")
    y_ref = sp.csr_matrix((values, col_idx, row_ptr), shape=shape) @ x

    vdt = torch.float64 if values.dtype == np.float64 else "auto"

    def build():
        cfg = CSR5Config(sigma=compute_sigma(m, int(row_ptr[-1]), sigma))
        host = (row_ptr, col_idx, values, shape)
        sl = (
            bigslice.build_csr5_sliced(host, cfg, value_dtype=vdt, device=device)
            if sliced
            else None
        )
        if sl is not None:
            phases = dict(convert.last_convert_phases)  # summed over the slices
            detail = f"sigma = {sl.sigma}, {sl.num_slices} row slices"
            return sl, sl.sigma, _dtype_name(sl.slices[0].val_tiles), detail, phases
        if autotune and sigma == AUTO_TUNED_SIGMA:
            a5 = convert.build_csr5_autotuned(host, cfg, value_dtype=vdt, device=device)
        else:
            a5 = convert.build_csr5(host, cfg, value_dtype=vdt, device=device)
        phases = dict(convert.last_convert_phases)
        return a5, a5.sigma, _dtype_name(a5.val_tiles), "", phases

    fn = csr5_spmm if R > 1 else _csr5_spmv_any
    res = _measure(name, "csr5", shape, values, x, y_ref, build, fn, num_run, device, max(R, 1))
    if isinstance(res.matrix, bigslice.SlicedCSR5):
        res.backend += "-sliced"
    return res


def _csr5_spmv_any(mat, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x on a whole-matrix CSR5 (K1, K1p or K4) or a row-sliced one
    (K3)."""
    if isinstance(mat, bigslice.SlicedCSR5):
        return bigslice.sliced_spmv(mat, x)
    return csr5_spmv(mat, x)


def run_dia(
    name: str,
    row_ptr: np.ndarray,
    col_idx: np.ndarray,
    values: np.ndarray,
    shape,
    num_rhs: int = 1,
    num_run: int = 50,
    device=DEFAULT_DEVICE,
) -> BenchResult:
    """Benchmark DIA SpMV (K5) or, with ``num_rhs > 1``, SpMM (K6) on one
    matrix: the JAX CLI's ``_run_dia`` (``cli.py:257-314``). x holds
    integers 1-9 from ``default_rng(0)``, shaped (n, R) for SpMM; the plane
    is float32, as the JAX path builds it."""
    _check_values(values, "dia", num_rhs)
    device = resolve_device(device, "run_dia")
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
    device=DEFAULT_DEVICE,
) -> BenchResult:
    """Benchmark HYB5 SpMV (K5 on the dense diagonals plus K1 on the
    remainder) on one matrix: the JAX CLI's ``_run_hyb``
    (``cli.py:218-254``)."""
    _check_values(values, "hyb")
    device = resolve_device(device, "run_hyb")
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
    device=DEFAULT_DEVICE,
) -> BenchResult:
    """Benchmark band-block SpMM (K7) on one matrix: the JAX CLI's
    ``_run_bandblock`` (``cli.py:171-215``). X is (n, R) integers 1-9
    from ``default_rng(0)``; the plane's dtype follows the lossless
    bfloat16 gate and ``precision="auto"`` follows the plane."""
    _check_values(values, "bandblock", num_rhs)
    device = resolve_device(device, "run_bandblock")
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
