"""One run of one cell: make the matrix, convert it, warm up, run the closed
loop, check the outputs against the plain reference, and build the
result line.

Everything a cell is made of is found by name under the benchmark's
root (the checkout): the cell in ``BENCHMARK.json``; its configuration
in the file that entry names, whose ``generator`` names
``csr5_bench/generators/<generator>.py``; its traffic in
``csr5_bench/traffic/<traffic>.json``, whose ``solver`` (a solve mix)
names ``csr5_bench/solves/<solver>.py``; the limits of its comparisons in
``csr5_bench/limits/<cell>.json``; and each per-layer metric's reader in
``csr5_bench/metrics/<metric>.py``. The program is called only through
its public entries: ``build_csr5``, ``csr5_spmv``, ``csr5_spmm`` and
``solvers``.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import random
import subprocess
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import reference, yardstick

ROOT = Path(__file__).resolve().parent.parent
PKG = "csr5_bench"

#: the program's value plane by the configuration's precision; the
#: control runs the nearest precision below it through the program's own
#: path (a float32 plane and float32 vectors on K1 for float64; a
#: bfloat16 plane for float32)
PLANES = {"float64": torch.float64, "float32": torch.float32}
CONTROL_PLANES = {"float64": torch.float32, "float32": torch.bfloat16}
#: rows of the small conversion that loads the conversion's libraries
WARM_ROWS = 4096


def load_spec(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def load_module(root: Path, folder: str, name: str):
    """``<root>/csr5_bench/<folder>/<name>.py`` as a module."""
    path = Path(root) / PKG / folder / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"{PKG}_{folder}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_solve(root: Path, solver: str):
    """The solve a ``kind: solve`` traffic names: ``csr5_bench/solves/<solver>.py``,
    which defines ``planes``, ``inputs``, ``program`` and ``check`` (README)."""
    if not (Path(root) / PKG / "solves" / f"{solver}.py").is_file():
        raise SystemExit(f"no solve {solver!r}: {PKG}/solves/{solver}.py is missing")
    return load_module(root, "solves", solver)


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def _covers(metric: dict, cell: str, e2e_names=()) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return not e2e_names or metric["moves"] in e2e_names


def load_cell(workload: str, root: Path = ROOT, overrides: Optional[dict] = None) -> Cell:
    """The cell ``workload`` of ``BENCHMARK.json`` with its files read;
    ``overrides`` replaces keys of the configuration (tests only)."""
    root = Path(root)
    spec = load_spec(root)
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[workload]
    entry = next(c for c in spec["configs"] if c["name"] == w["config"])
    config = json.loads((root / entry["file"]).read_text())
    config.update(overrides or {})
    traffic = json.loads((root / PKG / "traffic" / f"{w['traffic']}.json").read_text())
    limits = json.loads((root / PKG / "limits" / f"{workload}.json").read_text())
    e2e = [m for m in spec["end_to_end"] if _covers(m, workload)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"] if _covers(m, workload, names)]
    return Cell(workload, config, traffic, limits, e2e, per_layer)


class Reservoir:
    """A uniform sample of at most ``k`` of the items offered, drawn by
    ``rng``; it holds references only, so the outputs it drops are freed."""

    def __init__(self, k: int, rng: random.Random):
        self.k, self.rng, self.seen, self.items = k, rng, 0, []

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = self.rng.randrange(self.seen)
            if j < self.k:
                self.items[j] = item


@dataclasses.dataclass
class Trace:
    """What a metric reader reads from the traced window."""

    kind: str  #: "solve" or "product"
    calls: int  #: solves or products in the traced window
    iters: int  #: iterations per solve (1 for a product)
    window_s: float  #: the window by CUDA events
    busy_s: float  #: the union of device activity in it
    device_ops: List[Tuple[str, float, float]]  #: (name, start us, end us)
    host_ops: List[Tuple[str, float, float]]
    dispatch_s: Optional[float]  #: host seconds per call to enqueue, or None
    bytes_per_call: float  #: the configuration's byte model for one product
    peak_gbps: float
    convert_ms: float  #: the host clock around ``build_csr5`` of every plane of the real matrix
    convert_phases: Dict[str, float]  #: the program's phase record of them, summed (ms)
    #: one product's byte model at each converted plane's value width, by plane
    plane_bytes: Dict[str, float] = dataclasses.field(default_factory=dict)


def _union_s(intervals: List[Tuple[str, float, float]]) -> Tuple[float, List[Tuple[float, float]]]:
    """Seconds covered by the intervals (us) and the gaps between them."""
    busy, gaps = 0.0, []
    spans = sorted((s, e) for _, s, e in intervals)
    if not spans:
        return 0.0, gaps
    lo, hi = spans[0]
    for s, e in spans[1:]:
        if s > hi:
            busy += hi - lo
            gaps.append((hi, s))
            lo, hi = s, e
        else:
            hi = max(hi, e)
    busy += hi - lo
    return busy * 1e-6, gaps


def _breakdown(t: Trace, gaps: List[Tuple[float, float]]) -> dict:
    """The device operations that took most time, and the idle gaps by
    the host operation that overlapped each most, ten of each."""
    by_op: Dict[str, float] = {}
    for name, s, e in t.device_ops:
        by_op[name[:120]] = by_op.get(name[:120], 0.0) + (e - s) * 1e-6
    by_host: Dict[str, float] = {}
    hosts = sorted(t.host_ops, key=lambda h: h[1])
    starts = [h[1] for h in hosts]
    for g0, g1 in gaps:
        best, best_ov = "no host operation", 0.0
        i = np.searchsorted(starts, g1)
        for name, s, e in hosts[max(0, i - 2000):i]:
            ov = min(e, g1) - max(s, g0)
            if ov > best_ov:
                best, best_ov = name, ov
        by_host[best[:120]] = by_host.get(best[:120], 0.0) + (g1 - g0) * 1e-6
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]  # noqa: E731
    return {"device_ops": top(by_op), "idle_gaps": top(by_host)}


def _profiled(loop: Callable[[], int], cuda: bool, sync: Callable[[], None]):
    """Run ``loop`` (which returns its count of calls) under the profiler:
    (calls, window seconds, device ops, host ops). The device ops leave out
    the card's copies of the host's annotations: c10d marks each exchange
    with a range (``nccl:coalesced``) that the trace repeats on the card
    over the exchange's kernel, and a sum of device time would count that
    kernel twice."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    sync()
    with profile(activities=acts) as prof:
        if cuda:
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
        h0 = time.perf_counter()
        calls = loop()
        if cuda:
            e1.record()
        sync()
        window_s = e0.elapsed_time(e1) * 1e-3 if cuda else time.perf_counter() - h0
    dev_ops, host_ops = [], []
    for e in prof.events():
        s, f = e.time_range.start, e.time_range.end
        if f <= s:
            continue
        if e.device_type != DeviceType.CUDA:
            host_ops.append((e.name, s, f))
        elif not (getattr(e, "is_user_annotation", False)
                  or getattr(e, "activity_type", None) == "gpu_user_annotation"):
            dev_ops.append((e.name, s, f))
    return calls, window_s, dev_ops, host_ops


class _Solves:
    """The traffic ``kind: solve``: repeated calls of the solve module's
    program, whose operators are kept across them, so every solve after
    the second replays."""

    kind = "solve"

    def __init__(self, solve, port, traffic: dict, mats: dict, inputs: dict, n: int, device,
                 rng: random.Random):
        self.fn, self.call, self.iters = solve.program(port, traffic, mats, inputs, n, device)
        self.solve, self.traffic, self.inputs = solve, traffic, inputs
        self.kept = Reservoir(int(traffic["keep"]), rng)

    def warm(self, sync) -> None:
        for _ in range(2):  # the eager first call, then the capture
            self.call()
            sync()

    def loop(self, seconds: float, sync, latencies: Optional[list] = None) -> int:
        t0 = time.perf_counter()
        calls = 0
        while True:
            t = time.perf_counter()
            out = self.call()
            sync()
            t1 = time.perf_counter()
            calls += 1
            self.kept.offer(out)
            if latencies is not None:
                latencies.append(t1 - t)
            if t1 - t0 >= seconds:
                return calls

    def close(self) -> None:
        self.call = None  # and with it the operators and their matrices
        self.fn.cache_clear()

    def check(self, ref: reference.CSR) -> Tuple[str, List[float]]:
        return self.solve.check(ref, self.traffic, self.inputs, self.kept.items)


class _Products:
    """The traffic ``kind: product``: back-to-back products over a pool of
    inputs, with no wait on the host inside the window but at its end."""

    kind = "product"
    iters = 1
    check_name = "y_err"

    def __init__(self, port, traffic: dict, a5, pool: list, rng: random.Random):
        if int(traffic["rhs"]) == 1:
            self.product = lambda x: port.csr5_spmv(a5, x)
        else:
            self.product = lambda x: port.csr5_spmm(a5, x)
        self.traffic, self.pool = traffic, pool
        self.kept = Reservoir(int(traffic["keep"]), rng)

    def warm(self, sync) -> None:
        held = [self.product(self.pool[i % len(self.pool)])
                for i in range(len(self.pool) + self.kept.k)]
        sync()
        del held

    def loop(self, seconds: float, sync, latencies=None) -> int:
        pool, p = self.pool, len(self.pool)
        t0 = time.perf_counter()
        calls = 0
        while True:
            j = calls % p
            self.kept.offer((j, self.product(pool[j])))
            calls += 1
            if time.perf_counter() - t0 >= seconds:
                break
        sync()
        return calls

    def dispatch_s(self, sync) -> float:
        """Host seconds per call of an enqueue loop, before the wait."""
        calls = int(self.traffic["dispatch_calls"])
        sync()
        t0 = time.perf_counter()
        for i in range(calls):
            self.product(self.pool[i % len(self.pool)])
        t1 = time.perf_counter()
        sync()
        return (t1 - t0) / calls

    def close(self) -> None:
        self.product = None

    def check(self, ref: reference.CSR) -> Tuple[str, List[float]]:
        errs = []
        for j in sorted({j for j, _ in self.kept.items}):
            want = ref.matmul(self.pool[j])
            errs += [yardstick.relative_error(y, want, float("inf"))
                     for i, y in self.kept.items if i == j]
            del want
        return self.check_name, errs


def _inputs(traffic: dict, csr: dict, seed: int, device, dtype) -> dict:
    """A product traffic's inputs from the seed: a pool of x vectors (rhs
    1) or X blocks (rhs > 1), uniform in [-1, 1). A solve's come from its
    module."""
    m, n = csr["shape"]
    gen = torch.Generator(device=device).manual_seed((seed + 1) % 2**63)
    rhs = int(traffic["rhs"])
    shape = (n,) if rhs == 1 else (n, rhs)
    pool = [torch.rand(shape, generator=gen, dtype=dtype, device=device) * 2 - 1
            for _ in range(int(traffic["pool"]))]
    return {"pool": pool}


def _card() -> dict:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout
        return {"nvidia_smi": out.strip().splitlines()[0]}
    except (OSError, subprocess.SubprocessError, IndexError):
        return {"nvidia_smi": "not read"}


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *, device="cuda",
             root: Path = ROOT, overrides: Optional[dict] = None, control: bool = False,
             t_start: Optional[float] = None) -> dict:
    """One run of ``workload``; returns the result object. ``control``
    runs the program one precision below the configuration's."""
    import benchmark_spmv_using_csr5_tpu_torch as port

    t_start = time.perf_counter() if t_start is None else t_start
    cell = load_cell(workload, root, overrides)
    cfg, traffic = cell.config, cell.traffic
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)
    solve = load_solve(root, traffic["solver"]) if traffic["kind"] == "solve" else None
    # the value planes of the one matrix, by name; the vectors take the first's precision
    planes = (solve.planes(cfg, control) if solve else
              {"a": (CONTROL_PLANES if control else PLANES)[cfg["precision"]]})
    plane = next(iter(planes.values()))
    vec = torch.float64 if plane == torch.float64 else torch.float32
    rng = random.Random(seed)

    phases = {"start_s": time.perf_counter() - t_start}
    # 1. the matrix and the traffic's inputs, from the seed
    csr = load_module(root, "generators", cfg["generator"]).generate(cfg, seed, dev)
    m, n = csr["shape"]
    nnz = int(csr["col"].shape[0])
    sync()
    phases["generate_s"] = time.perf_counter() - t_start
    inputs = (solve.inputs(cfg, traffic, csr, seed, dev, vec) if solve else
              _inputs(traffic, csr, seed, dev, vec))
    host = tuple(csr[k].cpu().numpy() for k in ("row_ptr", "col", "val")) + ((m, n),)
    del csr
    if cuda:
        torch.cuda.empty_cache()

    phases["to_host_s"] = time.perf_counter() - t_start
    # 2. a small conversion of each plane type, untimed, loads the conversion's libraries
    k = min(m, WARM_ROWS)
    e = int(host[0][k])
    for dtype in dict.fromkeys(planes.values()):
        port.build_csr5((host[0][: k + 1], host[1][:e], host[2][:e], (k, n)), value_dtype=dtype,
                        device=dev)
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)

    # 3. the conversion of the configuration's matrix to each plane, timed together
    mats, convert_phases = {}, {}
    t0 = time.perf_counter()
    for name, dtype in planes.items():
        mats[name] = port.build_csr5(host, value_dtype=dtype, device=dev)
        for key, ms in port.ops.convert.last_convert_phases.items():
            convert_phases[key] = convert_phases.get(key, 0) + ms
    sync()
    convert_ms = (time.perf_counter() - t0) * 1e3

    phases["convert_s"] = time.perf_counter() - t_start

    # 4. the cell's own shapes, warmed
    if solve:
        runner = _Solves(solve, port, traffic, mats, inputs, n, dev, rng)
    else:
        runner = _Products(port, traffic, mats["a"], inputs["pool"], rng)
    runner.warm(sync)
    setup_s = time.perf_counter() - t_start

    # 5. the window
    phases["setup_s"] = setup_s
    latencies: List[float] = []
    gc.collect()
    gc.disable()
    try:
        if trace:
            dispatch = runner.dispatch_s(sync) if runner.kind == "product" else None
            span = min(seconds, float(traffic["trace_seconds"]))
            calls, window_s, dev_ops, host_ops = _profiled(
                lambda: runner.loop(span, sync), cuda, sync)
        else:
            t0 = time.perf_counter()
            calls = runner.loop(seconds, sync, latencies)
            window_s = time.perf_counter() - t0
    finally:
        gc.enable()
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    phases["window_end_s"] = time.perf_counter() - t_start

    # 6. the check, once the program's state is freed
    runner.close()
    del mats
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ref = reference.CSR(host[0], host[1], host[2], (m, n), dev)
    check_name, errs = runner.check(ref)
    del ref
    phases["check_s"] = time.perf_counter() - t_start
    limit = float(cell.limits[check_name]["limit"])
    failed = sum(1 for x in errs if not x <= limit)
    worst = max(errs) if errs else float("inf")
    correct = bool(errs) and failed == 0

    # 7. the result
    metrics = {}
    dev_info = {"platform": "gpu" if cuda else dev.type,
                "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": calls, "failed": failed}
    if trace:
        busy_s, gaps = _union_s(dev_ops)
        model = yardstick.BYTE_MODELS[cfg["byte_model"]]
        value_bytes = 8 if cfg["precision"] == "float64" else 4
        rhs = int(traffic.get("rhs", 1))
        t = Trace(runner.kind, calls, runner.iters, window_s, busy_s, dev_ops, host_ops, dispatch,
                  model(m, n, nnz, rhs, value_bytes),
                  yardstick.hbm_gbps(dev_info["kind"]) if cuda else float("nan"),
                  convert_ms, convert_phases,
                  {name: model(m, n, nnz, rhs, dtype.itemsize) for name, dtype in planes.items()})
        for metric in cell.per_layer:
            value = load_module(root, "metrics", metric["name"]).read(t)
            if value is not None:
                metrics[metric["name"]] = {"value": value, "unit": metric["unit"]}
        dev_info.update(busy_s=busy_s, window_s=window_s)
        result.update(metrics=metrics, device=dev_info, breakdown=_breakdown(t, gaps))
    else:
        measured = {"setup_s": setup_s}
        if runner.kind == "solve":
            measured["solve_ms"] = window_s * 1e3 / calls
            measured["solve_p95_ms"] = float(np.percentile(latencies, 95)) * 1e3
        else:
            measured["product_ms"] = window_s * 1e3 / calls
        for metric in cell.end_to_end:
            if metric["name"] in measured:
                metrics[metric["name"]] = {"value": measured[metric["name"]], "unit": metric["unit"]}
        result.update(metrics=metrics, device=dev_info)
    if cuda:
        result["device"].update(_card())
    result["shape"] = {"rows": m, "cols": n, "nnz": nnz,
                       "plane": ", ".join(str(dtype) for dtype in planes.values())}
    result["phases"] = phases
    result["checks"] = {check_name: {"value": worst, "limit": limit, "compared": len(errs)}}
    return result
