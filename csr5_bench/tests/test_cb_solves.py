"""The solve contract: a ``kind: solve`` traffic names a module under
``csr5_bench/solves/`` that gives the solve's planes, inputs, program and
check. The shipped solves against a direct run of the reference, a
two-plane solve added as files alone, and an unknown solver."""

import json
import shutil

import pytest
import torch

from csr5_bench import harness, reference, yardstick
from csr5_bench.tests.conftest import SEED, tiny
from csr5_bench.tests.test_cb_harness import _altered, _half, _patch_products

import benchmark_spmv_using_csr5_tpu_torch as port

ROOT = harness.ROOT
SOLVE_TRAFFIC = sorted(p.stem for p in (ROOT / "csr5_bench" / "traffic").glob("*.json")
                       if json.loads(p.read_text())["kind"] == "solve")


@pytest.mark.parametrize("traffic", SOLVE_TRAFFIC)
def test_every_solve_traffic_has_its_module(traffic):
    solver = json.loads((ROOT / "csr5_bench" / "traffic" / f"{traffic}.json").read_text())["solver"]
    mod = harness.load_solve(ROOT, solver)
    assert all(callable(getattr(mod, f, None)) for f in ("planes", "inputs", "program", "check"))


def _by_hand(cell: str):
    """The cell's check on the seed without the harness or the solve
    modules: the matrix from the generator, the port's solver on its one
    plane, the reference's iterate, their gap."""
    c = harness.load_cell(cell, overrides=tiny(cell))
    cfg, traffic = c.config, c.traffic
    csr = harness.load_module(ROOT, "generators", cfg["generator"]).generate(cfg, SEED, "cpu")
    m, n = csr["shape"]
    host = tuple(csr[k].numpy() for k in ("row_ptr", "col", "val")) + ((m, n),)
    ref = reference.CSR(*host, "cpu")
    plane = harness.PLANES[cfg["precision"]]
    a5 = port.build_csr5(host, value_dtype=plane, device="cpu")
    spmv = lambda v: port.csr5_spmv(a5, v)  # noqa: E731
    iters = int(traffic["iters"])
    if traffic["solver"] == "cg":
        b = ref.matmul(torch.ones(n, dtype=torch.float64))
        vec = torch.float64 if plane == torch.float64 else torch.float32
        x = port.solvers.conjugate_gradient(spmv, b.to(vec), iters=iters)[0]
        return "x_err", yardstick.relative_error(x, reference.conjugate_gradient(ref, b, iters), 2)
    d = float(traffic["damping"])
    r = port.solvers.pagerank(spmv, n, damping=d, iters=iters, device="cpu")
    return "r_err", yardstick.relative_error(r, reference.pagerank(ref, d, iters), 1)


@pytest.mark.parametrize("cell", ["hpcg192.cg50", "kron23.pagerank20"])
def test_shipped_solves_found_and_equal_to_a_direct_run(run_tiny, monkeypatch, cell):
    loaded = []
    load = harness.load_module

    def recording(root, folder, name):
        loaded.append((folder, name))
        return load(root, folder, name)

    monkeypatch.setattr(harness, "load_module", recording)
    r = run_tiny(cell)
    solver = harness.load_cell(cell).traffic["solver"]
    assert ("solves", solver) in loaded
    name, err = _by_hand(cell)
    assert list(r["checks"]) == [name] and r["correct"]
    assert r["checks"][name]["value"] == err


def _copy_root(tmp_path):
    shutil.copytree(ROOT / "csr5_bench", tmp_path / "csr5_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    return tmp_path


def test_unknown_solver_names_the_folder(tmp_path):
    root = _copy_root(tmp_path)
    path = root / "csr5_bench" / "traffic" / "cg50.json"
    path.write_text(json.dumps({**json.loads(path.read_text()), "solver": "no_such_solve"}))
    with pytest.raises(SystemExit, match=r"csr5_bench/solves/no_such_solve\.py"):
        harness.run_cell("hpcg192.cg50", SEED, 0.1, False, device="cpu", root=root,
                         overrides=tiny("hpcg192"))


#: a two-plane solve written as a file: CG in float32 on K1's plane inside
#: float64 refinement, whose residual runs on the float64 plane
IR_SOLVE = '''
import torch

from csr5_bench import harness, reference, yardstick


def planes(cfg, control):
    table = harness.CONTROL_PLANES if control else harness.PLANES
    return {"hi": table[cfg["precision"]], "lo": table["float32"]}


def inputs(cfg, traffic, csr, seed, device, vec):
    m, n = csr["shape"]
    a = reference.CSR(csr["row_ptr"], csr["col"], csr["val"], (m, n), device)
    b = a.matmul(torch.ones(n, dtype=torch.float64, device=device))
    return {"b": b, "b_vec": b.to(vec)}


def program(port, traffic, mats, inputs, n, device):
    hi, lo, b = mats["hi"], mats["lo"], inputs["b_vec"]
    outer, inner = int(traffic["outer_iters"]), int(traffic["inner_iters"])
    spmv_hi = lambda v: port.csr5_spmv(hi, v)
    spmv_lo = lambda v: port.csr5_spmv(lo, v)
    fn = port.solvers.iterative_refinement
    call = lambda: fn(spmv_lo, spmv_hi, b, outer_iters=outer, inner_iters=inner)[0]
    return fn, call, outer * inner


def check(ref, traffic, inputs, kept):
    b = inputs["b"]
    return "res_err", [yardstick.relative_error(ref.matmul(x), b, 2) for x in kept]
'''
IR_CELL = "hpcg192.ir_test"


@pytest.fixture
def ir_root(tmp_path):
    """A copy of the root with the two-plane solve, its traffic, its cell
    and its limit added as files and entries."""
    root = _copy_root(tmp_path)
    bench = root / "csr5_bench"
    (bench / "solves" / "ir_test.py").write_text(IR_SOLVE)
    (bench / "traffic" / "ir_test.json").write_text(json.dumps(
        {"kind": "solve", "solver": "ir_test", "outer_iters": 4, "inner_iters": 20, "keep": 2,
         "trace_seconds": 0.1, "why": "a test mix"}))
    (bench / "limits" / f"{IR_CELL}.json").write_text(json.dumps({"res_err": {"limit": 1e-12}}))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": IR_CELL, "config": "hpcg192", "traffic": "ir_test",
                              "chips": 1, "why": "a test cell"})
    for m in spec["end_to_end"] + spec["per_layer"]:  # what CG's cell reports
        if "hpcg192.cg50" in m.get("workloads", ()):
            m["workloads"].append(IR_CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


def _run_ir(root, monkeypatch, trace=False, control=False):
    """The IR cell at a tiny size; also the value types of every
    conversion and, traced, the ``Trace`` the readers got."""
    built, traces = [], []
    build, trace_cls = port.build_csr5, harness.Trace

    def recording_build(*a, value_dtype, **kw):
        built.append(value_dtype)
        return build(*a, value_dtype=value_dtype, **kw)

    def recording_trace(*fields):
        traces.append(trace_cls(*fields))
        return traces[-1]

    monkeypatch.setattr(port, "build_csr5", recording_build)
    monkeypatch.setattr(harness, "Trace", recording_trace)
    r = harness.run_cell(IR_CELL, SEED, 0.2, trace, device="cpu", root=root,
                         overrides=tiny("hpcg192"), control=control)
    return r, built, traces


def test_two_plane_solve_from_files_is_correct(ir_root, monkeypatch):
    r, built, _ = _run_ir(ir_root, monkeypatch)
    f64, f32 = torch.float64, torch.float32
    assert built == [f64, f32, f64, f32]  # warmed, then timed, in the solve's order
    assert r["shape"]["plane"] == "torch.float64, torch.float32"
    assert r["correct"] is True and r["attempted"] >= 1, r["checks"]
    assert set(r["metrics"]) == {"setup_s", "solve_ms", "solve_p95_ms"}


def test_two_plane_solve_trace_has_each_planes_bytes(ir_root, monkeypatch):
    r, _, traces = _run_ir(ir_root, monkeypatch, trace=True)
    (t,) = traces
    rows = r["shape"]["rows"]
    model = yardstick.BYTE_MODELS["symmetric_stencil"]
    nnz = r["shape"]["nnz"]
    assert t.plane_bytes == {"hi": model(rows, rows, nnz, 1, 8), "lo": model(rows, rows, nnz, 1, 4)}
    assert t.bytes_per_call == t.plane_bytes["hi"] and t.iters == 4 * 20
    assert r["correct"] is True


def test_two_plane_control_is_not_correct(ir_root, monkeypatch):
    r, built, _ = _run_ir(ir_root, monkeypatch, control=True)
    assert built == [torch.float32, torch.bfloat16] * 2  # each plane one step down
    assert r["correct"] is False, r["checks"]


def _patch_ir(monkeypatch, **change):
    """The refinement patched: its loop counts replaced, or its x changed."""
    ir = port.solvers.iterative_refinement
    out = change.pop("out", None)

    def patched(*a, **kw):
        x, res = ir(*a, **{**kw, **change})
        return (out(x) if out else x), res

    monkeypatch.setattr(port.solvers, "iterative_refinement", patched)
    monkeypatch.setattr(patched, "cache_clear", lambda: None, raising=False)


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_two_plane_fault_is_not_correct(ir_root, monkeypatch, fault):
    if fault == "unchanged":  # the solve returns its start, x0 = 0
        _patch_ir(monkeypatch, outer_iters=0)
    elif fault == "half":  # half of every product's rows left out, on both planes
        _patch_products(monkeypatch, _half)
    else:
        _patch_ir(monkeypatch, out=_altered)
    r, _, _ = _run_ir(ir_root, monkeypatch)
    assert r["correct"] is False and r["failed"] >= 1, r["checks"]
