"""The harness driven end to end on the CPU at tiny sizes: the result line,
the modules a run loads, a cell added as files, and ``correct`` coming out
false under the control and under each fault of the timed path."""

import io
import json
import shutil
import subprocess
import sys

import pytest
import torch

from csr5_bench import harness, run
from csr5_bench.tests.conftest import CELLS, SEED, tiny

import benchmark_spmv_using_csr5_tpu_torch as port


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(run_tiny, cell, trace):
    r = run_tiny(cell, trace=trace)
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
    assert r["checks"] and all(c["value"] <= c["limit"] for c in r["checks"].values())
    spec = harness.load_cell(cell)
    if not trace:
        assert set(r["metrics"]) == {m["name"] for m in spec.end_to_end}
        assert all(m["value"] > 0 for m in r["metrics"].values())
    else:  # no CUDA kernels to read on the CPU: the readers return nothing
        assert "breakdown" in r and {"busy_s", "window_s"} <= set(r["device"])


def test_last_line_format(run_tiny):
    r = run_tiny("hpcg192.spmv")
    out, err = io.StringIO(), io.StringIO()
    run.emit(r, out, err)
    line = json.loads(out.getvalue().splitlines()[-1])
    keys = list(line)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "checks"
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for name, m in line["metrics"].items():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float)
    last = err.getvalue().splitlines()[-len(line["checks"]):]
    for text, (name, c) in zip(last, line["checks"].items()):
        assert text.startswith(f"check {name} {c['value']!r} limit {c['limit']!r}")


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, "-m", "csr5_bench.run", "--workload", "hpcg192.spmv",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=harness.ROOT, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout == ""


def test_alone_without_the_program(tmp_path):
    """In a directory holding only BENCHMARK.json and the benchmark's
    folder, a run fails and prints no result."""
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.ROOT / "csr5_bench", tmp_path / "csr5_bench")
    p = subprocess.run([sys.executable, "-m", "csr5_bench.run", "--workload", "hpcg192.spmv",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout == ""


def test_forbidden_names_compared_whole():
    assert run.loaded_forbidden(["benchmark_spmv_using_csr5_tpu_torch.ops.convert"]) == []
    assert run.loaded_forbidden(["benchmark_spmv_using_csr5_tpu.ops"]) == [
        "benchmark_spmv_using_csr5_tpu"]
    assert run.loaded_forbidden(["jax.numpy", "jaxlib", "flaxen"]) == ["jax", "jaxlib"]


def test_a_run_loads_no_jax():
    code = ("import json, sys\nfrom csr5_bench import harness, run\n"
            f"for cell, ov in {[(c, tiny(c)) for c in CELLS]!r}:\n"
            f"    harness.run_cell(cell, {SEED}, 0.1, False, device='cpu', overrides=ov)\n"
            "print(json.dumps([run.loaded_forbidden(),\n"
            "                  'benchmark_spmv_using_csr5_tpu_torch' in sys.modules]))\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    assert json.loads(p.stdout.splitlines()[-1]) == [[], True]  # the port ran, JAX did not


def test_reference_loads_nothing_of_the_program():
    code = ("import sys\nimport csr5_bench.reference, csr5_bench.yardstick\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'benchmark_spmv_using_csr5_tpu_torch', 'benchmark_spmv_using_csr5_tpu', 'jax'}))")
    p = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                       text=True, timeout=120)
    assert p.returncode == 0 and p.stdout.strip() == "[]", p.stderr[-2000:]


def test_new_traffic_found_by_name(tmp_path):
    """A traffic mix, its cell and its limits added as files (and an entry
    of BENCHMARK.json) run with no file of the harness edited."""
    shutil.copytree(harness.ROOT / "csr5_bench", tmp_path / "csr5_bench")
    spec = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "hpcg192.spmm4", "config": "hpcg192", "traffic": "spmm4",
                              "chips": 1, "why": "a test cell"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "product_ms" in (m["name"], m.get("moves")) and "workloads" in m:
            m["workloads"].append("hpcg192.spmm4")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    traffic = {"kind": "product", "rhs": 4, "pool": 3, "keep": 2, "dispatch_calls": 5,
               "trace_seconds": 0.1, "why": "a test mix"}
    (tmp_path / "csr5_bench" / "traffic" / "spmm4.json").write_text(json.dumps(traffic))
    (tmp_path / "csr5_bench" / "limits" / "hpcg192.spmm4.json").write_text(
        json.dumps({"y_err": {"limit": 1e-12}}))
    # csr5_spmm takes float32 only: run the new cell on a float32 plane
    r = harness.run_cell("hpcg192.spmm4", SEED, 0.1, False, device="cpu", root=tmp_path,
                         overrides={**tiny("hpcg192"), "precision": "float32"})
    assert "product_ms" in r["metrics"] and r["attempted"] >= 1
    assert r["checks"]["y_err"]["compared"] == 2


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(run_tiny, cell):
    r = run_tiny(cell, control=True)
    assert r["correct"] is False, r["checks"]


def _patch_products(monkeypatch, change):
    spmv, spmm = port.csr5_spmv, port.csr5_spmm
    monkeypatch.setattr(port, "csr5_spmv", lambda a, x, *k, **kw: change(spmv(a, x, *k, **kw)))
    monkeypatch.setattr(port, "csr5_spmm", lambda a, x, *k, **kw: change(spmm(a, x, *k, **kw)))


def _half(y):
    """Half of the batch left out: the second half of the rows (one
    vector) or of the columns (a block) never computed."""
    y = y.clone()
    if y.dim() == 1:
        y[y.shape[0] // 2:] = 0
    else:
        y[:, y.shape[1] // 2:] = 0
    return y


def _altered(y):
    """One answer altered where it is produced."""
    y = y.clone()
    flat = y.view(-1)
    flat[flat.numel() // 3] += 0.1 * flat.abs().max()
    return y


def _patch_solvers(monkeypatch, change):
    cg, pr = port.solvers.conjugate_gradient, port.solvers.pagerank
    def cg_changed(*a, **kw):
        x, *rest = cg(*a, **kw)
        return (change(x), *rest)

    monkeypatch.setattr(port.solvers, "conjugate_gradient", cg_changed)
    monkeypatch.setattr(port.solvers, "pagerank", lambda *a, **kw: change(pr(*a, **kw)))
    monkeypatch.setattr(port.solvers.conjugate_gradient, "cache_clear", lambda: None,
                        raising=False)
    monkeypatch.setattr(port.solvers.pagerank, "cache_clear", lambda: None, raising=False)


def _unchanged_state(monkeypatch, cell):
    """A step that returns its state unchanged: a product that leaves its
    zeroed output as it was, a solve that returns its start."""
    if cell.endswith(("spmv", "spmm16")):
        _patch_products(monkeypatch, torch.zeros_like)
        return
    cg = port.solvers.conjugate_gradient
    monkeypatch.setattr(port.solvers, "conjugate_gradient",
                        lambda spmv, b, iters=50: cg(spmv, b, iters=0))
    pr = port.solvers.pagerank
    monkeypatch.setattr(port.solvers, "pagerank", lambda *a, **kw: pr(*a, **{**kw, "iters": 0}))
    for f in ("conjugate_gradient", "pagerank"):
        monkeypatch.setattr(getattr(port.solvers, f), "cache_clear", lambda: None, raising=False)


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(run_tiny, monkeypatch, cell, fault):
    solve = cell.endswith(("cg50", "pagerank20"))
    if fault == "unchanged":
        _unchanged_state(monkeypatch, cell)
    elif fault == "half":  # the product under the solve, or the product itself
        _patch_products(monkeypatch, _half)
    elif solve:
        _patch_solvers(monkeypatch, _altered)
    else:
        _patch_products(monkeypatch, _altered)
    r = run_tiny(cell)
    assert r["correct"] is False and r["failed"] >= 1, r["checks"]
