"""The ``hpcg192.ir`` cell at a tiny size on the CPU: the shipped solve is
correct, and not correct under the control or any fault of the timed path;
its readers cut a synthetic two-operator trace by operator and give None
on a one-operator one or on a record without the per-operator launches."""

import json

import pytest
import torch

from csr5_bench import harness, refine_replays, replays, yardstick
from csr5_bench.reference import refinement
from csr5_bench.tests.conftest import SEED, tiny
from csr5_bench.tests.test_cb_harness import _altered, _half, _patch_products
from csr5_bench.tests.test_cb_solves import _patch_ir
from csr5_bench.tests.test_cb_spans import K4, _solve_trace

from benchmark_spmv_using_csr5_tpu_torch.utils import trace

CELL = "hpcg192.ir"
READERS = ("refine.lo_roofline", "refine.hi_roofline", "refine.vector_us_per_iter")


def _run(control=False, trace_on=False):
    return harness.run_cell(CELL, SEED, 0.2, trace_on, device="cpu", overrides=tiny(CELL),
                            control=control)


def test_the_cell_runs_its_own_solve_on_two_planes():
    c = harness.load_cell(CELL)
    assert c.traffic["solver"] == "ir" and c.config["name"] == "hpcg192mxp"
    solve = harness.load_solve(harness.ROOT, "ir")
    f64, f32 = torch.float64, torch.float32
    assert solve.planes(c.config, False) == {"hi": f64, "lo": f32}
    assert solve.planes(c.config, True) == {"hi": f32, "lo": torch.bfloat16}
    # the inner plane is the configuration's, not fixed by the solve
    assert solve.planes({**c.config, "inner_precision": "float64"}, False) == {"hi": f64,
                                                                                "lo": f64}
    assert {m["name"] for m in c.per_layer} >= set(READERS)


def test_the_configuration_is_hpcgs_system_under_its_own_source():
    """``hpcg192mxp`` is ``hpcg192``'s matrix at the same size (the same
    generator, grid, rows and nonzeros), deployed another way: its own
    source, and a float32 inner plane beside the float64 one."""
    entries = {c["name"]: c for c in harness.load_spec()["configs"]}
    mxp, base = (json.loads((harness.ROOT / entries[n]["file"]).read_text())
                 for n in ("hpcg192mxp", "hpcg192"))
    assert entries["hpcg192mxp"]["source"] != entries["hpcg192"]["source"]
    assert entries["hpcg192mxp"]["reduced"] == mxp["reduced"] == base["reduced"]
    for key in ("generator", "nx", "ny", "nz", "rows", "nnz", "precision", "byte_model"):
        assert mxp[key] == base[key], key
    assert mxp["inner_precision"] == "float32"


@pytest.mark.parametrize("trace_on", [False, True])
def test_shipped_ir_is_correct(trace_on):
    r = _run(trace_on=trace_on)
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1, r["checks"]
    assert r["shape"]["plane"] == "torch.float64, torch.float32"
    assert r["checks"]["res_err"]["value"] <= 1e-12
    if not trace_on:
        # no p95: about 38 solves a 25 s window leave two beyond it
        assert set(r["metrics"]) == {"setup_s", "solve_ms"}
    else:  # no CUDA kernels to read on the CPU: the readers return nothing
        assert not set(READERS) & set(r["metrics"])


def test_the_check_is_the_residual_of_the_reference_refinement():
    """The check's ``res_err`` of the port's x is at the float64 level, as
    the plain reference's own refinement with the same counts is."""
    c = harness.load_cell(CELL, overrides=tiny(CELL))
    csr = harness.load_module(harness.ROOT, "generators", "stencil27").generate(c.config, SEED,
                                                                               "cpu")
    m, n = csr["shape"]
    solve = harness.load_solve(harness.ROOT, "ir")
    inputs = solve.inputs(c.config, c.traffic, csr, SEED, "cpu", torch.float64)
    ref = harness.reference.CSR(csr["row_ptr"], csr["col"], csr["val"], (m, n), "cpu")
    outer, inner = c.traffic["outer_iters"], c.traffic["inner_iters"]
    x_ref = refinement.iterative_refinement(ref, inputs["b"], outer, inner)
    name, (err,) = solve.check(ref, c.traffic, inputs, [x_ref])
    assert name == "res_err" and err == yardstick.relative_error(ref.matmul(x_ref), inputs["b"])
    assert err <= 1e-12


def test_control_is_not_correct():
    r = _run(control=True)
    assert r["shape"]["plane"] == "torch.float32, torch.bfloat16"
    assert r["correct"] is False, r["checks"]


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_fault_is_not_correct(monkeypatch, fault):
    if fault == "unchanged":  # the solve returns its start, x0 = 0
        _patch_ir(monkeypatch, outer_iters=0)
    elif fault == "half":  # half of every product's rows left out, on both planes
        _patch_products(monkeypatch, _half)
    else:
        _patch_ir(monkeypatch, out=_altered)
    r = _run()
    assert r["correct"] is False and r["failed"] >= 1, r["checks"]


@pytest.fixture
def rec(monkeypatch):
    r = trace.Recorder()
    monkeypatch.setattr(trace, "_rec", r)
    return r


def _read(name, t):
    return harness.load_module(harness.ROOT, "metrics", name).read(t)


#: the synthetic replay's two calls (``test_cb_spans._replay_ops``): the
#: fill and the first K4, then the second K4
TWO = {"spmv_lo": ((1, 3),), "spmv_hi": ((4, 5),)}
LAUNCHED = {"spmv_lo": {"csr5_spmv": 1}, "spmv_hi": {"csr5_spmv_f64": 1}}


def _two_operator_trace(rec, products=TWO, launched=LAUNCHED):
    t = _solve_trace(rec)
    (prog,) = rec.captures.values()
    rec.captures[prog.program] = trace.Capture(
        **{**vars(prog), "products": products, "operator_launches": launched})
    # 1 µs a product at 1000 GB/s on the float64 plane, half that on the float32 one
    t.plane_bytes = {"hi": 1e6, "lo": 5e5}
    return t


def test_two_operators_cut_by_the_kernel_each_launched(rec):
    t = _two_operator_trace(rec)
    c = refine_replays.cut(t)
    assert c.replays == 3 and len(c.products["lo"]) == 3 and len(c.products["hi"]) == 3
    assert [name for name, _, _ in c.products["hi"][0]] == [K4]
    assert len(c.products["lo"][0]) == 2 and c.products["lo"][0][1][0] == K4
    # lo: the fill and a K4, 3 + 100 µs a product for 0.5 µs by its bytes
    assert _read("refine.lo_roofline", t) == pytest.approx(100 * 0.5 / 103)
    # hi: a K4, 100 µs a product for 1 µs
    assert _read("refine.hi_roofline", t) == pytest.approx(100 * 1 / 100)
    # 1 + 10 + 10 + 1 µs of other nodes per replay, 2 iterations each
    assert _read("refine.vector_us_per_iter", t) == pytest.approx(11.0)


def test_names_do_not_decide_the_planes(rec):
    """Operators named the other way round are cut by what they launched."""
    swapped = {"spmv_hi": TWO["spmv_lo"], "spmv_lo": TWO["spmv_hi"]}
    t = _two_operator_trace(rec, swapped, {"spmv_hi": {"csr5_spmv": 1},
                                           "spmv_lo": {"csr5_spmv_f64": 1}})
    assert _read("refine.lo_roofline", t) == pytest.approx(100 * 0.5 / 103)
    assert _read("refine.hi_roofline", t) == pytest.approx(100 * 1 / 100)


@pytest.mark.parametrize("case", ["one_operator", "no_counter", "both_k1", "mixed", "no_spans"])
def test_one_operator_or_no_counter_gives_none(rec, monkeypatch, case):
    if case == "one_operator":  # hpcg192.cg50's record: one SpMV operator on K4
        t = _two_operator_trace(rec, {"spmv": ((1, 3), (4, 5))}, {"spmv": {"csr5_spmv_f64": 2}})
    elif case == "no_counter":  # a program older than the counter
        t = _two_operator_trace(rec, TWO, None)
    elif case == "both_k1":
        t = _two_operator_trace(rec, TWO, {"spmv_lo": {"csr5_spmv": 1},
                                           "spmv_hi": {"csr5_spmv": 1}})
    elif case == "mixed":  # one operator launched both kernels
        t = _two_operator_trace(rec, TWO, {"spmv_lo": {"csr5_spmv": 1, "csr5_spmv_f64": 1},
                                           "spmv_hi": {"csr5_spmv_f64": 1}})
    else:  # a program with no spans
        t = _two_operator_trace(rec)
        monkeypatch.setattr(replays, "port_trace", lambda: None)
    assert refine_replays.cut(t) is None
    for name in READERS:
        assert _read(name, t) is None
