"""The readers of the program's spans on synthetic traces: each replay
attributed by the capture record's counts, spans placed on the
profiler's clock through the anchors, and None where a replay does not
fit, the clocks cannot be fitted, the run is on the CPU, or the program
has no spans."""

import pytest

from csr5_bench import harness, replays

from benchmark_spmv_using_csr5_tpu_torch.utils import trace

#: program ns = OFFSET + 1000 * profiler µs
OFFSET = 7_300_000_123_456
K4 = "(anonymous namespace)::csr5_spmv_f64_tile_kernel<int const*, double const*>(...)"
COPY = "Memcpy DtoD (Device -> Device)"


def _ns(us):
    return OFFSET + round(us * 1000)


def _replay_ops(base):
    """One replay's device operations from ``base`` µs: an input copy, the
    graph's seven nodes (a memset, a fill, K4, an axpy, K4, a dot, a copy),
    two output clones."""
    return [
        (COPY, base + 40, base + 45),
        ("Memset (Device)", base + 50, base + 51),
        ("void at::native::vectorized_elementwise_kernel<4, FillFunctor>", base + 52, base + 55),
        (K4, base + 60, base + 160),
        ("void at::native::vectorized_elementwise_kernel<2, AddFunctor>", base + 170, base + 180),
        (K4, base + 185, base + 285),
        ("void dot_kernel<double, 128, 0>", base + 290, base + 300),
        ("memcpy128", base + 301, base + 302),  # a graph's memcpy node run as a kernel
        (COPY, base + 310, base + 320),
        (COPY, base + 321, base + 322),
    ]


@pytest.fixture
def rec(monkeypatch):
    r = trace.Recorder()
    monkeypatch.setattr(trace, "_rec", r)
    return r


def _span(r, name, start_us, end_us, parent=None, **attrs):
    s = trace.Span(name, _ns(start_us), _ns(end_us), len(r.spans) + 1, parent, 1, attrs)
    r.spans.append(s)
    return s


def _solve_trace(r, solves=3, window_s=3000e-6):
    """Three replays of one program 1000 µs apart, each with its
    ``csr5.solve`` and ``csr5.graph.launch`` spans, and two anchors. The
    record places two SpMVs among each graph's device operations: the
    fill and the first K4, then the second K4."""
    prog = r.note_capture(
        solver="conjugate_gradient", loops={"iters": 2}, inputs=1, outputs=2,
        nodes={"kernel": 5, "memcpy": 1, "memset": 1, "empty": 1},
        launches={"csr5_spmv_f64": 2}, products={"spmv": ((1, 3), (4, 5))})
    host = []
    for k, (s, e) in enumerate([(10.0, 12.0), (2500.0, 2501.5)]):
        r.anchors.append((_ns(s) - 1500 - 300 * k, _ns(e) + 700))
        host.append((trace.ANCHOR, s, e))
    ops = []
    for i in range(solves):
        base = 1000.0 * (i + 1)
        solve = _span(r, "csr5.solve", base, base + 900, solver="conjugate_gradient",
                      mode="replay", program=prog.program)
        _span(r, "csr5.graph.launch", base + 10, base + 30, parent=solve.ident,
              program=prog.program)
        host.append(("cudaGraphLaunch", base + 12, base + 28))
        ops += _replay_ops(base)
    busy_s = replays.busy_us(ops) * 1e-6
    return harness.Trace("solve", solves, 2, window_s, busy_s, ops, host, None, 1e6, 1000.0,
                         1.0, {})


def _read(name, t):
    return harness.load_module(harness.ROOT, "metrics", name).read(t)


def test_op_kinds():
    assert [replays.op_kind(n) for n in (COPY, "memcpy128", "Memset (Unknown)", "memset32", K4,
                                         "void at::native::memcpy_kernel")] == [
        "memcpy", "memcpy", "memset", "memset", "kernel", "kernel"]


def test_each_replay_attributed_by_its_record(rec):
    t = _solve_trace(rec)
    reps = replays.replays(t)
    assert len(reps) == 3
    for r in reps:
        assert len(r.copies) == 1 and len(r.nodes) == 7 and len(r.clones) == 2
    products, rest = replays.split(reps)
    assert [[op[0][:12] for op in p] for p in products[:2]] == [
        ["void at::nat", K4[:12]], [K4[:12]]]
    assert len(products) == 6 and len(rest) == 12
    # 6 SpMVs of 3 + 100 and 100 µs against 1 µs each by the byte model
    assert _read("solve.spmv_roofline", t) == pytest.approx(100 * 2 / 203)
    # 1 + 10 + 10 + 1 µs of other nodes per replay, 2 iterations each
    assert _read("solver.vector_us_per_iter", t) == pytest.approx(11.0)
    # 252 µs from first node to last, 225 covered: 27 µs idle per replay
    assert _read("solver.graph_idle_pct", t) == pytest.approx(100 * 81e-6 / 3000e-6)
    assert _read("graph.launch_us", t) == pytest.approx(20.0)


def test_device_clock_apart_from_the_host_s(rec):
    """The cut is by the records' counts, so a device clock some µs off
    the host's (seen on the card in a process's later profiler sessions)
    moves no operation to another replay."""
    t = _solve_trace(rec)
    t.device_ops = [(n, s - 45.0, e - 45.0) for n, s, e in t.device_ops]
    assert len(replays.replays(t)) == 3
    assert _read("solve.spmv_roofline", t) == pytest.approx(100 * 2 / 203)


def test_first_replay_cut_short_is_left_out(rec):
    """Where the profiler's device trace starts inside the first replay,
    that replay is left out and the others are read."""
    t = _solve_trace(rec)
    del t.device_ops[:4]  # the first replay's copy and three nodes
    reps = replays.replays(t)
    assert len(reps) == 2 and reps[0].copies[0][1] == 2040
    assert _read("solver.vector_us_per_iter", t) == pytest.approx(11.0)
    del t.device_ops[:5]  # all of its nodes: what is left is no replay's tail
    t.device_ops.insert(0, ("void stray_kernel", 900.0, 901.0))
    assert replays.replays(t) is None


def test_spans_aligned_through_the_anchors(rec):
    """The anchors' brackets place the spans: the program's clock runs
    ``OFFSET`` ns ahead, and each graph launch span encloses its one
    ``cudaGraphLaunch``."""
    t = _solve_trace(rec)
    a, b, bracket, spread = trace.clock_fit(t.host_ops)
    assert b == 1000.0 and abs(a - OFFSET) <= 1000 * spread / 2 + 1
    assert bracket == pytest.approx(4.0)  # the second anchor: a 1.5 µs range, 2.5 µs around it
    launches = replays.spans(t, "csr5.graph.launch")
    hosts = [h for h in t.host_ops if h[0] == "cudaGraphLaunch"]
    for s in launches:
        assert sum(1 for _, h0, h1 in hosts if s.start <= h0 and h1 <= s.end) == 1


@pytest.mark.parametrize("fault", ["missing_node", "extra_op", "node_type", "clone_not_copy",
                                   "no_record", "no_nodes", "unknown_node"])
def test_a_replay_that_does_not_fit_gives_none(rec, fault):
    t = _solve_trace(rec)
    ops = t.device_ops
    if fault == "missing_node":
        del ops[13]  # a node of the second replay
    elif fault == "extra_op":
        ops.append(("void stray_kernel", 1500.0, 1501.0))
    elif fault == "node_type":
        ops[1] = ("void at::native::fill_kernel", ops[1][1], ops[1][2])  # the memset
    elif fault == "clone_not_copy":
        ops[9] = ("void at::native::copy_kernel", ops[9][1], ops[9][2])
    elif fault == "no_record":
        rec.captures.clear()
    else:
        (prog,) = rec.captures.values()
        nodes = None if fault == "no_nodes" else {**prog.nodes, "graph": 1}
        rec.captures[prog.program] = trace.Capture(**{**vars(prog), "nodes": nodes})
    assert replays.replays(t) is None
    for name in ("solve.spmv_roofline", "solver.vector_us_per_iter", "solver.graph_idle_pct"):
        assert _read(name, t) is None


def test_no_anchor_or_no_program_gives_none(rec, monkeypatch):
    t = _solve_trace(rec)
    t.host_ops = [h for h in t.host_ops if h[0] != trace.ANCHOR]
    assert replays.replays(t) is None and _read("graph.launch_us", t) is None
    t = _solve_trace(rec)
    monkeypatch.setattr(replays, "port_trace", lambda: None)  # a program with no spans
    for name in ("solve.spmv_roofline", "solver.vector_us_per_iter", "solver.graph_idle_pct",
                 "graph.launch_us"):
        assert _read(name, t) is None


@pytest.mark.parametrize("products", [None, {}, {"spmv_lo": ((2, 3),), "spmv_hi": ((4, 5),)}])
def test_products_not_placed_give_none(rec, products):
    """Replays that fit their records, but whose records do not place the
    calls of exactly one operator, give no SpMV roofline and no vector
    work; the idle inside the graphs and the launch spans still read."""
    t = _solve_trace(rec)
    (prog,) = rec.captures.values()
    rec.captures[prog.program] = trace.Capture(**{**vars(prog), "products": products})
    assert len(replays.replays(t)) == 3 and replays.split(replays.replays(t)) is None
    assert _read("solve.spmv_roofline", t) is None and _read("solver.vector_us_per_iter", t) is None
    assert _read("solver.graph_idle_pct", t) == pytest.approx(2.7)
    assert _read("graph.launch_us", t) == pytest.approx(20.0)


def test_on_the_cpu_every_reader_gives_none(run_tiny):
    """A traced CPU run has no device operations: no metric of the
    program's spans reports."""
    for cell in ("hpcg192.cg50", "hpcg192.spmv"):
        r = run_tiny(cell, trace=True)
        assert r["correct"] and not {"solve.spmv_roofline", "solver.vector_us_per_iter",
                                     "solver.graph_idle_pct", "graph.launch_us"} & set(r["metrics"])
