"""The exchange layer's readers of the program's spans on synthetic traces:
``dist.launch_us`` from the ``csr5.dist.product`` spans in replay mode,
and ``dist.exchange_us`` from each product's replay, cut from the end of
the window by the capture record's counts (the host runs ahead of the
card, so a replay lies after its own span, not inside it) and split at
the record's ``exchange``. Both give None where the trace does not fit,
the run is on the CPU, or the program records no distributed programs."""

import pytest

from csr5_bench import dist_replays, harness

from benchmark_spmv_using_csr5_tpu_torch.utils import trace

#: program ns = OFFSET + 1000 * profiler µs
OFFSET = 5_100_000_654_321
K4 = "(anonymous namespace)::csr5_spmv_f64_tile_kernel<int const*, double const*>(...)"
NCCL = "ncclDevKernel_SendRecv(ncclDevKernelArgsStorage<4096ul>)"
COPY = "Memcpy DtoD (Device -> Device)"
FILL = "void at::native::vectorized_elementwise_kernel<4, FillFunctor>"


def _ns(us):
    return OFFSET + round(us * 1000)


def _replay_ops(base):
    """One product's device operations from ``base`` µs: x's copy into the
    kept buffer, then the graph's three nodes (the exchange's NCCL kernel,
    y's fill, K4); the caller takes y as it is, with no clone."""
    return [
        (COPY, base, base + 35),
        (NCCL, base + 36, base + 53),
        (FILL, base + 54, base + 60),
        (K4, base + 61, base + 921),
    ]


@pytest.fixture
def rec(monkeypatch):
    r = trace.Recorder()
    monkeypatch.setattr(trace, "_rec", r)
    return r


def _span(r, start_us, end_us, **attrs):
    s = trace.Span(dist_replays.SPAN, _ns(start_us), _ns(end_us), len(r.spans) + 1, None,
                   len(r.spans) + 1, attrs)
    r.spans.append(s)
    return s


def _product_trace(r, products=4, window_s=4000e-6):
    """Back-to-back replays of one program, 1000 µs apart on the card,
    their spans 30 µs long and 100 µs apart on the host (which runs
    ahead), and two anchors. The record's nodes are those read on an H100
    under torch 2.11 and NCCL 2.28: NCCL's event recorded and waited on,
    which run nothing the profiler shows, and three kernels."""
    prog = r.note_capture(
        solver="distributed_spmv_local", loops={}, inputs=1, outputs=0,
        nodes={"wait_event": 1, "kernel": 3, "event_record": 1}, launches={"csr5_spmv_f64": 1},
        products={"spmv": ((1, 3),)}, exchange=(0, 1), nccl_kernels=1)
    host = []
    for k, (s, e) in enumerate([(5.0, 7.0), (2400.0, 2401.5)]):
        r.anchors.append((_ns(s) - 1500 - 300 * k, _ns(e) + 700))
        host.append((trace.ANCHOR, s, e))
    ops = []
    for i in range(products):
        start = 10.0 + 100.0 * i
        _span(r, start, start + 30.0, rank=1, halo=(36864, 36864), bytes=589824, mode="replay",
              program=prog.program)
        host.append(("cudaGraphLaunch", start + 10, start + 20))
        ops += _replay_ops(1000.0 * (i + 1))
    busy_s = sum(e - s for _, s, e in ops) * 1e-6
    return harness.Trace("product", products, 1, window_s, busy_s, ops, host, 50e-6, 9e8, 3350.0,
                         1.0, {})


def _read(name, t):
    return harness.load_module(harness.ROOT, "metrics", name).read(t)


def test_each_product_attributed_by_its_record(rec):
    t = _product_trace(rec)
    reps = dist_replays.product_replays(t)
    assert len(reps) == 4
    for r in reps:
        assert len(r.copies) == 1 and len(r.nodes) == 3 and not r.clones
    assert [[op[0] for op in ops] for ops in dist_replays.exchange_ops(reps)] == [[NCCL]] * 4
    assert _read("dist.exchange_us", t) == pytest.approx(17.0)
    assert _read("dist.launch_us", t) == pytest.approx(30.0)


def test_exchange_from_its_first_operation_to_its_last(rec):
    """An exchange of two operations reads from the first's start to the
    second's end, the gap between them included."""
    t = _product_trace(rec)
    (prog,) = rec.captures.values()
    rec.captures[prog.program] = trace.Capture(**{**vars(prog), "exchange": (0, 2)})
    assert _read("dist.exchange_us", t) == pytest.approx(24.0)


def test_only_replays_are_launches(rec):
    """``dist.launch_us`` reads the replay spans alone; ``dist.exchange_us``
    reads nothing once a product of the window was not a replay."""
    t = _product_trace(rec)
    rec.spans[0].attrs.update(mode="eager", program=None)
    rec.spans[0].end = rec.spans[0].start + 400_000
    assert _read("dist.launch_us", t) == pytest.approx(30.0)
    assert dist_replays.product_replays(t) is None and _read("dist.exchange_us", t) is None


def test_first_replay_cut_short_is_left_out(rec):
    t = _product_trace(rec)
    del t.device_ops[:2]  # the first replay's copy and its exchange
    reps = dist_replays.product_replays(t)
    assert len(reps) == 3 and reps[0].copies[0][1] == 2000.0
    assert _read("dist.exchange_us", t) == pytest.approx(17.0)


@pytest.mark.parametrize("fault", ["missing_node", "extra_op", "node_type", "before_its_span",
                                   "no_record", "no_exchange", "unknown_node"])
def test_a_window_that_does_not_fit_gives_none(rec, fault):
    t = _product_trace(rec)
    ops = t.device_ops
    (prog,) = rec.captures.values()
    if fault == "missing_node":
        del ops[6]  # a node of the second replay
    elif fault == "extra_op":
        ops.append(("void stray_kernel", 2500.0, 2501.0))
    elif fault == "node_type":
        ops[2] = ("Memset (Device)", ops[2][1], ops[2][2])  # y's fill
    elif fault == "before_its_span":  # the last replay before the product ahead of it
        t.device_ops = [(n, s - 3800.0, e - 3800.0) for n, s, e in ops]
    elif fault == "no_record":
        rec.captures.clear()
    else:
        fields = {"exchange": None} if fault == "no_exchange" else {
            "nodes": {**prog.nodes, "host": 1}}
        rec.captures[prog.program] = trace.Capture(**{**vars(prog), **fields})
    assert _read("dist.exchange_us", t) is None
    if fault == "no_exchange":
        assert len(dist_replays.product_replays(t)) == 4


def test_no_anchor_no_program_or_a_solve_gives_none(rec, monkeypatch):
    t = _product_trace(rec)
    t.host_ops = [h for h in t.host_ops if h[0] != trace.ANCHOR]
    assert _read("dist.launch_us", t) is None and _read("dist.exchange_us", t) is None
    t = _product_trace(rec)
    t.kind = "solve"
    assert _read("dist.launch_us", t) is None and _read("dist.exchange_us", t) is None
    t = _product_trace(rec)
    monkeypatch.setattr(dist_replays.replays, "port_trace", lambda: None)  # no spans in it
    assert _read("dist.launch_us", t) is None and _read("dist.exchange_us", t) is None


def test_without_device_operations_the_readers_give_none(rec):
    """A traced CPU run has no device operations: neither reader reports."""
    t = _product_trace(rec)
    t.device_ops = []
    assert _read("dist.launch_us", t) is None and _read("dist.exchange_us", t) is None
