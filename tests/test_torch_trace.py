"""The port's spans and capture records (``utils/trace.py``) on the CPU.

Recording follows torch's profiler: off, nothing is recorded; under a CPU
``torch.profiler`` the spans carry their parents and request ids, the
buffer is bounded, and the only events the module adds to the profiler's
are its anchors, host events that tie the two clocks together. A capture
record is kept for every captured program, recording or not, and
outlives the solver's cache. The CUDA graph itself needs a card
(``chip_smoke.py`` phase 11); here a stand-in card and a stand-in graph
take its place, as in ``tests/test_torch_solvers.py``.
"""

import collections
import contextlib
import time
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import benchmark_spmv_using_csr5_tpu_torch as P
from benchmark_spmv_using_csr5_tpu_torch.models import solvers
from benchmark_spmv_using_csr5_tpu_torch.utils import graphs, synth, trace


def _fresh(monkeypatch, **kw) -> trace.Recorder:
    rec = trace.Recorder(**kw)
    monkeypatch.setattr(trace, "_rec", rec)
    return rec


def _host(prof):
    return [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()]


def _work(pause=0.0):
    with trace.span("outer", step=1) as attrs:
        attrs["more"] = 2
        with trace.span("inner"):
            torch.ones(8).cumsum(0)
            time.sleep(pause)
        with trace.span("inner"):
            time.sleep(pause)
            torch.ones(8).cumsum(0)
    with trace.span("outer", step=2):
        time.sleep(pause)
        torch.ones(8).cumsum(0)
        time.sleep(pause)


def _toy(monkeypatch):
    """``scale(f, b, iters) = f(b) * iters`` decorated, on a stand-in card
    whose capture builds a program with a stand-in graph and its record."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(graphs, "_device_of", lambda arguments: torch.device("cuda", 0))

    def capture(body, arguments, loops, dev):
        inp = {"b": arguments["b"].clone()}
        out = torch.zeros_like(inp["b"])
        graph = types.SimpleNamespace(replay=lambda: out.copy_(2 * inp["b"] * arguments["iters"]))
        return graphs._program(body.__name__, {k: arguments[k] for k in loops}, graph, inp, out,
                               {"kernel": 5, "memset": 1}, {"csr5_spmv": 2}, {"f": [(1, 3)]})

    monkeypatch.setattr(graphs, "_capture", capture)

    @graphs.device_program(loops=("iters",))
    def scale(f, b, iters=2):
        return f(b) * iters

    return scale


def test_nothing_recorded_while_off(monkeypatch):
    """With no profiler running, a span yields nothing and records
    nothing, a solve and an SpMV open none, and no anchor is made."""
    rec = _fresh(monkeypatch)
    assert not trace.recording()
    with trace.span("csr5.solve", solver="x") as attrs:
        assert attrs is None
    a = synth.banded(50, 3, dtype=np.float64, seed=1).tocsr()
    a5 = P.build_csr5((a.indptr, a.indices, a.data, a.shape), value_dtype=torch.float64,
                      device="cpu")
    solvers.conjugate_gradient(lambda v: P.csr5_spmv(a5, v), torch.ones(50, dtype=torch.float64),
                               iters=3)
    assert trace.spans() == [] and trace.dropped() == 0 and len(rec.anchors) == 0


def test_spans_under_the_profiler_carry_parents_and_requests(monkeypatch):
    """Under a CPU profiler each span holds its parent and the request id
    of its root, and the attributes given and added; a solver call on the
    CPU is an eager ``csr5.solve`` that parents the spans its body opens."""
    _fresh(monkeypatch)
    with profile(activities=[ProfilerActivity.CPU]):
        _work()

        def f(v):
            with trace.span("inside"):
                return 2 * v

        solvers.pagerank(f, 6, iters=2, device="cpu")
    got = sorted(trace.spans(), key=lambda s: s.start)
    assert [s.name for s in got] == ["outer", "inner", "inner", "outer", "csr5.solve",
                                     "inside", "inside"]
    o1, i1, i2, o2, solve, f1, f2 = got
    assert o1.parent is None and i1.parent == o1.ident and i2.parent == o1.ident
    assert o1.attrs == {"step": 1, "more": 2} and o2.attrs == {"step": 2}
    assert o1.request == i1.request == i2.request != o2.request
    assert solve.attrs == {"solver": "pagerank", "mode": "eager", "program": None}
    assert f1.parent == f2.parent == solve.ident and f1.request == solve.request
    assert all(s.start <= s.end for s in got)
    assert i1.start >= o1.start and i2.end <= o1.end


def test_buffer_is_bounded_oldest_first(monkeypatch):
    """A full buffer drops its oldest spans first and counts them."""
    _fresh(monkeypatch, max_spans=3)
    with profile(activities=[ProfilerActivity.CPU]):
        for k in range(5):
            with trace.span("s", k=k):
                pass
    assert [s.attrs["k"] for s in trace.spans()] == [2, 3, 4] and trace.dropped() == 2


def test_the_anchor_is_the_only_event_added(monkeypatch):
    """The same work profiled with its spans and without: the profiler's
    events differ by the anchors alone, each a CPU event."""
    from torch.autograd import DeviceType

    rec = _fresh(monkeypatch)
    with profile(activities=[ProfilerActivity.CPU]) as with_spans:
        _work()
    monkeypatch.setattr(trace, "span", lambda name, **attrs: contextlib.nullcontext({}))
    with profile(activities=[ProfilerActivity.CPU]) as without:
        _work()
    a = collections.Counter(e.name for e in with_spans.events())
    b = collections.Counter(e.name for e in without.events())
    assert a - b == collections.Counter({trace.ANCHOR: len(rec.anchors)}) and not b - a
    anchors = [e for e in with_spans.events() if e.name == trace.ANCHOR]
    assert anchors and all(e.device_type == DeviceType.CPU for e in anchors)


def test_spans_on_the_profilers_clock(monkeypatch):
    """Through the anchors, each span lands on the profiler's clock around
    the torch operation it enclosed, to within the offsets the anchors
    allow; events with no anchor, or whose anchors the program did not
    make, give None."""
    rec = _fresh(monkeypatch)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _work(pause=0.06)
    host = _host(prof)
    assert len(rec.anchors) >= 2
    got = trace.on_profiler_clock(host)
    assert [s.name for s in got] == ["outer", "inner", "inner", "outer"]
    a, b, bracket, spread = trace.clock_fit(host)
    assert b == 1000.0 and 0 < bracket and spread <= bracket  # too short to fit a rate
    ops = sorted((s, e) for name, s, e in host if name == "aten::cumsum")
    assert len(ops) == 3
    for (s, e), sp in zip(ops, got[1:]):
        assert sp.start - spread <= s and e <= sp.end + spread
    assert trace.on_profiler_clock([h for h in host if h[0] != trace.ANCHOR]) is None
    assert trace.on_profiler_clock(host + [(trace.ANCHOR, 9e9, 9e9 + 1)]) is None
    last = max(s for n, s, _ in host if n == trace.ANCHOR)
    moved = [(n, s + 5e4, e + 5e4) if s == last else (n, s, e) for n, s, e in host]
    assert trace.on_profiler_clock(moved) is None  # its anchors disagree by 50 ms


def test_capture_record_outlives_the_cache(monkeypatch):
    """A captured program's record (its solver, loop counts, copies,
    nodes, clones, launches and products) is kept whether or not anything records,
    and stays after ``cache_clear``; a replay under the profiler is a
    ``csr5.solve`` in mode ``replay`` naming the program, around a
    ``csr5.graph.launch``."""
    _fresh(monkeypatch)
    scale = _toy(monkeypatch)
    f = lambda v: 2 * v  # noqa: E731
    b = torch.ones(3)
    scale(f, b)  # eager
    scale(f, b)  # capture, replay
    (rec,) = trace.captures().values()
    assert (rec.solver, rec.loops, rec.inputs, rec.outputs) == ("scale", {"iters": 2}, 1, 1)
    assert rec.nodes == {"kernel": 5, "memset": 1} and rec.launches == {"csr5_spmv": 2}
    assert rec.products == {"f": ((1, 3),)} and trace.spans() == []
    with profile(activities=[ProfilerActivity.CPU]):
        y = scale(f, 5 * b)
    assert torch.equal(y, 20 * b)
    solve, launch = sorted(trace.spans(), key=lambda s: s.start)
    assert solve.attrs == {"solver": "scale", "mode": "replay", "program": rec.program}
    assert launch.name == "csr5.graph.launch" and launch.parent == solve.ident
    assert launch.attrs == {"program": rec.program}
    scale.cache_clear()
    assert scale.cache_size() == 0 and trace.captures() == {rec.program: rec}


def test_capture_records_are_bounded(monkeypatch):
    """At most ``max_captures`` records, the oldest dropped first, each
    with its own program id."""
    _fresh(monkeypatch, max_captures=2)
    recs = [trace.note_capture(solver="s", loops={}, inputs=0, outputs=1, nodes=None,
                               launches={}, products=None) for _ in range(3)]
    assert [r.program for r in recs] == [1, 2, 3] and list(trace.captures()) == [2, 3]


class _FakeLibcuda:
    """``libcuda``'s graph queries over a graph of three nodes (a kernel, a
    memset, an empty node); ``fail`` names a call that returns an error."""

    def __init__(self, fail=None):
        self.fail, self.kinds = fail, {101: 0, 102: 2, 103: 5}

    def cuGraphGetNodes(self, graph, nodes, num):
        if self.fail == "nodes":
            return 1
        if nodes is not None:
            for i, node in enumerate(self.kinds):
                nodes[i] = node
        num._obj.value = len(self.kinds)
        return 0

    def cuGraphNodeGetType(self, node, kind):
        if self.fail == "type":
            return 1
        kind._obj.value = self.kinds[node.value]
        return 0


@pytest.mark.parametrize("fail", [None, "nodes", "type", "no_libcuda"])
def test_graph_nodes_read_or_none(monkeypatch, fail):
    """A captured graph's nodes are counted by type from ``libcuda``; where
    it cannot be loaded or returns an error, the count is None and nothing
    raises."""
    lib = None if fail == "no_libcuda" else _FakeLibcuda(fail)
    monkeypatch.setattr(graphs, "_libcuda", lambda: lib)
    got = graphs.graph_nodes(types.SimpleNamespace(raw_cuda_graph=lambda: 7))
    assert got == ({"kernel": 1, "memset": 1, "empty": 1} if fail is None else None)


def test_products_placed_among_device_operations(monkeypatch):
    """Each call of a marked operator is noted with the device operations
    captured before and after it; once they cannot be read, the products
    are None and the operator still runs."""
    products = graphs._Products(types.SimpleNamespace(cuda_stream=0))
    counts = iter([0, 2, 3, 4, None, 9])
    monkeypatch.setattr(products, "_ops", lambda: next(counts))
    spmv = products.marked("spmv", lambda v: 2 * v)
    assert spmv(1) == 2 and spmv(2) == 4
    assert products.spans == {"spmv": [(0, 2), (3, 4)]}
    assert spmv(3) == 6 and products.spans is None
    assert spmv(4) == 8 and products.spans is None  # no more reads
