"""Iterative refinement on two planes of one matrix, and the capture record
that lets a reader cut its graph by operator, on the CPU.

The port's ``iterative_refinement`` (K1's plain version on a float32
plane inside float64 refinement on K4's float64 plane) is held to the
benchmark's plain reference (``csr5_bench/reference/refinement.py``) on a
seeded 12^3 grid of HPCG's 27-point stencil (``csr5_bench/generators/
stencil27.py``); with both planes one step down it stays at float32's
level. The placement of an operator's calls in a growing graph reads
each node once and gives the positions a full read gives; the launches
each operator's calls enqueued are kept by operator. The CUDA graph itself
needs a card (``chip_smoke.py`` phase 11, the ``hpcg192.ir`` cell).
"""

import types

import numpy as np
import pytest
import torch

import benchmark_spmv_using_csr5_tpu_torch as P
from benchmark_spmv_using_csr5_tpu_torch.models import solvers
from benchmark_spmv_using_csr5_tpu_torch.utils import cuda_build, graphs
from csr5_bench import harness, reference, yardstick
from csr5_bench.reference import refinement

#: a 12^3 grid: A's eigenvalues lie in 1.5-36.4 on seeds 0, 12345 and 2^31 + 7
GRID = {"nx": 12, "ny": 12, "nz": 12}
SEED = 2**31 + 7
#: counts that reach float64 accuracy at 12^3: each outer step of 50
#: float32 CG iterations gains about 1e-7, so 4 steps reach the floor
OUTER, INNER = 4, 50
#: ||b - A x||_2 / ||b||_2 of a float64-accurate solve; the floor is about
#: 1e-14 (b = A 1 is zero to rounding in the interior rows)
RES_F64 = 1e-12
#: x against the reference's x: x - x_ref = A^-1 (r_ref - r), so the gap
#: over ||x_ref|| is at most cond(A) (res + res_ref) <= 25 * 2e-12 = 5e-11
X_GAP = 1e-10
#: the least residual the control reaches: its x and its residual are
#: float32 (unit roundoff 6e-8)
RES_F32 = 1e-7


@pytest.fixture(scope="module")
def grid():
    gen = harness.load_module(harness.ROOT, "generators", "stencil27")
    csr = gen.generate(GRID, SEED, "cpu")
    m, n = csr["shape"]
    host = tuple(csr[k].numpy() for k in ("row_ptr", "col", "val")) + ((m, n),)
    ref = reference.CSR(*host, "cpu")
    return host, ref, ref.matmul(torch.ones(n, dtype=torch.float64))


def _port_ir(host, b, hi_dtype, lo_dtype):
    hi = P.build_csr5(host, value_dtype=hi_dtype, device="cpu")
    lo = P.build_csr5(host, value_dtype=lo_dtype, device="cpu")
    return solvers.iterative_refinement(lambda v: P.csr5_spmv(lo, v),
                                        lambda v: P.csr5_spmv(hi, v), b,
                                        outer_iters=OUTER, inner_iters=INNER)[0]


def test_refinement_matches_the_plain_reference(grid):
    host, ref, b = grid
    x = _port_ir(host, b, torch.float64, torch.float32)
    x_ref = refinement.iterative_refinement(ref, b, OUTER, INNER)
    assert x.dtype == x_ref.dtype == torch.float64
    res = yardstick.relative_error(ref.matmul(x), b, 2)
    res_ref = yardstick.relative_error(ref.matmul(x_ref), b, 2)
    assert res <= RES_F64 and res_ref <= RES_F64, (res, res_ref)
    assert yardstick.relative_error(x, x_ref, 2) <= X_GAP


def test_refinement_one_step_down_stays_at_float32(grid):
    """A float32 plane for the residual and a bfloat16 plane for the inner
    CG, with float32 vectors, as the benchmark's control runs them."""
    host, ref, b = grid
    x = _port_ir(host, b.float(), torch.float32, torch.bfloat16)
    assert x.dtype == torch.float32
    assert yardstick.relative_error(ref.matmul(x), b, 2) > RES_F32


def test_each_outer_step_gains_as_float32_cg_does(grid):
    """The reference's residual after each outer step: a first step at
    float32's level, then at least a factor 1e4 a step to the floor."""
    _, ref, b = grid
    res = [yardstick.relative_error(
        ref.matmul(refinement.iterative_refinement(ref, b, k, INNER)), b, 2)
        for k in range(1, OUTER + 1)]
    assert 1e-9 < res[0] < 1e-4 and res[1] < res[0] * 1e-4 and res[-1] <= RES_F64


class _GrowingGraph:
    """``libcuda``'s capture and graph queries over a node list that an
    operator's calls extend, as a capture does; ``reorder`` lists the
    nodes in another order from the given read on. Counts the type reads."""

    KINDS = {"kernel": 0, "memcpy": 1, "memset": 2, "empty": 5}

    def __init__(self, reorder_at=None):
        self.nodes, self.kinds, self.type_reads, self.reads = [], {}, 0, 0
        self.reorder_at = reorder_at

    def add(self, *kinds):
        for kind in kinds:
            node = 0x1000 + len(self.nodes)
            self.nodes.append(node)
            self.kinds[node] = self.KINDS[kind]

    def listed(self):
        if self.reorder_at is not None and self.reads >= self.reorder_at:
            return self.nodes[::-1]
        return self.nodes

    def cuStreamGetCaptureInfo_v2(self, stream, status, ids, graph, deps, num_deps):
        graph._obj.value = 7
        return 0

    def cuGraphGetNodes(self, graph, nodes, num):
        listed = self.listed()
        if nodes is not None:
            self.reads += 1
            for i in range(min(len(nodes), len(listed))):
                nodes[i] = listed[i]
        num._obj.value = len(listed)
        return 0

    def cuGraphNodeGetType(self, node, kind):
        self.type_reads += 1
        kind._obj.value = self.kinds[node.value]
        return 0

    def device_ops(self):
        """A full read: the device operations among every node."""
        return sum(1 for n in self.nodes if self.kinds[n] in (0, 1, 2))


def _capture_like(lib, products, outer=4, inner=6):
    """Iterative refinement's calls on a growing graph: each call of
    ``spmv_lo`` adds a fill and K1, of ``spmv_hi`` a fill and K4, and the
    vector work between them kernels, copies and empty nodes. Returns the
    positions a full read gives before and after each call."""
    want = {"spmv_lo": [], "spmv_hi": []}

    def op(name, *kinds):
        def call(v):
            first = lib.device_ops()
            lib.add(*kinds)
            want[name].append((first, lib.device_ops()))
            return v
        return products.marked(name, call)

    lo, hi = op("spmv_lo", "memset", "kernel"), op("spmv_hi", "memset", "kernel")
    lib.add("memset", "empty")
    for _ in range(outer):
        hi(0)
        lib.add("kernel", "kernel")
        for _ in range(inner):
            lo(0)
            lib.add("kernel", "memcpy", "kernel", "empty", "kernel")
        lib.add("kernel")
    hi(0)
    lib.add("kernel")
    return want


@pytest.mark.parametrize("reorder_at", [None, 9])
def test_placement_reads_each_node_once_and_equals_a_full_read(monkeypatch, reorder_at):
    lib = _GrowingGraph(reorder_at)
    monkeypatch.setattr(graphs, "_libcuda", lambda: lib)
    products = graphs._Products(types.SimpleNamespace(cuda_stream=0))
    want = _capture_like(lib, products)
    placed = products.spans
    assert placed == want and len(placed["spmv_lo"]) == 24 and len(placed["spmv_hi"]) == 5
    assert products.kernels == {"spmv_lo": [1] * 24, "spmv_hi": [1] * 5}
    if reorder_at is None:  # every node's type read once, but the last, added after the calls
        assert lib.type_reads == len(lib.nodes) - 1
    else:  # listed in another order: read whole again, and placed the same
        assert lib.type_reads > len(lib.nodes)
    # the graph read whole, as the record's node count is, holds that one kernel more
    full = graphs._node_types(7)
    assert sum(k in graphs.DEVICE_OPS for k in full) == products.ops + 1


def test_launches_kept_by_operator_from_the_counters(monkeypatch):
    """Each operator's calls add the launch counters they moved under its
    name: iterative refinement's eager body at 4 x 200 with one K1 launch a
    ``spmv_lo`` call and one K4 launch a ``spmv_hi`` call gives 800 and 5;
    the record keeps them beside the capture's whole count."""
    counters = dict.fromkeys(cuda_build.launches, 0)
    monkeypatch.setattr(cuda_build, "launches", counters)
    products = graphs._Products(types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(products, "_ops", lambda: 0)
    d = torch.linspace(1.0, 2.0, 16, dtype=torch.float64)

    def launching(counter, dtype):
        def spmv(v):
            counters[counter] += 1
            return d.to(dtype) * v
        return spmv

    lo = products.marked("spmv_lo", launching("csr5_spmv", torch.float32))
    hi = products.marked("spmv_hi", launching("csr5_spmv_f64", torch.float64))
    before = graphs.read_launches()
    x, _ = solvers.iterative_refinement.__wrapped__(lo, hi, d * 1.0, outer_iters=4,
                                                    inner_iters=200)
    np.testing.assert_allclose(x.numpy(), np.ones(16), rtol=1e-12)
    assert products.launches == {"spmv_lo": {"csr5_spmv": 800}, "spmv_hi": {"csr5_spmv_f64": 5}}
    counted = graphs.launches_between(before, graphs.read_launches())
    prog = graphs._program("iterative_refinement", {"outer_iters": 4, "inner_iters": 200},
                           types.SimpleNamespace(replay=lambda: None), {}, x, {"kernel": 9},
                           counted, products.spans, operator_launches=products.launches)
    rec = prog.record
    assert rec.launches == {"csr5_spmv": 800, "csr5_spmv_f64": 5}
    assert rec.operator_launches == {"spmv_lo": {"csr5_spmv": 800},
                                     "spmv_hi": {"csr5_spmv_f64": 5}}
