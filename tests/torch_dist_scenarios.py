"""The scenarios the distributed tests run in spawned gloo ranks
(``parallel.launch.run_ranks``): module-level functions, so the children
can import them, that build the same matrices as the tests from the same
seeds and return numpy results. All the scenarios of a test file run in
one spawn (:func:`run`), on meshes of the first D ranks."""

import collections
import contextlib
import types
from unittest import mock

import numpy as np
import scipy.sparse as sp
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark_spmv_using_csr5_tpu_torch.parallel import distributed as pd
from benchmark_spmv_using_csr5_tpu_torch.parallel import distributed_dia as pdd
from benchmark_spmv_using_csr5_tpu_torch.parallel import scaling
from benchmark_spmv_using_csr5_tpu_torch.utils import graphs, synth, trace
from csr5_bench.generators import stencil27_zstack


def _halo_round():
    """A diagonal plus one entry 130 columns left of row 200: a halo that
    fits n_per = 128 before the lane rounding and not after it."""
    m = n = 1024
    extra = sp.csr_matrix((np.ones(1, np.float32), ([200], [200 - 130])), shape=(m, n))
    return (sp.eye(m, n, format="csr", dtype=np.float32) + extra).tocsr()


def _cg256():
    a = synth.banded(256, 5, dtype=np.float32)
    return sp.csr_matrix((a + a.T) * 0.5 + sp.eye(256) * 50.0).astype(np.float32)


def _wide_offsets():
    m, far = 1024, 16384 + 256
    return sp.diags([np.ones(m), np.ones(m)], [0, far], shape=(m, m + far),
                    format="csr").astype(np.float32)


#: name -> factory of a float32 scipy CSR matrix (the JAX tests' matrices)
MATRICES = {
    "banded1024_9": lambda: synth.banded(1024, 9, dtype=np.float32),
    "banded1001_7": lambda: synth.banded(1001, 7, dtype=np.float32),
    "powerlaw2000": lambda: synth.power_law(2000, 2000, 6.0, seed=3).astype(np.float32),
    "empty9": lambda: sp.csr_matrix((np.ones(3, np.float32), ([0, 1, 2], [0, 1, 2])), shape=(9, 9)),
    "banded4096_9": lambda: synth.banded(4096, 9, dtype=np.float32),
    "random1024": lambda: synth.random_csr(1024, 1024, 0.02, dtype=np.float32),
    "halo_round": _halo_round,
    "banded520_7": lambda: synth.banded(520, 7, dtype=np.float32),
    "powerlaw800": lambda: sp.csr_matrix(synth.power_law(800, 800, 6.0, dtype=np.float32)),
    "powerlaw600": lambda: synth.power_law(600, 600, 5.0, dtype=np.float32),
    "cg256": _cg256,
    "banded2048_3": lambda: synth.banded(2048, 3, dtype=np.float32),
    "banded1000_7": lambda: synth.banded(1000, 7, dtype=np.float32),
    "banded1024_5": lambda: synth.banded(1024, 5, dtype=np.float32),
    "wide_offsets": _wide_offsets,
}


def matrix(name):
    return sp.csr_matrix(MATRICES[name]())


def x_of(a):
    return synth.dense_x(a.shape[1], dtype=np.float32)


def xm_of(a, R, ragged=False):
    if ragged:
        return x_of(a)[:, None] * np.ones((1, R), np.float32)
    return np.random.default_rng(4).integers(1, 10, (a.shape[1], R)).astype(np.float32)


def _spmv(mesh, name, halo="none", convert="host", alpha=1.0):
    a = matrix(name)
    da = pd.distribute_csr(a.indptr, a.indices, a.data, a.shape, mesh, halo=halo, convert=convert)
    y = pd.distributed_spmv(da, torch.from_numpy(x_of(a)), mesh, alpha)
    return {"y": y.numpy(), "halo": da.halo, "bytes": da.x_bytes_exchanged(),
            "route": da.convert_route, "rows_per": da.rows_per_shard}


def _spmm(mesh, name, R, ragged=False):
    a = matrix(name)
    da = pd.distribute_csr(a.indptr, a.indices, a.data, a.shape, mesh)
    return {"y": pd.distributed_spmm(da, torch.from_numpy(xm_of(a, R, ragged)), mesh).numpy()}


def _cg(mesh, iters=100):
    """CG on the rank-local form: each rank holds its blocks of x, r and
    p, the products exchange x shards, the dot products are all-reduced."""
    a = matrix("cg256")
    da = pd.distribute_csr(a.indptr, a.indices, a.data, a.shape, mesh)
    n_per = -(-a.shape[0] // mesh.size)
    b = pd.shard_of(torch.ones(a.shape[0]), n_per, mesh)

    def dot(u, v):
        s = torch.dot(u, v).reshape(1)
        torch.distributed.all_reduce(s, group=mesh.group)
        return s[0]

    x = torch.zeros_like(b)
    r, p = b.clone(), b.clone()
    rs = dot(r, r)
    for _ in range(iters):
        ap = pd.distributed_spmv_local(da, p, mesh)
        den = dot(p, ap)
        alpha = rs / den if den != 0 else torch.zeros(())
        x, r = x + alpha * p, r - alpha * ap
        rs_new = dot(r, r)
        p = r + (rs_new / rs if rs != 0 else 0.0) * p
        rs = rs_new
    return {"x": pd.all_gather_cat(x, mesh)[: a.shape[0]].numpy()}


#: HPCG's local grid at a test's size (deep enough in z that a halo of one
#: lane-rounded plane each way moves less than an all-gather at D = 2); D
#: of them are stacked along z
ZSTACK = {"nx": 8, "ny": 8, "nz": 8}
#: a seed past 32 signed bits, as the benchmark's runs are given
ZSEED = 2**31 + 12345
DTYPES = {None: None, "float32": torch.float32, "float64": torch.float64}


def zstack(D):
    """HPCG's float64 matrix over a 1 x 1 x D process grid of
    :data:`ZSTACK` local grids: host ``(row_ptr, col, val, shape)``."""
    g = stencil27_zstack.generate({**ZSTACK, "process_grid": [1, 1, D]}, ZSEED, "cpu", rank=0)
    return g["row_ptr"].numpy(), g["col"].numpy(), g["val"].numpy(), g["shape"]


def zstack_x(n, k):
    """The k-th seeded x of n float64 values, uniform in [-1, 1)."""
    return torch.from_numpy(np.random.default_rng(k).uniform(-1.0, 1.0, n))


def _zstack(mesh, convert="device", value_dtype=None, alpha=1.0):
    """The distributed product on the z-stacked stencil (halo "auto": one
    plane each way): the global y, then two local products in a row (the
    first kept to see that the second leaves it), then the spans one
    more product records with the profiler off and on."""
    rp, ci, v, shape = zstack(mesh.size)
    da = pd.distribute_csr(rp, ci, v, shape, mesh, halo="auto", convert=convert,
                           value_dtype=DTYPES[value_dtype])
    vec = da.local.val_tiles.dtype
    n_per = -(-shape[1] // mesh.size)
    y = pd.distributed_spmv(da, zstack_x(shape[1], 0).to(vec), mesh, alpha)
    shards = [pd.shard_of(zstack_x(shape[1], k).to(vec), n_per, mesh) for k in (1, 2)]
    y1 = pd.distributed_spmv_local(da, shards[0], mesh, alpha)
    first = y1.clone()
    y2 = pd.distributed_spmv_local(da, shards[1], mesh, alpha)
    named = lambda: [s for s in trace.spans() if s.name == "csr5.dist.product"]  # noqa: E731
    before = len(named())
    pd.distributed_spmv_local(da, shards[0], mesh, alpha)
    off = len(named()) - before
    with profile(activities=[ProfilerActivity.CPU]):
        pd.distributed_spmv_local(da, shards[0], mesh, alpha)
    spans = named()[before:]
    return {"y": y.numpy(), "halo": da.halo, "route": da.convert_route, "plane": str(vec),
            "y1": y1.numpy(), "y2": y2.numpy(), "distinct": y1.data_ptr() != y2.data_ptr(),
            "first_kept": bool(torch.equal(y1, first)), "spans_off": off,
            "spans": [s.attrs for s in spans]}


@contextlib.contextmanager
def _graphs_on_the_cpu():
    """The distributed product's program path on CPU tensors over gloo,
    ``utils/graphs.py::capture`` as written: its warm-up runs for real,
    its capture records the exchange and the local product without
    running them (as a CUDA graph records device work), and a replay runs
    what was recorded. Yields a counter of the exchanges run."""
    real_exchange, real_spmv = pd._exchange, pd.csr5_spmv
    made = collections.Counter()

    def exchange(sends, recvs, mesh):
        made["exchanges"] += 1
        real_exchange(sends, recvs, mesh)

    class Graph:
        def __init__(self, keep_graph=False):
            self.ops = []

        def replay(self):
            for op in self.ops:
                op()

        def instantiate(self):
            pass

        def raw_cuda_graph(self):
            return 0

    @contextlib.contextmanager
    def capturing(graph, stream=None, capture_error_mode="global"):
        def record_exchange(sends, recvs, mesh):
            graph.ops.append(lambda: exchange(sends, recvs, mesh))

        def record_spmv(local, x, alpha=1.0):
            out = real_spmv(local, x, alpha)
            graph.ops.append(lambda: out.copy_(real_spmv(local, x, alpha)))
            return out

        with mock.patch.object(pd, "_exchange", record_exchange), \
                mock.patch.object(pd, "csr5_spmv", record_spmv):
            yield

    nothing = lambda *a, **k: contextlib.nullcontext()  # noqa: E731
    stream = types.SimpleNamespace(cuda_stream=None, wait_stream=lambda other: None)
    patches = [
        (pd, "_graphed", lambda da, x, mesh: da.halo is not None and not graphs._inline()),
        (pd, "_exchange", exchange), (graphs, "_stream", lambda dev: stream),
        (graphs, "_libcuda", lambda: None), (torch.cuda, "current_stream", lambda *a: None),
        (torch.cuda, "is_current_stream_capturing", lambda: False),
        (torch.cuda, "stream", nothing), (torch.cuda, "device", nothing),
        (torch.cuda, "CUDAGraph", Graph), (torch.cuda, "graph", capturing),
    ]
    with contextlib.ExitStack() as stack:
        for obj, name, new in patches:
            stack.enter_context(mock.patch.object(obj, name, new))
        yield made


def _zstack_held(mesh, hold=(0,), calls=pd.RING + 4):
    """The program path (:func:`_graphs_on_the_cpu`) on the z-stacked
    stencil: ``calls`` local products of the seeded x shards 0, 1, 2, ...
    (mod 3); the ranks in ``hold`` keep every y (each call after the first
    captures another program, up to ``RING``, then runs the eager body),
    the others drop each (one capture, then replays). Every y, each
    call's mode, the exchanges run, and whether each held y kept its
    product."""
    rp, ci, v, shape = zstack(mesh.size)
    da = pd.distribute_csr(rp, ci, v, shape, mesh, halo="auto", convert="device")
    n_per = -(-shape[1] // mesh.size)
    shards = [pd.shard_of(zstack_x(shape[1], k), n_per, mesh) for k in range(3)]
    ys, held = [], []
    with _graphs_on_the_cpu() as made, profile(activities=[ProfilerActivity.CPU]):
        for k in range(calls):
            y = pd.distributed_spmv_local(da, shards[k % 3], mesh)
            ys.append(y.numpy().copy())
            if mesh.rank in hold:
                held.append(y)
            del y
    spans = [s for s in trace.spans() if s.name == "csr5.dist.product"][-calls:]
    return {"ys": np.stack(ys), "modes": [s.attrs["mode"] for s in spans],
            "exchanges": made["exchanges"],
            "held_kept": all(np.array_equal(h.numpy(), ys[i]) for i, h in enumerate(held))}


def _dia_spmv(mesh, name, alpha=1.0):
    a = matrix(name)
    dd = pdd.distribute_dia(a, mesh)
    y = pdd.distributed_dia_spmv(dd, torch.from_numpy(x_of(a)), mesh, alpha)
    return {"y": y.numpy(), "halo": dd.halo, "bytes": dd.x_bytes_exchanged(),
            "rows_per": dd.rows_per_shard}


def _dia_spmm(mesh, name, R):
    a = matrix(name)
    dd = pdd.distribute_dia(a, mesh)
    return {"y": pdd.distributed_dia_spmm(dd, torch.from_numpy(xm_of(a, R)), mesh, 1.0).numpy()}


def _weak(mesh):
    pts = scaling.weak_scaling([1, 2], rows_per_device=2048, iters=3, device="cpu")
    return {"points": [vars(p) for p in pts], "report": scaling.report(pts)}


SCENARIOS = {
    "spmv": _spmv,
    "spmm": _spmm,
    "cg": _cg,
    "dia_spmv": _dia_spmv,
    "dia_spmm": _dia_spmm,
    "weak": _weak,
    "zstack": _zstack,
    "zstack_held": _zstack_held,
}


def run(rank, world_size, jobs):
    """Rank ``rank``'s results of ``jobs``, a list of ``(key, D, scenario,
    kwargs)``: ``{key: result}`` for each job whose mesh (the first D
    ranks) holds this rank. Every rank makes every mesh, in job order."""
    meshes, out = {}, {}
    for key, D, kind, kw in jobs:
        if D not in meshes:
            meshes[D] = pd.make_mesh(D, device="cpu")
        if meshes[D].rank is not None:
            out[key] = SCENARIOS[kind](meshes[D], **kw)
    return out
