"""The distributed product as a program (``parallel/distributed.py``) and
the shard builders' value type, on the CPU.

- One spawn of 4 gloo ranks (``parallel.launch.run_ranks``) runs HPCG's
  float64 stencil over 1 x 1 x D stacked local grids (8 x 8 x 8 each, a
  halo of one plane each way) at D = 2 and 4: the device route and the
  host route with ``value_dtype=torch.float64`` against the plain float64
  reference of the benchmark (``csr5_bench/reference``), two products in
  a row owned by the caller, and the ``csr5.dist.product`` span, which
  records only under a profiler (the eager body, as gloo always runs).
  The same spawn takes the program path through ``graphs.capture`` as
  written, its CUDA graph stood in for on the CPU, with some ranks keeping
  every y and their neighbours dropping each: one exchange a call on
  every rank, and every y the reference's.
- In this process: the program cache by key (a stand-in capture, since a
  CUDA graph needs a card; the graph itself runs in the four-card
  benchmark cell ``hpcg192x4.spmv``), the ring without torch's use count,
  the device route's ``plan`` phase, and each route's value plane by
  ``value_dtype``.
"""

import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import torch_dist_scenarios as S
from benchmark_spmv_using_csr5_tpu_torch.ops import convert
from benchmark_spmv_using_csr5_tpu_torch.parallel import distributed as pd
from benchmark_spmv_using_csr5_tpu_torch.parallel.launch import run_ranks
from benchmark_spmv_using_csr5_tpu_torch.utils import graphs, trace
from csr5_bench import reference

#: (key, D, scenario, kwargs) run by the spawned ranks
JOBS = [
    ("device_2", 2, "zstack", {"convert": "device"}),
    ("device_4", 4, "zstack", {"convert": "device"}),
    ("alpha_4", 4, "zstack", {"convert": "device", "alpha": -1.75}),
    ("host64_2", 2, "zstack", {"convert": "host", "value_dtype": "float64"}),
    ("host64_4", 4, "zstack", {"convert": "host", "value_dtype": "float64"}),
    ("host_2", 2, "zstack", {"convert": "host"}),
    ("held_2", 2, "zstack_held", {"hold": (0,)}),
    ("held_4", 4, "zstack_held", {"hold": (0, 2)}),
]
JOB = {key: (D, kw) for key, D, _, kw in JOBS}
#: one x-y plane of a local grid, lane-rounded
HALO = (128, 128)


@pytest.fixture(scope="module")
def ranks():
    """Every rank's results of JOBS, from one spawn of 4 gloo ranks."""
    return run_ranks(S.run, 4, JOBS)


def _ref(D, k=0, alpha=1.0):
    rp, ci, v, shape = S.zstack(D)
    return alpha * reference.CSR(rp, ci, v, shape, "cpu").matmul(S.zstack_x(shape[1], k)).numpy()


def _err(y, want):
    """The benchmark's ``y_err``: the largest gap over the largest answer."""
    return float(np.abs(y.astype(np.float64) - want).max() / np.abs(want).max())


def _results(ranks, key):
    D = JOB[key][0]
    assert all(key not in ranks[r] for r in range(D, 4))
    return [ranks[r][key] for r in range(D)]


@pytest.mark.parametrize("key,limit", [("device_2", 1e-13), ("device_4", 1e-13),
                                       ("alpha_4", 1e-13), ("host64_2", 1e-14),
                                       ("host64_4", 1e-14)])
def test_float64_product_matches_the_reference(ranks, key, limit):
    """Every rank's global y, and its own blocks of two local products,
    within ``limit`` of the float64 reference; the shards hold float64
    planes and exchange one plane each way."""
    D, kw = JOB[key]
    alpha = kw.get("alpha", 1.0)
    got = _results(ranks, key)
    want = [_ref(D, k, alpha) for k in range(3)]
    rows = len(want[0]) // D
    for r, g in enumerate(got):
        assert g["plane"] == "torch.float64" and g["halo"] == HALO
        assert g["route"] == kw["convert"]
        assert _err(g["y"], want[0]) <= limit
        for k, y in ((1, g["y1"]), (2, g["y2"])):
            assert y.shape == (rows,) and _err(y, want[k][r * rows:(r + 1) * rows]) <= limit


def test_host_route_default_still_narrows_to_float32(ranks):
    """Without ``value_dtype`` the host route keeps its float32 plane."""
    for g in _results(ranks, "host_2"):
        assert g["plane"] == "torch.float32" and g["route"] == "host"
        assert 1e-9 < _err(g["y"], _ref(2)) < 1e-5


@pytest.mark.parametrize("key", ["device_2", "device_4", "host64_4"])
def test_caller_owns_each_y(ranks, key):
    """Two local products in a row return two tensors, and the second
    leaves the first as it was."""
    for g in _results(ranks, key):
        assert g["distinct"] and g["first_kept"]
        assert not np.array_equal(g["y1"], g["y2"])


@pytest.mark.parametrize("key", ["device_2", "device_4"])
def test_span_recorded_only_under_a_profiler(ranks, key):
    """With the profiler off a product records no span; under a profiler
    it records one ``csr5.dist.product`` in eager mode with its rank, halo
    widths and the x bytes it exchanges."""
    for r, g in enumerate(_results(ranks, key)):
        assert g["spans_off"] == 0
        assert g["spans"] == [{"rank": r, "halo": HALO, "bytes": 8 * sum(HALO), "mode": "eager",
                               "program": None}]


@pytest.mark.parametrize("key", ["held_2", "held_4"])
def test_one_exchange_a_call_whatever_each_rank_holds(ranks, key):
    """The ranks of ``hold`` keep every y, so each of their calls after the
    first captures a program (up to ``RING``, then the eager body), while
    their neighbours drop each y and replay one program. Every call on
    every rank still runs exactly one exchange, every y is the
    reference's, and a held y keeps its product."""
    D, kw = JOB[key]
    calls = pd.RING + 4
    want = [_ref(D, k) for k in range(3)]
    rows = len(want[0]) // D
    for r, g in enumerate(_results(ranks, key)):
        held = r in kw["hold"]
        assert g["modes"] == (["eager"] + ["capture"] * pd.RING + ["eager"] * 3 if held
                              else ["eager", "capture"] + ["replay"] * (calls - 2))
        assert g["exchanges"] == calls and g["held_kept"]
        for k, y in enumerate(g["ys"]):
            assert _err(y, want[k % 3][r * rows:(r + 1) * rows]) <= 1e-13


# ---------------------------------------------------------------------------
# in this process
# ---------------------------------------------------------------------------


@pytest.fixture
def stand_in(monkeypatch):
    """A halo shard of rank 0 of 2 taken down the program path: the eager
    body and the capture are stand-ins (no card, no peer); a captured
    program's stand-in graph runs the same body on its static input into
    its own y. Returns the shard, its mesh and the captures made."""
    rp, ci, v, shape = S.zstack(2)
    da = pd.build_shard(rp, ci, v, shape, 0, 2, halo="auto", convert="device", device="cpu")
    mesh = pd.Mesh(group=None, size=2, rank=0, device=torch.device("cpu"), backend="nccl")
    rows = da.rows_per_shard
    body = lambda x, alpha: (alpha * x[:rows]).to(torch.float64)  # noqa: E731
    captures = []

    def capture(local, rows_, buf, x_mid, pairs, mesh_, alpha, dev):
        captures.append((x_mid.dtype, alpha))
        y = torch.zeros(rows_ + 5, dtype=torch.float64)
        out = y[:rows_]
        graph = types.SimpleNamespace(replay=lambda: out.copy_(body(x_mid, alpha)))
        return graphs._program("distributed_spmv_local", {}, graph, {"x_shard": x_mid}, out,
                               {"kernel": 3}, {}, {"spmv": ((1, 3),)}, exchange=(0, 1),
                               nccl_kernels=1)

    monkeypatch.setattr(pd, "_graphed", lambda da_, x, mesh_: da_.halo is not None)
    monkeypatch.setattr(pd, "_eager_product", lambda da_, x, mesh_, alpha: body(x, alpha))
    monkeypatch.setattr(pd, "_capture_program", capture)
    yield da, mesh, captures
    pd._programs.pop(da, None)


def _traced(calls, da, mesh, keep):
    """Each call's (y, span attributes); ``keep`` holds every y returned,
    else each is dropped before the next call."""
    ys, out = [], []
    with profile(activities=[ProfilerActivity.CPU]):
        for x, a in calls:
            y = pd.distributed_spmv_local(da, x, mesh, a)
            out.append((y.clone(), y.data_ptr()))
            if keep:
                ys.append(y)
            del y
    spans = [s for s in trace.spans() if s.name == "csr5.dist.product"][-len(calls):]
    return out, [s.attrs for s in spans], ys


def test_program_cache_by_key(stand_in):
    """A key's first call is eager, its second captures, later ones replay
    that program while the caller drops each y; another x dtype or alpha
    is another key."""
    da, mesh, captures = stand_in
    x = torch.arange(da.local.n - sum(da.halo), dtype=torch.float64)
    calls = [(x, 1.0)] * 4 + [(x.float(), 1.0)] * 3 + [(x, 2.0)] * 2
    out, attrs, _ = _traced(calls, da, mesh, keep=False)
    assert [a["mode"] for a in attrs] == ["eager", "capture", "replay", "replay", "eager",
                                          "capture", "replay", "eager", "capture"]
    progs = [a["program"] for a in attrs]
    assert progs[0] is None and progs[1] == progs[2] == progs[3] is not None
    assert progs[5] == progs[6] not in (None, progs[1]) and progs[8] not in (None, *progs[:8])
    assert captures == [(torch.float64, 1.0), (torch.float32, 1.0), (torch.float64, 2.0)]
    record = trace.captures()[progs[1]]
    assert record.exchange == (0, 1) and record.nccl_kernels == 1
    for (y, _), (xx, a) in zip(out, calls):
        assert torch.equal(y, (a * xx[: da.rows_per_shard]).double())
    assert out[1][1] == out[2][1] == out[3][1]  # the dropped y's memory, reused
    assert len(pd._programs[da].programs) == 3


def test_a_held_y_is_never_overwritten(stand_in):
    """While the caller holds every y, each call captures another program,
    up to ``RING``; past that it runs the eager body. Each y keeps its own
    product."""
    da, mesh, captures = stand_in
    n = da.local.n - sum(da.halo)
    calls = [(torch.full((n,), float(k), dtype=torch.float64), 1.0) for k in range(pd.RING + 4)]
    out, attrs, ys = _traced(calls, da, mesh, keep=True)
    assert [a["mode"] for a in attrs] == ["eager"] + ["capture"] * pd.RING + ["eager"] * 3
    assert len(captures) == pd.RING and len({a["program"] for a in attrs[1:-3]}) == pd.RING
    assert len({p for _, p in out}) == len(calls)  # no two y share memory
    for y, (x, _) in zip(ys, calls):
        assert torch.equal(y, x[: da.rows_per_shard])
    del ys[3]  # a program's y let go: the next call takes that program
    y = pd.distributed_spmv_local(da, calls[0][0], mesh)
    assert y.data_ptr() == out[3][1] and torch.equal(y, calls[0][0][: da.rows_per_shard])
    assert len(captures) == pd.RING


def test_without_a_use_count_one_program_and_a_clone(stand_in, monkeypatch):
    """Where torch cannot count a storage's holders, a key captures one
    program and every call returns a clone of its y, so a held y is never
    overwritten."""
    monkeypatch.delattr(torch._C, "_storage_Use_Count")
    da, mesh, captures = stand_in
    n = da.local.n - sum(da.halo)
    calls = [(torch.full((n,), float(k), dtype=torch.float64), 1.0) for k in range(5)]
    out, attrs, ys = _traced(calls, da, mesh, keep=True)
    assert [a["mode"] for a in attrs] == ["eager", "capture", "replay", "replay", "replay"]
    assert len(captures) == 1 and len({p for _, p in out}) == len(calls)
    for y, (x, _) in zip(ys, calls):
        assert torch.equal(y, x[: da.rows_per_shard])


def test_device_route_records_its_plan_phase():
    """The device route's host pre-pass over every shard is the ``plan``
    phase of ``last_convert_phases``, as the host route's plan is."""
    rp, ci, v, shape = S.zstack(2)
    convert.last_convert_phases.clear()
    s = pd.build_shard(rp, ci, v, shape, 1, 2, halo="auto", convert="device", device="cpu")
    assert s.convert_route == "device" and convert.last_convert_phases["plan"] > 0


def test_only_halo_shards_on_the_card_under_nccl_are_programs():
    """On CPU tensors, on gloo or for an all-gathered shard the product is
    the eager body."""
    rp, ci, v, shape = S.zstack(2)
    halo = pd.build_shard(rp, ci, v, shape, 0, 2, halo="auto", device="cpu")
    full = pd.build_shard(rp, ci, v, shape, 0, 2, halo="none", device="cpu")
    x = torch.zeros(shape[1] // 2, dtype=torch.float64)
    for backend in ("gloo", "nccl"):
        mesh = pd.Mesh(group=None, size=2, rank=0, device=torch.device("cpu"), backend=backend)
        assert not pd._graphed(halo, x, mesh) and not pd._graphed(full, x, mesh)
    assert halo.halo == HALO and full.halo is None


@pytest.mark.parametrize("D", [2, 4])
@pytest.mark.parametrize("convert", ["host", "device"])
@pytest.mark.parametrize("value_dtype", [None, torch.float32, torch.float64])
def test_shard_value_plane_by_value_dtype(convert, value_dtype, D):
    """The value plane of every shard of the float64 stencil: float64 where
    asked on either route (with the raw columns K4 reads), float32 where
    asked, and without ``value_dtype`` each route's own rule (the host
    route narrows, the device route keeps the values' type)."""
    rp, ci, v, shape = S.zstack(D)
    want = value_dtype or (torch.float32 if convert == "host" else torch.float64)
    for d in range(D):
        s = pd.build_shard(rp, ci, v, shape, d, D, halo="auto", convert=convert,
                           value_dtype=value_dtype, device="cpu")
        assert s.local.val_tiles.dtype == want and s.convert_route == convert
        if want == torch.float64:
            assert s.local.col_idx_tiles is not None


def test_shard_refuses_an_unknown_value_dtype():
    rp, ci, v, shape = S.zstack(2)
    with pytest.raises(ValueError, match="value_dtype"):
        pd.build_shard(rp, ci, v, shape, 0, 2, value_dtype="auto", device="cpu")
