"""The kernels' one launch path, on the CPU (``utils/cuda_build.py``): the
ctypes signatures of every kernel library against its C source, the launch
call and its registry of counters, and the launch plan the CSR5 wrappers
keep on a matrix (``ops/csr5_kernel.py::_plan``). The kernels themselves
run only on the card (``chip_smoke.py``)."""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import os
import re
import types

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import benchmark_spmv_using_csr5_tpu_torch as P
from benchmark_spmv_using_csr5_tpu_torch.ops import bigslice_kernel, csr5_kernel
from benchmark_spmv_using_csr5_tpu_torch.utils import cuda_build, graphs, synth

_C_TYPES = {
    "const void*": ctypes.c_void_p,
    "void*": ctypes.c_void_p,
    "int": ctypes.c_int,
    "float": ctypes.c_float,
    "long long": ctypes.c_longlong,
    "long long*": ctypes.POINTER(ctypes.c_longlong),
}


def _source(lib: str) -> str:
    with open(os.path.join(cuda_build.CSRC_DIR, f"{lib}.cu")) as f:
        return f.read()


def _c_signatures(lib: str) -> dict:
    """name -> parameter types of every function of the C interface of
    ``csrc/<lib>.cu`` that returns an int."""
    src = _source(lib)
    src = src[src.index('extern "C" {'):]
    sigs = {}
    for name, params in re.findall(r"^int (\w+)\(([^)]*)\)", src, flags=re.M):
        types_ = []
        for p in params.split(","):
            p = " ".join(p.split())
            types_.append(_C_TYPES[re.sub(r"\s*\w+$", "", p).replace(" *", "*")])
        sigs[name] = types_
    return sigs


@pytest.mark.parametrize("lib", sorted(cuda_build.SIGNATURES))
def test_ctypes_signatures_match_the_c_interface(monkeypatch, lib):
    sigs = _c_signatures(lib)
    names = set(sigs) | {cuda_build.ERROR_STRING}
    fake = types.SimpleNamespace(**{n: types.SimpleNamespace() for n in names})
    monkeypatch.setattr(cuda_build, "load", lambda name: fake)
    monkeypatch.setattr(cuda_build, "_bound", {})
    assert cuda_build.bind(lib) is fake
    assert cuda_build.bind(lib) is fake  # bound once
    assert sigs and set(cuda_build.SIGNATURES[lib]) == set(sigs)
    for name, want in sigs.items():
        fn = getattr(fake, name)
        assert fn.restype is ctypes.c_int, name
        assert len(fn.argtypes) == len(want), name
        for got, exp in zip(fn.argtypes, want):
            assert got is exp or got == exp, (name, got, exp)
    err = getattr(fake, cuda_build.ERROR_STRING)
    assert err.argtypes == [ctypes.c_int] and err.restype is ctypes.c_char_p
    # the error string comes from the one shared header, under one name
    src = _source(lib)
    assert '#include "csr5_error.cuh"' in src and "cudaGetErrorString" not in src
    if lib == "csr5_spmv":
        # the share travels as a C float, just before the stream
        assert fake.csr5_spmv_f32.argtypes[-2] is ctypes.c_float
        assert fake.csr5_spmv_packed_bf16.argtypes[-2] is ctypes.c_float


def test_the_shared_header_defines_the_error_string():
    with open(os.path.join(cuda_build.CSRC_DIR, "csr5_error.cuh")) as f:
        src = f.read()
    assert re.search(rf'extern "C" const char\* {cuda_build.ERROR_STRING}\(int code\)', src)
    assert set(cuda_build.SIGNATURES) == {
        f[:-3] for f in os.listdir(cuda_build.CSRC_DIR) if f.endswith(".cu")}


class _Lib:
    """A kernel library of one entry point that returns ``rc``."""

    def __init__(self, rc=0):
        self.rc, self.calls = rc, []

    def entry(self, *args):
        self.calls.append(args)
        return self.rc

    def csr5_cuda_error_string(self, rc):
        return b"an error"


@pytest.fixture
def stand_in_card(monkeypatch):
    """Device 0 current, each device's stream 77, and the devices a launch
    entered; the registry is a copy, so the port's counters stay."""
    entered = []

    @contextlib.contextmanager
    def device(dev):
        entered.append(dev)
        yield

    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(cuda_build, "stream_handle", lambda dev: 77)
    monkeypatch.setattr(cuda_build, "launches", dict(cuda_build.launches))
    return entered


@pytest.mark.parametrize("counter", list(cuda_build.launches))
def test_a_launch_adds_one_to_its_own_counter(stand_in_card, counter):
    before = graphs.read_launches()
    assert set(before) == set(cuda_build.launches)
    lib = _Lib()
    cuda_build.launch(lib, "entry", torch.device("cuda", 0), (1, 2), "who", counter)
    assert lib.calls == [(1, 2, 77)]  # the stream goes last
    assert graphs.launches_between(before, graphs.read_launches()) == {counter: 1}
    assert stand_in_card == []  # x's device is current: nothing is entered


def test_a_launch_enters_x_device_only_when_it_is_not_current(stand_in_card):
    lib = _Lib()
    dev = torch.device("cuda", 1)
    cuda_build.launch(lib, "entry", dev, (), "who", "csr5_spmv")
    assert stand_in_card == [dev] and lib.calls == [(77,)]
    assert cuda_build.launches["csr5_spmv"] == graphs.read_launches()["csr5_spmv"]


def test_a_failed_or_uncounted_launch_counts_nothing(stand_in_card):
    before = graphs.read_launches()
    with pytest.raises(RuntimeError, match=r"^who: kernel launch failed: an error \(700\)$"):
        cuda_build.launch(_Lib(rc=700), "entry", torch.device("cuda", 0), (), "who", "dia_spmv")
    cuda_build.launch(_Lib(), "entry", torch.device("cuda", 0), (), "who", None)
    assert graphs.read_launches() == before


def test_graphs_reads_the_registry_and_imports_no_kernel_module():
    assert graphs.read_launches() == cuda_build.launches
    with open(graphs.__file__) as f:
        src = f.read()
    assert "ops" not in re.findall(r"^\s*from \.\.(\w+)", src, flags=re.M)


def _matrix(kind: str):
    """A CPU matrix with a raw column plane (sigma 12), a packed one
    (sigma 16, the raw plane dropped) or a float64 value plane (K4's raw
    columns beside the packed plane)."""
    a = sp.csr_matrix(synth.banded(3000, 9)).astype(np.float32)
    host = (a.indptr, a.indices, a.data, a.shape)
    sigma = 12 if kind == "raw" else 16
    dt = torch.float64 if kind == "f64" else torch.float32
    a5 = P.build_csr5(host, P.CSR5Config(sigma=sigma), value_dtype=dt, device="cpu")
    assert (a5.col_packed is None) == (kind == "raw")
    assert (a5.col_idx_tiles is None) == (kind == "packed")
    return a5


def _plan(a5, kind, device=None):
    """The plan of K4 (``kind`` "f64") or of K1, K1p, K2 and K2p."""
    return csr5_kernel._plan(a5, a5.device if device is None else device, "csr5_spmv_cuda",
                             kind == "f64")


KINDS = ["raw", "packed", "f64"]


@pytest.mark.parametrize("kind", KINDS)
def test_plan_is_kept_while_the_planes_are_unchanged(monkeypatch, kind):
    a5 = _matrix(kind)
    assert a5.launch_plan is None
    plan = _plan(a5, kind)
    assert a5.launch_plan is plan
    col = a5.col_packed if kind == "packed" else a5.col_idx_tiles
    want = [col, a5.val_tiles, a5.win_map, a5.tile_ptr]
    if kind != "f64":
        want.append(a5.pages if kind == "packed" or a5.pages_contig else None)
    assert plan[3] == tuple(0 if t is None else t.data_ptr() for t in want)

    def checked(*args, **kwargs):
        raise AssertionError("a plane was checked again")

    # later calls check no plane: only the addresses are read
    monkeypatch.setattr(csr5_kernel, "_expect", checked)
    assert _plan(a5, kind) is plan and _plan(a5, kind) is plan


@pytest.mark.parametrize("kind", KINDS)
def test_plan_is_rebuilt_when_a_plane_is_swapped_or_moved(kind):
    a5 = _matrix(kind)
    plan = _plan(a5, kind)
    # dataclasses.replace carries no plan over
    b = dataclasses.replace(a5, val_tiles=a5.val_tiles.clone())
    assert b.launch_plan is None
    assert _plan(b, kind)[3][1] == b.val_tiles.data_ptr() != plan[3][1]
    # a plane swapped on the matrix itself
    a5.tile_ptr = a5.tile_ptr.clone()
    moved = _plan(a5, kind)
    assert moved is not plan and moved[3][3] == a5.tile_ptr.data_ptr()
    # the same tensor, moved to another address
    win = a5.win_map
    win.data = win.data.clone()
    again = _plan(a5, kind)
    assert again is not moved and again[3][2] == win.data_ptr() and again[2][2] is win
    assert _plan(a5, kind) is again


@pytest.mark.parametrize("kind", KINDS)
def test_a_wrong_plane_raises_at_its_first_launch(kind):
    a5 = _matrix(kind)
    _plan(a5, kind)
    wrong = torch.int16 if kind != "f64" else torch.float32
    bad = dataclasses.replace(a5, val_tiles=a5.val_tiles.to(wrong))
    for _ in range(2):  # no plan is kept for wrong planes
        with pytest.raises(ValueError, match="val_tiles has dtype"):
            _plan(bad, kind)
        assert bad.launch_plan is None
    # the planes on another device than x raise, whatever plan the matrix has
    with pytest.raises(ValueError, match="is on cpu, x on meta"):
        _plan(a5, kind, torch.device("meta"))
    assert a5.launch_plan[1] == a5.device


@pytest.mark.parametrize("kind", KINDS)
def test_plan_reads_every_plane_address_on_every_call(kind):
    """A capture keeps what it read (``graphs._Reads``): the kept plan still
    reads each plane's address, so a graph keeps the planes it launched on."""
    a5 = _matrix(kind)
    plan = _plan(a5, kind)
    reads = graphs._Reads()
    with reads:
        assert _plan(a5, kind) is plan
    held = {id(t) for t in plan[2] if t is not None}
    assert held and held <= set(reads.read)


def test_k3_table_checks_each_slice_through_its_plan():
    a = sp.csr_matrix(synth.banded(4000, 27)).astype(np.float32)
    host = (a.indptr, a.indices, a.data, a.shape)
    sl = P.build_csr5_sliced(host, P.CSR5Config(sigma=16), elem_cap=3000, device="cpu")
    assert sl.num_slices > 1
    table = bigslice_kernel._table(sl, torch.device("cpu"))[0]
    col = bigslice_kernel.DESC_FIELDS.index("col")
    for k, a5 in enumerate(sl.slices):
        assert a5.launch_plan is not None
        assert int(table[k, col]) == a5.launch_plan[3][0] == a5.col_packed.data_ptr()
    sl.slices[1].win_map = sl.slices[1].win_map.long()
    with pytest.raises(ValueError, match="sliced_spmv_cuda: win_map has dtype"):
        bigslice_kernel._table(sl, torch.device("cpu"))
