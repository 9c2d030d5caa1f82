"""The multi-rank harness (``ranks.py``) driven end to end on the CPU: four
gloo ranks on a tiny z-stacked stencil, the program's plain versions. A
sound run is correct; the control and each planted fault (``rank_faults``)
are not; a rank that raises, dies or hangs ends the run within its
deadline; a one-process run of the cell stops at its generator.

No cell of ``BENCHMARK.json`` asks for four chips yet (``PERF.md`` §7), so
the tests run the prepared cell ``hpcg192x4.spmv`` from a copy of the
benchmark whose ``BENCHMARK.json`` carries the entries that add it."""

import json
import math
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from csr5_bench import harness, ranks
from csr5_bench.generators import stencil27, stencil27_zstack
from csr5_bench.tests import rank_faults
from csr5_bench.tests.conftest import SEED, tiny

CELL = "hpcg192x4.spmv"
#: seconds a test run may take before the launcher ends it
DEADLINE = 120.0
#: the entries that add the four-chip cell to BENCHMARK.json
CONFIG = {"name": "hpcg192x4", "source": "https://www.hpcg-benchmark.org (HPCG 3.1; SAND2013-8752)",
          "file": "csr5_bench/configs/hpcg192x4.json", "reduced": ["nx", "ny", "nz"],
          "why": "HPCG on four cards"}
WORKLOAD = {"name": CELL, "config": "hpcg192x4", "traffic": "spmv", "chips": 4,
            "why": "HPCG's SpMV on 4 ranks"}
METRICS = ("product_ms", "convert.host_ms", "dispatch.host_us", "spmv_roofline",
           "device.idle_pct.product")
NCCL = {"name": "dist.nccl_us", "unit": "us", "better": "lower", "source": "device_trace",
        "layer": "exchange", "moves": "product_ms", "workloads": [CELL]}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A copy of the benchmark with the four-chip cell added."""
    root = tmp_path_factory.mktemp("bench")
    shutil.copytree(harness.ROOT / "csr5_bench", root / "csr5_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = harness.load_spec()
    spec["configs"].append(CONFIG)
    spec["workloads"].append(WORKLOAD)
    for m in spec["end_to_end"] + spec["per_layer"]:
        if m["name"] in METRICS:
            m["workloads"].append(CELL)
    spec["per_layer"].append(NCCL)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


def _run(root, seed=SEED, trace=False, **kw):
    kw.setdefault("deadline_s", DEADLINE)
    return ranks.run_cell(CELL, seed, 0.2, trace, device="cpu", root=root,
                          overrides=tiny(CELL), **kw)


@pytest.mark.parametrize("trace", [False, True])
def test_sound_run_is_correct(root, trace):
    r = _run(root, trace=trace)
    assert r["correct"] is True and r["failed"] == 0
    assert r["attempted"] >= ranks.CHUNK and r["attempted"] % ranks.CHUNK == 0
    assert r["checks"]["y_err"]["value"] <= 1e-14
    assert r["device"]["count"] == 4
    cfg = harness.load_cell(CELL, root, overrides=tiny(CELL)).config
    plane = cfg["nx"] * cfg["ny"]
    lanes = -(-plane // 128) * 128
    for p in r["shape"]["ranks"]:  # one plane each way, lane-rounded
        assert p["halo"] == [lanes, lanes] and p["rows"] == plane * cfg["nz"]
    assert r["shape"]["plane"] == "torch.float64"
    if trace:
        assert "breakdown" in r and {"busy_s", "window_s"} <= set(r["device"])
    else:
        assert set(r["metrics"]) == {"setup_s", "product_ms"}
        assert all(m["value"] > 0 for m in r["metrics"].values())


def test_control_is_not_correct(root):
    r = _run(root, control=True)
    assert r["correct"] is False, r["checks"]
    assert r["shape"]["plane"] == "torch.float32"


@pytest.mark.parametrize("fault", ["halo_zero", "altered", "shard_left_out", "half", "unchanged"])
def test_fault_is_not_correct(root, fault):
    r = _run(root, hook=getattr(rank_faults, fault))
    assert r["correct"] is False and r["failed"] >= 1, r["checks"]


@pytest.mark.parametrize("fault", ["raises", "dies", "hangs"])
def test_failed_rank_ends_the_run(root, fault):
    deadline = 40.0
    t0 = time.perf_counter()
    with pytest.raises(ranks.RankFailure) as info:
        _run(root, hook=getattr(rank_faults, fault), deadline_s=deadline)
    assert time.perf_counter() - t0 < deadline + 15
    # a rank's death shows first as its exit or as a peer's broken exchange
    want = {"raises": ("rank 2 raised",), "dies": ("rank 1 ended with exit code 7", "raised"),
            "hangs": ("did not finish",)}[fault]
    assert any(w in str(info.value) for w in want), str(info.value)[-2000:]


def test_generator_needs_a_rank(root):
    cfg = {**harness.load_cell(CELL, root).config, **tiny(CELL)}
    with pytest.raises(RuntimeError, match="multi-rank harness"):
        stencil27_zstack.generate(cfg, SEED, "cpu")
    got = stencil27_zstack.generate(cfg, SEED, "cpu", rank=1)
    want = stencil27.generate({**cfg, "nz": cfg["nz"] * 4}, SEED, "cpu")
    for k in ("row_ptr", "col", "val"):
        assert torch.equal(got[k], want[k])
    a = sp.csr_matrix((got["val"].numpy(), got["col"].numpy(), got["row_ptr"].numpy()),
                      shape=got["shape"])
    assert abs(a - a.T).max() == 0.0 and a.shape[0] == cfg["nx"] * cfg["ny"] * cfg["nz"] * 4


def test_one_process_harness_stops_at_the_generator(root):
    """The one-chip harness, given the four-rank cell, fails at once."""
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="multi-rank harness"):
        harness.run_cell(CELL, SEED, 0.2, False, device="cpu", root=root, overrides=tiny(CELL))
    assert time.perf_counter() - t0 < 30


def test_no_card_no_result(root):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, "-m", "csr5_bench.run", "--workload", CELL,
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=root, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout == ""
    assert "needs 4 CUDA device(s)" in p.stderr


def _part(rank, gaps, metrics=None, busy=None, peak=1, calls=300):
    part = {"calls": calls, "window_s": 0.3 + rank, "setup_s": 10.0 + rank,
            "phases": {"rank": rank}, "check_name": "y_err", "gaps": gaps, "forbidden": [],
            "device": {"platform": "gpu", "kind": "card", "memory_peak_bytes": peak},
            "shape": {"rows": 8}, "rank_shape": {"rank": rank}}
    if metrics is not None:
        part.update(metrics=metrics, busy_s=busy, window_s=1.0, breakdown={"rank": rank})
    return part


def test_combine_takes_the_whole_y_and_the_worst_rank(root):
    cell = harness.load_cell(CELL, root)
    limit = cell.limits["y_err"]["limit"]
    # a sampled product's gap is over the whole y's largest value: rank 1's
    # 1.5 limit against rank 0's 2.0 passes; a non-finite answer fails
    gaps = [[(0.0, 2.0), (0.0, 1.0)], [(1.5 * limit, 1.0), (0.0, 4.0)],
            [(0.0, 1.0), (0.0, 1.0)], [(0.0, 1.0), (math.inf, 1.0)]]
    r = ranks.combine(cell, [_part(i, g, peak=10 * i) for i, g in enumerate(gaps)])
    assert r["attempted"] == 300 and r["failed"] == 1 and r["correct"] is False
    assert r["checks"]["y_err"] == {"value": math.inf, "limit": limit, "compared": 2}
    assert r["device"]["count"] == 4 and r["device"]["memory_peak_bytes"] == 30
    assert r["metrics"]["product_ms"]["value"] == pytest.approx(1.0)  # rank 0's window
    assert r["metrics"]["setup_s"]["value"] == 10.0
    ok = [[(0.0, 2.0)], [(1.5 * limit, 1.0)], [(0.0, 1.0)], [(0.0, 1.0)]]
    r = ranks.combine(cell, [_part(i, g) for i, g in enumerate(ok)])
    assert r["correct"] is True and r["checks"]["y_err"]["value"] == pytest.approx(0.75 * limit)

    per = [{"spmv_roofline": 30.0 - i, "dispatch.host_us": 100.0 + i, "dist.nccl_us": None}
           for i in range(4)]
    busy = [0.99, 0.90, 0.95, 0.97]
    r = ranks.combine(cell, [_part(i, ok[i], per[i], busy[i]) for i in range(4)])
    assert r["metrics"]["spmv_roofline"]["value"] == 27.0  # higher is better: the lowest
    assert r["metrics"]["dispatch.host_us"]["value"] == 103.0  # lower is better: the highest
    assert "dist.nccl_us" not in r["metrics"]  # no rank read it
    assert r["device"]["busy_s"] == 0.90 and r["breakdown"] == {"rank": 1}


def test_combine_refuses_unequal_counts_and_forbidden_modules(root):
    cell = harness.load_cell(CELL, root)
    parts = [_part(i, [(0.0, 1.0)], calls=300 + (i == 2)) for i in range(4)]
    with pytest.raises(ranks.RankFailure, match="different counts"):
        ranks.combine(cell, parts)
    parts = [_part(i, [(0.0, 1.0)]) for i in range(4)]
    parts[3]["forbidden"] = ["jax"]
    with pytest.raises(ranks.RankFailure, match="jax"):
        ranks.combine(cell, parts)


def test_a_run_loads_no_jax(root):
    code = ("import json\nfrom csr5_bench import ranks, run\n"
            "if __name__ == '__main__':\n"
            f"    r = ranks.run_cell({CELL!r}, {SEED}, 0.1, False, device='cpu', "
            f"root={str(root)!r}, overrides={tiny(CELL)!r})\n"
            "    print(json.dumps([r['correct'], run.loaded_forbidden()]))\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    assert json.loads(p.stdout.splitlines()[-1]) == [True, []]


def test_rank_rows_follow_the_global_grid(root):
    """Each rank's block of the z-stacked matrix is its local grid's rows
    of the global stencil: the nonzeros per rank of the configuration."""
    cfg = harness.load_cell(CELL, root).config
    nx, ny, nz = cfg["nx"], cfg["ny"], cfg["nz"]
    plane = (3 * nx - 2) * (3 * ny - 2)  # nonzeros of one x-y plane, one dz
    edge, inner = plane * (3 * nz - 1), plane * 3 * nz
    assert cfg["nnz_per_rank"] == [edge, inner, inner, edge]
    assert cfg["nnz"] == sum(cfg["nnz_per_rank"]) == plane * (3 * nz * 4 - 2)
    assert cfg["rows"] == 4 * cfg["rows_per_rank"] == nx * ny * nz * 4
    assert cfg["halo_columns"] == [-(-nx * ny // 128) * 128] * 2
    assert np.prod(cfg["process_grid"]) == 4
