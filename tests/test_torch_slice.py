"""The port's main path as a whole, on the CPU, against the JAX pipeline.

``cli.run`` loads the matrix, converts it, checks y against scipy at the
reference's 1 % gate and times it, as the JAX CLI does. On these
integer-valued inputs the check must give max rel err 0.0, and y must
equal the JAX pipeline's y on the same seed (``default_rng(0)``), exactly.
"""

import argparse
import os

import numpy as np
import pytest
import torch

from benchmark_spmv_using_csr5_tpu.bench import cli as jcli
from benchmark_spmv_using_csr5_tpu.bench.harness import run_benchmark as jax_run_benchmark
from benchmark_spmv_using_csr5_tpu.ops.csr5_spmv import csr5_spmv_xla
from benchmark_spmv_using_csr5_tpu_torch.bench import cli, harness

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE = os.path.join(ROOT, "example.mtx")


@pytest.mark.parametrize("argv", [[EXAMPLE], ["--synthetic", "banded:3000:27"]])
def test_slice_matches_jax_pipeline(argv):
    res = cli.run(argv + ["--num-run", "2"])
    assert res.check_ok and res.max_rel_err == 0.0
    assert res.backend == "torch" and res.device == "cpu"
    assert res.pct_of_roofline is None  # a host time has no device roofline
    assert "roofline not measured" in res.report()

    rp, ci, v, shape, name = jcli.load_matrix(
        argparse.Namespace(
            matrix=argv[0] if len(argv) == 1 else None,
            synthetic=argv[1] if len(argv) == 2 else None,
            dtype="float32",
        )
    )
    jres = jax_run_benchmark(name, rp, ci, v, shape, num_run=2)
    assert jres.check_ok and jres.max_rel_err == 0.0
    assert res.storage == jres.storage == "bfloat16"
    assert (res.nnz, res.sigma) == (jres.nnz, jres.sigma)
    x = np.random.default_rng(0).integers(1, 10, size=shape[1]).astype(np.float32)
    y_jax = np.asarray(csr5_spmv_xla(jres.matrix, x))
    np.testing.assert_array_equal(res.y.numpy(), y_jax)


@pytest.mark.parametrize(
    "extra,item",
    [
        (["--dtype", "float64"], "item 7"),
        (["--spmm", "4"], "item 8"),
        (["--format", "dia"], "item 9"),
        (["--format", "hyb"], "item 9"),
        (["--format", "bandblock"], "item 8"),
        (["--format", "auto"], "item 9"),
        (["--autotune"], "item 2"),
        (["--reorder", "rcm"], "item 9"),
    ],
)
def test_cli_unported_choices_raise(extra, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP queue 1 {item}"):
        cli.run([EXAMPLE] + extra)


def test_cli_cuda_backend_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.run([EXAMPLE, "--backend", "cuda"])


def test_harness_rejects_float64_values():
    rp, ci = np.array([0, 1]), np.array([0], np.int32)
    with pytest.raises(NotImplementedError, match="K4"):
        harness.run_benchmark("f64", rp, ci, np.ones(1), (1, 1), device="cpu")


def test_cli_main_prints_report(capsys):
    assert cli.main([EXAMPLE, "--num-run", "1", "--backend", "torch"]) == 0
    out = capsys.readouterr().out
    assert "Check... PASS!" in out and "[torch, bfloat16, cpu]" in out
