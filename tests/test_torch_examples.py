"""The port's examples run at a tiny size with ``--device cpu`` (the
plain versions) and converge: CG on the 2D Poisson matrix to a relative
residual below 1e-4, PageRank to a total mass of 1 within 1e-5; the
distributed example on four spawned gloo ranks is exact in both
exchanges."""

import importlib.util
import os
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod  # spawned ranks find their function by module name
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("k", [12, 20])
def test_poisson_cg_converges(k, capsys):
    out = _load("poisson_cg_torch").main([str(k), "--device", "cpu"])
    assert out["rel_residual"] < 1e-4 and out["seconds"] > 0
    printed = capsys.readouterr().out
    assert f"2D Poisson {k}x{k}: m={k * k}" in printed and "|r|/|b|" in printed


def test_poisson_matrix_equals_the_jax_example():
    sys.modules.pop("poisson_cg", None)
    jmod = _load("poisson_cg")
    a, ja = _load("poisson_cg_torch").laplacian_2d(9), jmod.laplacian_2d(9)
    assert (a != ja).nnz == 0 and a.dtype == ja.dtype == np.float32


def test_distributed_example_on_gloo_ranks(capsys):
    """Four spawned gloo ranks: both exchanges exact, the halo moving
    fewer x bytes, the counters those of the JAX example at the same m
    and D."""
    out = _load("distributed_spmv_torch").main(["4096", "4", "--device", "cpu"])
    assert out["devices"] == 4 and out["backend"] == "gloo"
    assert out["all_gather_rel_err"] == 0.0 and out["halo_rel_err"] == 0.0
    assert out["halo_widths"] == (128, 128) and out["all_gather_widths"] is None
    assert out["halo_bytes"] == 256 * 4 and out["all_gather_bytes"] == 3 * 1024 * 4
    printed = capsys.readouterr().out
    assert "all-gather exchange: 12,288 B/device" in printed and "halo exchange (128, 128)" in printed


def test_pagerank_mass_and_ranks(capsys):
    out = _load("pagerank_torch").main(["2000", "--device", "cpu"])
    assert abs(out["mass"] - 1.0) <= 1e-5
    assert len(out["top"]) == 5 and len(set(out["top"])) == 5
    assert "total mass" in capsys.readouterr().out
