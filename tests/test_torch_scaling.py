"""The port's weak-scaling sweep and projection (``parallel/scaling.py``):
``weak_scaling`` at d in {1, 2} on two spawned gloo ranks (finite,
positive efficiencies, the same points on both ranks, ``report`` naming
weak-eff), and ``project_weak_scaling`` equal to the JAX one when both
are given the same link bandwidth and latency. The port carries none of
the JAX module's TPU figures."""

import inspect

import numpy as np
import pytest

import torch_dist_scenarios as S
from benchmark_spmv_using_csr5_tpu.parallel import scaling as jscaling
from benchmark_spmv_using_csr5_tpu_torch.parallel import scaling
from benchmark_spmv_using_csr5_tpu_torch.parallel.launch import run_ranks


@pytest.fixture(scope="module")
def weak():
    return run_ranks(S.run, 2, [("weak", 2, "weak", {})])


def test_weak_scaling_on_two_gloo_ranks(weak):
    pts = [r["weak"]["points"] for r in weak]
    assert pts[0] == pts[1]  # every rank returns rank 0's measurement
    assert [p["devices"] for p in pts[0]] == [1, 2]
    for p in pts[0]:
        assert np.isfinite(p["efficiency"]) and p["efficiency"] > 0 and p["ms_per_spmv"] > 0
        assert p["nnz_per_sec"] == pytest.approx(p["nnz"] / (p["ms_per_spmv"] * 1e-3))
    assert pts[0][0]["efficiency"] == 1.0
    assert pts[0][1]["nnz"] == S.synth.banded(4096, 27).nnz
    assert "weak-eff" in weak[0]["weak"]["report"]


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("gbps,latency_s", [(45.0, 1e-6), (450.0, 7.5e-6)])
def test_projection_matches_jax(monkeypatch, gbps, latency_s, overlap):
    monkeypatch.setattr(jscaling, "ICI_HOP_LATENCY_S", latency_s)
    kw = dict(bandwidth=27, device_counts=(2, 4, 8, 64), itemsize=4, overlap=overlap)
    got = scaling.project_weak_scaling(0.04, 500_000, link_gbps=gbps, latency_s=latency_s, **kw)
    want = jscaling.project_weak_scaling(0.04, 500_000, ici_gbps=gbps, **kw)
    assert [vars(p) for p in got] == [vars(p) for p in want]
    text = scaling.projection_report(got, 0.04, gbps, latency_s)
    assert "measured at D = 1" in text and "proj-eff" in text


def test_no_tpu_figures_in_the_port():
    sig = inspect.signature(scaling.project_weak_scaling)
    assert sig.parameters["latency_s"].default is inspect.Parameter.empty
    assert sig.parameters["link_gbps"].default == scaling.NVLINK_GBPS == 450.0
    src = inspect.getsource(scaling)
    assert "ICI_GBPS" not in src and "45.0" not in src and "819" not in src
