"""K1's grouped tile step, on the CPU: the wrapper's mirror of K1's shared
memory against the expression of ``csrc/csr5_spmv.cu``'s launch, its rows
per group against the kernel's constant, the share of a lane's rows loaded
a group ahead, and the largest sigma K1 takes. The kernel itself runs only
on the card (``chip_smoke.py``)."""

from __future__ import annotations

import os
import re

import numpy as np
import pytest
import scipy.sparse as sp

from benchmark_spmv_using_csr5_tpu_torch import CSR5Config, build_csr5
from benchmark_spmv_using_csr5_tpu_torch.ops import bigslice, csr5_kernel
from benchmark_spmv_using_csr5_tpu_torch.utils import cuda_build, synth


def _source(name: str) -> str:
    with open(os.path.join(cuda_build.CSRC_DIR, name)) as f:
        return f.read()


def _int_constant(src: str, name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def _c_smem_bytes(sigma: int) -> int:
    """The dynamic shared memory K1's launch asks for, as
    ``csrc/csr5_spmv.cu`` writes it, with ``csr5_tile.cuh``'s kLanes."""
    src = _source("csr5_spmv.cu")
    launch = src[src.index("int launch(const void* col"):]
    expr = re.search(r"const size_t smem = (.*?);", launch, flags=re.S).group(1)
    expr = expr.replace("(size_t)", "").replace("sizeof(float)", "4")
    expr = expr.replace("kLanes", str(_int_constant(_source("csr5_tile.cuh"), "kLanes")))
    if not re.fullmatch(r"[\s\w()+*]+", expr):
        raise ValueError(f"unexpected C expression: {expr}")
    return eval(f"({expr})", {}, {"sigma": sigma})


def test_unroll_matches_the_kernel():
    assert _int_constant(_source("csr5_spmv.cu"), "kUnroll") == csr5_kernel.K1_UNROLL


@pytest.mark.parametrize("sigma", [1, 7, 8, 24, 33, 448])
def test_smem_mirror_matches_the_launch(sigma):
    assert csr5_kernel.k1_smem_bytes(sigma) == _c_smem_bytes(sigma)


@pytest.mark.parametrize(
    "sigma, share",
    [(1, 0.0), (7, 0.0), (8, 1.0), (16, 1.0), (24, 1.0), (31, 24 / 31), (32, 1.0)],
)
def test_grouped_share(sigma, share):
    got = csr5_kernel.k1_grouped_share(sigma)
    assert got == pytest.approx(share, rel=0, abs=1e-15)
    full = round(got * sigma)
    assert full % csr5_kernel.K1_UNROLL == 0 and 0 <= sigma - full < csr5_kernel.K1_UNROLL


def test_max_sigma_rule():
    k = csr5_kernel
    room = k.SMEM_MAX - k.STATIC_SMEM
    # the largest sigma a packed plane can have (sigma % 16 == 0) whose K1
    # block fits beside K1's static warp totals
    assert k.MAX_SIGMA % 16 == 0
    assert k.k1_smem_bytes(k.MAX_SIGMA) <= room < k.k1_smem_bytes(k.MAX_SIGMA + 16)
    src = _source("csr5_spmv.cu")
    kernel = src[src.index("csr5_spmv_tile_kernel("):src.index("csr5_spmv_packed_kernel(")]
    static = re.findall(r"__shared__ float \w+\[kWarps\];", kernel)
    assert len(static) * 4 * (k.LANES // 32) <= k.STATIC_SMEM


def test_sliced_build_refuses_past_max_sigma():
    a = sp.csr_matrix(synth.banded(3000, 9)).astype(np.float32)
    host = (a.indptr, a.indices, a.data, a.shape)
    at = build_csr5(host, CSR5Config(sigma=csr5_kernel.MAX_SIGMA), device="cpu")
    past = build_csr5(host, CSR5Config(sigma=csr5_kernel.MAX_SIGMA + 1), device="cpu")
    assert bigslice._kernel_takes(at)
    assert not bigslice._kernel_takes(past)
