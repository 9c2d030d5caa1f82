"""Shared helpers of the benchmark's CPU tests: every cell at a tiny size,
on the program's plain versions."""

import pytest

#: each configuration cut to a size a test holds
TINY = {"hpcg192": {"nx": 6, "ny": 5, "nz": 4}, "kron23": {"scale": 8},
        "hpcg192x4": {"nx": 8, "ny": 8, "nz": 4}}
CELLS = ("hpcg192.cg50", "kron23.pagerank20", "hpcg192.spmv", "kron23.spmm16")
#: a seed past 32 signed bits, as the benchmark's runs are given
SEED = 2**31 + 12345


def tiny(cell: str) -> dict:
    return TINY[cell.split(".", 1)[0]]


@pytest.fixture
def run_tiny():
    from csr5_bench import harness

    def run(cell, seed=SEED, trace=False, **kw):
        return harness.run_cell(cell, seed, 0.2, trace, device="cpu", overrides=tiny(cell), **kw)

    return run
