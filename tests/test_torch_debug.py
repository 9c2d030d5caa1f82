"""The port's debug printers (``utils/debug.py``) give the JAX package's
strings for the same matrix and tile: ``tile_to_string``/``print_tile``
on float32 and bfloat16 planes, wrapped and packed-only layouts, and
``print_1darray`` on tensors and arrays."""

import io

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import benchmark_spmv_using_csr5_tpu as J
from benchmark_spmv_using_csr5_tpu.utils import debug as jdebug
from benchmark_spmv_using_csr5_tpu_torch import CSR5Config, build_csr5
from benchmark_spmv_using_csr5_tpu_torch.utils import debug, synth


@pytest.mark.parametrize(
    "make, sigma, vdt",
    [
        (lambda: synth.banded(900, 9, dtype=np.float32), 16, "float32"),
        (lambda: synth.power_law(700, 600, 8.0, seed=11, dtype=np.float32), 8, "bfloat16"),
        (lambda: synth.banded(2000, 27, dtype=np.float32), 24, "float32"),
        (lambda: synth.power_law(500, 400, 6.0, seed=7, dtype=np.float32), 36, "float32"),
    ],
)
def test_tile_to_string_equals_jax(make, sigma, vdt):
    a = sp.csr_matrix(make())
    a.data = np.random.default_rng(1).uniform(-4, 4, a.nnz).astype(np.float32)
    a5 = build_csr5(a, CSR5Config(sigma=sigma),
                    value_dtype=getattr(torch, vdt), device="cpu")
    ja5 = J.build_csr5(J.csr_from_scipy(a), J.CSR5Config(sigma=sigma),
                       value_dtype=getattr(jnp, vdt))
    for t in sorted({0, a5.num_tiles // 2, a5.num_tiles - 1}):
        got = debug.tile_to_string(a5, t)
        assert got == jdebug.tile_to_string(ja5, t)
        assert got.startswith(f"tile {t}: row_start={int(a5.tile_ptr[t])}")
        assert len(got.splitlines()) == sigma + 4
    buf, jbuf = io.StringIO(), io.StringIO()
    debug.print_tile(a5, 0, file=buf)
    jdebug.print_tile(ja5, 0, file=jbuf)
    assert buf.getvalue() == jbuf.getvalue()


@pytest.mark.parametrize(
    "arr",
    [np.arange(12, dtype=np.int32), np.linspace(-1, 1, 7, dtype=np.float32), np.zeros(0, np.float64)],
)
def test_print_1darray_equals_jax(arr):
    buf, jbuf = io.StringIO(), io.StringIO()
    debug.print_1darray(torch.from_numpy(arr), "tile_ptr", file=buf)
    jdebug.print_1darray(jnp.asarray(arr), "tile_ptr", file=jbuf)
    assert buf.getvalue() == jbuf.getvalue()
    host = io.StringIO()
    debug.print_1darray(arr, "tile_ptr", file=host)
    assert host.getvalue() == buf.getvalue()
