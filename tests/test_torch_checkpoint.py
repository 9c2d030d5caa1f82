"""Checkpoints of converted matrices in the port (``utils/checkpoint.py``),
mirroring ``tests/test_checkpoint.py``: round trips bit-exact for float32,
bfloat16 and float64 planes and for the packed column plane; a file the
JAX package saved loads in the port (same planes, same y through the
plain versions) and a file the port saved loads in the JAX package; the
version and type checks; the DIA ``offsets_t`` rebuilt on load."""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import benchmark_spmv_using_csr5_tpu as J
from benchmark_spmv_using_csr5_tpu.models.formats import col_tiles_of as jcol_tiles_of
from benchmark_spmv_using_csr5_tpu.ops import dia as jdia
from benchmark_spmv_using_csr5_tpu.ops.csr5_spmv import csr5_spmv_xla
from benchmark_spmv_using_csr5_tpu.utils import checkpoint as jcheckpoint
from benchmark_spmv_using_csr5_tpu_torch import CSR5Config, build_csr5, build_dia
from benchmark_spmv_using_csr5_tpu_torch.models.formats import (
    PLANE_FIELDS,
    STATIC_FIELDS,
    col_tiles_of,
)
from benchmark_spmv_using_csr5_tpu_torch.ops import csr5_kernel
from benchmark_spmv_using_csr5_tpu_torch.ops.csr5_spmv import csr5_spmv_torch
from benchmark_spmv_using_csr5_tpu_torch.ops.dia import dia_spmv_torch
from benchmark_spmv_using_csr5_tpu_torch.utils import checkpoint, synth


def _assert_same_csr5(a5, back):
    assert back.config == a5.config
    for f in STATIC_FIELDS:
        assert getattr(back, f) == getattr(a5, f), f
    for f in PLANE_FIELDS:
        v0, v1 = getattr(a5, f), getattr(back, f)
        if v0 is None:
            assert v1 is None, f
            continue
        assert v1.dtype == v0.dtype and v1.device.type == "cpu", f
        assert torch.equal(v0, v1), f


@pytest.mark.parametrize(
    "value_dtype, sigma",
    [(torch.float32, 24), (torch.bfloat16, 16), (torch.float64, 16), (torch.float32, 32)],
)
def test_csr5_roundtrip_exact(tmp_path, value_dtype, sigma):
    a = sp.csr_matrix(synth.power_law(400, 400, 6.0, dtype=np.float64))
    a5 = build_csr5(a, CSR5Config(sigma=sigma), value_dtype=value_dtype, device="cpu")
    if value_dtype == torch.bfloat16:
        assert a5.col_packed is not None
    p = str(tmp_path / "ck.npz")
    checkpoint.save_csr5(p, a5)
    back = checkpoint.load_csr5(p, device="cpu")
    _assert_same_csr5(a5, back)
    x = torch.from_numpy(synth.dense_x(400, dtype=np.float64)).to(
        torch.float64 if value_dtype == torch.float64 else torch.float32
    )
    assert torch.equal(csr5_spmv_torch(back, x), csr5_spmv_torch(a5, x))


def test_packed_plane_roundtrip(tmp_path):
    a = sp.csr_matrix(synth.banded(600, 9, dtype=np.float32))
    a5 = build_csr5(a, CSR5Config(sigma=16), value_dtype=torch.bfloat16, device="cpu")
    assert a5.col_packed is not None
    p = str(tmp_path / "ck.npz")
    checkpoint.save_csr5(p, a5)
    back = checkpoint.load_csr5(p, device="cpu")
    assert back.val_tiles.dtype == torch.bfloat16
    assert torch.equal(back.col_packed, a5.col_packed) and torch.equal(back.pages, a5.pages)
    with np.load(p) as z:
        static = json.loads(str(z["__static__"]))
        assert static["__version__"] == 3 and static["__type__"] == "CSR5Matrix"
        assert static["__bf16__"] == ["val_tiles"] and z["val_tiles"].dtype == np.uint16
        assert static["config"] == [128, 16, a5.config.tiles_per_block]


@pytest.mark.parametrize("vdt", ["float32", "bfloat16"])
def test_jax_saved_csr5_loads_in_the_port(tmp_path, vdt):
    a = sp.csr_matrix(synth.banded(900, 9, dtype=np.float32))
    ja5 = J.build_csr5(
        J.csr_from_scipy(a), J.CSR5Config(sigma=16),
        value_dtype=jnp.bfloat16 if vdt == "bfloat16" else None,
    )
    assert ja5.col_idx_tiles is None and ja5.col_packed is not None  # the JAX default
    p = str(tmp_path / "jax.npz")
    jcheckpoint.save_csr5(p, ja5)
    back = checkpoint.load_csr5(p, device="cpu")
    assert str(back.val_tiles.dtype) == f"torch.{vdt}"
    for f in PLANE_FIELDS:
        jv = getattr(ja5, f)
        got = getattr(back, f)
        if f == "col_idx_tiles":  # dropped in both; the port's decode is JAX's
            assert got is None
            jv, got = jcol_tiles_of(ja5), col_tiles_of(back)
        got = got.float() if got.dtype == torch.bfloat16 else got
        np.testing.assert_array_equal(got.numpy(), np.asarray(jv).astype(got.numpy().dtype), err_msg=f)
    for f in STATIC_FIELDS:
        if f == "config":
            cfg = lambda c: (c.omega, c.sigma, c.tiles_per_block)  # noqa: E731
            assert cfg(back.config) == cfg(ja5.config)
        else:
            assert getattr(back, f) == getattr(ja5, f), f
    x = np.random.default_rng(0).integers(1, 10, 900).astype(np.float32)
    np.testing.assert_array_equal(
        csr5_spmv_torch(back, torch.from_numpy(x)).numpy(), np.asarray(csr5_spmv_xla(ja5, x))
    )


def test_port_saved_csr5_loads_in_jax(tmp_path):
    a = sp.csr_matrix(synth.power_law(700, 700, 7.0, dtype=np.float32))
    a5 = build_csr5(a, value_dtype="auto", device="cpu")
    csr5_kernel._plan(a5, a5.device, "csr5_spmv_cuda")  # as a first launch leaves it
    assert a5.launch_plan is not None
    p = str(tmp_path / "port.npz")
    checkpoint.save_csr5(p, a5)
    with np.load(p) as z:
        assert "launch_plan" not in z.files and "launch_plan" not in str(z["__static__"])
    ja5 = jcheckpoint.load_csr5(p)
    assert ja5.config.sigma == a5.sigma and ja5.shape == a5.shape
    assert str(np.asarray(ja5.val_tiles).dtype) == str(a5.val_tiles.dtype).removeprefix("torch.")
    x = np.random.default_rng(0).integers(1, 10, 700).astype(np.float32)
    np.testing.assert_array_equal(
        np.asarray(csr5_spmv_xla(ja5, x)), csr5_spmv_torch(a5, torch.from_numpy(x)).numpy()
    )


def test_dia_roundtrip_rebuilds_offsets_t(tmp_path):
    a = sp.csr_matrix(synth.banded(800, 5, dtype=np.float32))
    d = build_dia(a, value_dtype=torch.bfloat16, device="cpu")
    p = str(tmp_path / "dia.npz")
    checkpoint.save_dia(p, d)
    with np.load(p) as z:
        assert "offsets_t" not in z.files and "launch_plan" not in z.files
    back = checkpoint.load_dia(p, device="cpu")
    assert back.offsets == d.offsets and back.shape == d.shape and back.interleaved == d.interleaved
    assert back.data.dtype == torch.bfloat16 and torch.equal(back.data, d.data)
    assert torch.equal(back.offsets_t, d.offsets_t) and back.offsets_t.dtype == torch.int32
    x = torch.from_numpy(synth.dense_x(800, dtype=np.float32))
    assert torch.equal(dia_spmv_torch(back, x), dia_spmv_torch(d, x))


def test_dia_crosses_both_ways(tmp_path):
    a = sp.csr_matrix(synth.banded(800, 5, dtype=np.float32))
    jd = jdia.build_dia((a.indptr, a.indices, a.data, a.shape))
    p = str(tmp_path / "jdia.npz")
    jcheckpoint.save_dia(p, jd)
    back = checkpoint.load_dia(p, device="cpu")
    np.testing.assert_array_equal(back.data.numpy(), np.asarray(jd.data))
    assert back.offsets == jd.offsets and back.m_pad == jd.m_pad
    x = np.random.default_rng(0).integers(1, 10, 800).astype(np.float32)
    y = dia_spmv_torch(back, torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(y, a @ x)
    np.testing.assert_array_equal(y, np.asarray(jdia.dia_spmv_xla(jd, x)))
    p2 = str(tmp_path / "pdia.npz")
    checkpoint.save_dia(p2, back)
    jback = jcheckpoint.load_dia(p2)
    np.testing.assert_array_equal(np.asarray(jback.data), np.asarray(jd.data))
    assert jback.offsets == jd.offsets


def test_type_and_version_errors(tmp_path):
    a5 = build_csr5(sp.csr_matrix(synth.banded(300, 5, dtype=np.float32)), device="cpu")
    p = str(tmp_path / "x.npz")
    checkpoint.save_csr5(p, a5)
    with pytest.raises(ValueError, match="DIAMatrix"):
        checkpoint.load_dia(p, device="cpu")
    arrays, static = checkpoint._pack_fields(a5)
    static["__version__"] = 2
    old = str(tmp_path / "v2.npz")
    np.savez_compressed(old, __static__=json.dumps(static), **arrays)
    with pytest.raises(ValueError, match="unsupported checkpoint version"):
        checkpoint.load_csr5(old, device="cpu")


def test_missing_defaulted_field_warns_and_fills(tmp_path):
    a5 = build_csr5(sp.csr_matrix(synth.banded(300, 5, dtype=np.float32)), device="cpu")
    arrays, static = checkpoint._pack_fields(a5)
    del static["n_pad"]
    p = str(tmp_path / "old.npz")
    np.savez_compressed(p, __static__=json.dumps(static), **arrays)
    with pytest.warns(UserWarning, match="n_pad"):
        back = checkpoint.load_csr5(p, device="cpu")
    assert back.n_pad == dataclasses.fields(type(a5))[-1].default
