"""Checkpoints of converted matrices: save a CSR5 or DIA matrix to one
compressed ``.npz`` and load it back bit for bit, so a service skips the
conversion on restart.

The counterpart of ``benchmark_spmv_using_csr5_tpu/utils/checkpoint.py``
(``:40-145``), with its file layout: one array per tensor field, a JSON
``__static__`` entry with ``__version__`` (:data:`FORMAT_VERSION` = 3),
``__type__``, the static fields, ``config`` as ``[omega, sigma,
tiles_per_block]``, ``__none__`` (fields that are None) and ``__bf16__``
(bfloat16 planes, stored as their uint16 bits). A file saved by either
package loads in the other. Loading puts every plane on ``device`` (the
card by default) in the dtype it was saved in; nothing is narrowed. A
JAX matrix saved without its raw column plane (``col_packed`` only)
loads with that plane decoded, since the port always keeps it. The
port's DIA ``offsets_t`` is derived from ``offsets``: it is not saved,
and it is rebuilt on load.
"""

from __future__ import annotations

import dataclasses
import json
import warnings

import numpy as np
import torch

from ..config import DEFAULT_DEVICE, CSR5Config, resolve_device
from ..models.formats import CSR5Matrix, col_tiles_of
from ..ops.dia import DIAMatrix

#: the JAX package's layout version (v3: aligned win_map carries the
#: wrap-flag bits 23/24 too)
FORMAT_VERSION = 3
#: fields the port derives and never writes
_DERIVED = {"offsets_t"}


def _pack_fields(obj) -> tuple:
    """Split a matrix dataclass into (arrays, static JSON) dicts."""
    arrays = {}
    static = {"__version__": FORMAT_VERSION, "__type__": type(obj).__name__}
    for f in dataclasses.fields(obj):
        if not f.init or f.name in _DERIVED:
            continue
        v = getattr(obj, f.name)
        if f.name == "config":
            static["config"] = [v.omega, v.sigma, v.tiles_per_block]
        elif v is None:
            static.setdefault("__none__", []).append(f.name)
        elif isinstance(v, torch.Tensor):
            t = v.detach().cpu()
            if t.dtype == torch.bfloat16:
                # npz has no bfloat16: store the bits and name the field
                arrays[f.name] = t.view(torch.int16).numpy().view(np.uint16)
                static.setdefault("__bf16__", []).append(f.name)
            else:
                arrays[f.name] = t.numpy()
        elif isinstance(v, tuple):
            static[f.name] = list(v)
        else:
            static[f.name] = v
    return arrays, static


def _tensor(arr: np.ndarray, bf16: bool, device) -> torch.Tensor:
    if bf16:
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def _unpack_fields(cls, path: str, expect_type: str, device):
    with np.load(path, allow_pickle=False) as z:
        static = json.loads(str(z["__static__"]))
        if static.pop("__version__") != FORMAT_VERSION:
            raise ValueError(f"unsupported checkpoint version in {path}")
        if static.pop("__type__", expect_type) != expect_type:
            raise ValueError(f"{path} does not hold a {expect_type}")
        none_fields = set(static.pop("__none__", []))
        bf16_fields = set(static.pop("__bf16__", []))
        kwargs = {}
        for f in dataclasses.fields(cls):
            if not f.init or f.name in _DERIVED:
                continue
            if f.name == "config":
                om, sig, tpb = static["config"]
                kwargs["config"] = CSR5Config(omega=om, sigma=sig, tiles_per_block=tpb)
            elif f.name in none_fields:
                kwargs[f.name] = None
            elif f.name in z.files:
                kwargs[f.name] = _tensor(z[f.name], f.name in bf16_fields, device)
            elif f.name in static:
                v = static[f.name]
                kwargs[f.name] = tuple(v) if isinstance(v, list) else v
            elif f.default is not dataclasses.MISSING:
                # a static field added after the file was written: its
                # default means "feature off" (the JAX contract,
                # models/formats.py), so the matrix computes as it did
                warnings.warn(
                    f"loading {path}: field {f.name!r} absent from the checkpoint; filled "
                    f"with its default {f.default!r} (pre-feature semantics)",
                    stacklevel=3,
                )
                kwargs[f.name] = f.default
            else:
                raise ValueError(f"loading {path}: field {f.name!r} missing and has no default")
    return cls(**kwargs)


def save_csr5(path: str, a5: CSR5Matrix) -> None:
    """Write a CSR5Matrix (planes + static plan) to ``path`` (.npz)."""
    arrays, static = _pack_fields(a5)
    np.savez_compressed(path, __static__=json.dumps(static), **arrays)


def load_csr5(path: str, device=DEFAULT_DEVICE) -> CSR5Matrix:
    """A CSR5Matrix saved by :func:`save_csr5` or by the JAX package, on
    ``device`` (default: the card)."""
    device = resolve_device(device, "load_csr5")
    a5 = _unpack_fields(CSR5Matrix, path, "CSR5Matrix", device)
    if a5.col_idx_tiles is None:
        a5.col_idx_tiles = col_tiles_of(a5).contiguous()
    return a5


def save_dia(path: str, dia: DIAMatrix) -> None:
    """Write a DIAMatrix to ``path`` (.npz)."""
    arrays, static = _pack_fields(dia)
    np.savez_compressed(path, __static__=json.dumps(static), **arrays)


def load_dia(path: str, device=DEFAULT_DEVICE) -> DIAMatrix:
    """A DIAMatrix saved by :func:`save_dia` or by the JAX package, on
    ``device`` (default: the card), its ``offsets_t`` rebuilt."""
    device = resolve_device(device, "load_dia")
    return _unpack_fields(DIAMatrix, path, "DIAMatrix", device)
