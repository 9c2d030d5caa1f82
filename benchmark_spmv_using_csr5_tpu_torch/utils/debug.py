"""Debug printers: the reference's ``print_tile`` / ``print_1darray``
(``CSR5_cuda/detail/utils.h:22-55``), on the port's CSR5Matrix.

The counterpart of ``benchmark_spmv_using_csr5_tpu/utils/debug.py``
(``:19-59``): the same strings for the same matrix and tile. A tile is
rendered in its (sigma, omega) layout with the decoded descriptor, the
first thing to look at when a kernel's y differs from the plain version
on one tile.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..models.formats import CSR5Matrix, col_tiles_of


def _host(t) -> np.ndarray:
    """A tensor (any device; bfloat16 widened to float32) or array as numpy."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(t)


def print_1darray(arr, name: str = "array", file=sys.stdout) -> None:
    """The reference's print_1darray (detail/utils.h:44-55)."""
    a = _host(arr)
    print(f"{name} ({a.shape}):\n{a}", file=file)


def tile_to_string(a5: CSR5Matrix, t: int) -> str:
    """Tile ``t``: columns and values in (sigma, omega) layout, the first
    8 lanes, with the decoded descriptor (row-head bits, y_offset,
    seg_offset, the dirty bit)."""
    sig, om = a5.sigma, a5.omega
    col = _host(col_tiles_of(a5)[t])
    val = _host(a5.val_tiles[t]).astype(np.float64)
    bf = _host(a5.bit_flag[t])  # (nwords, omega)
    yo = _host(a5.y_offset[t])
    so = _host(a5.seg_offset[t])
    dirty = bool(_host(a5.tile_dirty[t]))
    rs = int(_host(a5.tile_ptr[t]))

    flags = np.zeros((sig, om), np.int8)
    for s in range(sig):
        flags[s] = (bf[s // 32] >> (s % 32)) & 1

    lines = [
        f"tile {t}: row_start={rs} dirty={dirty}",
        f"  y_offset[:8]  = {yo[:8].tolist()}",
        f"  seg_offset[:8]= {so[:8].tolist()}",
    ]
    show = min(om, 8)
    for s in range(sig):
        row = " ".join(
            f"{'*' if flags[s, l] else ' '}{col[s, l]:>7}:{val[s, l]:<6g}"
            for l in range(show)  # noqa: E741 - the reference's lane index
        )
        lines.append(f"  s={s:<2} {row}{' ...' if om > show else ''}")
    lines.append("  (* marks a row-head bit; first 8 of omega lanes shown)")
    return "\n".join(lines)


def print_tile(a5: CSR5Matrix, t: int, file=sys.stdout) -> None:
    """The reference's print_tile (detail/utils.h:22-42), in the CSR5
    layout of this package."""
    print(tile_to_string(a5, t), file=file)
