"""Sparse matrix containers: COO, CSR and CSR5, as dataclasses of torch tensors.

The counterpart of ``benchmark_spmv_using_csr5_tpu/models/formats.py``
with the same field names and static fields (``formats.py:132-198``), so
each plane can be held against the JAX one. Where the JAX package stores
flax pytrees, the port stores plain dataclasses; all tensors of a matrix
live on one device.

:func:`csr5_from_numpy` and :func:`csr5_to_numpy` carry a converted
matrix across between the two packages as numpy planes;
:func:`dia_from_numpy` and :func:`dia_to_numpy` do the same for a DIA
matrix, and a HYB matrix crosses as its two parts.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import CSR5Config
from ..ops.dia import DIAMatrix

#: the static (non-tensor) fields of a DIA matrix, as the JAX
#: ``DIAMatrix`` declares them (``ops/dia.py:66-71``)
DIA_STATIC_FIELDS = ("shape", "offsets", "nnz_stored", "m_pad", "interleaved")

#: the tensor fields of :class:`CSR5Matrix`, in declaration order
PLANE_FIELDS = (
    "row_ptr",
    "tile_ptr",
    "tile_dirty",
    "y_offset",
    "seg_offset",
    "bit_flag",
    "empty_offset_ptr",
    "empty_offset",
    "col_idx_tiles",
    "val_tiles",
    "pages",
    "page_cnt",
    "win_map",
    "col_packed",
)
#: the static (non-tensor) fields of :class:`CSR5Matrix`
STATIC_FIELDS = (
    "shape",
    "config",
    "num_tiles",
    "nnz_stored",
    "win_rel",
    "tail_row_start",
    "capw",
    "pmax",
    "pages_contig",
    "m_pad",
    "n_pad",
)


@dataclasses.dataclass
class COOMatrix:
    """Coordinate-format sparse matrix, the .mtx on-disk model
    (``main.cu:211-238``; the JAX ``COOMatrix``, ``formats.py:35-52``)."""

    row: torch.Tensor  # (nnz,) int32
    col: torch.Tensor  # (nnz,) int32
    values: torch.Tensor  # (nnz,) float
    shape: Tuple[int, int]

    @property
    def nnz(self) -> int:
        return self.values.shape[0]

    @property
    def dtype(self) -> torch.dtype:
        return self.values.dtype


@dataclasses.dataclass
class CSRMatrix:
    """Compressed sparse row matrix (``anonymouslibHandle::inputCSR``,
    ``anonymouslib_cuda.h:62-76``)."""

    row_ptr: torch.Tensor  # (m+1,) int32
    col_idx: torch.Tensor  # (nnz,) int32
    values: torch.Tensor  # (nnz,) float
    shape: Tuple[int, int]

    @property
    def m(self) -> int:
        return self.shape[0]

    @property
    def n(self) -> int:
        return self.shape[1]

    @property
    def nnz(self) -> int:
        return self.values.shape[0]

    @property
    def dtype(self) -> torch.dtype:
        return self.values.dtype


@dataclasses.dataclass
class CSR5Matrix:
    """CSR5 tiled sparse matrix: the JAX package's layout, field for field.

    Element (t, s, l) of the ``(p, sigma, omega)`` planes is CSR element
    ``t*omega*sigma + l*sigma + s`` (the AoS->SoA tile transpose,
    ``format_cuda.h:525-744``). ``win_map[t, d]`` packs the in-tile
    position of the last element of window slot d's row as
    ``sub | lane << 16`` with flag bits 23 (first-row slot) and 24
    (d >= tile_ptr[t] % 128). The port always keeps ``col_idx_tiles``:
    its kernel streams raw int32 columns. ``pages``, ``page_cnt`` and
    ``col_packed`` are the JAX package's TPU gather plan, kept for parity.
    """

    shape: Tuple[int, int]
    config: CSR5Config
    #: number of stored tiles incl. padded tail tile(s)
    num_tiles: int
    #: true (unpadded) nonzero count
    nnz_stored: int

    row_ptr: torch.Tensor  # (m+1,) int32
    tile_ptr: torch.Tensor  # (p+1,) int32: row where each tile starts
    tile_dirty: torch.Tensor  # (p,) bool: empty row in tile's row range
    y_offset: torch.Tensor  # (p, omega) int32
    seg_offset: torch.Tensor  # (p, omega) int32
    bit_flag: torch.Tensor  # (p, ceil(sigma/32), omega) uint32
    empty_offset_ptr: torch.Tensor  # (p+1,) int32
    empty_offset: torch.Tensor  # (num_offsets,) int32

    col_idx_tiles: Optional[torch.Tensor]  # (p, sigma, omega) int32
    val_tiles: torch.Tensor  # (p, sigma, omega) float32 or bfloat16

    pages: torch.Tensor  # (p, pmax) int32
    page_cnt: torch.Tensor  # (p,) int32
    win_map: torch.Tensor  # (p, capw) int32
    col_packed: Optional[torch.Tensor] = None  # (p, sigma/2, omega) int32

    win_rel: bool = False
    tail_row_start: int = 0
    capw: int = 128
    pmax: int = 8
    pages_contig: bool = False
    m_pad: int = 0
    n_pad: int = 0

    @property
    def m(self) -> int:
        return self.shape[0]

    @property
    def n(self) -> int:
        return self.shape[1]

    @property
    def nnz(self) -> int:
        return self.nnz_stored

    @property
    def dtype(self) -> torch.dtype:
        return self.val_tiles.dtype

    @property
    def device(self) -> torch.device:
        return self.val_tiles.device

    @property
    def sigma(self) -> int:
        return self.config.sigma

    @property
    def omega(self) -> int:
        return self.config.omega


def col_tiles_of(a5: CSR5Matrix) -> torch.Tensor:
    """The (p, sigma, omega) int32 column plane, decoding ``col_packed``
    when the raw plane is absent (``formats.py:225-248``).

    The packed code of element (t, s, l) is ``lane | local_page << 7``
    and the column is ``pages[t][local_page] * 128 + lane``: an exact
    inverse.
    """
    if a5.col_idx_tiles is not None:
        return a5.col_idx_tiles
    cp = a5.col_packed  # (p, sigma/2, omega) int32, two codes per word
    p, s2, om = cp.shape
    codes = torch.cat([cp & 0xFFFF, (cp >> 16) & 0xFFFF], dim=1)
    lane = codes & 127
    local = (codes >> 7).reshape(p, 2 * s2 * om).long()
    page = torch.gather(a5.pages, 1, local).reshape(p, 2 * s2, om)
    return page * 128 + lane


def _to_tensor(arr, device) -> torch.Tensor:
    """A copy of a numpy plane on ``device`` (never an alias of ``arr``).
    bfloat16 planes (``ml_dtypes``, as the JAX package hands them out)
    cross as their bit patterns."""
    arr = np.array(arr, copy=True, order="C")
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def csr5_from_numpy(planes: dict, static: dict, device="cpu") -> CSR5Matrix:
    """Build the port's :class:`CSR5Matrix` from numpy planes.

    ``planes`` maps each name of :data:`PLANE_FIELDS` to an array (or
    None for ``col_idx_tiles``/``col_packed``); ``static`` maps each name
    of :data:`STATIC_FIELDS` to its value, with ``config`` given as a
    dict of :class:`CSR5Config` fields or a config object, and an optional
    ``value_dtype`` (``"bfloat16"``/``"float32"``) that the value plane is
    cast to. A matrix the JAX package converted crosses as
    ``{f: np.asarray(getattr(a5, f))}``. A missing raw column plane is
    decoded from ``col_packed``: the port's kernel streams raw columns.
    """
    cfg = static["config"]
    if not isinstance(cfg, CSR5Config):
        fields = cfg if isinstance(cfg, dict) else dataclasses.asdict(cfg)
        cfg = CSR5Config(**fields)
    kw = {k: static[k] for k in STATIC_FIELDS if k != "config"}
    kw["shape"] = tuple(int(v) for v in kw["shape"])
    tensors = {
        f: None if planes.get(f) is None else _to_tensor(planes[f], device)
        for f in PLANE_FIELDS
    }
    vdt = static.get("value_dtype")
    if vdt is not None:
        tensors["val_tiles"] = tensors["val_tiles"].to(getattr(torch, vdt))
    a5 = CSR5Matrix(config=cfg, **kw, **tensors)
    if a5.col_idx_tiles is None:
        a5.col_idx_tiles = col_tiles_of(a5).contiguous()
    return a5


def dia_from_numpy(data, static: dict, device="cpu") -> DIAMatrix:
    """Build the port's :class:`..ops.dia.DIAMatrix` from a numpy value
    plane and the static fields of :data:`DIA_STATIC_FIELDS`. A matrix
    the JAX package built crosses as ``np.asarray(d.data)`` and
    ``{f: getattr(d, f)}``; a bfloat16 plane keeps its dtype."""
    return DIAMatrix(
        shape=tuple(int(v) for v in static["shape"]),
        offsets=tuple(int(o) for o in static["offsets"]),
        nnz_stored=int(static["nnz_stored"]),
        data=_to_tensor(data, device),
        m_pad=int(static["m_pad"]),
        interleaved=bool(static["interleaved"]),
    )


def dia_to_numpy(dia: DIAMatrix) -> Tuple[np.ndarray, dict]:
    """``(data, static)`` of a port DIA matrix as a host numpy copy: the
    inverse of :func:`dia_from_numpy`, with a bfloat16 plane widened to
    float32 (exact)."""
    d = dia.data.detach()
    if d.dtype == torch.bfloat16:
        d = d.float()
    return d.cpu().numpy().copy(), {k: getattr(dia, k) for k in DIA_STATIC_FIELDS}


def csr5_to_numpy(a5: CSR5Matrix) -> Tuple[dict, dict]:
    """``(planes, static)`` of a port matrix as host numpy copies: the
    inverse of :func:`csr5_from_numpy`. A bfloat16 value plane is widened
    to float32 (exact) and named in ``static["value_dtype"]``."""
    planes = {}
    for f in PLANE_FIELDS:
        t = getattr(a5, f)
        if t is not None and t.dtype == torch.bfloat16:
            t = t.float()
        planes[f] = None if t is None else t.detach().cpu().numpy().copy()
    static = {k: getattr(a5, k) for k in STATIC_FIELDS}
    static["config"] = dataclasses.asdict(a5.config)
    static["value_dtype"] = str(a5.val_tiles.dtype).removeprefix("torch.")
    return planes, static
