"""Sparse matrix containers: COO, CSR and CSR5, as dataclasses of torch tensors.

The counterpart of ``benchmark_spmv_using_csr5_tpu/models/formats.py``
with the same field names and static fields (``formats.py:132-198``), so
each plane can be held against the JAX one. Where the JAX package stores
flax pytrees, the port stores plain dataclasses; all tensors of a matrix
live on one device.

:func:`csr_from_numpy` and :func:`csr_from_scipy` build a
:class:`CSRMatrix` from host arrays or a scipy matrix, as the JAX
package's do (``formats.py:251-271``).
:func:`csr5_from_numpy` and :func:`csr5_to_numpy` carry a converted
matrix across between the two packages as numpy planes (float64 value
planes included); :func:`csr5_from_df64` builds the float64 plane from
a JAX double-single matrix;
:func:`dia_from_numpy` and :func:`dia_to_numpy` do the same for a DIA
matrix, and a HYB matrix crosses as its two parts.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import DEFAULT_DEVICE, CSR5Config, resolve_device
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
    (d >= tile_ptr[t] % 128). Where ``col_packed`` exists (sigma % 16 ==
    0, pmax <= 512) the kernels stream it with ``pages`` instead of
    ``col_idx_tiles`` (K1p, K2p), as the JAX kernel does, and the
    conversion drops the raw plane (None) unless asked to keep it or the
    value plane is float64 (K4 reads raw columns): read the columns with
    :func:`col_tiles_of`. ``empty_offset`` is the ragged table of the
    host conversion, or, from the on-card conversion, ``eo_width`` slots
    per dirty tile. ``page_cnt`` is the JAX package's TPU gather plan,
    kept for parity.
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
    val_tiles: torch.Tensor  # (p, sigma, omega) float32, bfloat16 or float64

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
    return col_tiles_from_packed(a5)


def col_tiles_from_packed(a5: CSR5Matrix) -> torch.Tensor:
    """The (p, sigma, omega) int32 column plane decoded from ``col_packed``
    and ``pages``, whether or not the raw plane is present: the decode of
    kernels K1p and K2p in plain torch. Word (t, s, l) holds the code of
    element (t, s, l) in its low half and of (t, s + sigma/2, l) in its
    high half."""
    if a5.col_packed is None:
        raise ValueError("the matrix has no col_packed plane (sigma % 16 != 0 or pmax > 512)")
    return decode_packed_codes(a5.col_packed, a5.pages)


#: tiles decoded at a time by :func:`decode_packed_codes` (bounds its
#: int64 gather index: 2**24 elements, 128 MB)
_DECODE_ELEMS = 2**24


def decode_packed_codes(cp: torch.Tensor, pages: torch.Tensor) -> torch.Tensor:
    """(p, 2 * s2, omega) int32 columns from (p, s2, omega) packed words
    and the (p, pmax) page lists, on their device: the low half of word
    (t, s, l) is element (t, s, l), the high half (t, s + s2, l); a code
    is ``lane | local_page << 7`` and the column ``pages[t][local_page] *
    128 + lane``. Decodes a bounded number of tiles at a time, so a 560M-
    nonzero plane needs no nnz-sized int64 index on the card."""
    p, s2, om = cp.shape
    out = torch.empty((p, 2 * s2, om), dtype=torch.int32, device=cp.device)
    step = max(1, _DECODE_ELEMS // max(2 * s2 * om, 1))
    for t0 in range(0, p, step):
        c = cp[t0 : t0 + step]
        codes = torch.cat([c & 0xFFFF, (c >> 16) & 0xFFFF], dim=1)
        local = (codes >> 7).reshape(c.shape[0], -1).long()
        page = torch.gather(pages[t0 : t0 + step], 1, local).reshape(codes.shape)
        out[t0 : t0 + step] = page * 128 + (codes & 127)
    return out


def with_k4_columns(a5: CSR5Matrix) -> CSR5Matrix:
    """``a5``, its raw column plane decoded from ``col_packed`` in place
    when the value plane is float64 and the plane is missing (a matrix
    saved or carried without it): K4 reads raw columns. Other matrices
    are returned as they are."""
    if a5.col_idx_tiles is None and a5.val_tiles.dtype == torch.float64:
        a5.col_idx_tiles = col_tiles_of(a5).contiguous()
    return a5


def csr_from_numpy(
    row_ptr: np.ndarray,
    col_idx: np.ndarray,
    values: np.ndarray,
    shape: Tuple[int, int],
    dtype=None,
    device=DEFAULT_DEVICE,
) -> CSRMatrix:
    """A :class:`CSRMatrix` on ``device`` (default: the card) from host
    arrays, the inputCSR analogue (JAX ``formats.py:251-265``): int32
    indices, values in ``dtype`` (a numpy or torch dtype) or else their
    own dtype, ``tuple(shape)``."""
    device = resolve_device(device, "csr_from_numpy")
    as_torch = isinstance(dtype, torch.dtype)
    v = torch.from_numpy(np.array(values, dtype=None if as_torch else dtype, copy=True))
    if as_torch:
        v = v.to(dtype)
    return CSRMatrix(
        row_ptr=torch.from_numpy(np.asarray(row_ptr, dtype=np.int32).copy()).to(device),
        col_idx=torch.from_numpy(np.asarray(col_idx, dtype=np.int32).copy()).to(device),
        values=v.to(device),
        shape=tuple(shape),
    )


def csr_from_scipy(sp_mat, dtype=None, device=DEFAULT_DEVICE) -> CSRMatrix:
    """A :class:`CSRMatrix` on ``device`` (default: the card) from a
    scipy.sparse matrix (JAX ``formats.py:268-271``)."""
    csr = sp_mat.tocsr()
    return csr_from_numpy(csr.indptr, csr.indices, csr.data, csr.shape, dtype, device)


def _to_tensor(arr, device) -> torch.Tensor:
    """A copy of a numpy plane on ``device`` (never an alias of ``arr``).
    bfloat16 planes (``ml_dtypes``, as the JAX package hands them out)
    cross as their bit patterns."""
    arr = np.array(arr, copy=True, order="C")
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def csr5_from_numpy(planes: dict, static: dict, device=DEFAULT_DEVICE) -> CSR5Matrix:
    """Build the port's :class:`CSR5Matrix` from numpy planes.

    ``planes`` maps each name of :data:`PLANE_FIELDS` to an array (or
    None for ``col_idx_tiles``/``col_packed``); ``static`` maps each name
    of :data:`STATIC_FIELDS` to its value, with ``config`` given as a
    dict of :class:`CSR5Config` fields or a config object, and an optional
    ``value_dtype`` (``"bfloat16"``/``"float32"``) that the value plane is
    cast to. A matrix the JAX package converted crosses as
    ``{f: np.asarray(getattr(a5, f))}``; a float64 value plane (the JAX
    package under x64) stays float64, its missing raw column plane
    decoded from ``col_packed`` for K4 (:func:`with_k4_columns`). The
    planes go to ``device`` (default: the card).
    """
    device = resolve_device(device, "csr5_from_numpy")
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
    return with_k4_columns(CSR5Matrix(config=cfg, **kw, **tensors))


def csr5_from_df64(planes: dict, lo_plane, static: dict, device=DEFAULT_DEVICE) -> CSR5Matrix:
    """The port's float64 :class:`CSR5Matrix` from a JAX ``DF64CSR5``.

    ``planes`` and ``static`` are the numpy planes and static fields of
    the df64 matrix's ``a5`` (its float32 hi plane and all the
    structure), as :func:`csr5_from_numpy` takes them; ``lo_plane`` is
    ``np.asarray(d.val_lo_tiles)``. The value plane is
    ``f64(hi) + f64(lo)``, exact in float64. That is the df64
    representation of the matrix, about 2^-48 from the original float64
    values (``csr5_df64.split_f64``), not the original values.
    """
    hi = np.asarray(planes["val_tiles"], np.float64)
    vals = hi + np.asarray(lo_plane, np.float64)
    static = {k: v for k, v in static.items() if k != "value_dtype"}
    return csr5_from_numpy({**planes, "val_tiles": vals}, static, device)


def dia_from_numpy(data, static: dict, device=DEFAULT_DEVICE) -> DIAMatrix:
    """Build the port's :class:`..ops.dia.DIAMatrix` from a numpy value
    plane and the static fields of :data:`DIA_STATIC_FIELDS`. A matrix
    the JAX package built crosses as ``np.asarray(d.data)`` and
    ``{f: getattr(d, f)}``; a bfloat16 plane keeps its dtype. The plane
    goes to ``device`` (default: the card)."""
    device = resolve_device(device, "dia_from_numpy")
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
