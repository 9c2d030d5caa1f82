"""Global configuration, tunables and status codes.

The counterpart of ``benchmark_spmv_using_csr5_tpu/config.py`` without
``jax.numpy``: status codes and the format enum mirror
``CSR5_cuda/detail/common.h:13-22``, and :func:`compute_sigma` keeps the
JAX package's heuristic unchanged (``config.py:122-149``).

The tile width stays at omega = 128 (the JAX package's TPU lane width), so
every converted plane of the port can be compared element for element
with the JAX one. On Hopper a tile is one 128-thread block: one thread per
lane.
"""

from __future__ import annotations

import dataclasses
import enum

import torch


class Status(enum.IntEnum):
    SUCCESS = 0
    INVALID_HANDLE = -1
    UNSUPPORTED_CSR5_OMEGA = -2
    UNSUPPORTED_CSR5_SIGMA = -3
    UNSUPPORTED_COMPUTE_CAPABILITY = -4
    UNSUPPORTED_VALUE_TYPE = -5


class Format(enum.IntEnum):
    """Storage format state of a matrix handle (detail/common.h:20-22)."""

    CSR = 0
    CSR5 = 1
    HYB5 = 2  # declared but unused by the reference; kept for parity


#: Sentinel requesting the sigma auto-tune heuristic
#: (ANONYMOUSLIB_AUTO_TUNED_SIGMA, anonymouslib_cuda.h:299).
AUTO_TUNED_SIGMA = -1

#: Tile width of the CSR5 layout (the JAX package's TPU lane count).
LANES = 128

#: sigma granularity of the heuristic (the JAX package's f32 sublane count)
SIGMA_QUANTUM = 8


@dataclasses.dataclass(frozen=True)
class CSR5Config:
    """Static CSR5 tiling configuration: omega/sigma (``common_cuda.h:11-15``)
    plus the tile-count padding quantum the conversion applies
    (``tiles_per_block``, kept so converted planes match the JAX ones)."""

    #: Tile width = number of lanes cooperating on a tile.
    omega: int = LANES
    #: Tile height = consecutive nonzeros per lane.
    sigma: int = 16
    #: The conversion pads the tile count to a multiple of this (capped
    #: at the next power of two >= the tile count).
    tiles_per_block: int = 128
    #: Index dtype name (the reference templates iT/uiT).
    index_dtype: str = "int32"

    @property
    def tile_nnz(self) -> int:
        return self.omega * self.sigma

    @property
    def idt(self) -> torch.dtype:
        return getattr(torch, self.index_dtype)

    def __post_init__(self):
        if self.omega % LANES != 0:
            raise ValueError(
                f"omega={self.omega} must be a multiple of the tile width "
                f"{LANES} (Status.UNSUPPORTED_CSR5_OMEGA)"
            )
        if self.sigma < 1 or self.sigma > 1024:
            raise ValueError(
                f"sigma={self.sigma} out of range (Status.UNSUPPORTED_CSR5_SIGMA)"
            )


#: where the port's builders, handle and harness put their data unless
#: the caller names another device: the card
DEFAULT_DEVICE = "cuda"


def resolve_device(device, who: str) -> torch.device:
    """``device`` as a :class:`torch.device`. A CUDA device when no card is
    present raises, naming the ``device`` argument: nothing carries on on
    the CPU unless the caller asks for it."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{who}: device={str(device)!r} but no CUDA device is available; "
            "pass device='cpu' to run the plain versions on the CPU"
        )
    return device


def compute_sigma(m: int, nnz: int, sigma: int = AUTO_TUNED_SIGMA) -> int:
    """Sigma auto-tune heuristic, unchanged from the JAX package.

    Behavioural parity with ``anonymouslibHandle::computeSigma``
    (``anonymouslib_cuda.h:295-318``), breakpoints (r, s, t, u) snapped to
    multiples of 8:

    - short rows (nnz/row <= r): small sigma
    - medium rows: sigma tracks nnz/row
    - long rows (nnz/row > t): small sigma again (fast-track tiles dominate)
    """
    if sigma != AUTO_TUNED_SIGMA:
        return int(sigma)
    r, s, t, u = 8, 32, 256, 8
    nnz_per_row = nnz / max(m, 1)
    if nnz_per_row <= r:
        sig = r
    elif nnz_per_row <= s:
        sig = int(nnz_per_row)
    elif nnz_per_row <= t:
        sig = s
    else:
        sig = u
    return max(SIGMA_QUANTUM, (sig // SIGMA_QUANTUM) * SIGMA_QUANTUM)
