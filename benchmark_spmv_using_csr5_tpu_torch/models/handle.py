"""SpMVHandle: the anonymouslibHandle-compatible stateful API.

The counterpart of ``benchmark_spmv_using_csr5_tpu/models/handle.py``
(``handle.py:29-234``), which mirrors ``anonymouslibHandle<iT,uiT,vT>``
(``CSR5_cuda/anonymouslib_cuda.h:16-23``): ``warmup()``, ``inputCSR()``,
``asCSR()``, ``asCSR5()``, ``setX()``, ``spmv()``, ``setSigma()``,
``destroy()``, with snake_case spellings and camelCase aliases. The
handle owns the format state machine CSR <-> CSR5
(``anonymouslib_cuda.h:28-53``).

The port's handle keeps its data on ``device`` (default: the card). A
float32 matrix runs K1 or K1p (``spmv``) and K2 or K2p (``spmm``); beyond
the JAX package's VMEM cap (``should_slice``) it holds the row-sliced form
instead, as the JAX handle does, and runs K3 (``spmv``) and K2/K2p per
slice (``spmm``). A float64 matrix gets a float64 value plane and
``spmv`` runs K4; it never slices. x is used in the dtype
it is given: a float64 x on a float32 matrix, or the reverse, raises in
the dispatcher rather than being cast.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import (
    AUTO_TUNED_SIGMA,
    DEFAULT_DEVICE,
    CSR5Config,
    Format,
    Status,
    compute_sigma,
    resolve_device,
)
from ..ops.bigslice import SlicedCSR5, build_csr5_sliced, should_slice, sliced_spmm, sliced_spmv
from ..ops.convert import build_csr5, build_csr5_autotuned, csr5_to_csr
from ..ops.csr5_spmv import csr5_spmm, csr5_spmv
from ..ops.reference import csr_spmv
from .formats import CSR5Matrix, CSRMatrix


class SpMVHandle:
    """Stateful matrix handle with the reference's lifecycle semantics."""

    def __init__(self, m: int, n: int, device=DEFAULT_DEVICE):
        self.shape = (int(m), int(n))
        self.device = resolve_device(device, "SpMVHandle")
        self._format: Optional[Format] = None
        self._csr: Optional[CSRMatrix] = None
        self._csr5: Optional[CSR5Matrix] = None
        #: the row-sliced form, and the right-hand-side count it was sized for
        self._csr5_sliced: Optional[SlicedCSR5] = None
        self._sliced_rhs = 1
        #: right-hand-side counts for which re-slicing found no form of its
        #: own since the last conversion; the held slices serve them
        self._unsliceable_rhs: set = set()
        self._host_csr = None  # host-side (row_ptr, col_idx, values, shape)
        self._x: Optional[torch.Tensor] = None
        self._sigma: int = AUTO_TUNED_SIGMA
        self._backend: str = "auto"

    # -- lifecycle (anonymouslib_cuda.h:62-103,106-220) -------------------

    def warmup(self) -> "SpMVHandle":
        """Run one spmv before timing (format_cuda.h:7-19): on the card it
        builds and loads the kernel library."""
        if self._format == Format.CSR5:
            _ = self.spmv(1.0)
        return self

    def input_csr(self, nnz: int, row_ptr, col_idx, values) -> "SpMVHandle":
        # a re-input replaces ALL matrix state (a stale host copy from an
        # earlier input would otherwise win in as_csr5 and convert the
        # wrong matrix)
        self._host_csr = None
        self._csr5 = None
        self._csr5_sliced = None
        if not (isinstance(values, torch.Tensor) and values.is_cuda):
            # keep a host copy: conversion is host-side, so a matrix given
            # on the host never round-trips through the card
            self._host_csr = (
                np.asarray(row_ptr, np.int64),
                np.asarray(col_idx, np.int32),
                np.asarray(values),
                self.shape,
            )
        row_ptr = torch.as_tensor(row_ptr, dtype=torch.int32).to(self.device)
        col_idx = torch.as_tensor(col_idx, dtype=torch.int32).to(self.device)
        values = torch.as_tensor(values).to(self.device)
        if int(row_ptr[-1]) != nnz or col_idx.shape[0] != nnz:
            raise ValueError(f"inconsistent nnz={nnz} (Status.INVALID_HANDLE)")
        self._csr = CSRMatrix(row_ptr, col_idx, values, self.shape)
        self._format = Format.CSR
        return self

    def as_csr5(self) -> "SpMVHandle":
        """Convert to CSR5. A float64 matrix keeps a float64 value plane
        (K4's). A float32 matrix beyond the JAX package's VMEM cap
        (``should_slice``) converts straight to the row-sliced form, as the
        JAX handle does (``handle.py:89-96``); one that cannot be sliced
        takes the whole-matrix form."""
        if self._format == Format.CSR5:
            return self
        if self._csr is None:
            raise ValueError("inputCSR first (Status.INVALID_HANDLE)")
        cfg = CSR5Config(sigma=self.compute_sigma())
        src = self._host_csr if self._host_csr is not None else self._csr
        vdt = torch.float64 if self._csr.values.dtype == torch.float64 else None
        if vdt is None and should_slice(*self.shape):
            self._csr5_sliced = build_csr5_sliced(src, cfg, device=self.device)
            self._sliced_rhs = 1
            self._unsliceable_rhs = set()
        if self._csr5_sliced is None:
            if self._sigma == AUTO_TUNED_SIGMA:
                # auto sigma: the structure-aware re-tune; an explicit
                # setSigma skips it, like the reference's fixed-sigma path
                # (anonymouslib_cuda.h:295)
                self._csr5 = build_csr5_autotuned(src, cfg, value_dtype=vdt, device=self.device)
            else:
                self._csr5 = build_csr5(src, cfg, value_dtype=vdt, device=self.device)
        self._format = Format.CSR5
        return self

    def as_csr(self) -> "SpMVHandle":
        if self._format == Format.CSR:
            return self
        if self._csr5 is None and self._csr5_sliced is None:
            raise ValueError("asCSR5 first (Status.INVALID_HANDLE)")
        if self._csr5_sliced is not None:
            # the CSR from inputCSR is still the matrix: drop the slices
            self._csr5_sliced = None
        else:
            self._csr = csr5_to_csr(self._csr5)
            self._csr5 = None
        self._format = Format.CSR
        return self

    def set_x(self, x) -> "SpMVHandle":
        """Bind the dense x vector (setX, ``anonymouslib_cuda.h:222-260``),
        copied to the handle's device in its own dtype."""
        x = torch.as_tensor(x).to(self.device)
        if x.shape[0] != self.shape[1]:
            raise ValueError("x length != n (Status.INVALID_HANDLE)")
        self._x = x
        return self

    def set_sigma(self, sigma: int) -> "SpMVHandle":
        """Select sigma or request auto-tuning (anonymouslib_cuda.h:295-318);
        a matrix already in CSR5 is converted again with the new sigma."""
        self._sigma = int(sigma)
        if self._format == Format.CSR5:
            self.as_csr()
            self.as_csr5()
        return self

    def compute_sigma(self) -> int:
        m, _ = self.shape
        nnz = self._csr.nnz if self._csr is not None else 0
        return compute_sigma(m, nnz, self._sigma)

    def spmv(self, alpha, y_out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """y = alpha * A @ x (anonymouslib_cuda.h:262-285), into ``y_out``
        when it is given."""
        if self._x is None:
            raise ValueError("setX first (Status.INVALID_HANDLE)")
        if self._format == Format.CSR5 and self._csr5_sliced is not None:
            y = sliced_spmv(self._csr5_sliced, self._x, alpha, backend=self._backend)
        elif self._format == Format.CSR5:
            y = csr5_spmv(self._csr5, self._x, alpha, backend=self._backend)
        elif self._format == Format.CSR:
            y = csr_spmv(self._csr, self._x, alpha)
        else:
            raise ValueError("no matrix loaded (Status.INVALID_HANDLE)")
        if y_out is not None:
            return y_out.copy_(y)
        return y

    def spmm(self, x_mat, alpha=1.0) -> torch.Tensor:
        """Y = alpha * A @ X for X (n, R) (multi-rhs extension; the
        reference has no SpMM). float32 only, as in the JAX package."""
        x_mat = torch.as_tensor(x_mat).to(self.device)
        if x_mat.dim() != 2 or x_mat.shape[0] != self.shape[1]:
            raise ValueError("X must be (n, R) (Status.INVALID_HANDLE)")
        if self._format != Format.CSR5:
            raise ValueError("asCSR5 first (Status.INVALID_HANDLE)")
        if self._csr5_sliced is not None:
            # slices from as_csr5 were sized for one rhs: re-slice for R
            # (the JAX package's cap // R) and keep that form until R
            # changes, as the JAX handle does (handle.py:181-199). Where R
            # has no sliced form, the held slices serve it (K2 takes any R
            # on each slice) and R is remembered, so it never converts again
            R = int(x_mat.shape[1])
            if self._sliced_rhs != R and R not in self._unsliceable_rhs:
                src = self._host_csr if self._host_csr is not None else self._csr
                cfg = CSR5Config(sigma=self.compute_sigma())
                sl_r = build_csr5_sliced(src, cfg, num_rhs=R, device=self.device)
                if sl_r is not None:
                    self._csr5_sliced, self._sliced_rhs = sl_r, R
                else:
                    self._unsliceable_rhs.add(R)
            return sliced_spmm(self._csr5_sliced, x_mat, alpha, backend=self._backend)
        return csr5_spmm(self._csr5, x_mat, alpha, backend=self._backend)

    def destroy(self) -> int:
        """Release state; converts back to CSR first like the reference's
        destroy() -> asCSR() (anonymouslib_cuda.h:287-292)."""
        if self._format == Format.CSR5:
            self.as_csr()
        self._csr = None
        self._csr5 = None
        self._csr5_sliced = None
        self._host_csr = None
        self._x = None
        self._format = None
        return int(Status.SUCCESS)

    # -- camelCase aliases for reference-driver parity --------------------
    inputCSR = input_csr
    asCSR5 = as_csr5
    asCSR = as_csr
    setX = set_x
    setSigma = set_sigma
    computeSigma = compute_sigma

    # -- introspection -----------------------------------------------------
    @property
    def format(self) -> Optional[Format]:
        return self._format

    @property
    def csr5(self) -> Optional[CSR5Matrix]:
        return self._csr5

    @property
    def csr5_sliced(self) -> Optional[SlicedCSR5]:
        return self._csr5_sliced

    @property
    def csr(self) -> Optional[CSRMatrix]:
        return self._csr
